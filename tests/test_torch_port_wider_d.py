"""PyTorch port, K1 at head dims 320 to 512 (the reference's Pallas
kernel at D % 64 == 0 above 256; K2 and K3 there are held to the Pallas
backward in test_torch_port_wider_bwd.py): K1's plain version against
``_flash_fwd`` in Pallas interpret mode, the dispatch's route and the
head-dim gates, the wrappers' launches off the CPU, and TinyGenLM at head
dims 512 (DeepSeek-V4-Flash's) and 320 against the JAX package, through
to a stock config streaming tokens over HTTP.

Inputs are made with numpy and fed to both packages, in f32. Where a
test stands in for the card, the route is asked with ``on_cuda`` forced
true (``_forced_card``), or the wrappers' CUDA branch runs on meta
tensors with spies for the entry points (``fake_card``).
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.pallas_attention import _flash_fwd
from analytics_zoo_tpu.serving.generation.engine import (
    DecodeEngine as JaxDecodeEngine)
from analytics_zoo_tpu.serving.generation.model import (
    GenModelConfig as JaxGenModelConfig)
from analytics_zoo_tpu.serving.generation.model import TinyGenLM as JaxLM
from analytics_zoo_tpu_torch.bridge import gen_params_from_tree
from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.ops import attention as port_attention
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from analytics_zoo_tpu_torch.serving.generation import (
    DecodeEngine, GenModelConfig, TinyGenLM)
from analytics_zoo_tpu_torch.serving.launcher import launch
from tests.test_torch_port_k5b_bwd import D_ARG, fake_card  # noqa: F401
from tests.test_torch_port_wide_d import _forced_card

torch.set_num_threads(2)

WIDER = (320, 384, 448, 512)
# f32 on both sides, exact arithmetic in another order:
# |port - pallas| <= TOL * (1 + |pallas|), for out and lse alike
TOL = 1e-5
# TinyGenLM logits, K and V (f32, dim 64): as test_torch_port_wide_d.py
# holds the model at head_dim 256
LM_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _drop_port_flight_recorder():
    # launch() installs the port's process-wide crash hooks
    yield
    from analytics_zoo_tpu_torch.obs.flight import (
        uninstall_flight_recorder)

    uninstall_flight_recorder()


def _qkv(seed, b, h, lq, lk, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, lq, d).astype(np.float32),
            rng.randn(b, h, lk, d).astype(np.float32),
            rng.randn(b, h, lk, d).astype(np.float32))


# ------------------------------------------------------------- K1 plain --
class TestWiderReference:
    @pytest.mark.parametrize("causal,lk", [(False, 128), (True, 128),
                                           (True, 256)])
    @pytest.mark.parametrize("d", WIDER)
    def test_matches_pallas_kernel(self, d, causal, lk):
        """K1's plain version (what the CUDA kernel is held to on the
        card), out and lse, against ``_flash_fwd`` with its logsumexp:
        [1,2,128,d] causal and not, and cross-length causal 128 -> 256."""
        q, k, v = _qkv(d + lk + causal, 1, 2, 128, lk, d)
        out, lse = _flash_fwd(*(jnp.asarray(a) for a in (q, k, v)), causal,
                              1.0 / np.sqrt(d), None, None, with_lse=True)
        got, got_lse = fa.flash_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
            with_lse=True)
        assert got.shape == (1, 2, 128, d) and got_lse.shape == (2, 128)
        np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[..., 0],
                                   rtol=TOL, atol=TOL)


class TestWiderRouteAndGates:
    BASE = dict(impl="flash", on_cuda=True, l=256, lk=256, has_mask=False,
                dropout_rate=0.0)

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("d", WIDER)
    def test_k1_without_a_gradient(self, d, causal):
        assert port_attention._flash_route(
            **self.BASE, d=d, causal=causal) == "kernels"

    @pytest.mark.parametrize("change", [
        {"needs_grad": True}, {"has_key_padding_mask": True},
        {"needs_grad": True, "has_key_padding_mask": True}])
    @pytest.mark.parametrize("d", WIDER)
    def test_einsum_with_a_gradient_or_a_mask(self, d, change):
        """A key-padding mask takes the einsum path (no masked kernel
        above 128; the reference's einsum path), with or without a
        gradient; a gradient alone takes the kernels (K1-lse, K2 and K3
        at these head dims)."""
        got = port_attention._flash_route(
            **dict(self.BASE, d=d, causal=True, **change))
        assert got == (None if change.get("has_key_padding_mask")
                       else "kernels")

    @pytest.mark.parametrize("d", [576, 640])
    def test_einsum_above_512(self, d):
        assert port_attention._flash_route(**self.BASE, d=d,
                                           causal=True) is None

    @pytest.mark.parametrize("d", WIDER)
    def test_gates(self, d):
        fa._check_head_dim(d)
        fa._check_head_dim(d, backward=True)
        with pytest.raises(NotImplementedError, match="masked"):
            fa._check_head_dim(d, masked=True)

    def test_gate_above_512(self):
        for backward in (False, True):
            with pytest.raises(NotImplementedError, match="above 512"):
                fa._check_head_dim(576, backward=backward)

    @pytest.mark.parametrize("with_lse", [False, True])
    @pytest.mark.parametrize("d", WIDER)
    def test_card_launch_counts_wider(self, fake_card, monkeypatch, d,
                                      with_lse):
        """Off the CPU (meta tensors, spied entry points) K1 launches at
        the caller's head dim, with or without a logsumexp, and counts in
        ``wide_d_launches``, as K1 at 192 and 256 does; f32 there runs the
        f32 tensor-core kernel."""
        monkeypatch.setattr(fa.flash_attention, "small_d_launches", 0)
        monkeypatch.setattr(fa.flash_attention, "wide_d_launches", 0)
        q = torch.empty(1, 64, 256, d, device="meta")
        got = fa.flash_attention(q, q, q, True, None, with_lse)
        out = got[0] if with_lse else got
        assert out.shape == q.shape
        assert [(name, args[D_ARG[name]]) for name, args in fake_card] == [
            ("zoo_flash_attn_fwd_f32tc", d)]
        assert (fake_card[0][1][4] is not None) == with_lse
        w = fa.flash_attention
        assert (w.launches, w.small_d_launches,
                w.wide_d_launches) == (1, 0, 1)

    def test_card_gradient_raises_before_k1(self, fake_card, monkeypatch):
        """``FlashAttention`` at D = 512 no longer raises: off the CPU
        (meta tensors, spied entry points) a gradient launches K1-lse,
        then K2, then K3 at that head dim, each counted in
        ``wide_d_launches`` (f32: all three on the f32 tensor-core
        entries)."""
        for w in (fa.flash_attention, fa.flash_attention_bwd_dq,
                  fa.flash_attention_bwd_dkv):
            monkeypatch.setattr(w, "wide_d_launches", 0)
        q = torch.empty(1, 2, 128, 512, device="meta", requires_grad=True)
        out = fa.flash_attention(q, q, q, True)
        (grad,) = torch.autograd.grad(out, q, torch.empty_like(out))
        assert grad.shape == q.shape
        assert [(name, args[D_ARG[name]]) for name, args in fake_card] == [
            ("zoo_flash_attn_fwd_f32tc", 512),
            ("zoo_flash_attn_bwd_dq_f32tc", 512),
            ("zoo_flash_attn_bwd_dkv_f32tc", 512)]
        for w in (fa.flash_attention, fa.flash_attention_bwd_dq,
                  fa.flash_attention_bwd_dkv):
            assert (w.launches, w.wide_d_launches) == (1, 1)


# ----------------------------------------------- TinyGenLM at D = 512/320 --
def _kw(head_dim):
    return dict(vocab=64, dim=64, heads=2, head_dim=head_dim, layers=2,
                max_len=256, mlp_ratio=2, seed=0)


@pytest.fixture(scope="module", params=[512, 320])
def models(request):
    """The JAX package's TinyGenLM at this head dim and the port's over
    the same weights (carried by ``gen_params_from_tree``)."""
    kw = _kw(request.param)
    jax_lm = JaxLM(JaxGenModelConfig(**kw))
    jax_params = jax_lm.init_params()
    port_lm = TinyGenLM(GenModelConfig(**kw))
    bridged = gen_params_from_tree(
        jax.tree_util.tree_map(np.asarray, jax_params), device="cpu")
    return jax_lm, jax_params, port_lm, bridged


class TestWiderTinyGenLM:
    @pytest.mark.parametrize("length", [9, 128])
    def test_prefill_logits_k_v_match(self, models, length):
        jax_lm, jax_params, port_lm, bridged = models
        toks = np.random.RandomState(length).randint(
            0, 64, (1, length)).astype(np.int32)
        want = jax_lm.prefill(jax_params, toks)
        with torch.inference_mode():
            got = port_lm.prefill(bridged, torch.from_numpy(toks))
        for a, b in zip(got, want):
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=LM_ATOL)

    def test_prefill_bucket_goes_through_k1(self, monkeypatch, models):
        """A prefill bucket of 128 tokens as on the card (no autograd,
        causal at lq == lk): every layer's attention is one
        ``flash_attention`` call at this head dim, and the logits are the
        JAX package's."""
        jax_lm, jax_params, port_lm, bridged = models
        d = port_lm.config.head_dim
        calls = _forced_card(monkeypatch)
        toks = np.random.RandomState(4).randint(0, 64, (1, 128)).astype(
            np.int32)
        try:
            with torch.inference_mode():
                logits, _, _ = port_lm.prefill(bridged,
                                               torch.from_numpy(toks))
        finally:
            get_config().unset("zoo.ops.attention_impl")
        assert calls == [((1, 2, 128, d), True, False)] * 2
        want, _, _ = jax_lm.prefill(jax_params, toks)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                                   atol=LM_ATOL)

    def test_decode_step_through_the_pool(self, models):
        """One decode step through ``PagedKVCache``: its logits are the
        JAX package's full prefill over the prompt and the first token,
        the pool is sized from the config's head dim, and the engine's
        tokens are the JAX engine's."""
        jax_lm, jax_params, port_lm, bridged = models
        d = port_lm.config.head_dim
        engine = DecodeEngine(port_lm, params=bridged, num_slots=2,
                              page_size=16, max_len=256, device="cpu")
        pages = engine.cache.num_pages
        assert engine.cache.kv.shape[-2:] == (2, d)
        assert engine.cache.stats()["bytes"] == 2 * 2 * (pages + 1) * 16 \
            * 2 * d * 4
        prompt = np.arange(3, 40, dtype=np.int32) % 64
        steps = []
        real = port_lm.decode_step

        def capture(*args):
            steps.append(real(*args))
            return steps[-1]

        port_lm.decode_step = capture
        try:
            slot, tok0 = engine.admit(prompt, 4)
            toks = [tok0]
            while len(toks) < 4:
                toks.append(dict(engine.step())[slot])
            engine.release(slot)
        finally:
            del port_lm.decode_step
        want, _, _ = jax_lm.prefill(
            jax_params, np.append(prompt, tok0).astype(np.int32)[None])
        np.testing.assert_allclose(steps[0][slot].numpy(),
                                   np.asarray(want)[0, -1], atol=LM_ATOL)
        jax_engine = JaxDecodeEngine(jax_lm, params=jax_params,
                                     num_slots=2, page_size=16, max_len=256)
        jslot, jtok0 = jax_engine.admit(prompt, 4)
        want_toks = [jtok0]
        while len(want_toks) < 4:
            want_toks.append(dict(jax_engine.step())[jslot])
        assert toks == want_toks

    def test_reference_generate_token_exact(self, models):
        jax_lm, jax_params, port_lm, bridged = models
        prompt = np.array([3, 7, 1, 9, 2, 60], np.int32)
        want = jax_lm.reference_generate(jax_params, prompt, 5)
        got = port_lm.reference_generate(bridged, prompt, 5)
        assert list(got) == list(want)


def test_stock_config_streams_over_http_token_exact():
    """The slice as a whole on the CPU: a stock config (no ``http:``
    block) with a ``generation:`` block at head_dim 512 -> launch() ->
    HttpFrontend -> ``POST /generate`` -> GenerationWorker ->
    DecodeEngine -> PagedKVCache -> TinyGenLM. Each SSE stream carries
    the JAX package's reference_generate tokens."""
    kw = _kw(512)
    jax_lm = JaxLM(JaxGenModelConfig(**kw))
    jax_params = jax_lm.init_params()
    app = launch({"generation": {"model": dict(kw), "slots": 2,
                                 "page_size": 16, "max_len": 256}},
                 device="cpu")
    prompts = [list(range(1, 6)), [int(t) for t in
                                   np.arange(2, 150) % 64]]
    try:
        for prompt in prompts:
            req = urllib.request.Request(
                app.address + "/generate",
                data=json.dumps({"prompt": prompt,
                                 "max_tokens": 5}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.headers["Content-Type"] == "text/event-stream"
                events = [json.loads(line[len(b"data: "):])
                          for line in resp.read().split(b"\n\n") if line]
            data = events[1:]
            assert [e["seq"] for e in data] == list(range(len(data)))
            assert data[-1]["finish_reason"] == "length"
            toks = [t for e in data for t in e.get("token", [])]
            assert toks == [int(t) for t in jax_lm.reference_generate(
                jax_params, np.asarray(prompt, np.int32), 5)]
    finally:
        app.stop()
