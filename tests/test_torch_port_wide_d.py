"""PyTorch port, head dims the kernels take only by width or by padding:
K1 at D in {192, 256} (the reference's Pallas kernel at D % 64 == 0
above 128; K2 and K3 there in ``test_torch_port_wide_bwd.py``), the
dispatch's route to it, TinyGenLM at head_dim 256 (the
generation plane at Gemma-2B's head dim), and head dims that are not a
multiple of 8, which the wrappers zero-pad (fault 5).

The JAX kernel runs in Pallas interpret mode, and the JAX package's
einsum path and TinyGenLM on the CPU; inputs are made with numpy and fed
to both packages. Where a test stands in for the card, the route is
asked with ``on_cuda`` forced true, or the wrappers' CUDA branch runs on
meta tensors with spies for the entry points (``fake_card``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.attention import (
    dot_product_attention as jax_dot_product_attention)
from analytics_zoo_tpu.ops.pallas_attention import _flash_fwd
from analytics_zoo_tpu.serving.generation.model import (
    GenModelConfig as JaxGenModelConfig)
from analytics_zoo_tpu.serving.generation.model import TinyGenLM as JaxLM
from analytics_zoo_tpu_torch.bridge import gen_params_from_tree
from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.ops import attention as port_attention
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from analytics_zoo_tpu_torch.serving.generation import (
    GenModelConfig, TinyGenLM)
from analytics_zoo_tpu_torch.serving.launcher import launch
from tests.test_torch_port_generation import _drain_stream
from tests.test_torch_port_k5b_bwd import D_ARG, fake_card  # noqa: F401
from tests.test_torch_port_masked import _mask

torch.set_num_threads(2)

# f32 on both sides: the tolerances test_torch_port_attention.py holds
# K1's plain version to against the Pallas kernel (out; lse, whose
# magnitude ~10 leaves a few 1e-6 from the order of f32 sums)
ATOL, LSE_ATOL = 2e-5, 1e-5
# bf16 on both sides: the Pallas kernel rounds P to bf16 before P V, the
# plain version keeps it in f32; both round the output (2^-7 relative)
BF16_TOL = 2e-2


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


# ------------------------------------------------------------ K1 at 192+ --
class TestWideReference:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("causal,lq,lk", [(False, 128, 128),
                                              (True, 128, 128),
                                              (False, 128, 256),
                                              (True, 128, 256)])
    @pytest.mark.parametrize("d", [192, 256])
    def test_matches_pallas_kernel(self, d, causal, lq, lk, dtype):
        """K1's plain version (what the CUDA kernel is held to on the
        card) against ``_flash_fwd`` with its logsumexp."""
        q, k, v = _qkv(d + lk + causal, 1, 2, lq, lk, d)
        scale = 1.0 / np.sqrt(d)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        out, lse = _flash_fwd(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                              causal, scale, None, None, with_lse=True)
        got, got_lse = fa.flash_attention(
            *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
            causal=causal, with_lse=True)
        assert got.dtype == tdt and got.shape == (1, 2, lq, d)
        assert got_lse.shape == (2, lq) and got_lse.dtype == torch.float32
        want = np.asarray(out.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
            np.testing.assert_allclose(got_lse.numpy(),
                                       np.asarray(lse)[..., 0],
                                       atol=LSE_ATOL)
        else:
            np.testing.assert_allclose(got.float().numpy(), want,
                                       atol=BF16_TOL, rtol=BF16_TOL)
            np.testing.assert_allclose(got_lse.numpy(),
                                       np.asarray(lse)[..., 0], atol=1e-3)


class TestWideRoute:
    BASE = dict(impl="flash", on_cuda=True, l=256, lk=256, causal=True,
                has_mask=False, dropout_rate=0.0)

    @pytest.mark.parametrize("needs_grad", [False, True])
    @pytest.mark.parametrize("key_padding", [False, True])
    @pytest.mark.parametrize("d", [192, 256, 320])
    def test_route(self, d, key_padding, needs_grad):
        """The kernels at 192, 256 and 320 for an unmasked call, with or
        without a gradient (K1, or K1-lse, K2 and K3); the einsum path
        with a key-padding mask (the reference's stock-kernel branch stops
        at 128)."""
        got = port_attention._flash_route(
            **self.BASE, d=d, has_key_padding_mask=key_padding,
            needs_grad=needs_grad)
        assert got == (None if key_padding else "kernels")

    def test_gates(self):
        for d in (192, 256):
            fa._check_head_dim(d)
            fa._check_head_dim(d, backward=True)
            with pytest.raises(NotImplementedError, match="masked"):
                fa._check_head_dim(d, masked=True)
        for d in (136, 320, 512, 576):
            if d in (320, 512):
                fa._check_head_dim(d)  # K1, and K1-lse, K2 and K3
                fa._check_head_dim(d, backward=True)
                continue
            with pytest.raises(NotImplementedError, match="192 and 256"):
                fa._check_head_dim(d)
            with pytest.raises(NotImplementedError, match="still to port"):
                fa._check_head_dim(d, backward=True)


def _forced_card(monkeypatch):
    """The dispatch as on the card: the route's ``on_cuda`` forced true,
    ``flash_attention`` a spy that records each call and returns the
    plain version's values."""
    calls = []
    real = port_attention._flash_route

    def spy(q, k, v, causal=False, scale=None, with_lse=False,
            key_padding_mask=None):
        calls.append((tuple(q.shape), causal, q.requires_grad))
        return fa.flash_attention_reference(q, k, v, causal, scale)

    monkeypatch.setattr(port_attention, "_flash_route",
                        lambda impl, on_cuda, *a: real(impl, True, *a))
    monkeypatch.setattr(fa, "flash_attention", spy)
    get_config().set("zoo.ops.attention_impl", "flash")
    return calls


class TestWideDispatch:
    @pytest.mark.parametrize("grad", [False, True])
    def test_no_grad_reaches_k1_grad_takes_einsum(self, monkeypatch,
                                                  fake_card, grad):
        """The dispatch as on the card at D = 256, causal. Without a
        gradient the call reaches ``flash_attention`` (K1). Under autograd
        it no longer takes the einsum path, as it did before K2 and K3
        were built at 256: on the card (meta tensors, spied entry points)
        it launches K1-lse, K2 and K3, each counted in
        ``wide_d_launches``, and on the CPU the same wiring gives the JAX
        package's output and gradients."""
        q, k, v = _qkv(7, 1, 2, 128, 128, 256)
        want, *want_grads = _jax_einsum_grads(
            q, k, v, np.ones_like(q), None, True)
        if not grad:
            calls = _forced_card(monkeypatch)
        else:
            real = port_attention._flash_route
            monkeypatch.setattr(port_attention, "_flash_route",
                                lambda impl, on_cuda, *a: real(impl, True,
                                                               *a))
            get_config().set("zoo.ops.attention_impl", "flash")
            for w in (fa.flash_attention, fa.flash_attention_bwd_dq,
                      fa.flash_attention_bwd_dkv):
                monkeypatch.setattr(w, "wide_d_launches", 0)
        tensors = [torch.from_numpy(a).requires_grad_(grad)
                   for a in (q, k, v)]
        try:
            got = port_attention.dot_product_attention(*tensors, causal=True)
            if grad:
                grads = torch.autograd.grad(got, tensors,
                                            torch.ones_like(got))
                meta = [torch.empty(1, 2, 128, 256, device="meta",
                                    requires_grad=True) for _ in range(3)]
                out = port_attention.dot_product_attention(*meta,
                                                           causal=True)
                torch.autograd.grad(out, meta, torch.empty_like(out))
        finally:
            get_config().unset("zoo.ops.attention_impl")
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL)
        if not grad:
            assert calls == [((1, 2, 128, 256), True, False)]
            return
        for g, w in zip(grads, want_grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
        assert [(name, args[D_ARG[name]]) for name, args in fake_card] == [
            ("zoo_flash_attn_fwd_f32tc", 256),
            ("zoo_flash_attn_bwd_dq_f32tc", 256),
            ("zoo_flash_attn_bwd_dkv_f32tc", 256)]
        for w in (fa.flash_attention, fa.flash_attention_bwd_dq,
                  fa.flash_attention_bwd_dkv):
            assert (w.launches, w.wide_d_launches) == (1, 1)


# --------------------------------------------------- TinyGenLM at D = 256 --
WIDE_KW = dict(vocab=32, dim=64, heads=2, head_dim=256, layers=2,
               max_len=128, mlp_ratio=2, seed=0)


@pytest.fixture(scope="module")
def wide_models():
    """The JAX package's TinyGenLM at head_dim 256 and the port's over
    the same weights (carried by ``gen_params_from_tree``)."""
    jax_lm = JaxLM(JaxGenModelConfig(**WIDE_KW))
    jax_params = jax_lm.init_params()
    port_lm = TinyGenLM(GenModelConfig(**WIDE_KW))
    bridged = gen_params_from_tree(
        jax.tree_util.tree_map(np.asarray, jax_params), device="cpu")
    return jax_lm, jax_params, port_lm, bridged


class TestWideTinyGenLM:
    @pytest.mark.parametrize("length", [7, 128])
    def test_prefill_matches(self, wide_models, length):
        jax_lm, jax_params, port_lm, bridged = wide_models
        toks = np.random.RandomState(length).randint(
            0, WIDE_KW["vocab"], (1, length)).astype(np.int32)
        want = jax_lm.prefill(jax_params, toks)
        with torch.inference_mode():
            got = port_lm.prefill(bridged, torch.from_numpy(toks))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)

    def test_prefill_bucket_goes_through_k1(self, monkeypatch, wide_models):
        """A prefill bucket of 128 tokens, as on the card (no autograd,
        causal at lq == lk): every layer's attention is one
        ``flash_attention`` call at D = 256, and the logits are the JAX
        package's."""
        jax_lm, jax_params, port_lm, bridged = wide_models
        calls = _forced_card(monkeypatch)
        toks = np.random.RandomState(3).randint(
            0, WIDE_KW["vocab"], (1, 128)).astype(np.int32)
        try:
            with torch.inference_mode():
                logits, _, _ = port_lm.prefill(bridged,
                                               torch.from_numpy(toks))
        finally:
            get_config().unset("zoo.ops.attention_impl")
        assert calls == [((1, 2, 128, 256), True, False)] * 2
        want, _, _ = jax_lm.prefill(jax_params, toks)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                                   atol=1e-4)

    def test_pool_and_engine_at_head_dim_256(self, wide_models):
        """The KV pool is sized from the config's head dim: a page holds
        16 positions x 2 heads x 256 dims x 4 bytes a layer for K and as
        much for V (one extra trash page), and a decode step over the
        pool gives the JAX package's engine's tokens."""
        from analytics_zoo_tpu.serving.generation.engine import (
            DecodeEngine as JaxDecodeEngine)
        from analytics_zoo_tpu_torch.serving.generation import DecodeEngine

        jax_lm, jax_params, port_lm, bridged = wide_models
        engine = DecodeEngine(port_lm, params=bridged, num_slots=2,
                              page_size=16, max_len=128, device="cpu")
        pages = engine.cache.num_pages
        assert engine.cache.kv.shape[-2:] == (2, 256)
        assert engine.cache.stats()["bytes"] == (
            WIDE_KW["layers"] * 2 * (pages + 1) * 16 * 2 * 256 * 4)
        jax_engine = JaxDecodeEngine(jax_lm, params=jax_params, num_slots=2,
                                     page_size=16, max_len=128)
        prompt = np.arange(3, 40, dtype=np.int32) % 32
        toks = {}
        for name, eng in (("port", engine), ("jax", jax_engine)):
            slot, tok0 = eng.admit(prompt, 4)
            toks[name] = [tok0]
            while len(toks[name]) < 4:
                toks[name].append(dict(eng.step())[slot])
            eng.release(slot)
        assert toks["port"] == toks["jax"]

    def test_reference_generate_token_exact(self, wide_models):
        jax_lm, jax_params, port_lm, bridged = wide_models
        prompt = np.array([3, 7, 1, 9, 2, 30], np.int32)
        want = jax_lm.reference_generate(jax_params, prompt, 5)
        got = port_lm.reference_generate(bridged, prompt, 5)
        assert list(got) == list(want)

    def test_launch_streams_token_exact(self, wide_models):
        """launch() with a generation: block at head_dim 256 answers each
        stream once with the JAX package's reference_generate tokens."""
        jax_lm, jax_params, _, _ = wide_models
        app = launch({"generation": {"model": dict(WIDE_KW), "slots": 2,
                                     "page_size": 16, "max_len": 128},
                      "http": {"enabled": False}}, device="cpu")
        prompts = {"w0": np.arange(1, 6, dtype=np.int32),
                   "w1": np.arange(2, 20, dtype=np.int32) % 32}
        try:
            for uri, p in prompts.items():
                assert app.gen_input_queue.enqueue_generation(
                    uri, p, max_tokens=5)
            got = _drain_stream(app.output_queue, list(prompts), 60.0)
            assert app.drain(deadline_ms=10000) is True
        finally:
            app.stop()
        for uri, rec in got.items():
            assert rec["seqs"] == list(range(5))
            assert rec["toks"] == [int(t) for t in jax_lm.reference_generate(
                jax_params, prompts[uri], 5)]


# ------------------------------------------- padded head dims (fault 5) --
def _jax_einsum_grads(q, k, v, do, m, causal):
    def f(q, k, v):
        return jax_dot_product_attention(
            q, k, v, key_padding_mask=None if m is None else jnp.asarray(m),
            causal=causal)

    out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return (out, *vjp(jnp.asarray(do)))


class TestPaddedHeadDims:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("d", [12, 20])
    def test_forward_and_backward_match_einsum(self, d, causal, masked):
        """``FlashAttention`` pads Q, K, V to the next multiple of 8 (on
        the CPU too, so this is the wiring the card runs), keeps the
        scale of the true D and cuts O, dQ, dK, dV back: the JAX einsum
        path's output and gradients."""
        q, k, v = _qkv(d + 2 * causal + masked, 2, 2, 128, 128, d)
        do = np.random.RandomState(d).randn(*q.shape).astype(np.float32)
        m = _mask("prefix", 2, 128, seed=d) if masked else None
        want = _jax_einsum_grads(q, k, v, do, m, causal)
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out = fa.flash_attention(
            tq, tk, tv, causal,
            key_padding_mask=None if m is None else torch.from_numpy(m))
        got = (out, *torch.autograd.grad(out, (tq, tk, tv),
                                         torch.from_numpy(do)))
        for a, b in zip(got, want):
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=1e-5, rtol=1e-5)

    def test_route_keeps_the_stock_kernel_branch(self):
        assert port_attention._flash_route(
            "flash", True, 256, 256, 20, True, False, 0.0) == "k5b"
        assert fa._kernel_head_dim(20) == 24
        assert fa._kernel_head_dim(100) == 104
        assert fa._kernel_head_dim(128) == 128
        assert fa._kernel_head_dim(256) == 256

    @pytest.mark.parametrize("d", [12, 20, 100])
    def test_card_launches_at_the_padded_dim(self, fake_card, d):
        """On the card (meta tensors, spied entry points) K1-lse, K2 and
        K3 (f32: the f32 tensor-core entries) launch at the next multiple
        of 8, count as K5b, and hand back the caller's head dim."""
        q, k, v = (torch.empty(1, 2, 128, d, device="meta",
                               requires_grad=True) for _ in range(3))
        out = fa.flash_attention(q, k, v, True)
        grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
        assert out.shape == (1, 2, 128, d)
        assert all(g.shape == (1, 2, 128, d) for g in grads)
        padded = -(-d // 8) * 8
        assert [(name, args[D_ARG[name]]) for name, args in fake_card] == [
            ("zoo_flash_attn_fwd_f32tc", padded),
            ("zoo_flash_attn_bwd_dq_f32tc", padded),
            ("zoo_flash_attn_bwd_dkv_f32tc", padded)]
        # the true D's scale (the argument after the mask's two)
        for name, args in fake_card:
            assert args[D_ARG[name] + {"zoo_flash_attn_fwd_f32tc": 15}.get(
                name, 21)] == pytest.approx(1 / np.sqrt(d))
        for w in (fa.flash_attention, fa.flash_attention_bwd_dq,
                  fa.flash_attention_bwd_dkv):
            assert (w.launches, w.small_d_launches) == (1, 1)

    def test_card_counts_wide_launches(self, fake_card, monkeypatch):
        monkeypatch.setattr(fa.flash_attention, "wide_d_launches", 0)
        q = torch.empty(1, 2, 128, 256, device="meta")
        out = fa.flash_attention(q, q, q, True)
        assert out.shape == q.shape
        assert [args[D_ARG[name]] for name, args in fake_card] == [256]
        assert (fa.flash_attention.launches,
                fa.flash_attention.small_d_launches,
                fa.flash_attention.wide_d_launches) == (1, 0, 1)
