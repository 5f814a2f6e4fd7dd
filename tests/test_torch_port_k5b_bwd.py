"""PyTorch port, K5b backward: the flash-attention gradient at head dims
that are not a multiple of 64 (the plain versions of K2 and K3, and
``FlashAttention``'s wiring), the gates, the launch counters, the
dispatch at head dims above 128, and BERT-SQuAD fine-tuning at such head
dims, held against the JAX package on the CPU.

The reference is the JAX package's einsum path (``_einsum_attention``
and its ``jax.grad``; ``dot_product_attention`` takes that path on the
CPU). On the TPU the JAX package trains at these head dims through JAX's
stock Pallas ``flash_attention`` (``ops/attention.py:116``), whose own
dQ and dK/dV kernels are the ones K5b's backward replaces; that kernel
has no CPU mode (``jax.experimental.pallas.ops.tpu.flash_attention``
takes no ``interpret``), so no test here runs it. The port follows the
einsum path at every row (``ops/attention.py``'s docstring). The CUDA
kernels are held against the plain versions on the card by
``chip_smoke.py``.

Inputs are made with numpy and fed to both packages, in f32. Gradients
agree to rtol 1e-5 and an atol of 2e-5 of each tensor's largest entry:
exact f32 arithmetic in another order, through the softmax backward's
``dP - delta``, which cancels (typically 3e-7 of the largest entry; once
1.2e-5 at D = 8 in a loaded run, where the libraries' thread splits
change the order of the sums).
The slice as a whole: a small ``BERTSQuAD`` (vocab 512, 2 blocks, 2
heads of 32 or of 40, intermediate 256, L 128, batch 8, no dropout) at
the JAX package's initial weights takes 3 Adam steps on padded batches
in both packages, the port's attention forced onto the "k5b" route
(``FlashAttention`` with the plain K5b backward); losses agree to rtol
1e-4 and parameters to atol 1e-4, as in the BERT-base slice.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.attention import (
    dot_product_attention as jax_dot_product_attention)
from analytics_zoo_tpu_torch.bridge import state_dict_from_flax
from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.ops import attention as port_attention
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from tests.test_torch_port_learn import SMALL as SQUAD_SMALL
from tests.test_torch_port_learn import fit_both
from tests.test_torch_port_masked import _empty_rows, _jax_einsum, _mask

torch.set_num_threads(2)

RTOL, ATOL_OF_MAX = 1e-5, 2e-5
# K5b's head dims under test: D = 8 (mod 16) and D = 0 (mod 16), small
# and up to the largest
HEAD_DIMS = [8, 16, 24, 32, 40, 80, 120]
# name -> (b, lq, lk, causal, mask kind or None); lq == lk everywhere:
# the reference takes the stock kernel causal only there
KINDS = {
    "none": (2, 128, 128, False, None),
    "causal": (2, 128, 128, True, None),
    "prefix": (3, 128, 128, False, "prefix"),
    # left padding under causal: each short row's first rows see no key
    "causal_left": (3, 128, 128, True, "left"),
    "all_zero_row": (3, 128, 128, False, "all_zero_row"),
}


def _case(kind, d, seed):
    b, lq, lk, causal, mask_kind = KINDS[kind]
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(b, 2, n, d).astype(np.float32)
                  for n in (lq, lk, lk, lq))
    m = None if mask_kind is None else _mask(mask_kind, b, lk, seed + 1)
    return q, k, v, g, m, causal


@functools.lru_cache(maxsize=None)
def _jax_grads(kind, d):
    """(q, k, v, g, mask, causal) and ``jax.grad`` of the einsum path."""
    q, k, v, g, m, causal = _case(kind, d, seed=d)
    ones = np.ones((q.shape[0], k.shape[2]), np.int32)
    jg = jnp.asarray(g)

    def f(q_, k_, v_):
        return jnp.sum(_jax_einsum(q_, k_, v_, ones if m is None else m,
                                   causal) * jg)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    return (q, k, v, g, m, causal), [np.asarray(w) for w in want]


class TestPlainBackward:
    @pytest.mark.parametrize("fn", ["reference", "autograd"])
    @pytest.mark.parametrize("kind", sorted(KINDS))
    @pytest.mark.parametrize("d", HEAD_DIMS)
    def test_matches_jax_grad_of_einsum_path(self, d, kind, fn):
        """``flash_attention_bwd_reference`` on the plain forward's out and
        lse, and ``FlashAttention``'s CPU wiring (the dQ half, then the
        dK/dV half on its delta), against ``jax.grad``."""
        (q, k, v, g, m, causal), want = _jax_grads(kind, d)
        tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
        tm = None if m is None else torch.from_numpy(m)
        if fn == "reference":
            o, lse = fa.flash_attention_reference(tq, tk, tv, causal, None,
                                                  True, tm)
            got = fa.flash_attention_bwd_reference(tq, tk, tv, o, lse, tg,
                                                   causal,
                                                   key_padding_mask=tm)
        else:
            for t in (tq, tk, tv):
                t.requires_grad_()
            out = fa.flash_attention(tq, tk, tv, causal,
                                     key_padding_mask=tm)
            assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
            got = torch.autograd.grad(out, (tq, tk, tv), tg)
        for label, a, b in zip(("dq", "dk", "dv"), got, want):
            assert a.shape == b.shape and torch.isfinite(a).all(), label
            np.testing.assert_allclose(
                a.numpy(), b, rtol=RTOL, atol=ATOL_OF_MAX * np.abs(b).max(),
                err_msg=label)

    @pytest.mark.parametrize("d", [24, 40])
    def test_rows_without_a_key_give_no_dq(self, d):
        """At D = 8 (mod 16) too: rows that see no key give no dQ, padded
        keys get exactly zero dK."""
        (q, k, v, g, m, causal), _ = _jax_grads("causal_left", d)
        tq, tk, tv, tg, tm = (torch.from_numpy(a) for a in (q, k, v, g, m))
        o, lse = fa.flash_attention_reference(tq, tk, tv, causal, None,
                                              True, tm)
        dq, dk, _ = fa.flash_attention_bwd_reference(
            tq, tk, tv, o, lse, tg, causal, key_padding_mask=tm)
        empty = torch.from_numpy(_empty_rows(m, q.shape[2], causal))
        assert empty.any()
        assert torch.count_nonzero(
            dq[empty[:, None, :, None].expand_as(dq)]) == 0
        pad = torch.from_numpy(m == 0)[:, None, :, None].expand_as(dk)
        assert torch.count_nonzero(dk[pad]) == 0


class TestGates:
    @pytest.mark.parametrize("d", range(8, 129, 8))
    def test_every_multiple_of_8_has_a_kernel(self, d):
        """One gate for both directions: K1-K3 at 64 and 128, K5b at the
        other multiples of 8 up to 128."""
        fa._check_head_dim(d)

    @pytest.mark.parametrize("d", [20, 100])
    def test_other_head_dims_raise(self, d):
        with pytest.raises(NotImplementedError, match="multiples of 8"):
            fa._check_head_dim(d)


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA branch on meta tensors: each entry point is a
    spy that records (name, arguments) and returns 0 (launched); the
    input checks keep only the head-dim gate (meta is not CUDA)."""
    calls = []

    def entry(name):
        return lambda *args: calls.append((name, args)) or 0

    def check_inputs(q, k, v, causal, mask=None, **more):
        fa._check_head_dim(q.shape[-1])

    monkeypatch.setattr(fa, "_entry", entry)
    monkeypatch.setattr(fa, "_check_inputs", check_inputs)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    for w in (fa.flash_attention, fa.flash_attention_bwd_dq,
              fa.flash_attention_bwd_dkv):
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "masked_launches", 0)
        monkeypatch.setattr(w, "small_d_launches", 0)
    return calls


# where each entry point takes its head dim and its mask pointer
D_ARG = {"zoo_flash_attn_fwd": 10, "zoo_flash_attn_bwd_dq": 13,
         "zoo_flash_attn_bwd_dkv": 13}
MASK_ARG = {"zoo_flash_attn_fwd": 23, "zoo_flash_attn_bwd_dq": 32,
            "zoo_flash_attn_bwd_dkv": 32}


class TestLaunches:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("d", [16, 32, 80])
    def test_gradient_runs_k1_lse_k2_k3_counted_as_k5b(self, fake_card, d,
                                                       masked):
        """Off the CPU, ``FlashAttention`` at a K5b head dim launches
        K1-lse, then K2, then K3 at that head dim (with the mask, when
        given), and each wrapper counts its launch in ``launches``,
        ``masked_launches`` and ``small_d_launches``."""
        q, k, v = (torch.empty(2, 2, 128, d, device="meta",
                               requires_grad=True) for _ in range(3))
        m = torch.ones(2, 128, dtype=torch.uint8, device="meta") \
            if masked else None
        out = fa.flash_attention(q, k, v, True, key_padding_mask=m)
        torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
        assert [name for name, _ in fake_card] == [
            "zoo_flash_attn_fwd", "zoo_flash_attn_bwd_dq",
            "zoo_flash_attn_bwd_dkv"]
        for name, args in fake_card:
            assert args[D_ARG[name]] == d, name
            assert (args[MASK_ARG[name]] is not None) == masked, name
        for w in (fa.flash_attention, fa.flash_attention_bwd_dq,
                  fa.flash_attention_bwd_dkv):
            assert (w.launches, w.masked_launches, w.small_d_launches) == (
                1, int(masked), 1)

    @pytest.mark.parametrize("d", [64, 128])
    def test_k1_k3_head_dims_are_not_k5b(self, fake_card, d):
        q = torch.empty(1, 2, 128, d, device="meta", requires_grad=True)
        out = fa.flash_attention(q, q, q)
        torch.autograd.grad(out, q, torch.empty_like(out))
        assert len(fake_card) == 3
        for w in (fa.flash_attention, fa.flash_attention_bwd_dq,
                  fa.flash_attention_bwd_dkv):
            assert (w.launches, w.small_d_launches) == (1, 0)


class TestHeadDimsAbove128:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("d", [192, 256])
    def test_dispatch_takes_einsum_path(self, monkeypatch, d, causal,
                                        masked):
        """The route as on the card (``on_cuda`` forced true) sends D in
        {192, 256} to the einsum path, whose values match the JAX
        package's ``dot_product_attention``."""
        real = port_attention._flash_route
        monkeypatch.setattr(port_attention, "_flash_route",
                            lambda impl, on_cuda, *a: real(impl, True, *a))
        monkeypatch.setattr(fa, "flash_attention", None)  # never reached
        rng = np.random.RandomState(d + causal)
        q, k, v = (rng.randn(2, 2, 128, d).astype(np.float32)
                   for _ in range(3))
        m = _mask("prefix", 2, 128, seed=d) if masked else None
        want = jax_dot_product_attention(
            *map(jnp.asarray, (q, k, v)),
            key_padding_mask=None if m is None else jnp.asarray(m),
            causal=causal)
        get_config().set("zoo.ops.attention_impl", "flash")
        try:
            got = port_attention.dot_product_attention(
                *(torch.from_numpy(a) for a in (q, k, v)),
                key_padding_mask=None if m is None else torch.from_numpy(m),
                causal=causal)
        finally:
            get_config().unset("zoo.ops.attention_impl")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ------------------------------------------------------ BERT-SQuAD slice --
SEQ, N = 128, 24


def _padded_squad_data(n, seed):
    """Random token ids with per-row real lengths in [2, SEQ] (one full
    row, one of 2), the attention mask, and (start, end) spans inside the
    real part."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(2, SEQ + 1, n)
    lens[0], lens[1] = SEQ, 2
    mask = (np.arange(SEQ)[None, :] < lens[:, None]).astype(np.int32)
    ids = rng.randint(1, SQUAD_SMALL["vocab"], (n, SEQ)).astype(
        np.int32) * mask
    start = rng.randint(0, lens)
    end = np.minimum(start + rng.randint(0, 8, n), lens - 1)
    y = np.stack([start, end], axis=1).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask}, y


@pytest.fixture(scope="module", params=[(64, 2), (80, 2)],
                ids=["d32", "d40"])
def k5b_fit(request):
    """Both packages fit 3 Adam steps on 24 padded samples (batch 8) at a
    K5b head dim (hidden / heads = 32, and 40 for D = 8 mod 16); the
    port's attention takes the "k5b" route, and each backward through
    ``FlashAttention`` is recorded."""
    hidden, heads = request.param
    cfg = dict(SQUAD_SMALL, hidden_size=hidden, n_head=heads)
    seen = []
    bwd = fa.flash_attention_bwd

    def spy(q, k, v, o, lse, do, causal=False, scale=None,
            key_padding_mask=None):
        seen.append((q.shape[-1], key_padding_mask is not None))
        return bwd(q, k, v, o, lse, do, causal, scale, key_padding_mask)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "_flash_route", lambda *a: "k5b")
        mp.setattr(fa, "flash_attention_bwd", spy)
        fit = fit_both(cfg, *_padded_squad_data(N, 5))
    return dict(fit, backward_calls=seen, head_dim=hidden // heads,
                n_block=cfg["n_block"])


class TestBERTSQuADK5bSlice:
    def test_backward_took_the_k5b_route(self, k5b_fit):
        steps = len(k5b_fit["port_losses"])
        assert steps == 3
        assert k5b_fit["backward_calls"] == [
            (k5b_fit["head_dim"], True)] * (steps * k5b_fit["n_block"])

    def test_step_losses_match(self, k5b_fit):
        np.testing.assert_allclose(k5b_fit["port_losses"],
                                   k5b_fit["ref_losses"], rtol=1e-4)
        np.testing.assert_allclose(k5b_fit["port_hist"][0]["loss"],
                                   k5b_fit["ref_hist"][0]["loss"],
                                   rtol=1e-4)

    def test_parameters_after_three_steps_match(self, k5b_fit):
        want = state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, k5b_fit["ref"].estimator.variables))
        start = state_dict_from_flax(k5b_fit["tree"])
        got = k5b_fit["port"].module.state_dict()
        moved = 0
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-4,
                                       err_msg=k)
            moved += int(not np.allclose(v.numpy(), start[k]))
        assert moved > len(want) // 2
