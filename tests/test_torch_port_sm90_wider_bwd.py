"""PyTorch port, K2's and K3's Hopper kernels at head dims 320 to 512
(``csrc/flash_attn_bwd_sm90.cu``'s split templates,
``flash_bwd_dq_sm90_split_kernel`` and ``flash_bwd_dkv_sm90_split_kernel``):
the route that sends every bf16 backward call to the Hopper entries, 320
to 512 among them, and every f32 one to the f32 tensor-core entries
(``_bwd_entry``); what the wrappers hand those entries at 320 to 512 (the
head dim, the scale, the causal flag) and count (``sm90_launches``,
``wide_d_launches``); a masked call there raising before a launch (the
reference takes its einsum path for it); the retirement of the
``mma.sync`` split templates; and K2's and K3's plain versions (what the
kernels are held to on the card by ``chip_smoke.py``) against ``jax.grad``
of the JAX package's einsum path at D = 320 and 512, at the shapes the
split templates must get right: Lq = 192 (three of K2's 64-row q blocks,
six of K3's 32-row q tiles), causal Lq < Lk (the bottom-right diagonal;
K3's first q tile starts mid-diagonal), Lk = 320 (five of K3's 64-key
blocks, which end half-way through a 128-key block), and q, k and v as
views into one fused projection.

The reference is the einsum path (``_einsum_attention`` and its
``jax.grad``), which the reference's Pallas backward computes at these
head dims. The plain versions read the plain forward's out and
logsumexp, as the kernels read K1's. The CUDA kernels themselves cannot
run here (no card, no nvcc): where a test stands in for the card, the
wrappers' CUDA branch runs on meta tensors with spies for the entry
points (``fake_card``). Inputs are made with numpy from a seed and fed
to both packages.

Tolerances: in f32 rtol 1e-5 and an atol of 2e-5 of each tensor's
largest entry (exact arithmetic in another order, through the softmax
backward's ``dP - delta``, which cancels); in bf16 2e-2 * (1 + |ref|),
``chip_smoke.py``'s bf16 tolerance (the plain version rounds dS and P to
bf16 before their products, the einsum path's gradient rounds
elsewhere, and both round the gradients: 2^-7 relative).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.attention import _einsum_attention
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from tests.test_torch_port_k5b_bwd import fake_card  # noqa: F401

torch.set_num_threads(2)

DQ, DKV = "zoo_flash_attn_bwd_dq_sm90", "zoo_flash_attn_bwd_dkv_sm90"
F32TC_DQ, F32TC_DKV = ("zoo_flash_attn_bwd_dq_f32tc",
                       "zoo_flash_attn_bwd_dkv_f32tc")
FWD_SM90 = "zoo_flash_attn_fwd_sm90"
WIDER = (320, 384, 448, 512)
# where the backward entries take each argument
D_ARG, MASK_ARG, SCALE_ARG, CAUSAL_ARG = 13, 32, 34, 35
BF16 = torch.bfloat16
RTOL, ATOL_OF_MAX = 1e-5, 2e-5
BF16_TOL = 2e-2
CSRC = fa._CSRC
WRAPPERS = (fa.flash_attention, fa.flash_attention_bwd_dq,
            fa.flash_attention_bwd_dkv)


class TestRoute:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", WIDER)
    def test_every_bf16_call_takes_the_hopper_entries(self, d, dtype,
                                                      masked):
        """At 320 to 512 bf16 takes ``flash_attn_bwd_sm90.cu``'s K2 and K3
        and f32 ``flash_attn_bwd_f32tc.cu``'s, with a mask or without (a
        mask only up to 128, which ``_check_inputs`` enforces; every other
        head dim: ``tests/test_torch_port_sm90_bwd.py``)."""
        assert d in fa.SM90_HEAD_DIMS
        want = (DQ, DKV) if dtype == BF16 else (F32TC_DQ, F32TC_DKV)
        assert fa._bwd_entry(dtype) == want

    def test_retired_entries_and_sources_are_gone(self):
        """The ``mma.sync`` split templates' entries and sources are
        retired: four backward entries remain, two a source."""
        assert set(fa._ENTRY_POINTS) == {
            FWD_SM90, "zoo_flash_attn_fwd_f32tc", DQ, DKV, F32TC_DQ,
            F32TC_DKV}
        for name in ("flash_attn_bwd.cuh", "flash_attn_bwd_dq.cu",
                     "flash_attn_bwd_dkv.cu"):
            assert not (CSRC / name).exists()
        assert {fa._ENTRY_POINTS[n][0] for n in (DQ, DKV)} == {
            "flash_attn_bwd_sm90"}

    def test_split_templates_are_in_the_hopper_source(self):
        """The Hopper source instantiates K2's and K3's split templates at
        each of 320, 384, 448 and 512, and the f32 source no longer
        includes the retired header."""
        sm90 = (CSRC / "flash_attn_bwd_sm90.cu").read_text()
        for kernel in ("flash_bwd_dq_sm90_split_kernel",
                       "flash_bwd_dkv_sm90_split_kernel"):
            assert f"{kernel}<D>" in sm90
        for d in WIDER:
            assert f"DqSplitCfg<{d}>" in sm90
            assert f"DkvSplitCfg<{d}>" in sm90
        f32tc = (CSRC / "flash_attn_bwd_f32tc.cu").read_text()
        assert '#include "flash_attn_bwd.cuh"' not in f32tc


def _meta(d, b=2, h=3, lq=192, lk=320, grad=False):
    return [torch.empty(b, h, n, d, device="meta", dtype=BF16,
                        requires_grad=grad) for n in (lq, lk, lk, lq)]


def _lse(b=2, h=3, lq=192):
    return torch.empty(b * h, lq, device="meta", dtype=torch.float32)


@pytest.fixture
def counts(monkeypatch, fake_card):
    for w in WRAPPERS:
        monkeypatch.setattr(w, "sm90_launches", 0)
        monkeypatch.setattr(w, "wide_d_launches", 0)
    return fake_card


class TestLaunches:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("d", WIDER)
    def test_bf16_call_reaches_the_hopper_entries(self, counts, d, causal):
        """Off the CPU (meta tensors, spied entry points) a bf16 backward
        at 320 to 512 launches K2's and K3's Hopper kernels once each,
        with the head dim, the lengths, the scale, the causal flag and a
        null mask, and counts in ``launches``, ``sm90_launches`` and
        ``wide_d_launches``."""
        q, k, v, do = _meta(d)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, q, _lse(), do, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, _lse(), delta, do,
                                            causal)
        assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
        assert dq.dtype == dk.dtype == dv.dtype == BF16
        assert delta.shape == (6, 192) and delta.dtype == torch.float32
        assert [name for name, _ in counts] == [DQ, DKV]
        for name, args in counts:
            assert len(args) == len(fa._ENTRY_POINTS[name][1])
            assert args[D_ARG] == d
            assert args[11:13] == (192, 320)  # lq, lk
            assert args[MASK_ARG] is None
            assert args[SCALE_ARG] == pytest.approx(1 / np.sqrt(d))
            assert args[CAUSAL_ARG] == int(causal)
        for w in WRAPPERS[1:]:
            assert (w.launches, w.masked_launches, w.sm90_launches,
                    w.small_d_launches, w.wide_d_launches) == (1, 0, 1, 0, 1)

    @pytest.mark.parametrize("d", [320, 512])
    def test_gradient_runs_hopper_k1_lse_k2_k3(self, counts, d):
        """Under ``FlashAttention`` a bf16 call at 320 to 512 runs K1-lse,
        K2 and K3 on the Hopper kernels, in that order, each counted in
        ``sm90_launches`` and ``wide_d_launches``."""
        q, k, v, _ = _meta(d, lq=320, grad=True)
        out = fa.flash_attention(q, k, v, True, 0.05)
        grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
        assert all(g.shape == q.shape for g in grads)
        assert [name for name, _ in counts] == [FWD_SM90, DQ, DKV]
        assert [args[SCALE_ARG] for _, args in counts[1:]] == [
            pytest.approx(0.05)] * 2
        assert [w.sm90_launches for w in WRAPPERS] == [1, 1, 1]
        assert [w.wide_d_launches for w in WRAPPERS] == [1, 1, 1]

    @pytest.mark.parametrize("d", WIDER)
    def test_masked_call_raises_before_a_launch(self, counts, d):
        """No kernel takes a key-padding mask above 128 (the reference's
        dispatch sends such a call to its einsum path, and so does the
        port's): K2 and K3 raise before either entry is reached."""
        q, k, v, do = _meta(d)
        m = torch.ones(2, 320, dtype=torch.uint8, device="meta")
        with pytest.raises(NotImplementedError, match="masked"):
            fa.flash_attention_bwd_dq(q, k, v, q, _lse(), do, True,
                                      key_padding_mask=m)
        with pytest.raises(NotImplementedError, match="masked"):
            fa.flash_attention_bwd_dkv(q, k, v, _lse(), _lse(), do, True,
                                       key_padding_mask=m)
        assert counts == []
        assert all(w.launches == 0 for w in WRAPPERS)


# name -> (b, h, lq, lk, d, causal, views)
CASES = {
    # three 64-row q blocks (K2), six 32-row q tiles (K3)
    "d320_odd_blocks": (1, 2, 192, 192, 320, False, False),
    "d512_odd_blocks_causal": (1, 2, 192, 192, 512, True, False),
    # causal Lq < Lk with Lk = 320: five 64-key blocks, K3's first q tile
    # mid-diagonal
    "d320_cross_causal": (1, 2, 64, 320, 320, True, False),
    "d512_lk320_causal": (1, 2, 192, 320, 512, True, False),
    # q, k and v as views into one fused projection, dO laid out as the
    # attention output
    "d512_views": (2, 2, 128, 128, 512, False, True),
}


def _case(name):
    b, h, lq, lk, d, causal, views = CASES[name]
    rng = np.random.RandomState(lq + lk + d)
    # not symmetric: q, k, v and dO differ in scale and offset
    q = 1.5 * rng.randn(b, h, lq, d).astype(np.float32)
    k = rng.randn(b, h, lk, d).astype(np.float32)
    v = rng.randn(b, h, lk, d).astype(np.float32) + 0.25
    g = 0.5 * rng.randn(b, h, lq, d).astype(np.float32)
    return q, k, v, g, causal, views


@functools.lru_cache(maxsize=None)
def _jax_grads(name, dtype):
    """``jax.grad`` of the einsum path's sum(out * dO) in ``dtype``."""
    q, k, v, g, causal, _ = _case(name)
    jdt = getattr(jnp, dtype)
    jg = jnp.asarray(g, jdt)

    def f(q_, k_, v_):
        out = _einsum_attention(q_, k_, v_, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    want = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    return [np.asarray(w.astype(jnp.float32)) for w in want]


def _plain(name, dtype):
    """K2's then K3's plain version (the wrappers' CPU path) on the plain
    forward's out and logsumexp, with q, k and v as views into a fused
    ``[B, L, 3, H, D]`` projection and dO as ``[B, L, H, D]`` memory where
    the case says so; returns (dq, dk, dv)."""
    q, k, v, g, causal, views = _case(name)
    tdt = getattr(torch, dtype)
    if views:
        qkv = torch.from_numpy(np.stack([q, k, v], 2).transpose(
            0, 3, 2, 1, 4).copy()).to(tdt)             # [B, L, 3, H, D]
        tq, tk, tv = (t.transpose(1, 2) for t in qkv.unbind(2))
        tg = torch.from_numpy(g.transpose(0, 2, 1, 3).copy()).to(
            tdt).transpose(1, 2)
        assert not tq.is_contiguous() and tq.stride(-1) == 1
    else:
        tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    o, lse = fa.flash_attention_reference(tq, tk, tv, causal, None, True)
    dq, delta = fa.flash_attention_bwd_dq(tq, tk, tv, o, lse, tg, causal)
    dk, dv = fa.flash_attention_bwd_dkv(tq, tk, tv, lse, delta, tg, causal)
    assert delta.dtype == torch.float32 and delta.shape == lse.shape
    return dq, dk, dv


class TestPlainAgainstJaxGrad:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_matches_jax_grad_of_einsum_path(self, name, dtype):
        """dQ (K2) and dK, dV (K3) against ``jax.grad`` of the einsum
        path, at the head dims and shapes the split templates take."""
        got = _plain(name, dtype)
        want = _jax_grads(name, dtype)
        for label, a, b in zip(("dq", "dk", "dv"), got, want):
            assert a.dtype == getattr(torch, dtype), label
            assert a.shape == b.shape and torch.isfinite(a).all(), label
            a = a.float().numpy()
            if dtype == "float32":
                np.testing.assert_allclose(
                    a, b, rtol=RTOL, atol=ATOL_OF_MAX * np.abs(b).max(),
                    err_msg=label)
            else:
                excess = np.abs(a - b) - BF16_TOL * (1 + np.abs(b))
                assert excess.max() <= 0, (label, np.abs(a - b).max())
