"""PyTorch port, K2's and K3's Hopper kernels at the K5b head dims and
under the key-padding mask (``csrc/flash_attn_bwd_sm90.cu``): the route
that sends every bf16 backward call at a head dim up to 128, masked or
not, to them (``_bwd_entry``), their entry points (the older entries'
arguments, the mask's pointer and batch stride among them), what the
wrappers hand them (the mask, the head dim the kernels run at, the true
head dim's scale, the causal flag) and count, the retirement of the older
bf16 templates up to D = 128, and K2's and K3's plain versions (what the
kernels are held to on the card by ``chip_smoke.py``) against ``jax.grad``
of the JAX package's einsum path at the shapes the kernels must get
right: D = 8, 24, 32, 40, 80 and 120, a last 128-row block half empty
(Lq = 192), wholly padded kv tiles between real ones, causal Lq < Lk with
a left-padded batch row (rows that see no key), and a batch row with no
real token.

The reference is the einsum path (``_einsum_attention`` and its
``jax.grad``): on the TPU these calls train through JAX's stock Pallas
``flash_attention``, whose dQ and dK/dV kernels have no CPU mode (see
``tests/test_torch_port_k5b_bwd.py``), and the port follows the einsum
path at every row. The plain versions read the plain forward's out and
logsumexp, as the kernels read K1's. The CUDA kernels themselves cannot
run here (no card, no nvcc): where a test stands in for the card, the
wrappers' CUDA branch runs on meta tensors with spies for the entry
points (``fake_card``). Inputs are made with numpy from a seed and fed to
both packages.

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
# where the backward entries take each argument
D_ARG, MASK_ARG, MASK_SB_ARG, SCALE_ARG, CAUSAL_ARG = 13, 32, 33, 34, 35
BF16 = torch.bfloat16
RTOL, ATOL_OF_MAX = 1e-5, 2e-5
BF16_TOL = 2e-2
CSRC = fa._CSRC


class TestRoute:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("dp", range(8, 129, 8))
    def test_bf16_up_to_128_takes_the_hopper_kernels(self, dp, masked):
        """Every head dim a bf16 call runs at up to 128 (the wrappers pad
        the others to a multiple of 8), with a mask or without, takes
        ``flash_attn_bwd_sm90.cu``'s K2 and K3."""
        assert dp in fa.SM90_HEAD_DIMS
        assert fa._bwd_entry(BF16) == (DQ, DKV)

    @pytest.mark.parametrize("new,old", [(DQ, F32TC_DQ), (DKV, F32TC_DKV)])
    def test_entries_take_the_old_arguments(self, new, old):
        """The Hopper entries take the f32 tensor-core entries' arguments
        exactly, the mask's pointer and batch stride among them, so all
        four backward entries share one argument list."""
        argtypes = fa._ENTRY_POINTS[new][1]
        assert fa._ENTRY_POINTS[new][0] == "flash_attn_bwd_sm90"
        assert argtypes == fa._ENTRY_POINTS[old][1]
        assert argtypes == fa._BWD_ARGS
        assert (argtypes[MASK_ARG], argtypes[MASK_SB_ARG]) == (fa._P, fa._L)
        assert argtypes[D_ARG] == fa._I

    def test_older_bf16_templates_up_to_128_are_retired(self):
        """No ``mma.sync`` bf16 backward template is left (the split
        templates at 320 to 512 went with ``flash_attn_bwd.cuh``); the
        Hopper source holds K2 and K3 with the mask flag."""
        assert not (CSRC / "flash_attn_bwd.cuh").exists()
        for src in fa._SOURCES + fa._HEADERS:
            text = src.read_text()
            for kernel in ("flash_bwd_dq_bf16_kernel",
                           "flash_bwd_dkv_bf16_kernel",
                           "flash_bwd_dq_bf16_split_kernel"):
                assert kernel not in text, (src.name, kernel)
        sm90 = (CSRC / "flash_attn_bwd_sm90.cu").read_text()
        for kernel in ("flash_bwd_dq_sm90_kernel",
                       "flash_bwd_dkv_sm90_kernel"):
            assert f"{kernel}<D, kMask>" in sm90


def _meta(d, b=2, h=3, lq=192, lk=256, grad=False):
    return [torch.empty(b, h, n, d, device="meta", dtype=BF16,
                        requires_grad=grad) for n in (lq, lk, lk, lq)]


def _lse(b=2, h=3, lq=192):
    return torch.empty(b * h, lq, device="meta", dtype=torch.float32)


@pytest.fixture
def counts(monkeypatch, fake_card):
    for w in (fa.flash_attention, fa.flash_attention_bwd_dq,
              fa.flash_attention_bwd_dkv):
        monkeypatch.setattr(w, "sm90_launches", 0)
        monkeypatch.setattr(w, "wide_d_launches", 0)
    return fake_card


def _backward(q, k, v, do, causal, m):
    """K2 then K3 through their wrappers (out stands in for o)."""
    _, delta = fa.flash_attention_bwd_dq(q, k, v, q, _lse(), do, causal,
                                         key_padding_mask=m)
    return fa.flash_attention_bwd_dkv(q, k, v, _lse(), delta, do, causal,
                                      key_padding_mask=m)


class TestLaunches:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("d", [8, 20, 32, 40, 64, 80, 120, 128])
    def test_masked_call_reaches_the_hopper_entries(self, counts, d,
                                                    causal):
        """Off the CPU (meta tensors, spied entry points) a masked bf16
        backward launches K2's and K3's Hopper kernels once each, with
        the mask's pointer and batch stride, the head dim they run at,
        the lengths, the true head dim's scale and the causal flag, and
        counts in ``launches``, ``masked_launches``, ``sm90_launches``
        and, off a multiple of 64, ``small_d_launches``."""
        q, k, v, do = _meta(d)
        m = torch.ones(2, 256, dtype=torch.uint8, device="meta")
        dk, dv = _backward(q, k, v, do, causal, m)
        assert dk.shape == dv.shape == k.shape and dk.dtype == BF16
        assert [name for name, _ in counts] == [DQ, DKV]
        for _, args in counts:
            assert len(args) == len(fa._ENTRY_POINTS[DQ][1])
            assert args[D_ARG] == fa._kernel_head_dim(d)
            assert args[11:13] == (192, 256)  # lq, lk
            assert args[MASK_ARG] is not None and args[MASK_SB_ARG] == 256
            assert args[SCALE_ARG] == pytest.approx(1 / np.sqrt(d))
            assert args[CAUSAL_ARG] == int(causal)
        for w in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
            assert (w.launches, w.masked_launches, w.sm90_launches,
                    w.small_d_launches, w.wide_d_launches) == (
                1, 1, 1, int(fa._kernel_head_dim(d) % 64 != 0), 0)

    @pytest.mark.parametrize("d", [8, 20, 24, 40, 80, 120])
    def test_k5b_call_reaches_the_hopper_entries(self, counts, d):
        """An unmasked bf16 backward at a K5b head dim (20 padded to 24)
        launches the Hopper kernels with a null mask, counted as K5b."""
        q, k, v, do = _meta(d)
        _backward(q, k, v, do, True, None)
        assert [name for name, _ in counts] == [DQ, DKV]
        for _, args in counts:
            assert args[D_ARG] == fa._kernel_head_dim(d)
            assert args[MASK_ARG] is None and args[MASK_SB_ARG] == 0
            assert args[CAUSAL_ARG] == 1
        for w in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
            assert (w.launches, w.masked_launches, w.sm90_launches,
                    w.small_d_launches) == (1, 0, 1, 1)

    @pytest.mark.parametrize("d", [24, 32, 64])
    def test_gradient_runs_hopper_k1_lse_k2_k3(self, counts, d):
        """Under ``FlashAttention`` a masked bf16 call runs K1-lse, K2 and
        K3 on the Hopper kernels, in that order, each with the mask."""
        q, k, v, _ = _meta(d, lq=256, grad=True)
        m = torch.ones(2, 256, dtype=torch.uint8, device="meta")
        out = fa.flash_attention(q, k, v, False, key_padding_mask=m)
        grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
        assert all(g.shape == q.shape for g in grads)
        assert [name for name, _ in counts] == [FWD_SM90, DQ, DKV]
        assert counts[0][1][23] is not None            # K1's mask pointer
        assert all(args[MASK_ARG] is not None for _, args in counts[1:])
        assert [w.sm90_launches for w in (
            fa.flash_attention, fa.flash_attention_bwd_dq,
            fa.flash_attention_bwd_dkv)] == [1, 1, 1]


def _mask(kind, b, lk, seed):
    """[B, Lk] int32 key-padding masks (1 = real token): batch row 0
    full, the others "prefix" (real lengths in [2, Lk]), "gaps" (row 1
    real in the first and the last of every three 64-key tiles, whole
    padded tiles between; the others prefix), "left" (row 1 holds its
    40 real keys at the right end) or "zero_row" (prefix, row 1 with no
    real token)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(2, lk + 1, b)
    lens[0] = lk
    pos = np.arange(lk)[None, :]
    m = pos < lens[:, None]
    if kind == "gaps":
        m[1] = (pos[0] // 64) % 3 != 1
    elif kind == "left":
        m[1] = pos[0] >= lk - 40
    elif kind == "zero_row":
        m[1] = False
    return m.astype(np.int32)


# name -> (b, h, lq, lk, d, causal, mask kind or None)
CASES = {
    "d8_causal": (2, 2, 128, 128, 8, True, None),
    "d24_prefix": (3, 2, 128, 128, 24, False, "prefix"),
    # K2's last 128-row block half empty, masked and causal
    "d32_half_block": (2, 2, 192, 192, 32, False, "prefix"),
    "d40_half_block_causal": (2, 2, 192, 192, 40, True, "prefix"),
    # wholly padded kv tiles between real ones (K2's list of tiles, K3's
    # key blocks of padding)
    "d80_gaps": (2, 2, 64, 448, 80, False, "gaps"),
    # causal Lq < Lk, batch row 1 left-padded: its rows 0-23 see no key
    "d120_cross_left": (2, 2, 64, 192, 120, True, "left"),
    # a batch row with no real token
    "d32_zero_row": (3, 2, 128, 128, 32, False, "zero_row"),
    "d8_zero_row": (3, 2, 128, 128, 8, False, "zero_row"),
}


def _case(name):
    b, h, lq, lk, d, causal, kind = CASES[name]
    rng = np.random.RandomState(lq + lk + d)
    # not symmetric: q, k, v and dO differ in scale and offset
    q = 1.5 * rng.randn(b, h, lq, d).astype(np.float32)
    k = rng.randn(b, h, lk, d).astype(np.float32)
    v = rng.randn(b, h, lk, d).astype(np.float32) + 0.25
    g = 0.5 * rng.randn(b, h, lq, d).astype(np.float32)
    m = None if kind is None else _mask(kind, b, lk, d)
    return q, k, v, g, m, causal


@functools.lru_cache(maxsize=None)
def _jax_grads(name, dtype):
    """``jax.grad`` of the einsum path's sum(out * dO) in ``dtype``."""
    q, k, v, g, m, causal = _case(name)
    jdt = getattr(jnp, dtype)
    mask = None if m is None else jnp.asarray(m)[:, None, None, :]
    jg = jnp.asarray(g, jdt)

    def f(q_, k_, v_):
        out = _einsum_attention(q_, k_, v_, mask=mask, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    want = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    return [np.asarray(w.astype(jnp.float32)) for w in want]


def _plain(name, dtype):
    """K2's then K3's plain version (the wrappers' CPU path) on the plain
    forward's out and logsumexp; returns (dq, dk, dv) and the inputs."""
    q, k, v, g, m, causal = _case(name)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    tm = None if m is None else torch.from_numpy(m)
    o, lse = fa.flash_attention_reference(tq, tk, tv, causal, None, True,
                                          tm)
    dq, delta = fa.flash_attention_bwd_dq(tq, tk, tv, o, lse, tg, causal,
                                          key_padding_mask=tm)
    dk, dv = fa.flash_attention_bwd_dkv(tq, tk, tv, lse, delta, tg, causal,
                                        key_padding_mask=tm)
    assert delta.dtype == torch.float32 and delta.shape == lse.shape
    return (dq, dk, dv), (q, m, causal)


class TestPlainAgainstJaxGrad:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_matches_jax_grad_of_einsum_path(self, name, dtype):
        """dQ (K2) and dK, dV (K3) against ``jax.grad`` of the einsum
        path, at the head dims and masks the Hopper kernels take."""
        got, _ = _plain(name, dtype)
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

    @pytest.mark.parametrize("name", ["d120_cross_left", "d32_zero_row",
                                      "d8_zero_row"])
    def test_rows_without_a_key_and_padded_keys(self, name):
        """Rows that see no key give exactly zero dQ; padded keys get
        exactly zero dK, and each key's dV takes dO / Lk from every row
        that sees no key (the einsum path's uniform row)."""
        (dq, dk, dv), (q, m, causal) = _plain(name, "float32")
        b, h, lq, _ = q.shape
        lk = m.shape[1]
        keep = np.broadcast_to(m[:, None, :] != 0, (b, lq, lk))
        if causal:
            keep = keep & np.tril(np.ones((lq, lk), bool), lk - lq)[None]
        empty = torch.from_numpy(~keep.any(-1))
        assert empty.any()
        assert torch.count_nonzero(
            dq[empty[:, None, :, None].expand_as(dq)]) == 0
        pad = torch.from_numpy(m == 0)[:, None, :, None].expand_as(dk)
        assert torch.count_nonzero(dk[pad]) == 0
        # a batch row with no real key: every row sees none, so every
        # key's dV is the mean of dO over the rows
        _, _, _, g, _, _ = _case(name)
        for row in range(b):
            if not m[row].any():
                want = np.broadcast_to(g[row].mean(axis=1, keepdims=True),
                                       dv[row].shape)
                np.testing.assert_allclose(dv[row].numpy(), want,
                                           atol=1e-6)
