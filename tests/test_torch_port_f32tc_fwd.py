"""PyTorch port, K1 in f32 on the tensor cores
(``csrc/flash_attn_fwd_f32tc.cu``): the route that sends every float32
forward at a head dim up to 512, masked or not, to it (``_fwd_entry``),
what the wrapper hands its entry point and counts in ``f32tc_launches``,
and the kernel's arithmetic, emulated here, against the JAX package.

The CUDA kernel cannot run here (no card, no nvcc). Where a test stands
in for the card, the wrapper's CUDA branch runs on meta tensors with
spies for the entry points (``fake_card``). The arithmetic is emulated in
numpy as the kernel does it, fragment by fragment, with the helpers of
``tests/test_torch_port_f32tc_bwd.py`` (its K2 shares the design). Every
f32 operand is split without rounding: ``hi`` is x with its 13 low bits
cleared, and ``lo = x - hi`` is handed over whole, so the tensor cores
read it truncated (the kernel's raw split). Q is scaled by ``scale *
log2(e)`` first. S = Q K^T is three ``mma.sync.m16n8k8`` a k-step (lo·hi,
hi·lo, then hi·hi) on the PTX fragment layouts, the even and the odd
k-steps in two accumulators added at the end, over kv tiles of 64 keys
(32 above D = 64; above D = 128 the warps of a row group each take a
slice of D, two up to 256, then four (three at 384), and every warp adds
the slices' partial S in one fixed order, slice 0 first). The online
softmax runs on the accumulator fragments
(row max over the tile, ``corr = exp2(m_old - base)`` with base 0 for a
row that has seen no key yet, each thread's partial row sums). P becomes
the A fragments of P V by the relabelling ``{c0, c2, c1, c3}``, with B
gathered from V's rows 2t and 2t + 1; each tile's P V is taken in a fresh
accumulator and added to O by one rounding (``O * corr + P V``, an FMA).
At the end O / l and ``lse = (m + log2 l) ln 2``; a row that sees no key
gets the mean of V over all keys and ``EMPTY_LSE``.

That emulation is held against the JAX package within 1e-4 * (1 + |ref|)
(chip_smoke.py's f32 tolerance), and its lse within 1e-4, at D in {8, 16,
64, 80, 128, 256, 320, 512}: against ``_flash_fwd`` (the Pallas kernel in interpret
mode, out and lse) where it takes the head dim (D % 64 == 0) and the call
has no mask; otherwise against the JAX package's einsum path, the one its
own tests run on the CPU for the stock kernel's calls (and its lse from
the same scores, with the einsum path's finite -1e30 fill). Cases:
without a mask, causal with Lq < Lk, and with a key-padding mask that
leaves one batch row with no real key and one with 2 (up to D = 128, the
masked kernels' range). One TF32 pass, emulated the same way, fails that
tolerance (at D = 128 and 512), and the partial S of four slices summed
in another order differ in some bits. Inputs are made with numpy and fed
to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.attention import (
    _einsum_attention as jax_einsum_attention)
from analytics_zoo_tpu.ops.pallas_attention import _flash_fwd
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from tests.test_torch_port_f32tc_bwd import (C_RC, _cols, _excess, _over_d,
                                             _over_rows, _rows, _to_matrix,
                                             split_raw)
from tests.test_torch_port_k5b_bwd import D_ARG, MASK_ARG, fake_card  # noqa: F401
from tests.test_torch_port_masked import _mask

torch.set_num_threads(2)

F32TC, SM90 = "zoo_flash_attn_fwd_f32tc", "zoo_flash_attn_fwd_sm90"
# chip_smoke.py's LSE_TOL["float32"]: |lse - ref| <= LSE_TOL
LSE_TOL = 1e-4
# where the entry point takes its lse pointer
LSE_ARG = 4


class TestRoute:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", fa.HEAD_DIMS)
    def test_fwd_entry(self, d, dtype, masked):
        """f32 at every head dim up to 512, masked or not, takes the f32
        tensor-core kernel; bf16 at every head dim (up to 128 masked or
        not, K5b among them, 192 to 512 without a mask) the Hopper
        kernel. Both cover every head dim a kernel is built for."""
        want = F32TC if dtype == torch.float32 else SM90
        assert d <= fa.F32TC_FWD_MAX_D
        assert d in fa.SM90_FWD_HEAD_DIMS
        assert fa._fwd_entry(dtype) == want

    def test_limit(self):
        """The f32 forward and backward both reach 512, every head dim
        they are built for."""
        assert (fa.F32TC_FWD_MAX_D, fa.F32TC_MAX_D) == (512, 512)
        assert fa.F32TC_FWD_MAX_D == max(fa.HEAD_DIMS)

    def test_entry_point_is_registered(self):
        """The f32 entry takes the Hopper entry's arguments, mask
        included."""
        stem, argtypes = fa._ENTRY_POINTS[F32TC]
        assert stem == "flash_attn_fwd_f32tc"
        assert (fa._CSRC / f"{stem}.cu").is_file()
        assert argtypes == fa._ENTRY_POINTS[SM90][1]

    def test_shared_header_is_part_of_the_build(self):
        """Both f32 sources include the helpers' header, which the
        build hashes with the sources (a change to it rebuilds both)."""
        header = fa._CSRC / "flash_attn_f32tc.cuh"
        assert header in fa._HEADERS
        for stem in ("flash_attn_fwd_f32tc", "flash_attn_bwd_f32tc"):
            text = (fa._CSRC / f"{stem}.cu").read_text()
            assert '#include "flash_attn_f32tc.cuh"' in text


@pytest.fixture
def f32tc_count(monkeypatch, fake_card):
    for name in ("f32tc_launches", "sm90_launches", "wide_d_launches"):
        monkeypatch.setattr(fa.flash_attention, name, 0)
    return fake_card


def _meta(d, dtype=torch.float32, grad=False, b=2, h=3, lq=128, lk=192):
    return [torch.empty(b, h, n, d, device="meta", dtype=dtype,
                        requires_grad=grad) for n in (lq, lk, lk)]


class TestLaunches:
    @pytest.mark.parametrize("with_lse", [False, True])
    @pytest.mark.parametrize("d,masked", [
        (d, masked) for d in (8, 20, 64, 80, 128, 192, 256, 320, 512)
        for masked in (False, True) if not (masked and d > 128)])
    def test_f32_calls_reach_f32tc(self, f32tc_count, d, masked, with_lse):
        """Off the CPU (meta tensors, spied entry points) an f32 call up
        to D = 512 (masked up to 128) launches the f32 tensor-core kernel
        once, at the head dim the kernel runs (20 padded to 24), with the
        mask's pointer where there is one and the lse pointer where it is
        asked for, and counts in ``f32tc_launches`` (and ``launches``),
        never in ``sm90_launches``."""
        q, k, v = _meta(d)
        m = (torch.ones(2, 192, dtype=torch.uint8, device="meta")
             if masked else None)
        got = fa.flash_attention(q, k, v, True, None, with_lse, m)
        out = got[0] if with_lse else got
        assert out.shape == q.shape and out.dtype == torch.float32
        assert [name for name, _ in f32tc_count] == [F32TC]
        args = f32tc_count[0][1]
        assert args[D_ARG[F32TC]] == fa._kernel_head_dim(d)
        assert args[8:10] == (128, 192)  # lq, lk
        assert (args[MASK_ARG[F32TC]] is not None) == masked
        assert (args[LSE_ARG] is not None) == with_lse
        assert len(args) == len(fa._ENTRY_POINTS[F32TC][1])
        w = fa.flash_attention
        assert (w.launches, w.f32tc_launches, w.sm90_launches,
                w.masked_launches) == (1, 1, 0, int(masked))

    @pytest.mark.parametrize("d", [16, 64, 256, 320, 512])
    def test_gradient_runs_k1_lse_on_f32tc(self, f32tc_count, d):
        """Under ``FlashAttention`` an f32 call's K1-lse runs the f32
        tensor-core kernel (with an lse pointer), then K2 and K3 (above
        D = 128 on ``flash_attn_bwd_{dq,dkv}.cu``)."""
        q, k, v = _meta(d, grad=True, lq=192)
        out = fa.flash_attention(q, k, v, True)
        torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
        assert [name for name, _ in f32tc_count][0] == F32TC
        assert f32tc_count[0][1][LSE_ARG] is not None
        assert fa.flash_attention.f32tc_launches == 1

    @pytest.mark.parametrize("kind,d,dtype,masked", [
        ("bf16_masked", 64, torch.bfloat16, True),
        ("bf16_k5b", 32, torch.bfloat16, False),
        ("bf16_sm90", 128, torch.bfloat16, False),
        ("bf16_wide", 256, torch.bfloat16, False),
        ("bf16_wider", 512, torch.bfloat16, False),
    ])
    def test_other_calls_count_no_f32tc(self, f32tc_count, kind, d, dtype,
                                        masked):
        """Every bf16 call keeps its entry and counts nothing in
        ``f32tc_launches``."""
        q, k, v = _meta(d, dtype)
        m = (torch.ones(2, 192, dtype=torch.uint8, device="meta")
             if masked else None)
        fa.flash_attention(q, k, v, False, key_padding_mask=m)
        assert [name for name, _ in f32tc_count] == [fa._fwd_entry(dtype)]
        assert (fa.flash_attention.launches,
                fa.flash_attention.f32tc_launches) == (1, 0)


# ---------------------------------------------------- the emulation --
def _split(d):
    """Warps that share 16 rows, each over a slice of D (``FwdCfg::kSplit``):
    one up to D = 128, two up to 256, then four (three at 384), so that a
    slice is at most 128 dims."""
    return 1 if d <= 128 else 2 if d <= 256 else 3 if d == 384 else 4


def _partials(q, k, passes):
    """Each warp's partial S = Q K^T over its slice of D; within a warp the
    even and the odd k-steps in two accumulators added at the end."""
    d = q.shape[-1]
    ds = d // _split(d)
    steps = np.arange(ds).reshape(-1, 8)
    even, odd = steps[0::2].ravel(), steps[1::2].ravel()
    parts = []
    for i in range(_split(d)):
        qs, ks = q[..., i * ds:(i + 1) * ds], k[..., i * ds:(i + 1) * ds]
        part = _over_d(qs[..., even], ks[..., even], passes, split_raw)
        if odd.size:
            part = part + _over_d(qs[..., odd], ks[..., odd], passes,
                                  split_raw)
        parts.append(part)
    return parts


def _sum_in_order(parts, order):
    s = parts[order[0]]
    for i in order[1:]:
        s = s + parts[i]
    return s


def _scores(q, k, passes):
    """S = Q K^T as the kernel sums it: the slices' partials added in the
    kernel's order, slice 0 first."""
    parts = _partials(q, k, passes)
    return _sum_in_order(parts, range(len(parts)))


def _fma(a, b, c):
    """a * b + c rounded once to f32 (the kernel's fmaf)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def emulate_fwd(q, k, v, causal, scale, mask=None, passes=3):
    """K1 as flash_attn_fwd_f32tc.cu computes it, on [B, H, L, D] f32
    arrays; mask [B, Lk] or None. Returns out [B, H, Lq, D] and lse
    [B*H, Lq]."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    kv = 64 if d <= 64 else 32
    log2e = np.float32(1.4426950408889634)
    scale_log2 = np.float32(np.float32(scale) * log2e)
    # Q scaled once, so that S comes out in the log2 domain
    q = (q * scale_log2).astype(np.float32)
    vis = np.ones((b, 1, lq, lk), bool)
    if causal:
        vis = vis & np.tril(np.ones((lq, lk), bool), lk - lq)
    if mask is not None:
        vis = vis & (mask != 0)[:, None, None, :]
    vis = np.broadcast_to(vis, (b, h, lq, lk))
    w = lq // 16
    ga = 16 * np.arange(w)[:, None] + C_RC[0][None, :, 0]  # [W, 32] row a
    gb = ga + 8                                            # row b
    m = np.full((b, h, lq), -np.inf, np.float32)
    # each thread's partial row sums of its rows a and b
    l_a = np.zeros((b, h, w, 32), np.float32)
    l_b = np.zeros((b, h, w, 32), np.float32)
    o = np.zeros((b, h, w, d // 8, 32, 4), np.float32)
    for k0 in range(0, lk, kv):
        kt, vt = k[:, :, k0:k0 + kv], v[:, :, k0:k0 + kv]
        s = _scores(q, kt, passes)
        r, c = _rows(s), _cols(s, k0)                   # [W, kN, 32, 4]
        ok = vis[:, :, r, c]
        x = np.where(ok, s, np.float32(-np.inf))
        mx = np.maximum(m, _to_matrix(x).max(-1))       # [B, H, Lq]
        base = np.where(mx == -np.inf, np.float32(0), mx)
        corr = np.exp2(m - base).astype(np.float32)
        m = mx
        p = np.exp2(x - base[:, :, r]).astype(np.float32)
        sum_a = np.zeros_like(l_a)
        sum_b = np.zeros_like(l_b)
        for n in range(p.shape[-3]):
            sum_a = sum_a + (p[..., n, :, 0] + p[..., n, :, 1])
            sum_b = sum_b + (p[..., n, :, 2] + p[..., n, :, 3])
        l_a = _fma(l_a, corr[:, :, ga], sum_a)
        l_b = _fma(l_b, corr[:, :, gb], sum_b)
        # this tile's P V in a fresh accumulator, then O * corr + P V
        pv = _over_rows(np.zeros_like(o), p, vt, passes, split_raw)
        cf = np.stack([corr[:, :, ga], corr[:, :, ga], corr[:, :, gb],
                       corr[:, :, gb]], -1)[:, :, :, None]
        o = _fma(o, cf, pv)

    def row_sum(x):                                     # the two shuffles
        x = x.reshape(b, h, w, 8, 4)
        return (x[..., 0] + x[..., 1]) + (x[..., 2] + x[..., 3])

    l = np.zeros((b, h, lq), np.float32)
    l.reshape(b, h, w, 16)[..., :8] = row_sum(l_a)
    l.reshape(b, h, w, 16)[..., 8:] = row_sum(l_b)
    l = np.maximum(l, np.float32(1e-30))
    inv = (np.float32(1) / l).astype(np.float32)
    out = (_to_matrix(o) * inv[..., None]).astype(np.float32)
    with np.errstate(divide="ignore"):
        lse = ((m + np.log2(l)) * np.float32(0.6931471805599453)).astype(
            np.float32)
    empty = m == -np.inf
    if empty.any():
        mean = (v.sum(2, dtype=np.float32) / np.float32(lk))[:, :, None]
        out = np.where(empty[..., None], mean, out)
        lse = np.where(empty, np.float32(fa.EMPTY_LSE), lse)
    return out, lse.reshape(b * h, lq)


# name -> (b, lq, lk, causal, mask kind or None)
KINDS = {
    "plain": (2, 128, 128, False, None),
    "causal_cross": (1, 64, 192, True, None),
    # batch row 1 has 2 real keys, row 2 none: its rows see nothing
    "masked": (3, 128, 128, False, "two_and_empty"),
}
EMU_HEAD_DIMS = [8, 16, 64, 80, 128, 256, 320, 512]


def _inputs(kind, d, seed):
    b, lq, lk, causal, mask_kind = KINDS[kind]
    rng = np.random.RandomState(seed)
    # not symmetric: q, k and v differ in scale and offset
    q = 1.5 * rng.randn(b, 2, lq, d).astype(np.float32)
    k = rng.randn(b, 2, lk, d).astype(np.float32)
    v = rng.randn(b, 2, lk, d).astype(np.float32) + 0.25
    m = None
    if mask_kind is not None:
        m = _mask("prefix", b, lk, seed + 1)             # row 1: 2 keys
        m[2] = 0
    return q, k, v, m, causal


def _jax_lse(q, k, causal, scale, mask):
    """The row logsumexp of the einsum path's scores (-1e30 fills)."""
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale
    lq, lk = q.shape[2], k.shape[2]
    keep = jnp.ones((1, 1, lq, lk), bool)
    if causal:
        keep = keep & jnp.tril(jnp.ones((lq, lk), bool), lk - lq)
    if mask is not None:
        keep = keep & (jnp.asarray(mask) != 0)[:, None, None, :]
    s = jnp.where(keep, s, -1e30)
    return jax.nn.logsumexp(s, axis=-1).reshape(-1, lq)


def _reference(kind, d, seed):
    """(inputs, out, lse [B*H, Lq]) of the JAX package: ``_flash_fwd``
    in interpret mode at D % 64 == 0 without a mask, else the einsum
    path."""
    q, k, v, m, causal = _inputs(kind, d, seed)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    if m is None and d % 64 == 0:
        out, lse = _flash_fwd(jq, jk, jv, causal, scale, 64, 64,
                              with_lse=True)
        lse = lse[..., 0]
    else:
        out = jax_einsum_attention(
            jq, jk, jv, causal=causal, scale=scale,
            mask=None if m is None else jnp.asarray(m)[:, None, None, :])
        lse = _jax_lse(jq, jk, causal, scale, m)
    return (q, k, v, m, causal, scale), np.asarray(out), np.asarray(lse)


def _cases():
    return [(kind, d) for d in EMU_HEAD_DIMS for kind in sorted(KINDS)
            if not (kind == "masked" and d > 128)]


class TestEmulation:
    @pytest.mark.parametrize("kind,d", _cases())
    def test_3xtf32_matches_the_reference(self, kind, d):
        """The kernel's arithmetic within 1e-4 * (1 + |ref|) of the JAX
        package's forward, and its lse within 1e-4."""
        (q, k, v, m, causal, scale), want, want_lse = _reference(
            kind, d, seed=d + len(kind))
        out, lse = emulate_fwd(q, k, v, causal, scale, m)
        assert out.shape == want.shape and np.isfinite(out).all()
        assert _excess(out, want) <= 1, np.abs(out - want).max()
        assert np.abs(lse - want_lse).max() <= LSE_TOL
        if kind == "masked":
            # batch row 2 has no real key: the mean of V, EMPTY_LSE
            np.testing.assert_allclose(
                out[2], np.broadcast_to(v[2].mean(1, keepdims=True),
                                        out[2].shape), rtol=1e-5,
                atol=1e-6)
            assert (lse.reshape(3, 2, -1)[2] == fa.EMPTY_LSE).all()

    @pytest.mark.parametrize("kind,d", [("plain", 64), ("masked", 80)])
    def test_plain_version_matches_the_reference(self, kind, d):
        """What the kernel is held to on the card: the port's
        ``flash_attention`` on the CPU (its plain version), at the same
        inputs, within the same tolerances."""
        (q, k, v, m, causal, scale), want, want_lse = _reference(
            kind, d, seed=3)
        out, lse = fa.flash_attention(
            *map(torch.from_numpy, (q, k, v)), causal, scale, True,
            None if m is None else torch.from_numpy(m))
        assert _excess(out.numpy(), want) <= 1
        assert np.abs(lse.numpy() - want_lse).max() <= LSE_TOL

    def test_one_tf32_pass_fails_the_tolerance(self):
        """At D = 128 a single TF32 product (hi·hi only) misses 1e-4 *
        (1 + |ref|) where three products hold it: why the kernel takes
        three."""
        (q, k, v, m, causal, scale), want, _ = _reference("plain", 128,
                                                          seed=0)
        three, _ = emulate_fwd(q, k, v, causal, scale, m)
        one, _ = emulate_fwd(q, k, v, causal, scale, m, passes=1)
        assert _excess(three, want) <= 1
        assert _excess(one, want) > 1

    def test_one_tf32_pass_fails_the_tolerance_at_512(self):
        """The same at D = 512, where four warps each take 128 dims of S."""
        (q, k, v, m, causal, scale), want, _ = _reference("causal_cross",
                                                          512, seed=1)
        three, _ = emulate_fwd(q, k, v, causal, scale, m)
        one, _ = emulate_fwd(q, k, v, causal, scale, m, passes=1)
        assert _excess(three, want) <= 1
        assert _excess(one, want) > 1

    @pytest.mark.parametrize("d", [320, 384, 512])
    def test_partials_sum_in_one_order(self, d):
        """Above D = 256 three or four warps add their partial S. Float
        addition is not associative: summed in another order some scores
        differ in their last bits, so warps that each took their own
        first would hold different S, then m, l and P, and their slices of
        O would disagree. Every warp adds them in one order, slice 0 first.
        Two partials (D = 192, 256) commute, so a pair never needed it."""
        rng = np.random.RandomState(d)
        q = 1.5 * rng.randn(1, 1, 64, d).astype(np.float32)
        k = rng.randn(1, 1, 32, d).astype(np.float32)
        parts = _partials(q, k, 3)
        assert len(parts) == _split(d) > 2
        fixed = _sum_in_order(parts, range(len(parts)))
        np.testing.assert_array_equal(fixed, _scores(q, k, 3))
        others = [_sum_in_order(parts, order) for order in (
            range(len(parts) - 1, -1, -1), [0, 2, 1, 3][:len(parts)])]
        assert all((fixed != other).any() for other in others)
        pair = _partials(q[..., :256], k[..., :256], 3)
        np.testing.assert_array_equal(pair[0] + pair[1], pair[1] + pair[0])
