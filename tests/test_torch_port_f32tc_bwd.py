"""PyTorch port, K2 and K3 in f32 on the tensor cores
(``csrc/flash_attn_bwd_f32tc.cu``): the route that sends every float32
call to them (``_bwd_entry``; masked up to 128), what the wrappers hand
their entry points and count in ``f32tc_launches``, and the kernels'
arithmetic, emulated here, against the JAX package.

The CUDA kernels cannot run here (no card, no nvcc). Where a test stands
in for the card, the wrappers' CUDA branch runs on meta tensors with
spies for the entry points (``fake_card``). The arithmetic is emulated in
numpy as the kernels do it, fragment by fragment: every f32 operand is
split into ``hi = tf32(x)`` and ``lo = tf32(x - hi)`` with ``cvt.rna``'s
rounding on the bit pattern (round to nearest, ties away from zero, 10
mantissa bits); each product is three ``mma.sync.m16n8k8`` (lo·hi,
hi·lo, then hi·hi) on the PTX fragment layouts; the accumulators of S
and dP (or S^T and dP^T) become the A fragments of dQ += dS K,
dV += P^T dO and dK += dS^T Q by the relabelling ``{c0, c2, c1, c3}``,
with B gathered from rows 2t and 2t + 1, and those sums leave the
accumulators every 256 rows. That emulation is held against ``_flash_bwd``
(the dQ and dK/dV Pallas kernels in interpret mode, which run at any
head dim, on the forward's out and logsumexp) at D in {8, 32, 64, 120,
128}, without a mask and causal with Lq < Lk, and, with a key-padding
mask that leaves a batch row with no real key (or, at L = 320, one with 2
real keys), against ``jax.grad`` of
the JAX package's einsum path (the reference's masked branch; the Pallas
backward takes no mask), within 1e-4 * (1 + |ref|), chip_smoke.py's f32
tolerance. Above D = 128 (192, 320 and 512 here; no mask, causal or not,
and causal with Lq < Lk) the kernels split D over the warps that share 16
rows: each warp takes its partial S and dP (S^T and dP^T) over its slice
with the raw split (hi = x truncated to tf32, lo = x - hi read truncated),
the even and the odd k-steps in two accumulators, and every warp adds the
slices' partials in one order, slice 0 first; summed in another order
some bits of S or dS differ. One TF32 pass, emulated the same way, fails
the tolerance (at D = 128 and 512): that is why the kernels take three.

Inputs are made with numpy and fed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.pallas_attention import _flash_bwd, _flash_fwd
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from tests.test_torch_port_k5b_bwd import D_ARG, MASK_ARG, fake_card  # noqa: F401
from tests.test_torch_port_masked import _jax_einsum, _mask

torch.set_num_threads(2)

DQ, DKV = "zoo_flash_attn_bwd_dq_f32tc", "zoo_flash_attn_bwd_dkv_f32tc"
SM90_DQ, SM90_DKV = "zoo_flash_attn_bwd_dq_sm90", "zoo_flash_attn_bwd_dkv_sm90"
# chip_smoke.py's f32 tolerance: |got - ref| <= TOL * (1 + |ref|)
TOL = 1e-4


class TestRoute:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", fa.HEAD_DIMS)
    def test_bwd_entry(self, d, dtype, masked):
        """f32 at every head dim, masked or not, takes the f32
        tensor-core kernels; bf16 at every head dim (masked or not, K5b
        among them, 320 to 512 too) the Hopper kernels."""
        want = (DQ, DKV) if dtype == torch.float32 else (SM90_DQ, SM90_DKV)
        assert fa._bwd_entry(dtype) == want

    @pytest.mark.parametrize("new,old", [(DQ, SM90_DQ), (DKV, SM90_DKV)])
    def test_entry_points_are_registered(self, new, old):
        """The f32 entries take the Hopper entries' arguments, mask
        included."""
        stem, argtypes = fa._ENTRY_POINTS[new]
        assert stem == "flash_attn_bwd_f32tc"
        assert (fa._CSRC / f"{stem}.cu").is_file()
        assert argtypes == fa._ENTRY_POINTS[old][1]


@pytest.fixture
def f32tc_count(monkeypatch, fake_card):
    for w in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        monkeypatch.setattr(w, "f32tc_launches", 0)
        monkeypatch.setattr(w, "sm90_launches", 0)
        monkeypatch.setattr(w, "wide_d_launches", 0)
    monkeypatch.setattr(fa.flash_attention, "sm90_launches", 0)
    return fake_card


def _meta(d, dtype=torch.float32, grad=False, b=2, h=3, lq=128, lk=192):
    return [torch.empty(b, h, n, d, device="meta", dtype=dtype,
                        requires_grad=grad) for n in (lq, lk, lk, lq)]


def _lse(b=2, h=3, lq=128):
    return torch.empty(b * h, lq, device="meta", dtype=torch.float32)


class TestLaunches:
    @pytest.mark.parametrize("d,masked", [
        (d, masked) for masked in (False, True)
        for d in (8, 20, 32, 64, 120, 128)] + [(256, False), (512, False)])
    def test_f32_calls_reach_f32tc(self, f32tc_count, d, masked):
        """Off the CPU (meta tensors, spied entry points) K2 and K3 of an
        f32 call launch the f32 tensor-core kernels once each, with the
        mask's pointer where there is one (up to D = 128), at the head dim
        the kernels run (20 padded to 24), and count in
        ``f32tc_launches`` (and ``launches``, ``masked_launches`` and, at
        K5b's head dims, ``small_d_launches``), never in
        ``sm90_launches``; at 256 and 512 as at 128."""
        q, k, v, do = _meta(d)
        m = (torch.ones(2, 192, dtype=torch.uint8, device="meta")
             if masked else None)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, q, _lse(), do, True,
                                              key_padding_mask=m)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, _lse(), delta, do, True,
                                            key_padding_mask=m)
        assert dq.shape == q.shape and dq.dtype == torch.float32
        assert dk.shape == dv.shape == k.shape
        assert [name for name, _ in f32tc_count] == [DQ, DKV]
        for name, args in f32tc_count:
            assert args[D_ARG[name]] == fa._kernel_head_dim(d)
            assert args[11:13] == (128, 192)  # lq, lk
            assert (args[MASK_ARG[name]] is not None) == masked
            assert len(args) == len(fa._ENTRY_POINTS[name][1])
        for w in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
            assert (w.launches, w.f32tc_launches, w.sm90_launches,
                    w.masked_launches, w.small_d_launches) == (
                1, 1, 0, int(masked), int(fa._kernel_head_dim(d) % 64 != 0))

    @pytest.mark.parametrize("d", [32, 64, 128])
    def test_gradient_runs_f32tc(self, f32tc_count, d):
        """Under ``FlashAttention`` an f32 call runs K1-lse on K1's f32
        tensor-core kernel, then K2 and K3 on theirs."""
        q, k, v, _ = _meta(d, grad=True, lq=192)
        out = fa.flash_attention(q, k, v, True)
        grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
        assert all(g.shape == q.shape for g in grads)
        assert [name for name, _ in f32tc_count] == [
            "zoo_flash_attn_fwd_f32tc", DQ, DKV]
        for w in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
            assert (w.launches, w.f32tc_launches) == (1, 1)

    @pytest.mark.parametrize("kind,d,dtype,masked", [
        ("bf16_masked", 64, torch.bfloat16, True),
        ("bf16_k5b", 32, torch.bfloat16, False),
        ("bf16_sm90", 128, torch.bfloat16, False),
    ])
    def test_other_calls_count_no_f32tc(self, f32tc_count, kind, d, dtype,
                                        masked):
        """Every bf16 call keeps its entries and counts nothing in
        ``f32tc_launches``."""
        q, k, v, do = _meta(d, dtype)
        m = (torch.ones(2, 192, dtype=torch.uint8, device="meta")
             if masked else None)
        _, delta = fa.flash_attention_bwd_dq(q, k, v, q, _lse(), do, False,
                                             key_padding_mask=m)
        fa.flash_attention_bwd_dkv(q, k, v, _lse(), delta, do, False,
                                   key_padding_mask=m)
        assert [name for name, _ in f32tc_count] == list(
            fa._bwd_entry(dtype))
        for w in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
            assert (w.launches, w.f32tc_launches) == (1, 0)


# ---------------------------------------------------- the emulation --
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4
# PTX fragment layouts of mma.m16n8k8 with tf32 operands: (row, col) of
# each lane's registers. A is 16 x 8 (row-major), B 8 x 8 as [k][n], C
# 16 x 8
A_RC = (np.stack([G, G + 8, G, G + 8], 1), np.stack([T, T, T + 4, T + 4], 1))
B_RC = (np.stack([T, T + 4], 1), np.stack([G, G], 1))
C_RC = (np.stack([G, G, G + 8, G + 8], 1),
        np.stack([2 * T, 2 * T + 1, 2 * T, 2 * T + 1], 1))
# the accumulator of a block of 8 columns as the A fragment of a product
# contracting over them: k = t is column 2t, k = t + 4 column 2t + 1
RELABEL = [0, 2, 1, 3]
# rows of the sequence a partial sum of dQ, dK or dV takes in the
# accumulators before it is added to the total (kFlushRows)
FLUSH_ROWS = 256


def tf32(x):
    """``cvt.rna.tf32.f32``'s rounding on the bit pattern, as the kernels
    compute it: add half a tf32 ulp and clear the 13 low bits (round to
    nearest, ties away from zero, 10 mantissa bits)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(np.float32(x) - hi)


def _trunc(x):
    """x with its 13 low bits cleared: tf32 by truncation, what the
    tensor cores read of an f32 register."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split_raw(x):
    """The raw split (split_tf32<true>) of the kernels above D = 128 and
    of K1's: hi = x truncated to tf32, lo = x - hi (exact in f32) handed
    over as it is, so the tensor cores read it truncated."""
    hi = _trunc(x)
    return hi, _trunc(np.float32(x) - hi)


def _frags_to(frag, rc, shape):
    m = np.zeros(frag.shape[:-2] + shape, np.float64)
    m[..., rc[0], rc[1]] = frag
    return m


def mma(c, a, b):
    """One mma.sync.m16n8k8: the fragments (lanes on axis -2) made into
    matrices by the PTX layouts, C + A B summed exactly and rounded to
    f32, and handed back as C fragments."""
    prod = (_frags_to(a, A_RC, (16, 8)) @ _frags_to(b, B_RC, (8, 8))
            + _frags_to(c, C_RC, (16, 8)))
    return prod[..., C_RC[0], C_RC[1]].astype(np.float32)


def mma3(c, a, b, passes=3, split_fn=split):
    """c += a b as the kernels take it: lo_a hi_b, hi_a lo_b, hi_a hi_b;
    ``passes=1`` is one TF32 product (hi_a hi_b). ``split_fn`` gives
    (hi, lo) as the tensor cores read them (the kernels' rounded split
    by default)."""
    ahi, alo = split_fn(a)
    bhi, blo = split_fn(b)
    if passes == 3:
        c = mma(c, alo, bhi)
        c = mma(c, ahi, blo)
    return mma(c, ahi, bhi)


def _over_d(rows, cols, passes, split_fn=split):
    """rows [..., R, D] (R a multiple of 16) times cols^T [..., N, D]:
    the accumulator fragments [..., R/16, N/8, 32, 4] of the products
    over D, in k-steps of 8, A from rows and B from cols (K-major)."""
    *lead, r, d = rows.shape
    n = cols.shape[-2]
    a = rows.reshape(*lead, r // 16, 1, 16, d)
    b = cols.reshape(*lead, 1, n // 8, 8, d)
    acc = np.zeros((*lead, r // 16, n // 8, 32, 4), np.float32)
    for c in range(d // 8):
        af = a[..., A_RC[0], 8 * c + A_RC[1]]
        # B[k][n] = cols[n][8c + k]
        bf = b[..., B_RC[1], 8 * c + B_RC[0]]
        acc = mma3(acc, af, bf, passes, split_fn)
    return acc


def _over_rows(acc, frag, tile, passes, split_fn=split):
    """acc [..., W, D/8, 32, 4] += frag^T-contracted product: ``frag``
    [..., W, N/8, 32, 4] holds a 16 x N accumulator (S, dS, P^T or dS^T)
    whose columns are the rows of ``tile`` [..., N, D]; block j of 8
    columns becomes an A fragment by RELABEL and B is gathered from rows
    8j + 2t and 8j + 2t + 1, column g of each n-block. As in the kernels,
    each FLUSH_ROWS rows of the sum run in a zeroed accumulator and are
    then added to ``acc`` in f32."""
    d = tile.shape[-1]
    part = np.zeros_like(acc)
    for j in range(frag.shape[-3]):
        a = frag[..., j, :, :][..., RELABEL]
        r0 = tile[..., None, 8 * j + 2 * T, :]          # [..., 1, 32, D]
        r1 = tile[..., None, 8 * j + 2 * T + 1, :]
        for m in range(d // 8):
            b = np.stack([r0[..., LANE, 8 * m + G],
                          r1[..., LANE, 8 * m + G]], -1)
            part[..., m, :, :] = mma3(part[..., m, :, :], a, b, passes,
                                      split_fn)
        if (j + 1) % (FLUSH_ROWS // 8) == 0:
            acc += part
            part[...] = 0
    return acc + part


def _to_matrix(frag):
    """[..., W, N/8, 32, 4] accumulator fragments -> [..., 16 W, N]."""
    *lead, w, nb, _, _ = frag.shape
    m = np.zeros((*lead, w, nb, 16, 8), np.float32)
    m[..., C_RC[0], C_RC[1]] = frag
    return m.transpose(*range(len(lead)), -4, -2, -3, -1).reshape(
        *lead, w * 16, nb * 8)


def _cols(frag, base=0):
    """Column index (within the rows' N) of each accumulator element."""
    nb = frag.shape[-3]
    return base + 8 * np.arange(nb)[None, :, None, None] + C_RC[1][None, None]


def _rows(frag):
    """Row index (within the warp tiles' 16 W) of each element."""
    w = frag.shape[-4]
    return 16 * np.arange(w)[:, None, None, None] + C_RC[0][None, None]


def wide_split(d):
    """Warps that share 16 rows above D = 128, each over a slice of D
    (``WideCfg::kDqSplit`` and ``kDkvSplit``): two up to 256, four above,
    so that a slice is at most 128 dims."""
    return 2 if d <= 256 else 4


def partials(rows, cols, passes):
    """Each warp's partial product over its slice of D above D = 128
    (``mma_over_d1`` with the raw split): within a warp the even and the
    odd k-steps in two accumulators, added at the end."""
    d = rows.shape[-1]
    ds = d // wide_split(d)
    steps = np.arange(ds).reshape(-1, 8)
    even, odd = steps[0::2].ravel(), steps[1::2].ravel()
    out = []
    for i in range(wide_split(d)):
        r = rows[..., i * ds:(i + 1) * ds]
        c = cols[..., i * ds:(i + 1) * ds]
        out.append(_over_d(r[..., even], c[..., even], passes, split_raw)
                   + _over_d(r[..., odd], c[..., odd], passes, split_raw))
    return out


def in_order(parts, order=None):
    """The partials added one at a time in ``order`` (the kernels' order,
    slice 0 first, by default)."""
    order = list(range(len(parts)) if order is None else order)
    total = parts[order[0]]
    for i in order[1:]:
        total = total + parts[i]
    return total


def emulate_bwd(q, k, v, o, lse, do, causal, scale, mask=None, passes=3):
    """K2 then K3 as flash_attn_bwd_f32tc.cu computes them, on [B, H, L,
    D] f32 arrays, lse [B*H, Lq]; mask [B, Lk] or None. Above D = 128 the
    products over D are the slices' partials summed in order, and every
    operand takes the raw split. Returns dq, dk, dv (as [B, H, L, D]) and
    delta."""
    b, h, lq, d = q.shape
    if d > 128:
        def over_d(rows, cols):
            return in_order(partials(rows, cols, passes))
        split_fn = split_raw
    else:
        def over_d(rows, cols):
            return _over_d(rows, cols, passes)
        split_fn = split
    lk = k.shape[2]
    log2e = np.float32(1.4426950408889634)
    scale = np.float32(scale)
    scale_log2 = np.float32(scale * log2e)
    lse2 = lse.reshape(b, h, lq).astype(np.float32) * log2e
    delta = (do * o).sum(-1, dtype=np.float32)          # [B, H, Lq]
    vis = np.ones((b, 1, lq, lk), bool)
    if causal:
        vis = vis & np.tril(np.ones((lq, lk), bool), lk - lq)
    if mask is not None:
        vis = vis & (mask != 0)[:, None, None, :]
    vis = np.broadcast_to(vis, (b, h, lq, lk))

    def warp_tiles(x):                                  # [B, H, W, 16, *]
        return x.reshape(b, h, x.shape[2] // 16, 16, *x.shape[3:])

    # K2: rows are queries in warp tiles of 16; S and dP over all keys
    with np.errstate(over="ignore"):
        s = over_d(q, k)                                # [B,H,W,Lk/8,32,4]
        dp = over_d(do, v)
        r, c = _rows(s), _cols(s)                       # query, key
        ok = vis[:, :, r, c]
        pr = np.exp2(s * scale_log2 - lse2[:, :, r]).astype(np.float32)
        pr = np.where(ok, pr, np.float32(0))
        ds = (pr * (dp - delta[:, :, r]) * scale).astype(np.float32)
    dq = _over_rows(np.zeros((b, h, lq // 16, d // 8, 32, 4), np.float32),
                    ds, k, passes, split_fn)

    # K3: rows are keys; S^T and dP^T over all queries
    with np.errstate(over="ignore"):
        st = over_d(k, q)                               # [B,H,Wk,Lq/8,32,4]
        dpt = over_d(v, do)
        r, c = _rows(st), _cols(st)                     # key, query
        ok = vis[:, :, c, r]
        pt = np.exp2(st * scale_log2 - lse2[:, :, c]).astype(np.float32)
        pt = np.where(ok, pt, np.float32(0))
        dst = (pt * (dpt - delta[:, :, c]) * scale).astype(np.float32)
    acc = np.zeros((b, h, lk // 16, d // 8, 32, 4), np.float32)
    dv = _over_rows(acc, pt, do, passes, split_fn)
    dk = _over_rows(np.zeros_like(acc), dst, q, passes, split_fn)
    dk, dv = _to_matrix(dk), _to_matrix(dv)
    if mask is not None:
        # rows that see no key give dO / Lk to every key's dV (a prefix
        # of each batch row's queries, summed in order)
        empty = ~vis.any(-1)                            # [B, H, Lq]
        e = np.zeros((b, h, 1, d), np.float32)
        for i in range(lq):
            e += np.where(empty[:, :, i, None, None], do[:, :, i:i + 1],
                          np.float32(0))
        dv = (dv + e * np.float32(1.0 / lk)).astype(np.float32)
    return _to_matrix(dq), dk, dv, delta


# name -> (b, lq, lk, causal, mask kind or None)
KINDS = {
    "plain": (1, 128, 128, False, None),
    "causal_cross": (1, 64, 192, True, None),
    # batch row 1 has no real key: all its rows see nothing
    "masked": (3, 128, 128, False, "all_zero_row"),
    # batch row 1 has 2 real keys, so P is near 1/2 down 320 rows: the
    # sums over the sequence pass a flush
    "long_prefix": (3, 320, 320, False, "prefix"),
}
# above D = 128, where no call takes a mask
WIDE_KINDS = {
    "plain": (1, 64, 64, False, None),
    "causal": (1, 128, 128, True, None),
    "causal_cross": (1, 64, 128, True, None),
}


def _inputs(kind, d, seed):
    b, lq, lk, causal, mask_kind = (WIDE_KINDS if d > 128 else KINDS)[kind]
    rng = np.random.RandomState(seed)
    # not symmetric: q, k, v and dO differ in scale and offset
    q = 1.5 * rng.randn(b, 2, lq, d).astype(np.float32)
    k = rng.randn(b, 2, lk, d).astype(np.float32)
    v = rng.randn(b, 2, lk, d).astype(np.float32) + 0.25
    do = 0.5 * rng.randn(b, 2, lq, d).astype(np.float32)
    m = None if mask_kind is None else _mask(mask_kind, b, lk, seed + 1)
    return q, k, v, do, m, causal


def _reference(kind, d, seed):
    """(inputs, out, lse [B*H, Lq], [dq, dk, dv]): the forward's out and
    lse (the Pallas forward at D % 64 == 0, else the port's plain
    forward), and ``_flash_bwd``'s gradients (Pallas, interpret mode), or
    with a mask ``jax.grad`` of the einsum path."""
    q, k, v, do, m, causal = _inputs(kind, d, seed)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    if m is not None:
        o, lse = fa.flash_attention_reference(
            *map(torch.from_numpy, (q, k, v)), causal, None, True,
            torch.from_numpy(m))
        o, lse = o.numpy(), lse.numpy()

        def f(q_, k_, v_):
            return jnp.sum(_jax_einsum(q_, k_, v_, m, causal) * jdo)

        want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    else:
        if d % 64 == 0:
            jo, jlse = _flash_fwd(jq, jk, jv, causal, scale, 64, 64,
                                  with_lse=True)
            o, lse = np.asarray(jo), np.asarray(jlse[..., 0])
        else:
            to, tlse = fa.flash_attention_reference(
                *map(torch.from_numpy, (q, k, v)), causal, None, True)
            o, lse = to.numpy(), tlse.numpy()
            jo = jnp.asarray(o)
            jlse = jnp.broadcast_to(jnp.asarray(lse)[..., None],
                                    lse.shape + (128,))
        want = _flash_bwd(jq, jk, jv, jo, jlse, jdo, causal, scale, 64, 64)
    return (q, k, v, do, m, causal, scale), o, lse, [np.asarray(w)
                                                     for w in want]


def _excess(got, want):
    """The largest |got - want| as a share of TOL * (1 + |want|)."""
    return (np.abs(got - want) / (TOL * (1 + np.abs(want)))).max()


class TestEmulation:
    @pytest.mark.parametrize("kind", sorted(KINDS))
    @pytest.mark.parametrize("d", [8, 32, 64, 120, 128])
    def test_3xtf32_matches_the_reference(self, d, kind):
        """The kernels' arithmetic (3xTF32 on fragments, the relabelled
        A fragments, P = 0 for masked pairs, the dV share of rows that
        see no key) within 1e-4 * (1 + |ref|) of the JAX package's
        backward, and delta within that of rowsum(dO * O)."""
        (q, k, v, do, m, causal, scale), o, lse, want = _reference(
            kind, d, seed=d + len(kind))
        dq, dk, dv, delta = emulate_bwd(q, k, v, o, lse, do, causal, scale,
                                        m)
        for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            assert got.shape == w.shape and np.isfinite(got).all(), name
            assert _excess(got, w) <= 1, (name, np.abs(got - w).max())
        assert _excess(delta, (do.astype(np.float64)
                               * o.astype(np.float64)).sum(-1)) <= 1
        if kind == "masked":
            # padded keys: exactly zero dK; batch row 1 (no real key):
            # zero dQ for every row, dV = sum of dO / Lk for every key
            pad = (m == 0)[:, None, :, None]
            assert not np.broadcast_to(pad, dk.shape)[dk != 0].any()
            assert not dq[1].any()
            np.testing.assert_allclose(
                dv[1], np.broadcast_to(do[1].sum(1, keepdims=True)
                                       / k.shape[2], dv[1].shape),
                rtol=1e-5, atol=1e-6)

    def test_one_tf32_pass_fails_the_tolerance(self):
        """At D = 128, Lq = Lk = 128, seed 0, a single TF32 product (hi·hi
        only) misses 1e-4 * (1 + |ref|) where three products hold it:
        the reason the kernels take three."""
        (q, k, v, do, m, causal, scale), o, lse, want = _reference(
            "plain", 128, seed=0)
        three = emulate_bwd(q, k, v, o, lse, do, causal, scale, m)[:3]
        one = emulate_bwd(q, k, v, o, lse, do, causal, scale, m,
                          passes=1)[:3]
        assert max(_excess(g, w) for g, w in zip(three, want)) <= 1
        assert max(_excess(g, w) for g, w in zip(one, want)) > 1

    @pytest.mark.parametrize("kind", sorted(WIDE_KINDS))
    @pytest.mark.parametrize("d", [192, 320, 512])
    def test_wide_3xtf32_matches_the_reference(self, d, kind):
        """Above D = 128 (two warps a row group at 192, four at 320 and
        512): the slices' partial S and dP (S^T and dP^T) summed in
        order, the raw split, the relabelled A fragments, the flushes;
        within 1e-4 * (1 + |ref|) of ``_flash_bwd`` (Pallas, interpret
        mode), causal or not and causal with Lq < Lk, and delta within
        that of rowsum(dO * O)."""
        (q, k, v, do, m, causal, scale), o, lse, want = _reference(
            kind, d, seed=d + len(kind))
        dq, dk, dv, delta = emulate_bwd(q, k, v, o, lse, do, causal, scale)
        for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            assert got.shape == w.shape and np.isfinite(got).all(), name
            assert _excess(got, w) <= 1, (name, np.abs(got - w).max())
        assert _excess(delta, (do.astype(np.float64)
                               * o.astype(np.float64)).sum(-1)) <= 1

    def test_one_tf32_pass_fails_the_tolerance_at_512(self):
        """The same at D = 512, where four warps each take 128 dims: a
        single TF32 product misses the tolerance that three hold."""
        (q, k, v, do, m, causal, scale), o, lse, want = _reference(
            "causal", 512, seed=1)
        three = emulate_bwd(q, k, v, o, lse, do, causal, scale)[:3]
        one = emulate_bwd(q, k, v, o, lse, do, causal, scale,
                          passes=1)[:3]
        assert max(_excess(g, w) for g, w in zip(three, want)) <= 1
        assert max(_excess(g, w) for g, w in zip(one, want)) > 1

    @pytest.mark.parametrize("d", [320, 512])
    def test_partials_sum_in_one_order(self, d):
        """Above D = 256 four warps add their partial S and dP. Float
        addition is not associative: summed in another order some bits of
        S and of dS = P * (dP - delta) * scale differ, so warps that each
        took their own first would add different dS to their slices of
        dQ (or dK and dV). Every warp adds them in one order, slice 0
        first. Two partials (D = 192, 256) commute, so a pair never
        needed it."""
        rng = np.random.RandomState(d)
        q = 1.5 * rng.randn(1, 1, 16, d).astype(np.float32)
        k = rng.randn(1, 1, 64, d).astype(np.float32)
        v = rng.randn(1, 1, 64, d).astype(np.float32) + 0.25
        do = 0.5 * rng.randn(1, 1, 16, d).astype(np.float32)
        s_parts, dp_parts = partials(q, k, 3), partials(do, v, 3)
        assert len(s_parts) == len(dp_parts) == wide_split(d) == 4
        scale = np.float32(1 / np.sqrt(d))
        scale_log2 = np.float32(scale * 1.4426950408889634)
        # a row's log2-sum-exp and a delta, as K2 reads them
        exact = np.einsum("bhid,bhjd->bhij", q.astype(np.float64),
                          k.astype(np.float64)) * scale
        lse2 = np.float32(np.log2(np.exp(exact).sum(-1)).max())
        delta = np.float32(0.125)

        def s_and_ds(order=None):
            sc = in_order(s_parts, order)
            dp = in_order(dp_parts, order)
            pr = np.exp2(sc * scale_log2 - lse2).astype(np.float32)
            return sc, (pr * (dp - delta) * scale).astype(np.float32)

        fixed_s, fixed_ds = s_and_ds()
        for order in ([3, 2, 1, 0], [0, 2, 1, 3]):
            other_s, other_ds = s_and_ds(order)
            assert (fixed_s != other_s).any() and (fixed_ds != other_ds).any()
        pair = partials(q[..., :256], k[..., :256], 3)
        np.testing.assert_array_equal(pair[0] + pair[1], pair[1] + pair[0])

    def test_relabelled_fragments_contract_the_right_columns(self):
        """The relabelling alone, on one block of 8 columns: the A
        fragment {c0, c2, c1, c3} of a 16 x 8 accumulator times B
        gathered from rows 2t and 2t + 1 is the plain product, and the
        accumulator's own order {c0, c1, c2, c3} is not."""
        rng = np.random.RandomState(3)
        x = tf32(rng.randn(16, 8).astype(np.float32))
        y = tf32(rng.randn(8, 8).astype(np.float32))
        xf = x[C_RC[0], C_RC[1]]                        # accumulator frags
        yf = np.stack([y[2 * T, G], y[2 * T + 1, G]], -1)
        zero = np.zeros((32, 4), np.float32)
        got = _to_matrix(mma(zero, xf[:, RELABEL], yf)[None, None])
        np.testing.assert_allclose(got, x @ y, rtol=1e-6, atol=1e-6)
        wrong = _to_matrix(mma(zero, xf, yf)[None, None])
        assert not np.allclose(wrong, x @ y, atol=1e-3)
