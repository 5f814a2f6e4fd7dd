"""PyTorch port, K1's Hopper forward at the K5b head dims and under the
key-padding mask (``csrc/flash_attn_fwd_sm90.cu``): the route that sends
every bf16 call at a head dim up to 128, masked or not, to it
(``_fwd_entry``), K2's and K3's route beside it (``_bwd_entry``), what the
wrapper hands its entry point (the mask's pointer and batch stride, the
head dim it runs at, the lse pointer, the scale and the causal flag) and
counts, and K1's plain version (what the kernel is held to on the card
by ``chip_smoke.py``) against the JAX package's einsum path at the shapes
the kernel must get right: a masked call whose last 128-row block ends
half-way (Lq = 192), head dims of 8 mod 16 with the logsumexp, causal
Lq < Lk with a left-padded batch row (rows that see no key), and a batch
row with no real token (the mean of V, logsumexp -1e30).

The reference is the einsum path (``_einsum_attention``, and for the
logsumexp the same logits with the same -1e30 fills): on the TPU these
calls go to JAX's stock Pallas ``flash_attention``, which has no CPU mode
(see ``tests/test_torch_port_k5b_bwd.py``), and the port follows the
einsum path at every row. The CUDA kernel itself cannot run here (no
card, no nvcc): where a test stands in for the card, the wrappers' CUDA
branch runs on meta tensors with spies for the entry points
(``fake_card``). Inputs are made with numpy and fed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.attention import NEG_INF, _einsum_attention
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from tests.test_torch_port_k5b_bwd import fake_card  # noqa: F401

torch.set_num_threads(2)

SM90 = "zoo_flash_attn_fwd_sm90"
BWD_SM90 = ("zoo_flash_attn_bwd_dq_sm90", "zoo_flash_attn_bwd_dkv_sm90")
# where the entry point takes each argument
LSE_ARG, D_ARG, MASK_ARG, MASK_SB_ARG, SCALE_ARG, CAUSAL_ARG = (
    4, 10, 23, 24, 25, 26)
BF16 = torch.bfloat16
# f32 on both sides: exact arithmetic in another order; bf16 on both
# sides (test_torch_port_sm90_fwd.py's): the einsum path rounds P to
# bf16 before P V, the plain version keeps it in f32, and both round
# the output (2^-7 relative)
ATOL, LSE_ATOL = 2e-5, 1e-5
BF16_TOL, BF16_LSE_TOL = 2e-2, 1e-3


class TestRoute:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("dp", range(8, 129, 8))
    def test_bf16_up_to_128_takes_the_hopper_kernel(self, dp, masked):
        """Every head dim a bf16 call runs at up to 128 (the wrappers pad
        the others to a multiple of 8), with a mask or without, takes
        ``flash_attn_fwd_sm90.cu``."""
        assert dp in fa.SM90_FWD_HEAD_DIMS
        assert fa._fwd_entry(BF16) == SM90

    @pytest.mark.parametrize("dp", [320, 384, 448, 512])
    def test_bf16_above_256_keeps_the_older_source(self, dp):
        """bf16 above 256 (no mask) takes the Hopper kernel too, the
        source that kept it before (``flash_attn_fwd.cu``) being gone."""
        assert dp in fa.SM90_FWD_HEAD_DIMS
        assert fa._fwd_entry(BF16) == SM90
        assert not (fa._CSRC / "flash_attn_fwd.cu").exists()

    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("dp", range(8, 129, 8))
    def test_bwd_entry_is_unchanged(self, dp, masked):
        """K2 and K3 take their Hopper kernels at every head dim K1 takes
        its own up to 128, masked or not (the older bf16 templates there
        are retired)."""
        assert fa._bwd_entry(BF16) == BWD_SM90

    def test_backward_set_is_not_widened(self):
        """The backward's Hopper head dims are the forward's, no wider:
        every multiple of 8 up to 128 and 192 to 512 (the split templates
        above 256 in both directions)."""
        assert fa.SM90_HEAD_DIMS == fa.SM90_FWD_HEAD_DIMS
        assert fa.SM90_FWD_HEAD_DIMS == tuple(range(8, 129, 8)) + (
            192, 256, 320, 384, 448, 512)

    def test_entry_takes_the_old_arguments(self):
        """The Hopper entry takes the f32 entry's arguments, the mask's
        pointer and batch stride among them (at MASK_ARG and
        MASK_SB_ARG)."""
        argtypes = fa._ENTRY_POINTS[SM90][1]
        assert argtypes == fa._ENTRY_POINTS["zoo_flash_attn_fwd_f32tc"][1]
        assert (argtypes[MASK_ARG], argtypes[MASK_SB_ARG]) == (fa._P, fa._L)
        assert argtypes[D_ARG] == fa._I


def _meta(d, b=2, h=3, lq=192, lk=256, grad=False):
    return [torch.empty(b, h, n, d, device="meta", dtype=BF16,
                        requires_grad=grad) for n in (lq, lk, lk)]


@pytest.fixture
def counts(monkeypatch, fake_card):
    monkeypatch.setattr(fa.flash_attention, "sm90_launches", 0)
    monkeypatch.setattr(fa.flash_attention, "wide_d_launches", 0)
    for w in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        monkeypatch.setattr(w, "sm90_launches", 0)
    return fake_card


class TestLaunches:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("with_lse", [False, True])
    @pytest.mark.parametrize("d", [20, 32, 40, 64, 80, 128])
    def test_masked_call_reaches_the_hopper_entry(self, counts, d, with_lse,
                                                  causal):
        """Off the CPU (meta tensors, spied entry points) a masked bf16
        call launches the Hopper kernel once, with the mask's pointer and
        batch stride, the head dim it runs at, the lse pointer, the true
        head dim's scale and the causal flag, and counts in ``launches``,
        ``masked_launches``, ``sm90_launches`` and, off a multiple of 64,
        ``small_d_launches``."""
        q, k, v = _meta(d)
        m = torch.ones(2, 256, dtype=torch.uint8, device="meta")
        got = fa.flash_attention(q, k, v, causal, None, with_lse, m)
        out = got[0] if with_lse else got
        assert out.shape == q.shape and out.dtype == BF16
        assert [name for name, _ in counts] == [SM90]
        args = counts[0][1]
        assert len(args) == len(fa._ENTRY_POINTS[SM90][1])
        assert args[D_ARG] == fa._kernel_head_dim(d)
        assert args[8:10] == (192, 256)  # lq, lk
        assert args[MASK_ARG] is not None and args[MASK_SB_ARG] == 256
        assert (args[LSE_ARG] is not None) == with_lse
        assert args[SCALE_ARG] == pytest.approx(1 / np.sqrt(d))
        assert args[CAUSAL_ARG] == int(causal)
        w = fa.flash_attention
        assert (w.launches, w.masked_launches, w.sm90_launches,
                w.small_d_launches, w.wide_d_launches) == (
            1, 1, 1, int(fa._kernel_head_dim(d) % 64 != 0), 0)

    @pytest.mark.parametrize("d", [8, 20, 32, 48, 80, 120])
    def test_k5b_call_reaches_the_hopper_entry(self, counts, d):
        """An unmasked bf16 call at a K5b head dim (20 padded to 24)
        launches the Hopper kernel with a null mask."""
        q, k, v = _meta(d)
        fa.flash_attention(q, k, v, True)
        assert [name for name, _ in counts] == [SM90]
        args = counts[0][1]
        assert args[D_ARG] == fa._kernel_head_dim(d)
        assert args[MASK_ARG] is None and args[MASK_SB_ARG] == 0
        assert args[CAUSAL_ARG] == 1
        w = fa.flash_attention
        assert (w.launches, w.masked_launches, w.sm90_launches,
                w.small_d_launches) == (1, 0, 1, 1)

    def test_any_mask_dtype_reaches_it_as_bytes(self, counts):
        """An int32 mask is handed over as contiguous bytes, one a key
        (the batch stride in bytes is Lk)."""
        q, k, v = _meta(32)
        m = torch.ones(2, 256, dtype=torch.int32, device="meta")
        fa.flash_attention(q, k, v, False, key_padding_mask=m)
        assert counts[0][1][MASK_SB_ARG] == 256

    @pytest.mark.parametrize("d", [32, 64])
    def test_gradient_runs_hopper_k1_lse_then_older_k2_k3(self, counts, d):
        """Under ``FlashAttention`` a masked bf16 call runs K1-lse on the
        Hopper kernel (with the lse and the mask) and K2 then K3 on
        theirs (with the mask, the older templates being retired); each
        counts in ``sm90_launches``."""
        q, k, v = _meta(d, lq=256, grad=True)
        m = torch.ones(2, 256, dtype=torch.uint8, device="meta")
        out = fa.flash_attention(q, k, v, False, key_padding_mask=m)
        grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
        assert all(g.shape == q.shape for g in grads)
        assert [name for name, _ in counts] == [SM90, *BWD_SM90]
        args = counts[0][1]
        assert args[LSE_ARG] is not None and args[MASK_ARG] is not None
        # the backward entries take the mask at 32
        assert all(a[32] is not None for _, a in counts[1:])
        assert [w.sm90_launches for w in (
            fa.flash_attention, fa.flash_attention_bwd_dq,
            fa.flash_attention_bwd_dkv)] == [1, 1, 1]


def _mask(kind, b, lk, seed):
    """[B, Lk] int32 key-padding masks (1 = real token): batch row 0 full,
    the others "prefix" (real lengths in [2, Lk]), "left" (row 1 holds
    its 40 real keys at the right end), or "zero_row" (prefix, row 1 with
    no real token)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(2, lk + 1, b)
    lens[0] = lk
    pos = np.arange(lk)[None, :]
    m = pos < lens[:, None]
    if kind == "left":
        m[1] = pos[0] >= lk - 40
    elif kind == "zero_row":
        m[1] = False
    return m.astype(np.int32)


# name -> (b, h, lq, lk, d, causal, mask kind or None)
CASES = {
    # a 128-row block that ends half-way, masked, at one and two slabs
    "half_block_d32": (2, 2, 192, 192, 32, False, "prefix"),
    "half_block_d64": (2, 2, 192, 192, 64, False, "prefix"),
    "half_block_d80": (2, 2, 192, 192, 80, True, "prefix"),
    # D = 8 mod 16: the last k-step half zeros, unmasked and masked
    "d24": (1, 3, 128, 128, 24, True, None),
    "d40": (1, 3, 128, 128, 40, True, None),
    "d40_masked": (3, 2, 128, 128, 40, False, "prefix"),
    # causal Lq < Lk, batch row 1 left-padded: its rows 0-23 see no key
    "cross_left": (2, 2, 64, 192, 48, True, "left"),
    # a batch row with no real token: the mean of V, lse -1e30
    "zero_row": (3, 2, 128, 128, 32, False, "zero_row"),
    "zero_row_d120": (3, 2, 128, 128, 120, False, "zero_row"),
}


def _case(name, seed=0):
    b, h, lq, lk, d, causal, kind = CASES[name]
    rng = np.random.RandomState(seed + d + lq)
    # not symmetric: q, k and v differ in scale and offset
    q = 1.5 * rng.randn(b, h, lq, d).astype(np.float32)
    k = rng.randn(b, h, lk, d).astype(np.float32)
    v = rng.randn(b, h, lk, d).astype(np.float32) + 0.25
    m = None if kind is None else _mask(kind, b, lk, seed)
    return q, k, v, m, causal


def _einsum_with_lse(q, k, v, m, causal):
    """The JAX package's einsum path, and the natural-log logsumexp of
    the same logits with the same -1e30 fills ([B*H, Lq])."""
    mask = None if m is None else jnp.asarray(m)[:, None, None, :]
    out = _einsum_attention(q, k, v, mask=mask, causal=causal)
    lq, lk = q.shape[2], k.shape[2]
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                        preferred_element_type=jnp.float32)
    logits = logits / np.sqrt(q.shape[-1])
    if causal:
        keep = jnp.tril(jnp.ones((lq, lk), bool), k=lk - lq)[None, None]
        logits = jnp.where(keep, logits, NEG_INF)
    if mask is not None:
        logits = jnp.where(mask.astype(bool), logits, NEG_INF)
    lse = jax.nn.logsumexp(logits, axis=-1)
    return out, lse.reshape(-1, lq)


def _empty_rows(m, lq, lk, causal):
    """[B, Lq] bool: the rows that see no key."""
    keep = np.broadcast_to(m[:, None, :] != 0, (m.shape[0], lq, lk))
    if causal:
        keep = keep & np.tril(np.ones((lq, lk), bool), lk - lq)[None]
    return ~keep.any(-1)


class TestPlainAgainstEinsum:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_matches_einsum_path(self, name, dtype):
        """K1's plain version with its logsumexp (the wrapper's CPU path)
        against the einsum path, at the shapes the Hopper kernel must
        get right."""
        q, k, v, m, causal = _case(name)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        out, lse = _einsum_with_lse(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                    m, causal)
        got, got_lse = fa.flash_attention(
            *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal,
            with_lse=True,
            key_padding_mask=None if m is None else torch.from_numpy(m))
        b, h, lq, d = q.shape
        assert got.dtype == tdt and got.shape == (b, h, lq, d)
        assert got_lse.shape == (b * h, lq)
        want = np.asarray(out.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
            np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse),
                                       atol=LSE_ATOL)
        else:
            np.testing.assert_allclose(got.float().numpy(), want,
                                       atol=BF16_TOL, rtol=BF16_TOL)
            np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse),
                                       atol=BF16_LSE_TOL)

    @pytest.mark.parametrize("name", ["cross_left", "zero_row",
                                      "zero_row_d120"])
    def test_rows_without_a_key(self, name):
        """A row that sees no key: the mean of V over all Lk keys, and
        logsumexp ``EMPTY_LSE`` (-1e30, what f32 logsumexp of the
        einsum path's filled row gives)."""
        q, k, v, m, causal = _case(name)
        b, h, lq, d = q.shape
        lk = k.shape[2]
        empty = _empty_rows(m, lq, lk, causal)
        assert empty.any()
        got, got_lse = fa.flash_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), causal,
            with_lse=True, key_padding_mask=torch.from_numpy(m))
        mean = v.mean(axis=2)                                  # [B, H, D]
        rows = np.broadcast_to(empty[:, None, :], (b, h, lq))
        want = np.broadcast_to(mean[:, :, None, :], got.shape)[rows]
        np.testing.assert_allclose(got.numpy()[rows], want, atol=ATOL)
        lse = got_lse.numpy().reshape(b, h, lq)
        assert (lse[rows] == fa.EMPTY_LSE).all()
        assert (lse[~rows] > -1e29).all()
