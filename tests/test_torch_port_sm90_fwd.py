"""PyTorch port, K1's Hopper forward (``csrc/flash_attn_fwd_sm90.cu``):
the route that sends every bf16 call to it (``_fwd_entry``: every head
dim up to 128, masked or not, and without a key-padding mask 192 to 512;
the K5b and masked calls in detail in
``test_torch_port_sm90_masked_fwd.py``), what the wrapper hands its
entry point and counts, and K1's plain version (what the kernel is held
to on the card by ``chip_smoke.py``) against the JAX package's Pallas
kernel ``_flash_fwd`` in interpret mode at the shapes the kernel must
get right: an odd number of 64-row q blocks (its 128-row blocks end on a
half one; above 256 three 64-row blocks), Lq < Lk causal (the
bottom-right diagonal), Lk past the last whole 128-key tile, and the
logsumexp at 192 to 512.

The CUDA kernel itself cannot run here (no card, no nvcc). Where a test
stands in for the card, the wrappers' CUDA branch runs on meta tensors
with spies for the entry points (``fake_card``). Inputs are made with
numpy and fed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.pallas_attention import _flash_fwd
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from tests.test_torch_port_k5b_bwd import D_ARG, fake_card  # noqa: F401

torch.set_num_threads(2)

SM90 = "zoo_flash_attn_fwd_sm90"
F32TC = "zoo_flash_attn_fwd_f32tc"
# where the entry point takes its lse pointer, mask pointer, causal flag
# and scale
LSE_ARG, MASK_ARG, CAUSAL_ARG, SCALE_ARG = 4, 23, 26, 25
# f32 on both sides: exact arithmetic in another order (the tolerances
# test_torch_port_wide_d.py holds the plain version to); bf16 on both
# sides: the Pallas kernel rounds P to bf16 before P V, the plain version
# keeps it in f32, and both round the output (2^-7 relative)
ATOL, LSE_ATOL = 2e-5, 1e-5
BF16_TOL, BF16_LSE_TOL = 2e-2, 1e-3


class TestRoute:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", fa.HEAD_DIMS)
    def test_fwd_entry(self, fake_card, d, dtype, masked):
        """Every bf16 call takes the Hopper kernel, 320 to 512 among
        them; every f32 call the f32 tensor-core kernel (``_fwd_entry``),
        and a call through the wrapper (meta tensors, spied entry points)
        launches there at its head dim. A mask above 128 reaches no
        kernel: the call raises first."""
        want = SM90 if dtype == torch.bfloat16 else F32TC
        assert fa._fwd_entry(dtype) == want
        q, k, v = _meta(d, dtype)
        m = (torch.ones(2, 128, dtype=torch.uint8, device="meta")
             if masked else None)
        if masked and d > 128:
            with pytest.raises(NotImplementedError, match="masked"):
                fa.flash_attention(q, k, v, key_padding_mask=m)
            assert fake_card == []
            return
        fa.flash_attention(q, k, v, key_padding_mask=m)
        assert [(name, args[D_ARG[name]]) for name, args in fake_card] == [
            (want, d)]

    def test_entry_points_are_registered(self):
        """The Hopper entry takes q, k, v, o and lse, the dtype, the
        shape and head dim, the strides of q, k, v and o, the mask
        pointer and its batch stride, the scale, the causal flag and the
        stream: the f32 entry's arguments."""
        stem, argtypes = fa._ENTRY_POINTS[SM90]
        assert stem == "flash_attn_fwd_sm90"
        assert (fa._CSRC / f"{stem}.cu").is_file()
        P, I, L = fa._P, fa._I, fa._L
        assert argtypes == ([P] * 5 + [I] * 6 + [L] * 12
                            + [P, L, fa.ctypes.c_float, I, P])
        assert argtypes == fa._ENTRY_POINTS[F32TC][1]
        # the source the Hopper kernel retired is gone
        assert not (fa._CSRC / "flash_attn_fwd.cu").exists()
        assert "zoo_flash_attn_fwd" not in fa._ENTRY_POINTS


def _meta(d, dtype=torch.bfloat16, grad=False, b=2, h=3, lq=128, lk=128):
    return [torch.empty(b, h, n, d, device="meta", dtype=dtype,
                        requires_grad=grad) for n in (lq, lk, lk)]


@pytest.fixture
def sm90_count(monkeypatch, fake_card):
    monkeypatch.setattr(fa.flash_attention, "sm90_launches", 0)
    monkeypatch.setattr(fa.flash_attention, "wide_d_launches", 0)
    return fake_card


class TestLaunches:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("with_lse", [False, True])
    @pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 384, 448, 512])
    def test_bf16_call_reaches_sm90(self, sm90_count, d, with_lse, causal):
        """Off the CPU (meta tensors, spied entry points) a bf16 call
        without a mask launches the Hopper kernel once, with its head
        dim, lse pointer, scale and causal flag, and counts in
        ``sm90_launches`` (and ``launches``, and above 128 in
        ``wide_d_launches``): at 320 to 512 too."""
        q, k, v = _meta(d, lq=192, lk=256)
        got = fa.flash_attention(q, k, v, causal, None, with_lse)
        out = got[0] if with_lse else got
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        assert [name for name, _ in sm90_count] == [SM90]
        args = sm90_count[0][1]
        assert args[D_ARG[SM90]] == d
        assert args[8:10] == (192, 256)  # lq, lk
        assert (args[LSE_ARG] is not None) == with_lse
        assert args[MASK_ARG] is None
        assert args[CAUSAL_ARG] == int(causal)
        assert args[SCALE_ARG] == pytest.approx(1 / np.sqrt(d))
        assert len(args) == len(fa._ENTRY_POINTS[SM90][1])
        w = fa.flash_attention
        assert (w.launches, w.sm90_launches, w.masked_launches,
                w.small_d_launches, w.wide_d_launches) == (
            1, 1, 0, 0, int(d > 128))

    @pytest.mark.parametrize("d", [64, 128, 192, 256])
    def test_gradient_runs_sm90_then_k2_k3(self, sm90_count, d):
        """Under ``FlashAttention`` the forward is K1-lse on the Hopper
        kernel (with an lse), the backward K2 then K3 (on their Hopper
        kernels since ``flash_attn_bwd_sm90.cu``)."""
        q, k, v = _meta(d, grad=True)
        out = fa.flash_attention(q, k, v, True)
        grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
        assert all(g.shape == q.shape for g in grads)
        assert [name for name, _ in sm90_count] == [
            SM90, "zoo_flash_attn_bwd_dq_sm90", "zoo_flash_attn_bwd_dkv_sm90"]
        assert sm90_count[0][1][LSE_ARG] is not None
        assert fa.flash_attention.sm90_launches == 1

    @pytest.mark.parametrize("d", [320, 384, 448, 512])
    def test_gradient_above_256_runs_sm90_then_older_k2_k3(
            self, monkeypatch, sm90_count, d):
        """Above 256 ``FlashAttention``'s K1-lse runs on the Hopper kernel
        (with an lse, at the head dim), then K2 and K3 on the Hopper
        kernels' split templates (``flash_attn_bwd_sm90.cu``, which took
        them from the retired ``mma.sync`` ones); every launch is a wide
        one and counts in ``sm90_launches``."""
        for w in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
            for name in ("sm90_launches", "wide_d_launches"):
                monkeypatch.setattr(w, name, 0)
        q, k, v = _meta(d, grad=True)
        out = fa.flash_attention(q, k, v, True)
        grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
        assert all(g.shape == q.shape for g in grads)
        assert [(name, args[D_ARG[name]]) for name, args in sm90_count] == [
            (SM90, d), ("zoo_flash_attn_bwd_dq_sm90", d),
            ("zoo_flash_attn_bwd_dkv_sm90", d)]
        assert sm90_count[0][1][LSE_ARG] is not None
        assert sm90_count[0][1][CAUSAL_ARG] == 1
        wrappers = (fa.flash_attention, fa.flash_attention_bwd_dq,
                    fa.flash_attention_bwd_dkv)
        assert [w.sm90_launches for w in wrappers] == [1, 1, 1]
        assert [w.wide_d_launches for w in wrappers] == [1, 1, 1]

    @pytest.mark.parametrize("with_lse", [False, True])
    @pytest.mark.parametrize("d", [192, 320, 384, 448, 512])
    def test_mask_above_128_reaches_no_kernel(self, sm90_count, d, with_lse):
        """A bf16 call with a key-padding mask above 128 raises before
        any launch and counts nothing (the dispatch takes the einsum path
        for such a call)."""
        q, k, v = _meta(d)
        m = torch.ones(2, 128, dtype=torch.uint8, device="meta")
        with pytest.raises(NotImplementedError, match="masked"):
            fa.flash_attention(q, k, v, True, None, with_lse, m)
        assert sm90_count == []
        assert (fa.flash_attention.launches,
                fa.flash_attention.sm90_launches) == (0, 0)

    @pytest.mark.parametrize("kind,d,dtype,masked", [
        ("masked", 64, torch.bfloat16, True),
        ("f32", 64, torch.float32, False),
        ("f32_wide", 256, torch.float32, False),
        ("k5b", 80, torch.bfloat16, False),
        ("k5b_padded", 20, torch.bfloat16, False),
        ("split", 512, torch.bfloat16, False),
    ])
    def test_other_calls_keep_the_old_entry(self, sm90_count, kind, d,
                                            dtype, masked):
        """A masked bf16 call, bf16 K5b (D = 80, and 20 padded to 24) and
        bf16 at D = 512 reach the Hopper entry too, the mask's pointer
        with them, and count in ``sm90_launches``; f32 (D = 64 and 256)
        keeps the f32 tensor-core entry, which takes the same arguments,
        and does not count there."""
        q, k, v = _meta(d, dtype)
        m = (torch.ones(2, 128, dtype=torch.uint8, device="meta")
             if masked else None)
        fa.flash_attention(q, k, v, False, key_padding_mask=m)
        want = F32TC if dtype == torch.float32 else SM90
        assert [name for name, _ in sm90_count] == [want]
        args = sm90_count[0][1]
        assert args[D_ARG[want]] == fa._kernel_head_dim(d)
        assert (args[MASK_ARG] is not None) == masked
        assert fa.flash_attention.sm90_launches == int(want == SM90)
        assert fa.flash_attention.launches == 1


def _qkv(seed, b, h, lq, lk, d):
    rng = np.random.RandomState(seed)
    # not symmetric: q, k and v differ in scale and offset
    return (1.5 * rng.randn(b, h, lq, d).astype(np.float32),
            rng.randn(b, h, lk, d).astype(np.float32),
            rng.randn(b, h, lk, d).astype(np.float32) + 0.25)


class TestPlainAgainstPallas:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("causal,lq,lk", [
        (False, 192, 192),   # 3 q blocks of 64: the last 128-row block half
        (True, 192, 192),
        (True, 64, 192),     # Lq < Lk, the diagonal at offset 128
        (True, 192, 320),    # both, and Lk past the last 128-key tile
        (False, 64, 320),
    ])
    @pytest.mark.parametrize("d", [64, 128, 192, 256])
    def test_matches_pallas_kernel(self, d, causal, lq, lk, dtype):
        """K1's plain version against ``_flash_fwd`` with its
        logsumexp, at the new kernel's head dims."""
        q, k, v = _qkv(d + lq + lk + causal, 1, 2, lq, lk, d)
        scale = 1.0 / np.sqrt(d)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        out, lse = _flash_fwd(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                              causal, scale, 64, 64, with_lse=True)
        got, got_lse = fa.flash_attention(
            *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
            causal=causal, with_lse=True)
        assert got.dtype == tdt and got.shape == (1, 2, lq, d)
        assert got_lse.shape == (2, lq) and got_lse.dtype == torch.float32
        want = np.asarray(out.astype(jnp.float32))
        want_lse = np.asarray(lse)[..., 0]
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
            np.testing.assert_allclose(got_lse.numpy(), want_lse,
                                       atol=LSE_ATOL)
        else:
            np.testing.assert_allclose(got.float().numpy(), want,
                                       atol=BF16_TOL, rtol=BF16_TOL)
            np.testing.assert_allclose(got_lse.numpy(), want_lse,
                                       atol=BF16_LSE_TOL)

    @pytest.mark.parametrize("causal,lq,lk", [
        (False, 192, 192),   # three 64-row q blocks, an odd count
        (True, 192, 192),
        (True, 128, 384),    # Lq < Lk, the diagonal at offset 256
        (True, 192, 320),    # Lk not a multiple of 128
        (False, 64, 320),
    ])
    @pytest.mark.parametrize("d", [320, 384, 448, 512])
    def test_wider_bf16_matches_pallas_kernel(self, d, causal, lq, lk):
        """K1's plain version against ``_flash_fwd`` with its logsumexp
        in bf16 on both sides at the split kernel's head dims, at the
        shapes its 64-row q blocks must get right."""
        q, k, v = _qkv(d + lq + lk + causal, 1, 2, lq, lk, d)
        out, lse = _flash_fwd(*(jnp.asarray(a, jnp.bfloat16)
                                for a in (q, k, v)),
                              causal, 1.0 / np.sqrt(d), 64, 64,
                              with_lse=True)
        got, got_lse = fa.flash_attention(
            *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
            causal=causal, with_lse=True)
        assert got.dtype == torch.bfloat16 and got.shape == (1, 2, lq, d)
        assert got_lse.shape == (2, lq) and got_lse.dtype == torch.float32
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(out.astype(jnp.float32)),
                                   atol=BF16_TOL, rtol=BF16_TOL)
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[..., 0],
                                   atol=BF16_LSE_TOL)
