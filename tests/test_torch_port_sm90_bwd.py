"""PyTorch port, K2 and K3's Hopper kernels (``csrc/flash_attn_bwd_sm90.cu``):
the route that sends bf16 calls at head dims 64, 128, 192 and 256 to them
(``_bwd_entry``; every bf16 call: up to 128 masked or not, since the K5b
and masked slice, ``tests/test_torch_port_sm90_masked_bwd.py``, and at
320 to 512, ``tests/test_torch_port_sm90_wider_bwd.py``), what the
wrappers hand their entry points and count, and K2's and K3's plain
versions (what the
kernels are held to on the card by ``chip_smoke.py``) against the JAX
package's ``_flash_bwd`` (the dQ and dK/dV Pallas kernels in interpret
mode, and its jnp delta) at the shapes the new kernels must get right:
an odd number of 64-row q tiles (K2's 128-row blocks end on a half one),
and Lq < Lk causal (the bottom-right diagonal; K3's first q tile starts
mid-diagonal).

The CUDA kernels themselves cannot run here (no card, no nvcc). Where a
test stands in for the card, the wrappers' CUDA branch runs on meta
tensors with spies for the entry points (``fake_card``). Inputs are made
with numpy and fed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.pallas_attention import _flash_bwd, _flash_fwd
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from tests.test_torch_port_k5b_bwd import D_ARG, fake_card  # noqa: F401

torch.set_num_threads(2)

DQ, DKV = "zoo_flash_attn_bwd_dq_sm90", "zoo_flash_attn_bwd_dkv_sm90"
F32TC_DQ, F32TC_DKV = ("zoo_flash_attn_bwd_dq_f32tc",
                       "zoo_flash_attn_bwd_dkv_f32tc")
FWD_SM90 = "zoo_flash_attn_fwd_sm90"
# where the entries take their scale and causal flag, and the mask (the
# Hopper entries take the older ones' arguments, the mask's two among
# them)
SCALE_ARG, CAUSAL_ARG, MASK_ARG = 34, 35, 32
# |port - jax|: f32 on both sides is exact arithmetic in another order,
# within 2e-5; in bf16 both round dS and P to bf16 before their products
# and round the gradients (one bf16 ulp is 2^-7 relative), within
# 2e-2 * (1 + |jax|), chip_smoke.py's tolerance; delta is f32 on both
# sides
F32_ATOL, BF16_TOL, DELTA_ATOL = 2e-5, 2e-2, 1e-5


class TestRoute:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", fa.HEAD_DIMS)
    def test_bwd_entry(self, d, dtype, masked):
        """bf16 at every head dim (masked or not; a mask only up to 128,
        which ``_check_inputs`` enforces) takes the Hopper kernels, 320 to
        512 among them; f32 at every head dim the f32 tensor-core
        kernels. The route follows the dtype alone."""
        want = ((DQ, DKV) if dtype == torch.bfloat16
                else (F32TC_DQ, F32TC_DKV))
        assert d in fa.SM90_HEAD_DIMS
        assert fa._bwd_entry(dtype) == want

    @pytest.mark.parametrize("new,old", [(DQ, F32TC_DQ), (DKV, F32TC_DKV)])
    def test_entry_points_are_registered(self, new, old):
        stem, argtypes = fa._ENTRY_POINTS[new]
        assert stem == "flash_attn_bwd_sm90"
        assert (fa._CSRC / f"{stem}.cu").is_file()
        # the f32 entry's arguments, the mask pointer and stride included
        assert argtypes == fa._ENTRY_POINTS[old][1]


def _meta(d, dtype=torch.bfloat16, grad=False, b=2, h=3, lq=192, lk=256):
    return [torch.empty(b, h, n, d, device="meta", dtype=dtype,
                        requires_grad=grad) for n in (lq, lk, lk, lq)]


@pytest.fixture
def sm90_count(monkeypatch, fake_card):
    for w in (fa.flash_attention, fa.flash_attention_bwd_dq,
              fa.flash_attention_bwd_dkv):
        monkeypatch.setattr(w, "sm90_launches", 0)
        monkeypatch.setattr(w, "wide_d_launches", 0)
    return fake_card


def _lse(b=2, h=3, lq=192):
    return torch.empty(b * h, lq, device="meta", dtype=torch.float32)


class TestLaunches:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("d", [64, 128, 192, 256])
    def test_bf16_calls_reach_sm90(self, sm90_count, d, causal):
        """Off the CPU (meta tensors, spied entry points) K2 and K3 of a
        bf16 call without a mask launch the Hopper kernels once each,
        with the head dim, lengths, scale and causal flag, and count in
        ``sm90_launches`` (and ``launches``, and above 128 in
        ``wide_d_launches``)."""
        q, k, v, do = _meta(d)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, q, _lse(), do, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, _lse(), delta, do,
                                            causal)
        assert dq.shape == q.shape and dq.dtype == torch.bfloat16
        assert dk.shape == dv.shape == k.shape
        assert delta.shape == (6, 192) and delta.dtype == torch.float32
        assert [name for name, _ in sm90_count] == [DQ, DKV]
        for name, args in sm90_count:
            assert args[D_ARG[name]] == d
            assert args[11:13] == (192, 256)  # lq, lk
            assert args[MASK_ARG] is None
            assert args[SCALE_ARG] == pytest.approx(1 / np.sqrt(d))
            assert args[CAUSAL_ARG] == int(causal)
            assert len(args) == len(fa._ENTRY_POINTS[name][1])
        for w in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
            assert (w.launches, w.sm90_launches, w.masked_launches,
                    w.small_d_launches, w.wide_d_launches) == (
                1, 1, 0, 0, int(d > 128))

    @pytest.mark.parametrize("d", [64, 128, 192, 256])
    def test_gradient_runs_sm90_k1_k2_k3(self, sm90_count, d):
        """Under ``FlashAttention`` a bf16 call without a mask runs K1-lse,
        K2 and K3 on the Hopper kernels, in that order."""
        q, k, v, _ = _meta(d, grad=True, lq=256)
        out = fa.flash_attention(q, k, v, True)
        grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
        assert all(g.shape == q.shape for g in grads)
        assert [name for name, _ in sm90_count] == [FWD_SM90, DQ, DKV]
        for w in (fa.flash_attention, fa.flash_attention_bwd_dq,
                  fa.flash_attention_bwd_dkv):
            assert (w.launches, w.sm90_launches) == (1, 1)

    @pytest.mark.parametrize("kind,d,dtype,masked", [
        ("masked", 64, torch.bfloat16, True),
        ("masked_128", 128, torch.bfloat16, True),
        ("f32", 64, torch.float32, False),
        ("f32_wide", 256, torch.float32, False),
        ("k5b", 80, torch.bfloat16, False),
        ("k5b_padded", 20, torch.bfloat16, False),
        ("split", 512, torch.bfloat16, False),
    ])
    def test_other_calls_keep_the_old_entries(self, sm90_count, kind, d,
                                              dtype, masked):
        """A masked bf16 call (64 and 128), K5b (D = 80, and 20 padded
        to 24) and bf16 at D = 512 (the split templates) reach the Hopper
        entries too, counted in ``sm90_launches``; f32 (at 64 and at 256)
        the f32 tensor-core entries; all take the same arguments, and the
        mask's pointer goes with each."""
        q, k, v, do = _meta(d, dtype, lq=128, lk=128)
        m = (torch.ones(2, 128, dtype=torch.uint8, device="meta")
             if masked else None)
        lse = _lse(lq=128)
        _, delta = fa.flash_attention_bwd_dq(q, k, v, q, lse, do, False,
                                             key_padding_mask=m)
        fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, False,
                                   key_padding_mask=m)
        want = ([F32TC_DQ, F32TC_DKV] if dtype == torch.float32
                else [DQ, DKV])
        assert [name for name, _ in sm90_count] == want
        for name, args in sm90_count:
            assert args[D_ARG[name]] == fa._kernel_head_dim(d)
            assert (args[MASK_ARG] is not None) == masked
        for w in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
            assert (w.launches, w.sm90_launches) == (1, int(want[0] == DQ))


def _case(seed, lq, lk, d):
    rng = np.random.RandomState(seed)
    # not symmetric: q, k, v and dO differ in scale and offset
    return (1.5 * rng.randn(1, 2, lq, d).astype(np.float32),
            rng.randn(1, 2, lk, d).astype(np.float32),
            rng.randn(1, 2, lk, d).astype(np.float32) + 0.25,
            0.5 * rng.randn(1, 2, lq, d).astype(np.float32))


class TestPlainAgainstPallas:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("causal,lq,lk", [
        (False, 192, 192),   # 3 q tiles of 64: K2's last 128-row block half
        (True, 192, 192),
        (True, 64, 192),     # Lq < Lk: the diagonal at offset 128
    ])
    @pytest.mark.parametrize("d", [64, 128, 192, 256])
    def test_matches_pallas_kernels(self, d, causal, lq, lk, dtype):
        """K2's plain version (dQ and delta) and K3's (dK and dV), given
        the Pallas forward's out and logsumexp, against ``_flash_bwd``:
        the dQ and dK/dV Pallas kernels and the jnp delta."""
        q, k, v, do = _case(d + lq + lk + causal, lq, lk, d)
        scale = 1.0 / np.sqrt(d)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
        out, lse = _flash_fwd(jq, jk, jv, causal, scale, 64, 64,
                              with_lse=True)
        want = _flash_bwd(jq, jk, jv, out, lse, jdo, causal, scale, 64, 64)
        want_delta = jnp.sum(jdo.astype(jnp.float32)
                             * out.astype(jnp.float32), axis=-1)
        tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt)
                           for a in (q, k, v, do))
        to = torch.from_numpy(np.array(out.astype(jnp.float32))).to(tdt)
        tlse = torch.from_numpy(np.array(lse[..., 0]))
        dq, delta = fa.flash_attention_bwd_dq(tq, tk, tv, to, tlse, tdo,
                                              causal)
        dk, dv = fa.flash_attention_bwd_dkv(tq, tk, tv, tlse, delta, tdo,
                                            causal)
        assert delta.shape == (2, lq) and delta.dtype == torch.float32
        np.testing.assert_allclose(delta.numpy(),
                                   np.asarray(want_delta).reshape(2, lq),
                                   atol=DELTA_ATOL, rtol=1e-6)
        for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            assert g.dtype == tdt and g.shape == w.shape, name
            w = np.asarray(w.astype(jnp.float32))
            if dtype == "float32":
                np.testing.assert_allclose(g.numpy(), w, atol=F32_ATOL,
                                           err_msg=name)
            else:
                excess = (np.abs(g.float().numpy() - w)
                          - BF16_TOL * (1 + np.abs(w)))
                assert excess.max() <= 0, (name, np.abs(
                    g.float().numpy() - w).max())
