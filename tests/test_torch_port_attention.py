"""PyTorch port, attention: K1's plain version and the port's
``dot_product_attention`` held against the JAX package on the CPU.

The JAX kernel runs in Pallas interpret mode (as in
``test_transformer.py::TestPallasKernel``); the port's
``flash_attention`` takes a CPU tensor to its plain version. Inputs are
made with numpy and fed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.attention import (
    dot_product_attention as jax_dot_product_attention)
from analytics_zoo_tpu.ops.pallas_attention import (
    _flash_fwd, pallas_flash_attention_fwd)
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from analytics_zoo_tpu_torch.ops.attention import (
    dot_product_attention, reference_attention)

torch.set_num_threads(2)

# f32 on both sides; the same tolerance TestPallasKernel holds the
# Pallas kernel to against its jnp reference
ATOL = 2e-5


def _qkv(seed, b, h, lq, lk, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, lq, d).astype(np.float32),
            rng.randn(b, h, lk, d).astype(np.float32),
            rng.randn(b, h, lk, d).astype(np.float32))


def _port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


class TestFlashReference:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("d", [64, 128])
    def test_matches_pallas_kernel(self, causal, d):
        q, k, v = _qkv(0, 1, 2, 256, 256, d)
        want = pallas_flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal)
        got = fa.flash_attention(*_port(q, k, v), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL)

    @pytest.mark.parametrize("lq,lk", [(128, 384), (256, 384)])
    def test_cross_length_causal_matches_pallas_kernel(self, lq, lk):
        q, k, v = _qkv(2, 1, 2, lq, lk, 128)
        want = pallas_flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), True)
        got = fa.flash_attention(*_port(q, k, v), causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL)

    @pytest.mark.parametrize("causal,lq,lk", [(False, 256, 256),
                                              (True, 256, 256),
                                              (True, 128, 384)])
    def test_lse_matches_pallas_kernel(self, causal, lq, lk):
        d = 64
        q, k, v = _qkv(3, 2, 2, lq, lk, d)
        scale = 1.0 / np.sqrt(d)
        out, lse = _flash_fwd(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal, scale, None, None,
                              with_lse=True)
        got_out, got_lse = fa.flash_attention(*_port(q, k, v),
                                              causal=causal, with_lse=True)
        assert got_lse.shape == (2 * 2, lq)
        assert got_lse.dtype == torch.float32
        # lse is log(sum exp) of scores of size ~sqrt(d): |lse| ~ 10, so
        # f32 summation order leaves a few 1e-6 of absolute difference
        np.testing.assert_allclose(got_lse.numpy(),
                                   np.asarray(lse)[..., 0], atol=1e-5)
        np.testing.assert_allclose(got_out.numpy(), np.asarray(out),
                                   atol=ATOL)

    def test_rejects_causal_lq_gt_lk(self):
        q = torch.zeros(1, 1, 256, 128)
        k = torch.zeros(1, 1, 128, 128)
        with pytest.raises(ValueError, match=r"len\(q\)"):
            fa.flash_attention(q, k, k, causal=True)
        with pytest.raises(ValueError, match=r"len\(q\)"):
            fa.flash_attention_reference(q, k, k, causal=True)

    def test_cpu_tensor_takes_plain_version(self):
        fa.flash_attention.launches = 0
        q, k, v = _port(*_qkv(4, 1, 1, 128, 128, 64))
        out = fa.flash_attention(q, k, v)
        assert fa.flash_attention.launches == 0
        torch.testing.assert_close(out, fa.flash_attention_reference(q, k, v),
                                   rtol=0, atol=0)


class TestDotProductAttention:
    """The port's dispatch against the JAX package's on the CPU (both
    take their einsum path there)."""

    def _both(self, q, k, v, **kw):
        jax_kw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
                  for n, a in kw.items()}
        port_kw = {n: (torch.from_numpy(a) if isinstance(a, np.ndarray)
                       else a) for n, a in kw.items()}
        want = jax_dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), **jax_kw)
        got = dot_product_attention(*_port(q, k, v), **port_kw)
        return got.numpy(), np.asarray(want)

    @pytest.mark.parametrize("impl", ["auto", "flash", "einsum"])
    def test_plain_and_causal(self, impl):
        from analytics_zoo_tpu.common.config import get_config as jax_cfg
        from analytics_zoo_tpu_torch.common.config import get_config

        q, k, v = _qkv(5, 2, 2, 128, 256, 64)
        get_config().set("zoo.ops.attention_impl", impl)
        jax_cfg().set("zoo.ops.attention_impl", impl)
        try:
            for causal in (False, True):
                got, want = self._both(q, k, v, causal=causal)
                np.testing.assert_allclose(got, want, atol=ATOL)
        finally:
            get_config().unset("zoo.ops.attention_impl")
            jax_cfg().unset("zoo.ops.attention_impl")

    def test_key_padding_mask(self):
        q, k, v = _qkv(6, 2, 2, 128, 128, 64)
        kpm = np.ones((2, 128), np.int32)
        kpm[0, 100:] = 0
        kpm[1, 37:] = 0
        got, want = self._both(q, k, v, key_padding_mask=kpm)
        np.testing.assert_allclose(got, want, atol=ATOL)

    def test_mask_and_causal(self):
        q, k, v = _qkv(7, 2, 2, 64, 64, 32)
        rng = np.random.RandomState(8)
        mask = rng.rand(2, 1, 64, 64) > 0.3
        mask[..., 0] = True  # every row keeps one key
        got, want = self._both(q, k, v, mask=mask, causal=True)
        np.testing.assert_allclose(got, want, atol=ATOL)

    def test_reference_attention(self):
        from analytics_zoo_tpu.ops.attention import (
            reference_attention as jax_reference_attention)

        q, k, v = _qkv(9, 1, 2, 64, 128, 32)
        want = jax_reference_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=True)
        got = reference_attention(*_port(q, k, v), causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL)

    def test_rejects_causal_lq_gt_lk(self):
        q, k, v = _port(*_qkv(10, 1, 1, 128, 64, 64))
        with pytest.raises(ValueError, match=r"len\(q\)"):
            dot_product_attention(q, k, v, causal=True)
