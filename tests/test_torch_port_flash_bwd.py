"""PyTorch port, flash-attention backward: the plain versions of K2 (dQ)
and K3 (dK/dV) and the gradient through ``FlashAttention`` (K4) held
against the JAX package's ``_flash_bwd`` and ``jax.grad`` of
``pallas_flash_attention_fwd`` on the CPU (Pallas in interpret mode, as
``TestPallasKernel`` runs it); plus the wiring that makes a tensor that
needs a gradient go through K1-lse, K2 and K3, and the dropout repairs
of the layers (an explicit generator, attention-prob dropout applied).

Inputs are made with numpy and fed to both packages; f32 on both sides,
atol 2e-4 (the tolerance of
``test_flash_backward_matches_reference_grads``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.pallas_attention import (
    _flash_bwd, _flash_fwd, pallas_flash_attention_fwd)
from analytics_zoo_tpu_torch.keras.layers.transformer import (
    MultiHeadSelfAttention, TransformerBlock, dropout, reset_parameters)
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from analytics_zoo_tpu_torch.ops.attention import dot_product_attention

torch.set_num_threads(2)

ATOL = 2e-4
CASES = [  # (lq, lk, d, causal)
    (256, 256, 64, False),
    (256, 256, 64, True),
    (256, 256, 128, False),
    (256, 256, 128, True),
    (128, 384, 128, True),
]


def _arrays(seed, lq, lk, d, b=2, h=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, lq, d).astype(np.float32),
            rng.randn(b, h, lk, d).astype(np.float32),
            rng.randn(b, h, lk, d).astype(np.float32),
            rng.randn(b, h, lq, d).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


class TestPlainBackward:
    @pytest.mark.parametrize("lq,lk,d,causal", CASES)
    def test_matches_flash_bwd(self, lq, lk, d, causal):
        q, k, v, g = _arrays(0, lq, lk, d)
        scale = 1.0 / np.sqrt(d)
        jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
        out, lse = _flash_fwd(jq, jk, jv, causal, scale, None, None,
                              with_lse=True)
        want = _flash_bwd(jq, jk, jv, out, lse, jg, causal, scale, None,
                          None)
        tq, tk, tv, tg = _t(q, k, v, g)
        o, tlse = fa.flash_attention(tq, tk, tv, causal, with_lse=True)
        got = fa.flash_attention_bwd_reference(tq, tk, tv, o, tlse, tg,
                                               causal)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                       err_msg=name)

    @pytest.mark.parametrize("lq,lk,d,causal", CASES[1:2] + CASES[4:])
    def test_kernel_wrappers_take_plain_version_on_cpu(self, lq, lk, d,
                                                       causal):
        """K2 then K3 through their wrappers (delta handed from one to the
        other) equal the plain backward; no kernel launch is counted."""
        q, k, v, g = _t(*_arrays(1, lq, lk, d))
        o, lse = fa.flash_attention(q, k, v, causal, with_lse=True)
        fa.flash_attention_bwd_dq.launches = 0
        fa.flash_attention_bwd_dkv.launches = 0
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, g, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, g, causal)
        assert delta.shape == (4, lq) and delta.dtype == torch.float32
        torch.testing.assert_close(delta, (g * o).sum(-1).reshape(4, lq))
        want = fa.flash_attention_bwd_reference(q, k, v, o, lse, g, causal)
        for a, b in zip((dq, dk, dv), want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert fa.flash_attention_bwd_dq.launches == 0
        assert fa.flash_attention_bwd_dkv.launches == 0

    def test_bf16_rounds_like_the_reference_kernel(self):
        """dS is rounded to the input dtype before dQ/dK and P to dO's
        before dV, as ``_flash_bwd`` does: the bf16 plain backward is
        close to, but not equal to, the f32 one."""
        q, k, v, g = _t(*_arrays(2, 128, 128, 64))
        o, lse = fa.flash_attention(q, k, v, with_lse=True)
        f32 = fa.flash_attention_bwd_reference(q, k, v, o, lse, g)
        bf = [t.bfloat16() for t in (q, k, v, o)]
        b16 = fa.flash_attention_bwd_reference(*bf, lse, g.bfloat16())
        for a, b in zip(b16, f32):
            assert a.dtype == torch.bfloat16
            np.testing.assert_allclose(a.float().numpy(), b.numpy(),
                                       atol=0.1, rtol=0.05)


class TestGradientFunction:
    @pytest.mark.parametrize("lq,lk,d,causal", CASES)
    def test_matches_jax_grad(self, lq, lk, d, causal):
        q, k, v, g = _arrays(3, lq, lk, d)
        jg = jnp.asarray(g)

        def f(q_, k_, v_):
            return jnp.sum(pallas_flash_attention_fwd(q_, k_, v_, causal)
                           * jg)

        want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
        out = fa.flash_attention(tq, tk, tv, causal)
        # the Function, not autograd through the plain version
        assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
        got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                       err_msg=name)

    def test_backward_goes_through_k2_then_k3(self, monkeypatch):
        """Fault 1: the gradient of ``flash_attention`` comes from the K2
        and K3 wrappers (which on a CUDA tensor launch or raise), never
        from a tensor with no ``grad_fn``."""
        calls = []
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            real = getattr(fa, name)

            def spy(*args, _real=real, _name=name):
                calls.append(_name)
                return _real(*args)

            monkeypatch.setattr(fa, name, spy)
        q, k, v, g = _t(*_arrays(4, 128, 128, 64))
        q.requires_grad_()
        out, lse = fa.flash_attention(q, k, v, with_lse=True)
        assert out.grad_fn is not None and not lse.requires_grad
        (dq,) = torch.autograd.grad(out, (q,), g)
        assert calls == ["flash_attention_bwd_dq", "flash_attention_bwd_dkv"]
        assert torch.isfinite(dq).all()

    def test_no_grad_takes_the_forward_alone(self):
        q, k, v, _ = _t(*_arrays(5, 128, 128, 64))
        q.requires_grad_()
        with torch.no_grad():
            out = fa.flash_attention(q, k, v)
        assert out.grad_fn is None

    def test_dispatch_is_differentiable(self):
        """``dot_product_attention``'s gradient matches the plain
        attention's on the CPU (the einsum path there; the flash path
        on CUDA takes the Function)."""
        q, k, v, g = _t(*_arrays(6, 128, 128, 64))
        for t in (q, k, v):
            t.requires_grad_()
        got = torch.autograd.grad(dot_product_attention(q, k, v), (q, k, v),
                                  g)
        want = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v),
                                   g)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


class TestDropout:
    def _x(self):
        return torch.from_numpy(
            np.random.RandomState(7).randn(64, 256).astype(np.float32))

    def test_same_seed_same_mask_and_seeds_differ(self):
        x = self._x()
        a = dropout(x, 0.25, torch.Generator().manual_seed(1))
        b = dropout(x, 0.25, torch.Generator().manual_seed(1))
        c = dropout(x, 0.25, torch.Generator().manual_seed(2))
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.equal(a, c)

    def test_keep_rate_and_scale(self):
        x = torch.ones(200, 500)
        y = dropout(x, 0.3, torch.Generator().manual_seed(3))
        kept = y != 0
        assert abs(kept.float().mean().item() - 0.7) < 0.01
        torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))

    def test_rate_zero_is_identity_and_missing_generator_raises(self):
        x = self._x()
        assert dropout(x, 0.0, None) is x
        with pytest.raises(ValueError, match="generator"):
            dropout(x, 0.1, None)

    def test_layers_raise_without_generator_in_training(self):
        """Faults 2 and 3: a dropout that should run in training with no
        generator raises instead of being skipped (or drawn from torch's
        global RNG)."""
        block = reset_parameters(TransformerBlock(64, 1, 128))
        x = torch.from_numpy(
            np.random.RandomState(8).randn(2, 16, 64).astype(np.float32))
        with pytest.raises(ValueError, match="[Gg]enerator"):
            block(x, train=True)
        attn = reset_parameters(MultiHeadSelfAttention(64, 1,
                                                       attn_dropout=0.1))
        with pytest.raises(ValueError, match="dropout_rng"):
            attn(x, train=True)
        # inference never needs one
        torch.testing.assert_close(block(x), block(x))

    def test_attention_prob_dropout_is_applied(self):
        """Fault 2: attention-prob dropout runs in training, from the
        generator passed to the layer, and reproducibly."""
        attn = reset_parameters(MultiHeadSelfAttention(64, 1,
                                                       attn_dropout=0.5))
        x = torch.from_numpy(
            np.random.RandomState(9).randn(2, 16, 64).astype(np.float32))
        plain = attn(x)
        a = attn(x, train=True, rng=torch.Generator().manual_seed(4))
        b = attn(x, train=True, rng=torch.Generator().manual_seed(4))
        c = attn(x, train=True, rng=torch.Generator().manual_seed(5))
        assert (a - plain).abs().max() > 1e-2
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.equal(a, c)

    def test_training_forward_is_reproducible_from_the_seed(self):
        block = reset_parameters(TransformerBlock(64, 1, 128))
        x = torch.from_numpy(
            np.random.RandomState(10).randn(2, 16, 64).astype(np.float32))
        a = block(x, train=True, rng=torch.Generator().manual_seed(6))
        torch.manual_seed(123)  # the global RNG plays no part
        b = block(x, train=True, rng=torch.Generator().manual_seed(6))
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.equal(a, block(x))
