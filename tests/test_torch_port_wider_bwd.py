"""PyTorch port, the backward at head dims 320 to 512 (K2 and K3 there)
and ``TransformerModule`` trained as a causal LM with heads of 512, held
against the JAX package on the CPU.

The JAX side runs as its own tests run it: ``pallas_flash_attention_fwd``
and its custom_vjp in Pallas interpret mode, ``TransformerModule`` and
its ``Estimator`` on the CPU. Inputs are made with numpy and fed to both
packages. The slice as a whole: ``chip_smoke.causal_lm`` and the same
wrapper in flax (``FlaxCausalLM``), at vocab 64, seq_len 128, hidden
1024, 2 heads of 512, 2 blocks, intermediate 2048, no dropout, from the
JAX package's initial weights (carried over by ``bridge``), take 3 Adam
steps of ``Estimator.fit`` with the port's dispatch sent down the
kernels' route, as on the card (``FlashAttention``'s CPU wiring: the
plain versions of K1-lse, K2 and K3). Where a test stands in for the
card, the wrappers' CUDA branch runs on meta tensors with spies for the
entry points (``fake_card``).
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.bridge import state_dict_from_flax
from analytics_zoo_tpu_torch.ops import attention as port_attention
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from chip_smoke import lm_data
from tests.test_torch_port_k5b_bwd import D_ARG, fake_card  # noqa: F401
from tests.test_torch_port_wide_bwd import (BATCH, CALLS, SEQ, TOL,
                                            _assert_close, _fit_both,
                                            _pallas_case)

torch.set_num_threads(2)

WIDER = (320, 384, 448, 512)
WRAPPERS = (fa.flash_attention, fa.flash_attention_bwd_dq,
            fa.flash_attention_bwd_dkv)


# ------------------------------------------------------ K2, K3 at 320+ --
class TestWiderBackwardMatchesPallas:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("causal,lq,lk", CALLS)
    @pytest.mark.parametrize("d", WIDER)
    def test_plain_backward(self, d, causal, lq, lk, dtype):
        """``flash_attention_bwd_reference`` (what K2 and K3 are held to
        on the card), from the plain forward's out and logsumexp, gives
        the Pallas kernels' dQ, dK and dV."""
        (q, k, v, do), want = _pallas_case(d, dtype, causal, lq, lk)
        tdt = getattr(torch, dtype)
        tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
        out, lse = fa.flash_attention_reference(tq, tk, tv, causal,
                                                with_lse=True)
        got = fa.flash_attention_bwd_reference(tq, tk, tv, out, lse, tdo,
                                               causal)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == tdt
            _assert_close(g.float().numpy(), w, TOL[dtype], name)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("causal,lq,lk", CALLS)
    @pytest.mark.parametrize("d", WIDER)
    def test_flash_attention_under_autograd(self, d, causal, lq, lk, dtype):
        """``FlashAttention`` on CPU tensors (the wiring the card runs:
        K1-lse forward, K2 then K3 backward, here their plain versions)
        gives the Pallas kernels' gradients."""
        (q, k, v, do), want = _pallas_case(d, dtype, causal, lq, lk)
        tdt = getattr(torch, dtype)
        tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                      for a in (q, k, v))
        out = fa.flash_attention(tq, tk, tv, causal)
        got = torch.autograd.grad(out, (tq, tk, tv),
                                  torch.from_numpy(do).to(tdt))
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == tdt
            _assert_close(g.float().numpy(), w, TOL[dtype], name)


class TestWiderBackwardRouteAndGates:
    BASE = dict(impl="flash", on_cuda=True, l=256, lk=256, has_mask=False,
                dropout_rate=0.0)

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("d", WIDER)
    def test_gradient_takes_the_kernels(self, d, causal):
        assert port_attention._flash_route(
            **self.BASE, d=d, causal=causal, needs_grad=True) == "kernels"

    @pytest.mark.parametrize("needs_grad", [False, True])
    @pytest.mark.parametrize("d,masked", [(320, True), (512, True),
                                          (576, False), (1024, False)])
    def test_einsum_path_as_in_the_reference(self, d, masked, needs_grad):
        """A key-padding mask above 128 (no masked kernel; the reference
        takes its einsum path), and every D above 512 (still to port),
        take the einsum path, with or without a gradient."""
        assert port_attention._flash_route(
            **self.BASE, d=d, causal=True, has_key_padding_mask=masked,
            needs_grad=needs_grad) is None

    @pytest.mark.parametrize("d", WIDER)
    def test_gates(self, d):
        fa._check_head_dim(d, backward=True)
        with pytest.raises(NotImplementedError, match="masked"):
            fa._check_head_dim(d, backward=True, masked=True)
        with pytest.raises(NotImplementedError,
                           match="ROADMAP section 2, item 2"):
            fa._check_head_dim(576, backward=True)

    def test_card_gradient_above_512_raises_before_k1(self, fake_card):
        """``FlashAttention`` at D = 576 raises before K1-lse launches:
        no kernel takes that head dim (the dispatch sends such a call to
        the einsum path instead)."""
        q = torch.empty(1, 2, 128, 576, device="meta", requires_grad=True)
        with pytest.raises(NotImplementedError, match="still to port"):
            fa.flash_attention(q, q, q, True)
        assert fake_card == []

    @pytest.mark.parametrize("d", WIDER)
    def test_card_trained_call_launches_k1_lse_k2_k3(self, fake_card,
                                                     monkeypatch, d):
        """Off the CPU (meta tensors, spied entry points) a trained call
        at D = 320 to 512 launches K1-lse, then K2, then K3 at that head
        dim without a mask, each counted once in ``wide_d_launches``
        (f32: all three on the f32 tensor-core entries)."""
        for w in WRAPPERS:
            monkeypatch.setattr(w, "wide_d_launches", 0)
        q, k, v = (torch.empty(4, 2, 128, d, device="meta",
                               requires_grad=True) for _ in range(3))
        out = fa.flash_attention(q, k, v, True)
        grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
        assert all(g.shape == (4, 2, 128, d) for g in grads)
        assert [(name, args[D_ARG[name]]) for name, args in fake_card] == [
            ("zoo_flash_attn_fwd_f32tc", d),
            ("zoo_flash_attn_bwd_dq_f32tc", d),
            ("zoo_flash_attn_bwd_dkv_f32tc", d)]
        # K1 wrote a logsumexp (its fifth argument is not null)
        assert fake_card[0][1][4] is not None
        for w in WRAPPERS:
            assert (w.launches, w.masked_launches, w.small_d_launches,
                    w.wide_d_launches) == (1, 0, 0, 1)


# ------------------------------------------- the causal LM, heads of 512 --
LM = dict(vocab=64, seq_len=128, hidden_size=1024, n_head=2, n_block=2,
          intermediate_size=2048)


@pytest.fixture(scope="module")
def lm_fit():
    """Both packages fit 3 Adam steps (24 samples, batch 8) of the causal
    LM with 2 heads of 512."""
    return _fit_both(24, LM)


class TestCausalLMSliceAt512:
    def test_backward_took_the_kernels_route_at_512(self, lm_fit):
        steps = len(lm_fit["port_losses"])
        assert steps == 3
        assert lm_fit["backward_calls"] == [
            ((BATCH, LM["n_head"], SEQ, 512), True)] * (steps * LM["n_block"])

    def test_step_losses_match(self, lm_fit):
        np.testing.assert_allclose(lm_fit["port_losses"],
                                   lm_fit["ref_losses"], rtol=1e-4)
        np.testing.assert_allclose(lm_fit["port_hist"][0]["loss"],
                                   lm_fit["ref_hist"][0]["loss"], rtol=1e-4)
        assert lm_fit["port_losses"][-1] < lm_fit["port_losses"][0]

    def test_parameters_after_three_steps_match(self, lm_fit):
        """f32 on both sides, 3 steps of Adam at lr 1e-3: within 1e-4,
        and most tensors moved."""
        want = state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, lm_fit["ref"].variables))
        start = state_dict_from_flax(lm_fit["variables"])
        got = lm_fit["port"].model.state_dict()
        assert set(got) == set(want)
        moved = 0
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-4,
                                       err_msg=k)
            moved += int(not np.allclose(v.numpy(), start[k]))
        assert moved > len(want) // 2

    def test_trained_logits_match(self, lm_fit):
        """The fitted models' logits, ``[B * L, vocab]``, over new ids."""
        x, _ = lm_data(np.random.RandomState(8), 4, SEQ, LM["vocab"])
        want = lm_fit["ref"].adapter.apply(lm_fit["ref"].variables, x,
                                           training=False)[0]
        with torch.no_grad():
            got = lm_fit["port"].model(torch.from_numpy(x))
        assert got.shape == (4 * SEQ, LM["vocab"])
        _assert_close(got.numpy(), want, 1e-4)
