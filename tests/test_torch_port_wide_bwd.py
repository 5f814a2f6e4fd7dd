"""PyTorch port, the backward at head dims 192 and 256 (K2 and K3 there)
and ``TransformerModule``, the GPT-style causal decoder trained through
``Estimator.fit``, held against the JAX package on the CPU.

The JAX side runs as its own tests run it: ``pallas_flash_attention_fwd``
and its custom_vjp in Pallas interpret mode, the einsum path and
``TransformerModule`` on the CPU. Inputs are made with numpy and fed to
both packages. The slice as a whole: ``chip_smoke.causal_lm`` (the
port's ``TransformerModule`` with an untied f32 ``Dense(vocab)`` head,
the wrapper the card trains) and the same wrapper written in flax, at
vocab 64, seq_len 128, hidden 512, 2 heads of 256, 2 blocks,
intermediate 1024, no dropout, from the JAX package's initial weights
(carried over by ``bridge``), take 3 Adam steps of ``Estimator.fit``
with the port's dispatch sent down the kernels' route, as on the card
(``FlashAttention``'s CPU wiring: the plain versions of K1-lse, K2 and
K3). Where a test stands in for the card, the wrappers' CUDA branch runs
on meta tensors with spies for the entry points (``fake_card``).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras.layers.transformer import (
    TransformerModule as JaxTransformerModule)
from analytics_zoo_tpu.learn import optim as ref_optim
from analytics_zoo_tpu.learn.estimator import Estimator as RefEstimator
from analytics_zoo_tpu.ops.pallas_attention import pallas_flash_attention_fwd
from analytics_zoo_tpu_torch.bridge import (flatten, load_flax_into,
                                            state_dict_from_flax,
                                            variables_from_module)
from analytics_zoo_tpu_torch.keras.layers import TransformerModule
from analytics_zoo_tpu_torch.keras.layers.transformer import reset_parameters
from analytics_zoo_tpu_torch.learn import optim
from analytics_zoo_tpu_torch.learn.estimator import Estimator
from analytics_zoo_tpu_torch.ops import attention as port_attention
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from chip_smoke import causal_lm, lm_data
from tests.test_torch_port_k5b_bwd import D_ARG, fake_card  # noqa: F401

torch.set_num_threads(2)

# |port - jax| <= TOL * (1 + |jax|): f32 is exact arithmetic in another
# order; in bf16 both round dS and P to bf16 before their products and
# round the gradients (one bf16 ulp is 2^-7 relative)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _assert_close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    excess = np.abs(got - want) - tol * (1 + np.abs(want))
    assert excess.max() <= 0, (what, np.abs(got - want).max())


# (causal, lq, lk): causal with lq == lk and lq < lk (bottom-right
# diagonal), and not causal
CALLS = [(True, 128, 128), (True, 128, 256), (False, 128, 128)]


@functools.lru_cache(maxsize=None)
def _pallas_case(d, dtype, causal, lq, lk):
    """Inputs of one call (numpy f32, to be cast to ``dtype``) and the
    gradients of sum(out * do) through ``pallas_flash_attention_fwd``'s
    custom_vjp (``_flash_bwd``: the dQ and dK/dV Pallas kernels,
    interpret mode), as f32 numpy."""
    rng = np.random.RandomState(d + lk + causal)
    q = rng.randn(1, 2, lq, d).astype(np.float32)
    k = rng.randn(1, 2, lk, d).astype(np.float32)
    v = rng.randn(1, 2, lk, d).astype(np.float32)
    do = rng.randn(1, 2, lq, d).astype(np.float32)
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda q, k, v: pallas_flash_attention_fwd(
        q, k, v, causal), *(jnp.asarray(a, jdt) for a in (q, k, v)))
    grads = vjp(jnp.asarray(do, jdt))
    return (q, k, v, do), tuple(np.asarray(g.astype(jnp.float32))
                                for g in grads)


# ------------------------------------------------------ K2, K3 at 192+ --
class TestWideBackwardMatchesPallas:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("causal,lq,lk", CALLS)
    @pytest.mark.parametrize("d", [192, 256])
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
    @pytest.mark.parametrize("d", [192, 256])
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


class TestWideRouteAndGates:
    BASE = dict(impl="flash", on_cuda=True, l=256, lk=256, has_mask=False,
                dropout_rate=0.0)

    @pytest.mark.parametrize("needs_grad", [False, True])
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("d", [192, 256])
    def test_kernels_with_and_without_a_gradient(self, d, causal,
                                                 needs_grad):
        assert port_attention._flash_route(
            **self.BASE, d=d, causal=causal,
            needs_grad=needs_grad) == "kernels"

    @pytest.mark.parametrize("needs_grad", [False, True])
    @pytest.mark.parametrize("d,masked", [(192, True), (256, True),
                                          (320, False), (320, True),
                                          (512, False)])
    def test_einsum_path_as_in_the_reference(self, d, masked, needs_grad):
        """A key-padding mask above 128 takes the einsum path (the
        reference's stock-kernel branch stops at 128). Without one the
        kernels take the call at 192 to 512, with or without a gradient
        (K1, or K1-lse, K2 and K3)."""
        got = port_attention._flash_route(
            **self.BASE, d=d, causal=True, has_key_padding_mask=masked,
            needs_grad=needs_grad)
        assert got == (None if masked else "kernels")

    @pytest.mark.parametrize("d", [192, 256])
    def test_backward_gate_passes(self, d):
        fa._check_head_dim(d)
        fa._check_head_dim(d, backward=True)
        with pytest.raises(NotImplementedError, match="masked"):
            fa._check_head_dim(d, backward=True, masked=True)

    @pytest.mark.parametrize("backward", [False, True])
    @pytest.mark.parametrize("d", [320, 384, 512])
    def test_wider_head_dims_point_at_the_roadmap(self, d, backward):
        """K1, and K1-lse, K2 and K3 for a gradient, pass at 320 to 512;
        above 512 both raise with the ROADMAP item that ports them."""
        fa._check_head_dim(d, backward=backward)
        with pytest.raises(NotImplementedError,
                           match="ROADMAP section 2, item 2"):
            fa._check_head_dim(d + 256, backward=backward)

    @pytest.mark.parametrize("d", [192, 256])
    def test_card_trained_call_launches_k1_lse_k2_k3(self, fake_card,
                                                     monkeypatch, d):
        """Off the CPU (meta tensors, spied entry points) a trained call
        at D = 192 or 256 launches K1-lse, then K2, then K3 at that head
        dim without a mask (f32: all three on the f32 tensor-core
        entries), each counted in ``wide_d_launches``."""
        for w in (fa.flash_attention, fa.flash_attention_bwd_dq,
                  fa.flash_attention_bwd_dkv):
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
        for w in (fa.flash_attention, fa.flash_attention_bwd_dq,
                  fa.flash_attention_bwd_dkv):
            assert (w.launches, w.masked_launches, w.small_d_launches,
                    w.wide_d_launches) == (1, 0, 0, 1)


# ------------------------------------------------------ TransformerModule --
LM = dict(vocab=64, seq_len=128, hidden_size=512, n_head=2, n_block=2,
          intermediate_size=1024)
SEQ, BATCH = 128, 8


class FlaxCausalLM(fnn.Module):
    """``chip_smoke.causal_lm`` in flax: the JAX package's
    ``TransformerModule`` and an untied ``Dense(vocab)`` head, logits as
    ``[B * L, vocab]`` for ``sparse_categorical_crossentropy``."""

    vocab: int
    seq_len: int
    hidden_size: int
    n_head: int
    n_block: int
    intermediate_size: int

    @fnn.compact
    def __call__(self, ids, train: bool = False):
        h = JaxTransformerModule(
            self.vocab, self.seq_len, self.hidden_size, self.n_head,
            self.n_block, self.intermediate_size, hidden_dropout=0.0,
            attn_dropout=0.0, name="lm")(ids, train=train)
        return fnn.Dense(self.vocab, name="head")(h).reshape(-1, self.vocab)


def _ids(seed, n=2):
    return np.random.RandomState(seed).randint(
        0, LM["vocab"], (n, SEQ)).astype(np.int32)


@pytest.fixture(scope="module")
def decoders():
    """The JAX package's ``TransformerModule`` (no dropout) with its
    ``init`` variables, and the port's over the same weights."""
    cfg = dict(LM, hidden_dropout=0.0, attn_dropout=0.0)
    jax_tm = JaxTransformerModule(**cfg)
    tree = jax.tree_util.tree_map(np.asarray, jax_tm.init(
        jax.random.PRNGKey(0), jnp.asarray(_ids(0))))
    port_tm = load_flax_into(TransformerModule(**cfg), tree)
    return jax_tm, tree, port_tm


class TestTransformerModule:
    def test_forward_matches(self, decoders):
        jax_tm, tree, port_tm = decoders
        ids = _ids(1)
        want = jax_tm.apply(tree, jnp.asarray(ids))
        with torch.no_grad():
            got = port_tm(torch.from_numpy(ids))
        assert got.shape == (2, SEQ, LM["hidden_size"])
        _assert_close(got.numpy(), want, 1e-4)

    def test_variable_names_are_flax_init_tree(self, decoders):
        _, tree, port_tm = decoders
        want = {k: v.shape for k, v in flatten(tree["params"]).items()}
        back = flatten(variables_from_module(port_tm)["params"])
        assert {k: v.shape for k, v in back.items()} == want
        assert "position_embed" in want and "block_1/ln_ffn/scale" in want
        for k, v in flatten(tree["params"]).items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)

    def test_causal(self, decoders):
        """Changing the last token leaves every earlier position's
        output as it was, and changes the last one's."""
        _, _, port_tm = decoders
        ids = _ids(2, n=1)
        other = ids.copy()
        other[0, -1] = (other[0, -1] + 1) % LM["vocab"]
        with torch.no_grad():
            a, b = (port_tm(torch.from_numpy(x)) for x in (ids, other))
        np.testing.assert_array_equal(a[:, :-1].numpy(), b[:, :-1].numpy())
        assert not torch.allclose(a[:, -1], b[:, -1])

    def test_output_all_block(self, decoders):
        _, tree, _ = decoders
        cfg = dict(LM, hidden_dropout=0.0, attn_dropout=0.0,
                   output_all_block=True)
        port_tm = load_flax_into(TransformerModule(**cfg), tree)
        ids = _ids(3)
        want = JaxTransformerModule(**cfg).apply(tree, jnp.asarray(ids))
        with torch.no_grad():
            got = port_tm(torch.from_numpy(ids))
        assert isinstance(got, tuple) and len(got) == LM["n_block"]
        for g, w in zip(got, want):
            _assert_close(g.numpy(), w, 1e-4)

    def test_seq_axis_raises(self):
        with pytest.raises(NotImplementedError, match="seq_axis"):
            TransformerModule(**LM, seq_axis="seq")

    def test_training_dropout_needs_a_generator(self):
        tm = reset_parameters(TransformerModule(**dict(LM, n_block=1)), 0)
        ids = torch.from_numpy(_ids(4))
        with pytest.raises(ValueError, match="generator"):
            tm(ids, train=True)
        a, b = (tm(ids, train=True, rng=torch.Generator().manual_seed(5))
                for _ in range(2))
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _fit_both(n, lm=LM):
    """Both packages' ``Estimator.fit`` of the causal LM wrapper at ``lm``
    on ``lm_data`` (``n`` samples, batch 8, shuffled) with Adam (epsilon
    1e-5: the key bias's gradient is zero up to rounding, since softmax
    ignores a constant added to every key's score, and at 1e-8 Adam
    turns that rounding noise, which differs between the frameworks,
    into full steps of size lr) from the JAX package's initial weights.
    The port's dispatch takes the kernels' route, as on the card; every
    backward through ``FlashAttention`` is recorded."""
    x, y = lm_data(np.random.RandomState(7), n, SEQ, lm["vocab"])
    flax_lm = FlaxCausalLM(**lm)
    variables = jax.tree_util.tree_map(np.asarray, flax_lm.init(
        jax.random.PRNGKey(0), jnp.asarray(x[:1])))
    ref = RefEstimator(flax_lm, loss="sparse_categorical_crossentropy",
                       optimizer=ref_optim.Adam(epsilon=1e-5),
                       variables=jax.tree_util.tree_map(jnp.asarray,
                                                        variables))
    module = causal_lm(torch, dict(lm, hidden_dropout=0.0, attn_dropout=0.0))
    load_flax_into(module, variables)
    port = Estimator(module, loss="sparse_categorical_crossentropy",
                     optimizer=optim.Adam(epsilon=1e-5), device="cpu")

    ref_losses, port_losses, backward_calls = [], [], []
    step = ref._build_train_step()

    def ref_step(*args):
        out = step(*args)
        ref_losses.append(float(out[3]))
        return out

    real = port._train_step

    def port_step(xb, yb):
        loss = real(xb, yb)
        port_losses.append(float(loss))
        return loss

    bwd = fa.flash_attention_bwd

    def spy(q, k, v, o, lse, do, causal=False, scale=None,
            key_padding_mask=None):
        backward_calls.append((tuple(q.shape), causal))
        return bwd(q, k, v, o, lse, do, causal, scale, key_padding_mask)

    ref._train_step = ref_step
    port._train_step = port_step
    ref_hist = ref.fit((x, y), batch_size=BATCH, epochs=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "_flash_route", lambda *a: "kernels")
        mp.setattr(fa, "flash_attention_bwd", spy)
        port_hist = port.fit((x, y), batch_size=BATCH, epochs=1)
    return dict(ref=ref, port=port, variables=variables,
                ref_losses=ref_losses, port_losses=port_losses,
                ref_hist=ref_hist, port_hist=port_hist,
                backward_calls=backward_calls)


@pytest.fixture(scope="module")
def lm_fit():
    """Both packages fit 3 Adam steps (24 samples, batch 8)."""
    return _fit_both(24)


class TestCausalLMSlice:
    def test_backward_took_the_kernels_route_at_256(self, lm_fit):
        steps = len(lm_fit["port_losses"])
        assert steps == 3
        assert lm_fit["backward_calls"] == [
            ((BATCH, LM["n_head"], SEQ, 256), True)] * (steps * LM["n_block"])

    def test_step_losses_match(self, lm_fit):
        np.testing.assert_allclose(lm_fit["port_losses"],
                                   lm_fit["ref_losses"], rtol=1e-4)
        np.testing.assert_allclose(lm_fit["port_hist"][0]["loss"],
                                   lm_fit["ref_hist"][0]["loss"], rtol=1e-4)
        # the next-token rule is learnable: the loss falls from ln(vocab)
        assert lm_fit["port_losses"][-1] < lm_fit["port_losses"][0]

    def test_parameters_after_three_steps_match(self, lm_fit):
        """f32 on both sides, 3 steps of Adam at lr 1e-3: within 1e-4
        (a few f32 ulps of the largest weights, carried through the
        updates)."""
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


def test_lm_data_follows_the_next_token_rule():
    """``chip_smoke.lm_data``: even tokens are followed by token + 1, odd
    ones by token - 1 (mod vocab); labels are the inputs shifted left."""
    x, y = lm_data(np.random.RandomState(0), 4, 16, 50400)
    assert x.shape == y.shape == (4, 16) and x.dtype == np.int32
    nxt = np.where(x % 2 == 0, x + 1, x - 1) % 50400
    np.testing.assert_array_equal(x[:, 1:], nxt[:, :-1])
    np.testing.assert_array_equal(y[:, :-1], x[:, 1:])
