"""PyTorch port, masked flash slice: the key-padding mask through the
plain versions of K1-K3, ``FlashAttention``'s gradient, the dispatch and
``BERTNER``, held against the JAX package on the CPU.

The reference for attention is the JAX package's einsum path
(``_einsum_attention`` with the mask as ``[B, 1, 1, Lk]``, and
``dot_product_attention(key_padding_mask=...)``, which takes that path on
the CPU), not JAX's stock TPU kernel: the port follows the einsum path at
every query row (``ops/attention.py``'s docstring says where the two
differ). Inputs are made with numpy and fed to both packages, in f32.

The slice as a whole: a small ``BERTNER`` (vocab 512, hidden 128, 2
blocks, 2 heads of 64, intermediate 256, 9 tags, L 128, batch 8, no
dropout) at the JAX package's initial weights (carried over by
``bridge``) predicts the same logits and takes the same 3 Adam steps on
padded batches (tags -1 on padding) in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.learn import optim as ref_optim
from analytics_zoo_tpu.ops.attention import (
    _einsum_attention as jax_einsum_attention)
from analytics_zoo_tpu.ops.attention import (
    dot_product_attention as jax_dot_product_attention)
from analytics_zoo_tpu_torch.bridge import load_flax_into, state_dict_from_flax
from analytics_zoo_tpu_torch.learn import optim
from analytics_zoo_tpu_torch.models.text.bert_estimators import (
    BERTNER, IGNORE_INDEX, token_cross_entropy)
from analytics_zoo_tpu_torch.ops import attention as port_attention
from analytics_zoo_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

# f32 on both sides: exact arithmetic in another order
ATOL = 1e-5


def _mask(kind, b, lk, seed):
    """[B, Lk] int32 key-padding masks (1 = real token)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(2, lk + 1, b)
    lens[0], lens[1] = lk, 2
    pos = np.arange(lk)[None, :]
    if kind == "prefix":
        return (pos < lens[:, None]).astype(np.int32)
    if kind == "left":
        return (pos >= lk - lens[:, None]).astype(np.int32)
    if kind == "pattern":
        m = (rng.rand(b, lk) > 0.4).astype(np.int32)
        m[:, 1] = 1
        return m
    if kind == "all_zero_row":
        m = (pos < lens[:, None]).astype(np.int32)
        m[1] = 0
        return m
    raise ValueError(kind)


# name -> (b, h, lq, lk, d, causal, mask kind)
CASES = {
    "prefix": (3, 2, 128, 128, 64, False, "prefix"),
    "left": (3, 2, 128, 128, 64, False, "left"),
    "pattern": (2, 2, 128, 128, 128, False, "pattern"),
    "causal_prefix": (3, 2, 128, 128, 64, True, "prefix"),
    "cross_lq_ne_lk": (2, 2, 128, 256, 64, False, "prefix"),
    # left padding under a bottom-right causal diagonal: the first rows
    # of the short batch rows see no key
    "cross_causal_left": (3, 2, 128, 256, 64, True, "left"),
    "all_zero_row": (3, 2, 128, 128, 64, False, "all_zero_row"),
}
# cases where some query row sees no key
EMPTY_ROWS = {"cross_causal_left", "all_zero_row"}


def _case(name, seed=0):
    b, h, lq, lk, d, causal, kind = CASES[name]
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(b, h, n, d).astype(np.float32)
                  for n in (lq, lk, lk, lq))
    return q, k, v, g, _mask(kind, b, lk, seed + 1), causal


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_einsum(q, k, v, mask, causal):
    return jax_einsum_attention(q, k, v, mask=jnp.asarray(mask)[:, None,
                                                                 None, :],
                                causal=causal)


def _empty_rows(mask, lq, causal):
    """[B, Lq] bool: the query rows that see no key."""
    lk = mask.shape[1]
    keep = mask[:, None, :] != 0
    if causal:
        keep = keep & np.tril(np.ones((lq, lk), bool), lk - lq)[None]
    return ~np.broadcast_to(keep, (mask.shape[0], lq, lk)).any(-1)


class TestMaskedForward:
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_plain_matches_einsum_path(self, name):
        q, k, v, _, m, causal = _case(name)
        want = _jax_einsum(*map(jnp.asarray, (q, k, v)), m, causal)
        got = fa.flash_attention(*_t(q, k, v), causal,
                                 key_padding_mask=torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    @pytest.mark.parametrize("name", sorted(CASES))
    def test_dispatch_matches_jax_dispatch(self, name):
        """Both packages' ``dot_product_attention`` with the mask (each
        takes its einsum path on the CPU)."""
        q, k, v, _, m, causal = _case(name, seed=1)
        want = jax_dot_product_attention(
            *map(jnp.asarray, (q, k, v)), key_padding_mask=jnp.asarray(m),
            causal=causal)
        got = port_attention.dot_product_attention(
            *_t(q, k, v), key_padding_mask=torch.from_numpy(m),
            causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    @pytest.mark.parametrize("name", sorted(CASES))
    def test_lse(self, name):
        """K1-lse's plain version: the logsumexp of the visible scores,
        and the finite ``EMPTY_LSE`` on a row that sees no key."""
        q, k, v, _, m, causal = _case(name, seed=2)
        b, h, lq, d = q.shape
        lk = k.shape[2]
        out, lse = fa.flash_attention(*_t(q, k, v), causal, with_lse=True,
                                      key_padding_mask=torch.from_numpy(m))
        assert lse.shape == (b * h, lq) and lse.dtype == torch.float32
        assert torch.isfinite(lse).all() and torch.isfinite(out).all()
        s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(d)
        keep = m[:, None, None, :] != 0
        if causal:
            keep = keep & np.tril(np.ones((lq, lk), bool), lk - lq)
        s = np.where(keep, s.astype(np.float64), -np.inf)
        empty = _empty_rows(m, lq, causal)[:, None, :].repeat(h, 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
                + s.max(-1)
        want = np.where(empty, fa.EMPTY_LSE, want).reshape(b * h, lq)
        np.testing.assert_allclose(lse.numpy(), want, atol=ATOL, rtol=1e-6)
        assert bool(empty.any()) == (name in EMPTY_ROWS)

    def test_row_with_no_key_is_the_mean_of_v(self):
        """Trap 1: a logsumexp over a finite fill is the fill in f32, so
        exp(s - lse) would sum V. The plain version averages it, as the
        einsum path's softmax does."""
        q, k, v, _, m, _ = _case("all_zero_row", seed=3)
        out = fa.flash_attention(*_t(q, k, v),
                                 key_padding_mask=torch.from_numpy(m))
        np.testing.assert_allclose(
            out[1].numpy(),
            np.broadcast_to(v[1].mean(1, keepdims=True), out[1].shape),
            atol=ATOL)

    def test_any_mask_dtype_is_mask_ne_0(self):
        q, k, v, _, m, _ = _case("pattern", seed=4)
        want = fa.flash_attention(*_t(q, k, v),
                                  key_padding_mask=torch.from_numpy(m))
        for alt in (m.astype(bool), m.astype(np.float32) * 3,
                    m.astype(np.uint8)):
            got = fa.flash_attention(*_t(q, k, v),
                                     key_padding_mask=torch.from_numpy(alt))
            torch.testing.assert_close(got, want, rtol=0, atol=0)

    def test_all_ones_mask_is_no_mask(self):
        q, k, v, _, _, _ = _case("prefix", seed=5)
        ones = torch.ones(q.shape[0], k.shape[2], dtype=torch.int32)
        torch.testing.assert_close(
            fa.flash_attention(*_t(q, k, v), key_padding_mask=ones),
            fa.flash_attention(*_t(q, k, v)), rtol=0, atol=1e-6)


class TestMaskedGradient:
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_matches_jax_grad_of_einsum_path(self, name):
        q, k, v, g, m, causal = _case(name, seed=6)
        jg = jnp.asarray(g)

        def f(q_, k_, v_):
            return jnp.sum(_jax_einsum(q_, k_, v_, m, causal) * jg)

        want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
        out = fa.flash_attention(tq, tk, tv, causal,
                                 key_padding_mask=torch.from_numpy(m))
        assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
        got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
        for label, a, b in zip(("dq", "dk", "dv"), got, want):
            assert torch.isfinite(a).all(), label
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                       err_msg=label)

    @pytest.mark.parametrize("name", sorted(CASES))
    def test_padded_keys_get_exactly_zero_dk_dv(self, name):
        """dK of a padded key is exactly 0; so is its dV, apart from the
        uniform 1/Lk share of the rows that see no key (the einsum
        path's autograd)."""
        q, k, v, g, m, causal = _case(name, seed=7)
        tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
        out = fa.flash_attention(tq, tk, tv, causal,
                                 key_padding_mask=torch.from_numpy(m))
        dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv),
                                         torch.from_numpy(g))
        pad = torch.from_numpy(m == 0)[:, None, :, None].expand_as(dk)
        assert pad.any()
        assert torch.count_nonzero(dk[pad]) == 0
        lq = q.shape[2]
        empty = torch.from_numpy(_empty_rows(m, lq, causal))
        # rows that see no key give no gradient to q
        assert torch.count_nonzero(
            dq[empty[:, None, :, None].expand_as(dq)]) == 0
        batches_without = ~empty.any(1)
        pad_v = pad & batches_without[:, None, None, None]
        assert torch.count_nonzero(dv[pad_v]) == 0
        if name in EMPTY_ROWS:
            assert torch.count_nonzero(dv[pad & ~pad_v]) > 0

    @pytest.mark.parametrize("name", ["prefix", "cross_causal_left",
                                      "all_zero_row"])
    def test_kernel_wrappers_take_plain_version_on_cpu(self, name):
        q, k, v, g, m, causal = _t(*_case(name, seed=8)[:5]) + [
            CASES[name][5]]
        o, lse = fa.flash_attention_reference(q, k, v, causal, None, True, m)
        before = (fa.flash_attention_bwd_dq.launches,
                  fa.flash_attention_bwd_dkv.masked_launches)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, g, causal,
                                              None, m)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, g, causal,
                                            None, m)
        want = fa.flash_attention_bwd_reference(q, k, v, o, lse, g, causal,
                                                key_padding_mask=m)
        for a, b in zip((dq, dk, dv), want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        # a CPU tensor launches nothing
        assert before == (fa.flash_attention_bwd_dq.launches,
                          fa.flash_attention_bwd_dkv.masked_launches)

    def test_mask_takes_no_gradient(self):
        q, k, v, g, m, _ = _case("prefix", seed=9)
        tq = torch.from_numpy(q).requires_grad_()
        tm = torch.from_numpy(m.astype(np.float32)).requires_grad_()
        out = fa.FlashAttention.apply(tq, *_t(k, v), False, None, tm)[0]
        dq, dm = torch.autograd.grad(out, (tq, tm), torch.from_numpy(g),
                                     allow_unused=True)
        assert dq is not None and dm is None

    def test_bf16_backward_rounds_like_the_kernel(self):
        """The plain backward in bf16 (dS and P rounded before their
        products, as K2/K3 do) stays near the f32 one with a mask."""
        q, k, v, g, m, causal = _case("cross_causal_left", seed=10)
        q, k, v, g, m = _t(q, k, v, g, m)
        o, lse = fa.flash_attention_reference(q, k, v, causal, None, True, m)
        f32 = fa.flash_attention_bwd_reference(q, k, v, o, lse, g, causal,
                                               key_padding_mask=m)
        bf = [t.bfloat16() for t in (q, k, v, o)]
        b16 = fa.flash_attention_bwd_reference(*bf, lse, g.bfloat16(),
                                               causal, key_padding_mask=m)
        for a, b in zip(b16, f32):
            assert a.dtype == torch.bfloat16
            np.testing.assert_allclose(a.float().numpy(), b.numpy(),
                                       atol=0.1, rtol=0.05)


class TestDispatchRoute:
    """Where the dispatch sends a call on the card (the route is a pure
    function of the gates, so the CPU can read it)."""

    BASE = dict(impl="flash", on_cuda=True, l=128, lk=128, d=64,
                causal=False, has_mask=False, dropout_rate=0.0)

    @pytest.mark.parametrize("change,route", [
        ({}, "kernels"),
        ({"d": 128, "causal": True}, "kernels"),
        ({"lk": 384, "causal": True}, "kernels"),
        ({"impl": "auto"}, "kernels"),
        ({"d": 32}, "k5b"),
        ({"d": 96, "causal": True}, "k5b"),
        ({"d": 32, "lk": 256, "causal": True}, None),
        ({"impl": "einsum"}, None),
        ({"on_cuda": False}, None),
        ({"has_mask": True}, None),
        ({"dropout_rate": 0.1}, None),
        ({"l": 192}, None),
        # under autograd above 128 a key-padding mask still takes the
        # einsum path (K1-K3 at 192 and 256 are unmasked; an unmasked
        # call takes them with or without a gradient:
        # test_torch_port_wide_bwd.py)
        ({"d": 192, "needs_grad": True, "has_key_padding_mask": True}, None),
        ({"d": 192, "causal": True, "needs_grad": True,
          "has_key_padding_mask": True}, None),
        ({"d": 256, "needs_grad": True, "has_key_padding_mask": True}, None),
        ({"d": 256, "causal": True, "needs_grad": True,
          "has_key_padding_mask": True}, None),
        # K1-K3 at D in {192, 256}, unmasked; the reference takes a
        # masked call there, and every other D above 128, to its einsum
        # path. At 320 to 512 the port has K1-K3 too, so a call under a
        # gradient takes them (no-gradient calls below)
        ({"d": 192}, "kernels"),
        ({"d": 256, "causal": True}, "kernels"),
        ({"d": 256, "lk": 384, "causal": True}, "kernels"),
        ({"d": 256, "has_key_padding_mask": True}, None),
        ({"d": 320, "needs_grad": True}, "kernels"),
        ({"d": 512, "causal": True, "needs_grad": True}, "kernels"),
        # a head dim the kernels reach only padded (to 24): still K5b
        ({"d": 20, "causal": True}, "k5b"),
        ({"d": 64, "has_key_padding_mask": True}, "kernels"),
        # K1 at 320 to 512 without a gradient or a mask; a mask, and
        # every D above 512, keep the einsum path
        ({"d": 320}, "kernels"),
        ({"d": 512, "causal": True}, "kernels"),
        ({"d": 512, "has_key_padding_mask": True}, None),
        ({"d": 576}, None),
    ])
    def test_route(self, change, route):
        assert port_attention._flash_route(**dict(self.BASE, **change)) \
            == route

    def test_key_padding_mask_reaches_the_kernels(self, monkeypatch):
        """With a key-padding mask the dispatch calls ``flash_attention``
        with it (on the card: K1, or K1-lse, K2 and K3, with the mask)."""
        from analytics_zoo_tpu_torch.common.config import get_config

        seen = {}

        def spy(q, k, v, causal=False, scale=None, with_lse=False,
                key_padding_mask=None):
            seen["mask"] = key_padding_mask
            return q

        monkeypatch.setattr(fa, "flash_attention", spy)
        monkeypatch.setattr(port_attention, "_flash_route",
                            lambda *a: "kernels")
        q, k, v, _, m, _ = _case("prefix", seed=11)
        mask = torch.from_numpy(m)
        get_config().set("zoo.ops.attention_impl", "flash")
        try:
            port_attention.dot_product_attention(*_t(q, k, v),
                                                 key_padding_mask=mask)
        finally:
            get_config().unset("zoo.ops.attention_impl")
        assert seen["mask"] is mask

    def test_bert_converts_the_mask_once(self, monkeypatch):
        """BERTModule turns ``attention_mask`` into bytes once and hands
        that one tensor to every layer, in the form the wrappers take as
        it is (no conversion per layer)."""
        from analytics_zoo_tpu_torch.keras.layers import transformer

        seen = []
        real = transformer.dot_product_attention

        def spy(q, k, v, mask=None, key_padding_mask=None, **kw):
            seen.append(key_padding_mask)
            return real(q, k, v, mask=mask,
                        key_padding_mask=key_padding_mask, **kw)

        monkeypatch.setattr(transformer, "dot_product_attention", spy)
        bert = transformer.BERTModule(vocab=SMALL["vocab"], hidden_size=128, n_block=2,
                                      n_head=2, intermediate_size=256,
                                      max_position_len=128)
        x, _ = _ner_data(2, 13)
        m = torch.from_numpy(x["attention_mask"]) * 3  # any nonzero = real
        bert({"input_ids": torch.from_numpy(x["input_ids"]).long(),
              "attention_mask": m})
        assert len(seen) == 2 and seen[0] is seen[1]
        assert seen[0].dtype == torch.uint8 and seen[0].is_contiguous()
        assert torch.equal(seen[0].bool(), m != 0)
        assert fa._kernel_mask(seen[0]) is seen[0]

    def test_only_k5b_raises(self, monkeypatch):
        """The "k5b" route raises in neither direction: it calls
        ``flash_attention`` (K5b on the card, K1-lse, K2 and K3 under
        autograd) with the key-padding mask."""
        from analytics_zoo_tpu_torch.common.config import get_config

        seen = {}

        def spy(q, k, v, causal=False, scale=None, with_lse=False,
                key_padding_mask=None):
            seen.update(mask=key_padding_mask, causal=causal, d=q.shape[-1])
            return q

        monkeypatch.setattr(fa, "flash_attention", spy)
        monkeypatch.setattr(port_attention, "_flash_route", lambda *a: "k5b")
        rng = np.random.RandomState(12)
        q, k, v = (torch.from_numpy(rng.randn(2, 2, 128, 32).astype(
            np.float32)) for _ in range(3))
        mask = torch.from_numpy(_mask("prefix", 2, 128, seed=12))
        get_config().set("zoo.ops.attention_impl", "flash")
        try:
            port_attention.dot_product_attention(q, k, v,
                                                 key_padding_mask=mask,
                                                 causal=True)
        finally:
            get_config().unset("zoo.ops.attention_impl")
        assert seen["mask"] is mask and seen["causal"] and seen["d"] == 32


# -------------------------------------------------------- BERT-NER slice --
SMALL = dict(num_classes=9, vocab=512, hidden_size=128, n_block=2,
             n_head=2, intermediate_size=256, max_position_len=128,
             hidden_dropout=0.0)
SEQ, BATCH = 128, 8


def _ner_data(n, seed):
    """Random token ids, per-row real lengths in [2, SEQ] (one full row,
    one of 2), the attention mask, and tags in [0, 9) on real tokens,
    IGNORE_INDEX on padding."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(2, SEQ + 1, n)
    lens[0], lens[1] = SEQ, 2
    mask = (np.arange(SEQ)[None, :] < lens[:, None]).astype(np.int32)
    ids = rng.randint(1, SMALL["vocab"], (n, SEQ)).astype(np.int32) * mask
    tags = np.where(mask == 1, rng.randint(0, SMALL["num_classes"],
                                           (n, SEQ)), IGNORE_INDEX)
    return {"input_ids": ids, "attention_mask": mask}, tags.astype(np.int32)


@pytest.fixture(scope="module")
def ner_fit():
    """Both packages fit 3 Adam steps (24 padded samples, batch 8,
    shuffled) from the JAX package's initial weights; per-step losses
    recorded. Predictions of the initial weights are kept too."""
    from analytics_zoo_tpu.models.text.bert_estimators import (
        BERTNER as RefNER)

    ref = RefNER(**SMALL)
    ref._build_for_load()
    ref.compile(optimizer=ref_optim.Adam(epsilon=1e-5))
    tree = jax.tree_util.tree_map(np.asarray, ref.estimator.variables)
    port = BERTNER(device="cpu", **SMALL)
    load_flax_into(port.module, tree)
    port.compile(optimizer=optim.Adam(epsilon=1e-5))
    x0, _ = _ner_data(12, 1)
    initial = (np.asarray(ref.predict(x0, batch_size=BATCH)),
               port.predict(x0, batch_size=BATCH))

    ref_losses, port_losses = [], []
    step = ref.estimator._build_train_step()

    def ref_step(*args):
        out = step(*args)
        ref_losses.append(float(out[3]))
        return out

    ref.estimator._train_step = ref_step
    real = port.estimator._train_step

    def port_step(x, y):
        loss = real(x, y)
        port_losses.append(float(loss))
        return loss

    port.estimator._train_step = port_step
    x, y = _ner_data(24, 0)
    ref_hist = ref.fit((x, y), batch_size=BATCH, epochs=1)
    port_hist = port.fit((x, y), batch_size=BATCH, epochs=1)
    return dict(ref=ref, port=port, tree=tree, initial=initial,
                ref_losses=ref_losses, port_losses=port_losses,
                ref_hist=ref_hist, port_hist=port_hist)


class TestBERTNERSlice:
    def test_registered_and_exported(self):
        from analytics_zoo_tpu_torch import models
        from analytics_zoo_tpu_torch.models.common import _MODEL_REGISTRY

        assert models.BERTNER is BERTNER
        assert BERTNER.per_token and BERTNER.default_metrics == ()
        assert _MODEL_REGISTRY["BERTNER"] is BERTNER

    def test_bridge_loads_every_flax_leaf(self, ner_fit):
        want = state_dict_from_flax(ner_fit["tree"])
        got = ner_fit["port"].module.state_dict()
        assert set(want) <= set(got)
        assert set(got) - set(want) == {"bert.segment_embed.weight"}

    def test_predict_matches_at_bridged_weights(self, ner_fit):
        want, got = ner_fit["initial"]
        assert got.shape == (12, SEQ, SMALL["num_classes"])
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_step_losses_match(self, ner_fit):
        assert len(ner_fit["port_losses"]) == 3
        np.testing.assert_allclose(ner_fit["port_losses"],
                                   ner_fit["ref_losses"], rtol=1e-4)
        np.testing.assert_allclose(ner_fit["port_hist"][0]["loss"],
                                   ner_fit["ref_hist"][0]["loss"],
                                   rtol=1e-4)

    def test_parameters_after_three_steps_match(self, ner_fit):
        ref_params = jax.tree_util.tree_map(
            np.asarray, ner_fit["ref"].estimator.variables)
        want = state_dict_from_flax(ref_params)
        got = ner_fit["port"].module.state_dict()
        moved = 0
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-4,
                                       err_msg=k)
            moved += int(not np.allclose(
                v.numpy(), state_dict_from_flax(ner_fit["tree"])[k]))
        assert moved > len(want) // 2

    def test_evaluate_predict_and_token_accuracy_match(self, ner_fit):
        from analytics_zoo_tpu.models.text.bert_estimators import (
            BERTNER as RefNER)

        x, y = _ner_data(20, 2)  # a padded tail batch
        want = ner_fit["ref"].evaluate((x, y), batch_size=BATCH)
        got = ner_fit["port"].evaluate((x, y), batch_size=BATCH)
        assert set(got) == set(want) == {"loss"}
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        wl = np.asarray(ner_fit["ref"].predict(x, batch_size=BATCH))
        gl = ner_fit["port"].predict(x, batch_size=BATCH)
        np.testing.assert_allclose(gl, wl, atol=1e-4)
        np.testing.assert_array_equal(BERTNER.decode_tags(gl),
                                      RefNER.decode_tags(wl))
        assert BERTNER.token_accuracy(gl, y) == RefNER.token_accuracy(wl, y)

    def test_token_cross_entropy_matches_reference(self):
        from analytics_zoo_tpu.models.text.bert_estimators import (
            token_cross_entropy as ref_loss)

        rng = np.random.RandomState(13)
        logits = rng.randn(4, 16, 9).astype(np.float32)
        labels = rng.randint(0, 9, (4, 16)).astype(np.int32)
        labels[:, 10:] = IGNORE_INDEX
        labels[3] = IGNORE_INDEX  # a row with no real token
        want = ref_loss(jnp.asarray(logits), jnp.asarray(labels))
        got = token_cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        # nothing real at all: 0, not NaN (the reference's max(n, 1))
        none = np.full((2, 16), IGNORE_INDEX, np.int32)
        assert float(token_cross_entropy(torch.from_numpy(logits[:2]),
                                         torch.from_numpy(none))) == 0.0

    def test_token_accuracy_matches_reference(self):
        from analytics_zoo_tpu.models.text.bert_estimators import (
            BERTNER as RefNER)

        rng = np.random.RandomState(14)
        logits = rng.randn(3, 20, 9).astype(np.float32)
        labels = rng.randint(0, 9, (3, 20)).astype(np.int32)
        labels[:, 15:] = IGNORE_INDEX
        assert BERTNER.token_accuracy(logits, labels) == \
            RefNER.token_accuracy(logits, labels)
        np.testing.assert_array_equal(BERTNER.decode_tags(logits),
                                      RefNER.decode_tags(logits))

    def test_save_and_load_after_fit(self, tmp_path, ner_fit):
        from analytics_zoo_tpu_torch.models.common import ZooModel

        port = ner_fit["port"]
        path = str(tmp_path / "ner")
        port.save_model(path)
        loaded = ZooModel.load_model(path, device="cpu")
        assert isinstance(loaded, BERTNER)
        x, _ = _ner_data(4, 3)
        np.testing.assert_array_equal(loaded.predict(x), port.predict(x))
