"""PyTorch port, Keras slice 3a: ``BERT`` and ``TransformerLayer`` (the
Keras wrappers of ``BERTModule`` and ``TransformerModule``) inside a
functional ``Model``, held against the JAX package on the CPU.

Small configuration: vocab 50, hidden 32, 2 blocks of 4 heads,
intermediate 64, 16 positions, batch 8; ids and targets made from a
seed with numpy; the port's weights are the JAX model's (moved by a
seeded draw so that LayerNorm scales and biases are not at their
constants), copied across by ``bridge``. Each JAX model is built once
per module. Tolerance 1e-4 (1 + |ref|) for outputs and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras import Input as RefInput
from analytics_zoo_tpu.keras import Model as RefModel
from analytics_zoo_tpu.keras import layers as RL
from analytics_zoo_tpu.learn.objectives import (
    sparse_categorical_crossentropy as ref_sce)
from analytics_zoo_tpu_torch.bridge import (flatten, load_flax_into,
                                            to_flax_layout,
                                            variables_from_module)
from analytics_zoo_tpu_torch.keras import Input, Model
from analytics_zoo_tpu_torch.keras import layers as PL
from analytics_zoo_tpu_torch.learn.objectives import (
    sparse_categorical_crossentropy)
from analytics_zoo_tpu_torch.learn.optim import param_tree

torch.set_num_threads(2)

VOCAB, HIDDEN, BLOCKS, HEADS, INTER, SEQ, BATCH = 50, 32, 2, 4, 64, 16, 8
TOL = 1e-4


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    excess = np.abs(got - want) - TOL * (1 + np.abs(want))
    assert excess.max() <= 0, (what, float(excess.max()))


def _tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _ids(seed):
    return np.random.RandomState(seed).randint(
        0, VOCAB, (BATCH, SEQ)).astype(np.int32)


def _bert(L, Input, Model):
    ids = Input((SEQ,))
    h = L.BERT(vocab=VOCAB, hidden_size=HIDDEN, n_block=BLOCKS,
               n_head=HEADS, intermediate_size=INTER,
               max_position_len=SEQ)(ids)
    return Model(ids, L.Dense(2)(L.Dropout(0.1)(L.SelectTable(1)(h))))


def _transformer(L, Input, Model):
    ids = Input((SEQ,))
    h = L.TransformerLayer(vocab=VOCAB, seq_len=SEQ, hidden_size=HIDDEN,
                           n_head=HEADS, n_block=BLOCKS,
                           intermediate_size=INTER)(ids)
    return Model(ids, L.Dense(3)(h))


BUILDS = {"bert": _bert, "transformer": _transformer}


def _port_model(build):
    return build(PL, Input, lambda i, o: Model(i, o, device="cpu"))


@pytest.fixture(scope="module")
def ref_models():
    """{name: (JAX model, its moved weights)}, each built once."""
    out = {}
    rng = np.random.RandomState(0)
    for name, build in BUILDS.items():
        ref = build(RL, RefInput, RefModel)
        ref.predict(_ids(1), batch_size=BATCH)
        moved = jax.tree_util.tree_map(
            lambda a: (a + 0.05 * rng.randn(*a.shape)).astype(np.float32),
            _tree(ref.estimator.variables))
        ref.estimator.variables = jax.tree_util.tree_map(jnp.asarray, moved)
        out[name] = (ref, moved)
    return out


def _bridged(name, ref_models):
    ref, moved = ref_models[name]
    port = _port_model(BUILDS[name])
    port.materialize(_ids(1))
    load_flax_into(port.module, moved)
    return ref, moved, port


def test_bert_parameter_tree_is_flax_s(ref_models):
    """The functional Model ``Input -> BERT -> SelectTable(1) -> Dropout
    -> Dense`` holds BERT's tree under ``modules_0`` and the head under
    ``modules_3/Dense_0``, flax's paths (the port's BERT also has the
    segment table, which flax makes only for token type ids)."""
    ref, moved, port = _bridged("bert", ref_models)
    want = flatten(moved)
    got = flatten(variables_from_module(port.module))
    assert set(got) - set(want) == {
        "params/modules_0/segment_embed/embedding"}
    assert set(want) <= set(got)
    assert "params/modules_3/Dense_0/kernel" in want
    assert all(k.split("/")[1] in ("modules_0", "modules_3") for k in want)


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_forward_matches_reference(name, ref_models):
    ref, _, port = _bridged(name, ref_models)
    x = _ids(2)
    want = ref.predict(x, batch_size=BATCH)
    got = port.predict(x, batch_size=BATCH)
    _close(got, want, name)


def _ref_loss(name, out, y):
    if name == "bert":
        return ref_sce(out, y)
    return jnp.mean((out - y) ** 2)


def _loss(name, out, y):
    if name == "bert":
        return sparse_categorical_crossentropy(out, y)
    return torch.mean((out - y) ** 2)


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_gradient_matches_reference(name, ref_models):
    """One step's gradients (dropout off) at the same weights: every
    parameter's, within 1e-4 (1 + |ref|), and the loss."""
    ref, moved, port = _bridged(name, ref_models)
    x = _ids(3)
    rng = np.random.RandomState(4)
    y = (rng.randint(0, 2, BATCH).astype(np.int32) if name == "bert"
         else rng.randn(BATCH, SEQ, 3).astype(np.float32))
    module = ref.module
    params = jax.tree_util.tree_map(jnp.asarray, moved["params"])

    def loss_fn(p):
        return _ref_loss(name, module.apply({"params": p}, x), y)

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss = _loss(name, port.module(torch.from_numpy(x)),
                 torch.from_numpy(y))
    loss.backward()
    _close(float(loss.detach()), float(want_loss), "loss")
    want = flatten(_tree(want))
    got = {path: to_flax_layout(path, p.grad.numpy())
           for path, p in param_tree(port.module).items()
           if p.grad is not None}
    assert set(got) == set(want)
    for path, g in want.items():
        _close(got[path], g, path)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_bert_weights_cross_between_packages(tmp_path, saver):
    """The Keras BERT ``Model`` fitted one epoch (2 steps) in one
    package, ``save_weights``, then ``load_weights`` in the other into a
    fresh compiled model (the port's before any data): the same
    predictions and step count."""
    rng = np.random.RandomState(5)
    x = rng.randint(0, VOCAB, (2 * BATCH, SEQ)).astype(np.int32)
    y = rng.randint(0, 2, 2 * BATCH).astype(np.int32)
    path = str(tmp_path / saver)
    ref = _bert(RL, RefInput, RefModel)
    port = _port_model(_bert)
    for m in (ref, port):
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    src, dst = (ref, port) if saver == "jax" else (port, ref)
    src.fit(x, y, batch_size=BATCH, nb_epoch=1)
    src.save_weights(path)
    dst.load_weights(path)
    got = dst.predict(x, batch_size=BATCH)
    assert dst.estimator.global_step == 2
    _close(got, src.predict(x, batch_size=BATCH), saver)


def test_keras_bert_filters_keywords():
    """The wrappers pass on the model's keywords and leave the layer's
    own (``name``) to KerasLayer, as the reference's filter does."""
    layer = PL.BERT(vocab=VOCAB, hidden_size=HIDDEN, n_block=1,
                    n_head=HEADS, intermediate_size=INTER,
                    max_position_len=SEQ, type_vocab=3,
                    hidden_dropout=0.0, attn_dropout=0.2, name="bert")
    assert layer.name == "bert"
    mod = layer.build()
    assert mod.segment_embed.weight.shape == (3, HIDDEN)
    assert mod.encoder_0.attention.attn_dropout == 0.2
    t = PL.TransformerLayer(vocab=VOCAB, seq_len=SEQ, hidden_size=HIDDEN,
                            n_head=HEADS, n_block=1, output_all_block=True)
    assert t.build().output_all_block
    assert PL.BERT is PL.BERTKL and PL.TransformerLayer is \
        PL.TransformerLayerKL
    with pytest.raises(TypeError):
        PL.BERT(vocab=VOCAB, nope=1)
