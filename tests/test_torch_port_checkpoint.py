"""PyTorch port, saved models and checkpoints across the two packages:
the port's flax msgpack codec against ``flax.serialization`` both ways
(byte for byte, a chunked array included), the optimizer state in the
layout flax gives the optax chain's state, ``save_model`` in one package
and ``load_model`` / ``InferenceModel.load_zoo`` / ``launch()`` in the
other, and ``fit(resume=True)`` from the other package's checkpoint.

Small configuration: BERT vocab 512, hidden 64, 2 blocks, 2 heads (d=32),
intermediate 128, 64 positions, f32, hidden dropout 0 (so a resumed
step is deterministic); 3 classes or 5 tags.
"""

import copy
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from analytics_zoo_tpu.learn import optim as ref_optim
from analytics_zoo_tpu.learn.estimator import Estimator as RefEstimator
from analytics_zoo_tpu.models.common import ZooModel as RefZooModel
from analytics_zoo_tpu.models.text.bert_estimators import (
    BERTClassifier as RefBERTClassifier, BERTNER as RefBERTNER)
from analytics_zoo_tpu_torch.bridge import (
    flatten, from_flax_layout, load_flax_into, state_dict_from_flax,
    variables_from_module)
from analytics_zoo_tpu_torch.inference.inference_model import (
    InferenceModel)
from analytics_zoo_tpu_torch.keras.layers.transformer import reset_parameters
from analytics_zoo_tpu_torch.learn import checkpoint as ckpt_lib
from analytics_zoo_tpu_torch.learn import optim
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.models.text.bert_estimators import (
    BERTClassifier, BERTNER)
from analytics_zoo_tpu_torch.serving.launcher import launch
from analytics_zoo_tpu_torch.utils import flax_msgpack
from tests.test_torch_port_learn import OPTIMIZERS, _flat, _make_opt
from tests.test_torch_port_learn import _opt_params
from tests.test_torch_port_serving import _serve

torch.set_num_threads(2)

SEQ, N = 32, 16
CLS = dict(num_classes=3, vocab=512, hidden_size=64, n_block=2, n_head=2,
           intermediate_size=128, max_position_len=64, hidden_dropout=0.0)
NER = dict(CLS, num_classes=5)
# f32 models at the same weights: the frameworks differ only in the
# order of f32 sums
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _drop_port_flight_recorder():
    # launch() installs the port's process-wide crash hooks
    yield
    from analytics_zoo_tpu_torch.obs.flight import (
        uninstall_flight_recorder)

    uninstall_flight_recorder()


def _data(seed, ner=False):
    rng = np.random.RandomState(seed)
    x = {"input_ids": rng.randint(0, CLS["vocab"], (N, SEQ)
                                  ).astype(np.int32)}
    if ner:
        y = rng.randint(0, NER["num_classes"], (N, SEQ)).astype(np.int32)
    else:
        y = rng.randint(0, CLS["num_classes"], N).astype(np.int32)
    return x, y


# ---------------------------------------------------------------- codec --
def _rng_tree(seed):
    rng = np.random.RandomState(seed)
    return {
        "params": {"dense": {"kernel": rng.randn(3, 4).astype(np.float32),
                             "bias": np.zeros(4, np.float32)},
                   "ids": rng.randint(-9, 9, (2, 300)).astype(np.int32),
                   "empty": np.zeros((0, 3), np.float64)},
        "count": np.asarray(5, np.int32), "small": 7, "neg": -3,
        "neg8": -100, "u16": 70000, "i32": -70000, "u64": 2 ** 40,
        "float": 1.5, "short": "ab", "long": "x" * 40, "yes": True,
        "none": None, "bytes": b"abc", "u8": np.arange(5, dtype=np.uint8),
        "flags": np.array([True, False]), "scalar": np.float32(2.5),
        "wide": {str(i): i for i in range(20)}}


def _same(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (np.ndarray, np.generic)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


class TestCodec:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_bytes_equal_flax(self, seed):
        tree = _rng_tree(seed)
        want = serialization.msgpack_serialize(copy.deepcopy(tree),
                                               in_place=True)
        assert flax_msgpack.serialize(tree) == want

    @pytest.mark.parametrize("direction", ["flax_to_port", "port_to_flax"])
    def test_restore_reads_the_other(self, direction):
        tree = _rng_tree(2)
        if direction == "flax_to_port":
            got = flax_msgpack.restore(serialization.msgpack_serialize(
                copy.deepcopy(tree), in_place=True))
        else:
            got = serialization.msgpack_restore(
                flax_msgpack.serialize(tree))
        _same(serialization.msgpack_restore(serialization.msgpack_serialize(
            copy.deepcopy(tree), in_place=True)), got)

    def test_bfloat16_round_trip(self):
        x = jnp.asarray(np.random.RandomState(3).randn(4, 5), jnp.bfloat16)
        data = serialization.to_bytes({"w": x})
        got = flax_msgpack.restore(data)["w"]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(x.astype(jnp.float32)))
        assert flax_msgpack.serialize({"w": got}) == data

    def test_chunked_array_both_ways(self, monkeypatch):
        """An array above MAX_CHUNK_SIZE bytes is written in flax's
        chunked layout (a small limit stands in for flax's 1 GiB)."""
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
        rng = np.random.RandomState(4)
        tree = {"embed": {"embedding": rng.randn(10, 7).astype(np.float32)},
                "small": np.ones(3, np.float32)}
        want = serialization.msgpack_serialize(copy.deepcopy(tree),
                                               in_place=True)
        assert flax_msgpack.serialize(tree) == want
        raw = serialization.msgpack_restore(want)
        assert raw["embed"]["embedding"].shape == (10, 7)
        got = flax_msgpack.restore(want)
        np.testing.assert_array_equal(got["embed"]["embedding"],
                                      tree["embed"]["embedding"])
        np.testing.assert_array_equal(got["small"], tree["small"])

    def test_truncated_data_raises(self):
        data = flax_msgpack.serialize(_rng_tree(5))
        with pytest.raises(ValueError):
            flax_msgpack.restore(data[:-3])
        with pytest.raises(ValueError, match="trailing"):
            flax_msgpack.restore(data + b"\xc0")


# ------------------------------------------------------ optimizer state --
def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(np.shape(tree)), str(np.asarray(tree).dtype))


def _optax_and_port(name, kwargs, steps=3):
    """The same optimizer in both packages, ``steps`` updates from the
    same gradients: (optax state dict, port state, port template)."""
    params = _opt_params()
    rng = np.random.RandomState(1)
    grads = [jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.5).astype(np.float32), params)
        for _ in range(steps)]
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), params)
    jtx = RefEstimator._with_clipping(
        _make_opt(ref_optim, name, kwargs).to_optax(), 1.0, None)
    jstate = jtx.init(jparams)
    def port(flat):
        # the port's axes: a kernel's input axis last, as in its modules
        return {k: torch.tensor(from_flax_layout(k, v), dtype=torch.float32)
                for k, v in flat.items()}

    tparams = port(_flat(params))
    ttx = optim.with_clipping(_make_opt(optim, name, kwargs).to_transform(),
                              1.0, None)
    tstate = ttx.init(tparams)
    for g in grads:
        _, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, g),
                               jstate, jparams)
        _, tstate = ttx.update(port(_flat(g)), tstate, tparams)
    want = jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(jstate))
    return want, tstate, ttx.init(tparams)


class TestOptimizerState:
    @pytest.mark.parametrize("name,kwargs", OPTIMIZERS,
                             ids=[f"{n}-{i}" for i, (n, _) in
                                  enumerate(OPTIMIZERS)])
    def test_layout_and_values_are_optax(self, name, kwargs):
        """The port's state, written, is the optax chain's state dict:
        the same keys, shapes and dtypes (counts int32), the same
        values; and read back into a fresh ``init`` it is the port's
        state again."""
        want, tstate, template = _optax_and_port(name, kwargs)
        got = ckpt_lib.opt_state_to_flax(tstate)
        assert _shapes(got) == _shapes(want)
        flat_got, flat_want = flatten(got), flatten(want)
        for k in flat_want:
            np.testing.assert_allclose(flat_got[k], flat_want[k], atol=1e-6,
                                       err_msg=k)
        back = ckpt_lib.opt_state_from_flax(template, want)
        assert _shapes(ckpt_lib.opt_state_to_flax(back)) == _shapes(want)
        for k, v in flatten(ckpt_lib.opt_state_to_flax(back)).items():
            np.testing.assert_allclose(v, flat_want[k], atol=1e-6,
                                       err_msg=k)

    def test_other_optimizer_raises(self):
        want, _, _ = _optax_and_port("Adam", {})
        _, _, template = _optax_and_port("SGD", dict(lr=0.05, momentum=0.8))
        with pytest.raises(ValueError, match="does not match"):
            ckpt_lib.opt_state_from_flax(template, want)

    def test_missing_parameter_keeps_its_fresh_state(self):
        """A parameter the saving package never created (the JAX
        package's BERT without ``token_type_ids`` has no
        ``segment_embed``) keeps the template's entry."""
        want, _, template = _optax_and_port("Adam", {})
        del want["1"]["0"]["mu"]["head"]
        back = ckpt_lib.opt_state_from_flax(template, want)
        assert back[1][0]["mu"]["head/kernel"] is \
            template[1][0]["mu"]["head/kernel"]
        assert not torch.equal(back[1][0]["mu"]["encoder/dense/kernel"],
                               template[1][0]["mu"]["encoder/dense/kernel"])


# ----------------------------------------------------- saved ZooModels --
MODELS = {"classifier": (RefBERTClassifier, BERTClassifier, CLS, False),
          "ner": (RefBERTNER, BERTNER, NER, True)}


def _ref_model(kind, fit_seed=None):
    ref_cls, _, cfg, ner = MODELS[kind]
    ref = ref_cls(**cfg)
    ref._build_for_load()
    if fit_seed is not None:
        ref.compile(optimizer=ref_optim.Adam(epsilon=1e-5))
        ref.fit(_data(fit_seed, ner), batch_size=8, epochs=1)
    return ref


@pytest.mark.parametrize("kind", sorted(MODELS))
class TestSavedModels:
    def test_jax_saved_loads_in_the_port(self, tmp_path, kind):
        """``load_model`` and ``InferenceModel.load_zoo`` read a directory
        the JAX package saved (after a fit, so the optimizer state is
        not at its start), with the JAX model's outputs."""
        _, port_cls, _, ner = MODELS[kind]
        ref = _ref_model(kind, fit_seed=0)
        path = str(tmp_path / "jax_saved")
        ref.save_model(path)
        x, _ = _data(9, ner)
        want = np.asarray(ref.predict(x, batch_size=8))
        loaded = ZooModel.load_model(path, device="cpu")
        assert isinstance(loaded, port_cls)
        assert loaded.estimator.global_step == ref.estimator.global_step
        np.testing.assert_allclose(loaded.predict(x, batch_size=8), want,
                                   atol=ATOL)
        served = InferenceModel(device="cpu").load_zoo(path)
        np.testing.assert_allclose(served.predict(x), want, atol=ATOL)

    def test_port_saved_loads_in_jax(self, tmp_path, kind):
        _, port_cls, cfg, ner = MODELS[kind]
        port = port_cls(device="cpu", seed=3, **cfg)
        port.fit(_data(1, ner), batch_size=8, epochs=1)
        path = str(tmp_path / "port_saved")
        port.save_model(path)
        for name in ("config.json", "weights/model.2", "weights/optim.2",
                     "weights/meta.2.json", "weights/latest"):
            assert os.path.isfile(os.path.join(path, name)), name
        x, _ = _data(9, ner)
        loaded = RefZooModel.load_model(path)
        assert loaded.estimator.global_step == 2
        np.testing.assert_allclose(
            np.asarray(loaded.predict(x, batch_size=8)),
            port.predict(x, batch_size=8), atol=ATOL)

    def test_inference_load_reads_the_weights_alone(self, tmp_path, kind):
        """``load_zoo`` (and ``launch()``, through it) restores the
        weights only: it builds no optimizer state and needs no
        ``optim.<step>``, which ``load_model`` does read."""
        _, port_cls, cfg, ner = MODELS[kind]
        port = port_cls(device="cpu", seed=4, **cfg)
        port.fit(_data(2, ner), batch_size=8, epochs=1)
        path = str(tmp_path / "port_saved")
        port.save_model(path)
        os.remove(os.path.join(path, "weights", "optim.2"))
        x, _ = _data(9, ner)
        served = InferenceModel(device="cpu").load_zoo(path)
        # one batch of N on both sides: the same f32 sums
        np.testing.assert_array_equal(served.predict(x),
                                      port.predict(x, batch_size=N))
        weights_only = ZooModel.load_model(path, device="cpu",
                                           with_optim=False)
        assert weights_only.estimator.opt_state is None
        with pytest.raises(FileNotFoundError, match="optim.2"):
            ZooModel.load_model(path, device="cpu")



def test_launch_serves_a_jax_saved_model(tmp_path):
    """``launch({"model": {"path": ...}})`` over the JAX package's
    directory answers every request with the JAX model's output."""
    ref = _ref_model("classifier")
    path = str(tmp_path / "jax_saved")
    ref.save_model(path)
    rng = np.random.RandomState(12)
    reqs = {f"r{i:02d}": rng.randint(0, CLS["vocab"], SEQ).astype(np.int32)
            for i in range(6)}
    app = launch({"model": {"path": path},
                  "params": {"batch_size": 4, "warm_batch_sizes": [1, 4],
                             "warm_example": np.zeros((1, SEQ), np.int32)},
                  "http": {"enabled": False}}, device="cpu")
    try:
        got = _serve(app, reqs)
    finally:
        app.stop()
    uris = sorted(reqs)
    want = np.asarray(ref.predict(
        {"input_ids": np.stack([reqs[u] for u in uris])}, batch_size=8))
    np.testing.assert_allclose(np.stack([got[u]["output"] for u in uris]),
                               want, atol=ATOL)


# --------------------------------------------------------------- resume --
def _resume_both(ckpt, tmp_path, kind):
    """Each package resumes a copy of ``ckpt`` for a second epoch (2
    steps, shuffled as in the first): (port, ref, port history, ref
    history)."""
    ref_cls, port_cls, cfg, ner = MODELS[kind]
    x, y = _data(0, ner)
    port_dir, ref_dir = str(tmp_path / "port_run"), str(tmp_path / "ref_run")
    shutil.copytree(ckpt, port_dir)
    shutil.copytree(ckpt, ref_dir)
    # other initial weights, and the seed (0) that shuffles the epoch
    # as the JAX package does
    port = port_cls(device="cpu", **cfg)
    reset_parameters(port.module, 5)
    port.compile(optimizer=optim.Adam(epsilon=1e-5))
    port_hist = port.fit((x, y), batch_size=8, epochs=2,
                         checkpoint_dir=port_dir, resume=True)
    ref = ref_cls(**cfg)
    ref.compile(optimizer=ref_optim.Adam(epsilon=1e-5))
    ref_hist = ref.fit((x, y), batch_size=8, epochs=2,
                       checkpoint_dir=ref_dir, resume=True)
    return port, ref, port_hist, ref_hist


def _check_resumed(port, ref, port_hist, ref_hist):
    assert (port.estimator.global_step, port.estimator.epoch) == (4, 2)
    assert (ref.estimator.global_step, ref.estimator.epoch) == (4, 2)
    # the epoch's 2 steps: the second after one update from the restored
    # optimizer state
    np.testing.assert_allclose(port_hist[-1]["loss"], ref_hist[-1]["loss"],
                               rtol=1e-4)
    want = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, ref.estimator.variables))
    got = port.module.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("kind", sorted(MODELS))
class TestResume:
    def test_resume_from_a_jax_checkpoint(self, tmp_path, kind):
        ref_cls, _, cfg, ner = MODELS[kind]
        first = ref_cls(**cfg)
        first.compile(optimizer=ref_optim.Adam(epsilon=1e-5))
        ckpt = str(tmp_path / "jax_ckpt")
        first.fit(_data(0, ner), batch_size=8, epochs=1,
                  checkpoint_dir=ckpt)
        assert ckpt_lib.latest_step(ckpt) == 2
        _check_resumed(*_resume_both(ckpt, tmp_path, kind))

    def test_resume_from_a_port_checkpoint(self, tmp_path, kind):
        _, port_cls, cfg, ner = MODELS[kind]
        first = port_cls(device="cpu", seed=4, **cfg)
        first.compile(optimizer=optim.Adam(epsilon=1e-5))
        ckpt = str(tmp_path / "port_ckpt")
        first.fit(_data(0, ner), batch_size=8, epochs=1,
                  checkpoint_dir=ckpt)
        _check_resumed(*_resume_both(ckpt, tmp_path, kind))


class TestVariables:
    def test_inverse_of_state_dict_from_flax(self):
        """``variables_from_module`` is the JAX package's tree: the same
        paths, shapes and values ``load_flax_into`` took in."""
        ref = _ref_model("classifier")
        tree = jax.tree_util.tree_map(np.asarray, ref.estimator.variables)
        port = BERTClassifier(device="cpu", **CLS)
        load_flax_into(port.module, tree)
        got = flatten(variables_from_module(port.module))
        want = flatten(tree)
        # the port's BERT always has a segment embedding; this JAX one
        # was built without token_type_ids
        assert set(got) - set(want) == {
            "params/bert/segment_embed/embedding"}
        for k, v in want.items():
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], v, err_msg=k)
