"""PyTorch port, BERT: the port's ``_BERTHeadModule`` at weights carried
over from the JAX package by ``bridge.state_dict_from_flax`` gives the
JAX package's logits, ``BERTClassifier`` survives a save/load round
trip, and its ``fit`` trains.

Small configuration: vocab 512, hidden 128, 2 blocks, 2 heads (d=64),
intermediate 256, max_position_len 256, 3 classes.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.text.bert_estimators import (
    _BERTHeadModule as JaxBERTHead)
from analytics_zoo_tpu_torch.bridge import (
    load_flax_into, state_dict_from_flax)
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.models.text.bert_estimators import (
    BERTClassifier, _BERTHeadModule)

torch.set_num_threads(2)

CFG = dict(vocab=512, num_classes=3, hidden_size=128, n_block=2,
           n_head=2, intermediate_size=256, max_position_len=256)
B, L = 2, 64


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG["vocab"], (B, L)).astype(np.int32)
    types = (rng.rand(B, L) > 0.5).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[0, 40:] = 0
    mask[1, 9:] = 0
    return {"input_ids": ids, "token_type_ids": types,
            "attention_mask": mask}


def _pair(jax_dtype, torch_dtype):
    """A JAX-initialised head (segment embedding included) and the
    port's head with the same weights."""
    jm = JaxBERTHead(per_token=False, dtype=jax_dtype, **CFG)
    x = {k: jnp.asarray(v) for k, v in _inputs().items()}
    variables = jm.init(jax.random.PRNGKey(0), x)
    tree = jax.tree_util.tree_map(np.asarray, variables)
    pm = _BERTHeadModule(per_token=False, dtype=torch_dtype, **CFG)
    load_flax_into(pm, tree).eval()
    return jm, variables, pm, tree


def _run_both(jm, variables, pm, x):
    want = jm.apply(variables, {k: jnp.asarray(v) for k, v in x.items()},
                    train=False)
    with torch.no_grad():
        got = pm({k: torch.from_numpy(v) for k, v in x.items()})
    return got.numpy(), np.asarray(want)


@pytest.fixture(scope="module")
def f32_pair():
    return _pair(jnp.float32, torch.float32)


class TestBridge:
    def test_keys_and_shapes_match_port_state_dict(self, f32_pair):
        _, _, pm, tree = f32_pair
        sd = state_dict_from_flax(tree)
        port = pm.state_dict()
        assert sorted(sd) == sorted(port)
        for k, v in sd.items():
            assert tuple(v.shape) == tuple(port[k].shape), k
        # fused qkv: flax [H_in, 3, H] -> port [3, H, H_in]
        flax_qkv = tree["params"]["bert"]["encoder_0"]["attention"][
            "qkv"]["kernel"]
        np.testing.assert_array_equal(
            sd["bert.encoder_0.attention.qkv.weight"].numpy(),
            np.moveaxis(flax_qkv, 0, -1))

    def test_missing_segment_embed_is_tolerated(self):
        jm = JaxBERTHead(per_token=False, **CFG)
        ids = jnp.asarray(_inputs()["input_ids"])
        tree = jax.tree_util.tree_map(
            np.asarray, jm.init(jax.random.PRNGKey(1), ids))
        assert "segment_embed" not in tree["params"]["bert"]
        pm = load_flax_into(_BERTHeadModule(per_token=False, **CFG), tree)
        want = jm.apply(jax.tree_util.tree_map(jnp.asarray, tree), ids)
        with torch.no_grad():
            got = pm.eval()(torch.tensor(np.asarray(ids)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4)


class TestLogitsParity:
    # f32 on both sides: the same function summed in another order
    @pytest.mark.parametrize("keys", [
        ("input_ids",),
        ("input_ids", "attention_mask"),
        ("input_ids", "token_type_ids", "attention_mask"),
    ])
    def test_f32(self, f32_pair, keys):
        jm, variables, pm, _ = f32_pair
        x = {k: v for k, v in _inputs(3).items() if k in keys}
        got, want = _run_both(jm, variables, pm, x)
        assert got.shape == (B, CFG["num_classes"])
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_bare_input_ids(self, f32_pair):
        jm, variables, pm, _ = f32_pair
        ids = _inputs(4)["input_ids"]
        want = jm.apply(variables, jnp.asarray(ids))
        with torch.no_grad():
            got = pm(torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4)

    def test_bf16(self):
        # bf16 encoder, f32 head: the two frameworks round at different
        # points (flax rounds the matmul before adding the bias, torch
        # after), so logits of size ~1 agree to a few bf16 ulps
        jm, variables, pm, _ = _pair(jnp.bfloat16, torch.bfloat16)
        got, want = _run_both(jm, variables, pm, _inputs(5))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=2e-2)


class TestSaveLoad:
    def test_round_trip(self, tmp_path):
        model = BERTClassifier(device="cpu", seed=7, **CFG)
        x = {k: v for k, v in _inputs(6).items()}
        want = model.predict(x, batch_size=2)
        path = str(tmp_path / "bert")
        model.save_model(path)
        with open(os.path.join(path, "config.json")) as f:
            meta = json.load(f)
        assert meta["class"] == "BERTClassifier"
        assert meta["config"] == dict(CFG, hidden_dropout=0.1,
                                      dtype="float32")
        assert os.path.isfile(os.path.join(path, "weights",
                                           "state_dict.pt"))
        loaded = ZooModel.load_model(path, device="cpu")
        assert isinstance(loaded, BERTClassifier)
        np.testing.assert_array_equal(loaded.predict(x, batch_size=2),
                                      want)
        assert "total params" in loaded.summary()

    def test_seeds_differ(self):
        a = BERTClassifier(device="cpu", seed=0, **CFG).module
        b = BERTClassifier(device="cpu", seed=1, **CFG).module
        c = BERTClassifier(device="cpu", seed=0, **CFG).module
        w = "bert.encoder_0.ffn_in.weight"
        assert not torch.equal(a.state_dict()[w], b.state_dict()[w])
        assert torch.equal(a.state_dict()[w], c.state_dict()[w])

    def test_fit_trains_the_weights(self):
        """``fit`` runs through the Estimator with the reference's
        defaults (sparse categorical cross-entropy, Adam, accuracy) and
        moves the weights; ``evaluate`` reports loss and accuracy."""
        model = BERTClassifier(device="cpu", seed=2, **CFG)
        x = _inputs(7)
        y = np.array([0, 2], np.int32)
        w = "bert.encoder_1.ffn_in.weight"
        before = model.module.state_dict()[w].clone()
        hist = model.fit((x, y), batch_size=2, epochs=2)
        assert [h["epoch"] for h in hist] == [1, 2]
        assert all(np.isfinite(h["loss"]) for h in hist)
        assert not torch.equal(model.module.state_dict()[w], before)
        assert set(model.evaluate((x, y), batch_size=2)) == {"accuracy",
                                                             "loss"}
