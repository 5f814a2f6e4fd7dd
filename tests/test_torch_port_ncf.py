"""PyTorch port, NCF slice: ``NeuralCFNet``, its loss and metric, the
recommender's ranking, three Adam steps through both Estimators and
saved models in both directions, held against the JAX package on the
CPU.

Small configuration: 40 users, 30 items, 5 rating classes, embeddings of
8, hidden layers (16, 8), mf embeddings of 6; ids and ratings made from
a seed with numpy; the port's weights copied from the JAX package's
initial tree through ``bridge``.
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.common import ZooModel as RefZooModel
from analytics_zoo_tpu.models.common import softmax_probs as ref_softmax
from analytics_zoo_tpu.models.common import topk_with_probs as ref_topk
from analytics_zoo_tpu.models.recommendation.ncf import (
    NeuralCF as RefNeuralCF, NeuralCFNet as RefNeuralCFNet,
    _RatingAccuracy as RefRatingAccuracy, _shifted_ce as ref_shifted_ce)
from analytics_zoo_tpu_torch.bridge import load_flax_into, state_dict_from_flax
from analytics_zoo_tpu_torch.models import (
    NeuralCF, Recommender, UserItemFeature, UserItemPrediction, ZooModel,
    softmax_probs, topk_with_probs)
from analytics_zoo_tpu_torch.models.recommendation.ncf import (
    NeuralCFNet, _RatingAccuracy, _shifted_ce)

torch.set_num_threads(2)

USERS, ITEMS, CLASSES = 40, 30, 5
CFG = dict(user_count=USERS, item_count=ITEMS, class_num=CLASSES,
           user_embed=8, item_embed=8, hidden_layers=(16, 8), mf_embed=6)
TOL = 1e-5


def _pairs(n, seed):
    rng = np.random.RandomState(seed)
    x = np.stack([rng.randint(1, USERS + 1, n),
                  rng.randint(1, ITEMS + 1, n)], axis=1).astype(np.int32)
    y = rng.randint(1, CLASSES + 1, n).astype(np.int32)
    return x, y


def _tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _bridged(ref):
    """A port NeuralCF at the JAX model's weights."""
    port = NeuralCF(device="cpu", **CFG)
    load_flax_into(port.module, _tree(ref.estimator.variables))
    return port


@pytest.fixture(scope="module")
def ref_model():
    ref = RefNeuralCF(**CFG)
    ref._build_for_load()
    return ref


def test_helpers_match_reference():
    logits = np.random.RandomState(0).randn(6, 7).astype(np.float32)
    np.testing.assert_allclose(softmax_probs(logits), ref_softmax(logits),
                               rtol=1e-6)
    probs = ref_softmax(logits)
    assert topk_with_probs(probs, 3) == ref_topk(probs, 3)


@pytest.mark.parametrize("include_mf", [True, False])
def test_forward_matches_flax(include_mf):
    cfg = dict(CFG, include_mf=include_mf)
    flax_net = RefNeuralCFNet(**dict(cfg, hidden_layers=tuple(
        cfg["hidden_layers"])))
    x, _ = _pairs(32, 1)
    variables = flax_net.init(jax.random.PRNGKey(3), x)
    want = np.asarray(flax_net.apply(variables, x))
    net = NeuralCFNet(**cfg)
    load_flax_into(net, _tree(variables))
    assert net.mlp_user_embed.weight.shape == (USERS + 1, 8)
    assert net.mlp_item_embed.weight.shape == (ITEMS + 1, 8)
    assert hasattr(net, "mf_user_embed") == include_mf
    got = net(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (32, CLASSES)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_loss_and_metric_match_reference():
    rng = np.random.RandomState(2)
    preds = rng.randn(16, CLASSES).astype(np.float32)
    _, labels = _pairs(16, 2)
    np.testing.assert_allclose(
        float(_shifted_ce(torch.from_numpy(preds), labels)),
        float(ref_shifted_ce(preds, labels)), rtol=1e-6)
    weights = (rng.rand(16) > 0.25).astype(np.float32)
    ref_m, m = RefRatingAccuracy(), _RatingAccuracy()
    want = ref_m.result(ref_m.update(ref_m.empty(), preds, labels, weights))
    got = m.result(m.update(m.empty(), torch.from_numpy(preds), labels,
                            weights))
    assert m.name == ref_m.name == "accuracy"
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_three_adam_steps_match(ref_model):
    """Both Estimators take 3 Adam steps (24 pairs, batch 8, shuffled
    alike) from the JAX package's initial weights; the losses, the
    parameters and ``evaluate`` agree."""
    ref = RefNeuralCF(**CFG)
    ref._build_for_load()
    port = _bridged(ref)
    x, y = _pairs(24, 4)
    ref_hist = ref.fit((x, y), batch_size=8, epochs=1)
    port_hist = port.fit((x, y), batch_size=8, epochs=1)
    assert port.estimator.global_step == ref.estimator.global_step == 3
    np.testing.assert_allclose(port_hist[0]["loss"], ref_hist[0]["loss"],
                               rtol=1e-5)
    want = state_dict_from_flax(_tree(ref.estimator.variables))
    got = port.module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=TOL,
                                   err_msg=k)
    xe, ye = _pairs(20, 5)  # a padded tail batch
    want_eval = ref.evaluate((xe, ye), batch_size=8)
    got_eval = port.evaluate((xe, ye), batch_size=8)
    assert set(got_eval) == set(want_eval) == {"accuracy", "loss"}
    for k in want_eval:
        np.testing.assert_allclose(got_eval[k], want_eval[k], rtol=1e-5)


def test_recommendations_match(ref_model):
    port = _bridged(ref_model)
    assert isinstance(port, Recommender)
    for port_recs, ref_recs in [
            (port.recommend_for_user(7, 5),
             ref_model.recommend_for_user(7, 5)),
            (port.recommend_for_item(11, 4, candidate_users=range(1, 30)),
             ref_model.recommend_for_item(11, 4,
                                          candidate_users=range(1, 30))),
            (port.predict_user_item_pair([UserItemFeature(3, 4),
                                          UserItemFeature(40, 30)]),
             ref_model.predict_user_item_pair([UserItemFeature(3, 4),
                                               UserItemFeature(40, 30)]))]:
        assert [(r.user_id, r.item_id, r.prediction) for r in port_recs] \
            == [(r.user_id, r.item_id, r.prediction) for r in ref_recs]
        np.testing.assert_allclose([r.probability for r in port_recs],
                                   [r.probability for r in ref_recs],
                                   atol=1e-5)
        assert all(isinstance(r, UserItemPrediction) for r in port_recs)
        assert all(1 <= r.prediction <= CLASSES for r in port_recs)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_saved_model_crosses(tmp_path, saver):
    """``save_model`` after one fit in one package, ``load_model`` in
    the other: the same predictions, the step count kept."""
    x, y = _pairs(24, 6)
    xp, _ = _pairs(16, 7)
    path = str(tmp_path / "ncf")
    if saver == "jax":
        src = RefNeuralCF(**CFG)
        src.fit((x, y), batch_size=8, epochs=1)
        src.save_model(path)
        loaded = ZooModel.load_model(path, device="cpu")
        assert isinstance(loaded, NeuralCF)
    else:
        src = NeuralCF(device="cpu", seed=2, **CFG)
        src.fit((x, y), batch_size=8, epochs=1)
        src.save_model(path)
        loaded = RefZooModel.load_model(path)
    assert loaded.estimator.global_step == 3
    np.testing.assert_allclose(
        np.asarray(loaded.predict(xp, batch_size=8)),
        np.asarray(src.predict(xp, batch_size=8)), atol=TOL)
