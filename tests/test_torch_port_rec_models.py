"""PyTorch port, zoo models slice: ``models/recommendation/
wide_and_deep.py`` and ``session_recommender.py`` held against the JAX
package on the CPU, with the helpers (and tolerances: 1e-5 (1 + |ref|)
in f32) of ``test_torch_port_text_models.py``.

Small configuration: Wide & Deep over two wide base columns, one cross,
one indicator block, two embedded id columns and one continuous column,
3 classes, hidden (8, 4); the session recommender over 30 items,
embedding 6, GRUs (7, 5), session 6, history 4 with an MLP of (6, 4).
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.recommendation import (
    session_recommender as ref_session, wide_and_deep as ref_wnd)
from analytics_zoo_tpu_torch.models import (ColumnFeatureInfo, Recommender,
                                            SessionRecommender,
                                            UserItemPrediction, WideAndDeep)
from analytics_zoo_tpu_torch.models.recommendation import (
    session_recommender as port_session)
from tests.test_torch_port_text_models import (
    TOL, close, fit_both, forward_and_gradients_match, pair,
    saved_model_crosses, steps_match)

torch.set_num_threads(2)

# ---------------------------------------------------------- Wide & Deep --
USERS, ITEMS, CLASSES = 12, 9, 3
INFO = dict(wide_base_cols=["occupation", "gender"], wide_base_dims=[5, 3],
            wide_cross_cols=["age-gender"], wide_cross_dims=[7],
            indicator_cols=["genres"], indicator_dims=[4],
            embed_cols=["userId", "itemId"], embed_in_dims=[USERS, ITEMS],
            embed_out_dims=[4, 3], continuous_cols=["age"])
WIDE_DIM = 5 + 3 + 7
MODEL_TYPES = ["wide_n_deep", "wide", "deep"]


def _wnd_cfg(model_type):
    return dict(model_type=model_type, class_num=CLASSES,
                column_info=ColumnFeatureInfo(**INFO), hidden_layers=(8, 4))


def _features(users, items, seed):
    """The feature dict of (user, item) rows: the wide block's three
    active indices (with a pad slot on some rows), the two ids, a
    multi-hot genre block and a continuous age."""
    rng = np.random.RandomState(seed)
    n = len(users)
    wide = np.stack([1 + users % 5, 6 + items % 3,
                     9 + (users + items) % 7], 1).astype(np.int32)
    wide[rng.rand(n) < 0.3, 2] = 0
    return {"wide": wide,
            "embed": np.stack([users, items], 1).astype(np.int32),
            "indicator": (rng.rand(n, 4) < 0.4).astype(np.float32),
            "continuous": rng.rand(n, 1).astype(np.float32)}


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    users = rng.randint(1, USERS + 1, n)
    items = rng.randint(1, ITEMS + 1, n)
    return (_features(users, items, seed),
            rng.randint(1, CLASSES + 1, n).astype(np.int32))


def _wnd_pair(model_type, seed=0):
    return pair(ref_wnd.WideAndDeep, WideAndDeep, _wnd_cfg(model_type), seed)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_wide_and_deep_forward_and_gradients_match(model_type):
    ref, port = _wnd_pair(model_type)
    x, y = _rows(16, 1)
    got = forward_and_gradients_match(ref, port, x, y)
    assert got.shape == (16, CLASSES)
    wide = model_type != "deep"
    assert hasattr(port.module, "wide_weight") == wide
    if wide:
        assert port.module.wide_weight.shape == (WIDE_DIM + 1, CLASSES)


@pytest.fixture(scope="module")
def fitted_wnd():
    """``wide_n_deep`` after three Adam steps in both packages, its
    column info given as the dict a saved config holds."""
    ref, port = pair(ref_wnd.WideAndDeep, WideAndDeep,
                     dict(_wnd_cfg("wide_n_deep"), column_info=INFO), 2)
    x, y = _rows(24, 3)
    return ref, port, fit_both(ref, port, x, y, 8)


def test_wide_and_deep_three_adam_steps_match(fitted_wnd):
    ref, port, hists = fitted_wnd
    xe, ye = _rows(20, 4)
    steps_match(ref, port, hists, xe, ye, 8)


def test_wide_weights_start_at_zero_and_pads_add_nothing():
    port = WideAndDeep(device="cpu", **_wnd_cfg("wide"))
    assert not port.module.wide_weight.any() and \
        not port.module.wide_bias.any()
    with torch.no_grad():
        port.module.wide_weight.normal_(generator=torch.Generator()
                                        .manual_seed(0))
    x, _ = _rows(8, 5)
    padded = dict(x, wide=np.concatenate(
        [x["wide"], np.zeros((8, 3), np.int32)], 1))
    np.testing.assert_array_equal(port.predict(x), port.predict(padded))


def test_wide_and_deep_ranking_through_an_assembler():
    ref, port = _wnd_pair("wide_n_deep", seed=3)
    assert isinstance(port, Recommender)
    with pytest.raises(RuntimeError, match="set_feature_assembler"):
        port.recommend_for_user(3, 4, candidate_items=range(1, ITEMS + 1))
    with pytest.raises(ValueError, match="candidate_items"):
        port.set_feature_assembler(
            lambda u, i: _features(u, i, 0)).recommend_for_user(3, 4)
    for m in (ref, port):
        m.set_feature_assembler(lambda u, i: _features(u, i, 6))
    for got, want in [
            (port.recommend_for_user(3, 4, candidate_items=range(1, 10)),
             ref.recommend_for_user(3, 4, candidate_items=range(1, 10))),
            (port.recommend_for_item(5, 3, candidate_users=range(1, 13)),
             ref.recommend_for_item(5, 3, candidate_users=range(1, 13)))]:
        assert [(r.user_id, r.item_id, r.prediction) for r in got] == \
            [(r.user_id, r.item_id, r.prediction) for r in want]
        close([r.probability for r in got],
              [r.probability for r in want], TOL)
        assert all(isinstance(r, UserItemPrediction) for r in got)


def test_column_info_config_is_a_dict():
    port = WideAndDeep(device="cpu", model_type="deep", class_num=2,
                       **INFO)
    assert port._config["column_info"] == INFO
    assert port.column_info.wide_dim == WIDE_DIM
    assert port.column_info.indicator_dim == 4
    again = WideAndDeep(device="cpu", **dict(port._config))
    assert again.column_info == port.column_info
    with pytest.raises(ValueError, match="model_type"):
        WideAndDeep(device="cpu", model_type="narrow", **INFO)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_wide_and_deep_saved_model_crosses(tmp_path, fitted_wnd, saver):
    ref, port, _ = fitted_wnd
    loaded = saved_model_crosses(tmp_path, saver, ref, port,
                                 _rows(16, 8)[0], 8)
    assert loaded._config["column_info"] == INFO


# --------------------------------------------------- SessionRecommender --
N_ITEMS, SESSION, HISTORY = 30, 6, 4
SR = dict(item_count=N_ITEMS, item_embed=6, rnn_hidden_layers=(7, 5),
          session_length=SESSION, mlp_hidden_layers=(6, 4),
          history_length=HISTORY)


def _sessions(n, seed, history):
    """Sessions of item ids, left-padded with 0 on some rows; with
    ``history`` also a history block holding padding slots (whose
    embeddings the reference sums too)."""
    rng = np.random.RandomState(seed)
    s = rng.randint(1, N_ITEMS + 1, (n, SESSION)).astype(np.int32)
    s[rng.rand(n) < 0.3, :2] = 0
    y = rng.randint(1, N_ITEMS + 1, n).astype(np.int32)
    if not history:
        return s, y
    h = rng.randint(0, N_ITEMS + 1, (n, HISTORY)).astype(np.int32)
    return {"session": s, "history": h}, y


def _sr_pair(history, seed=0):
    return pair(ref_session.SessionRecommender, SessionRecommender,
                dict(SR, include_history=history), seed)


@pytest.mark.parametrize("history", [False, True])
def test_session_recommender_forward_and_gradients_match(history):
    ref, port = _sr_pair(history)
    x, y = _sessions(16, 1, history)
    got = forward_and_gradients_match(ref, port, x, y)
    assert got.shape == (16, N_ITEMS + 1)


def test_session_recommender_three_adam_steps_match():
    """With the history MLP; ``evaluate`` reads the default top-5
    accuracy."""
    ref, port = _sr_pair(True, seed=2)
    assert port.estimator.metrics[0].name == "top5_accuracy"
    x, y = _sessions(24, 3, True)
    xe, ye = _sessions(20, 4, True)
    steps_match(ref, port, fit_both(ref, port, x, y, 8), xe, ye, 8)


@pytest.mark.parametrize("history", [False, True])
def test_recommend_for_session_matches(history):
    ref, port = _sr_pair(history, seed=3)
    x, _ = _sessions(12, 5, history)
    for zero_based in (False, True):
        got = port.recommend_for_session(x, max_items=4, batch_size=8,
                                         zero_based_label=zero_based)
        want = ref.recommend_for_session(x, max_items=4, batch_size=8,
                                         zero_based_label=zero_based)
        assert [[i for i, _ in row] for row in got] == \
            [[i for i, _ in row] for row in want]
        close([[p for _, p in row] for row in got],
              [[p for _, p in row] for row in want], TOL)
        lowest = -1 if zero_based else 0
        assert all(i != lowest for row in got for i, _ in row)


def test_session_recommender_pair_methods_raise():
    port = SessionRecommender(device="cpu", **SR)
    for call in (lambda: port.predict_user_item_pair([]),
                 lambda: port.recommend_for_user(1, 3),
                 lambda: port.recommend_for_item(1, 3)):
        with pytest.raises(NotImplementedError,
                           match="recommend_for_session"):
            call()


def test_next_item_loss_matches():
    from analytics_zoo_tpu.models.recommendation.session_recommender import (
        _next_item_ce as ref_ce)

    rng = np.random.RandomState(9)
    preds = rng.randn(8, N_ITEMS + 1).astype(np.float32)
    labels = rng.randint(1, N_ITEMS + 1, (8, 1))
    close(float(port_session._next_item_ce(torch.from_numpy(preds),
                                           labels)),
          float(ref_ce(preds, labels)), TOL)
