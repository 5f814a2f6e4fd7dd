"""PyTorch port, zoo models slice: ``models/seq2seq.py`` and
``models/anomaly.py`` held against the JAX package on the CPU, with the
helpers (and tolerances: 1e-5 (1 + |ref|) in f32) of
``test_torch_port_text_models.py``.

Small configuration: Seq2seq over a vocabulary of 20, embedding 6,
hidden (7,) or (7, 5), sources of 6 and targets of 5 tokens, ``infer``
over 7 steps; the anomaly detector over windows of 8 steps of 2
features, LSTMs (5, 6, 4). Both move their initial weights by a draw
of spread 0.6, so that greedy decoding emits varied tokens. ``infer`` must give the reference's tokens exactly; the
test also checks that no step's top-two logit gap is below the
forward's tolerance at these weights, so that a near tie cannot decide
it.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models import anomaly as ref_anomaly
from analytics_zoo_tpu.models import seq2seq as ref_seq2seq
from analytics_zoo_tpu_torch.models import AnomalyDetector, Seq2seq
from tests.test_torch_port_text_models import (
    TOL, close, fit_both, forward_and_gradients_match, pair,
    saved_model_crosses, steps_match, torch_tree)

torch.set_num_threads(2)

# -------------------------------------------------------------- Seq2seq --
VOCAB, SRC, TGT, MAX_LEN = 20, 6, 5, 7
SEQ_CASES = [("pass", (7,)), ("dense", (7,)), ("pass", (7, 5)),
             ("dense", (7, 5))]


def _seq_cfg(bridge, hidden):
    return dict(vocab=VOCAB, embed_dim=6, hidden_sizes=hidden,
                bridge=bridge, max_len=MAX_LEN)


def _translations(n, seed):
    """({"src", "tgt_in"}, tgt_out): padded sources and targets (id 0
    at the tail of some rows, which the loss skips)."""
    rng = np.random.RandomState(seed)
    src = rng.randint(1, VOCAB + 1, (n, SRC)).astype(np.int32)
    src[rng.rand(n) < 0.3, -2:] = 0
    tgt = rng.randint(1, VOCAB + 1, (n, TGT + 1)).astype(np.int32)
    tgt[rng.rand(n) < 0.4, -2:] = 0
    return {"src": src, "tgt_in": tgt[:, :-1]}, tgt[:, 1:]


def _seq_pair(bridge, hidden, seed=0):
    return pair(ref_seq2seq.Seq2seq, Seq2seq, _seq_cfg(bridge, hidden),
                seed, scale=0.6)


@pytest.mark.parametrize("bridge,hidden", SEQ_CASES)
def test_seq2seq_forward_gradients_and_infer_match(bridge, hidden):
    """The teacher-forced forward and one step's gradients, then greedy
    ``infer`` in both modes: the reference's tokens exactly, every
    step's top-two logit gap above the forward's tolerance."""
    ref, port = _seq_pair(bridge, hidden)
    x, y = _translations(8, 1)
    got = forward_and_gradients_match(ref, port, x, y)
    assert got.shape == (8, TGT, VOCAB + 1)
    src = x["src"]
    want = ref.infer(src, start_id=1)
    tokens = port.infer(src, start_id=1)
    assert tokens.dtype == np.int32 and tokens.shape == (8, MAX_LEN)
    np.testing.assert_array_equal(tokens, want)
    np.testing.assert_array_equal(port.infer(src, 1, host_loop=True), want)
    assert len(np.unique(want)) > 2
    assert _min_top2_gap(port, src, want, 1) > TOL
    # the decoder reads left to right: a shorter window is a prefix
    np.testing.assert_array_equal(port.infer(src, start_id=1, max_len=3),
                                  want[:, :3])


def test_seq2seq_decoder_starts_from_each_layer_carry():
    """Layer i of the decoder starts from layer i of the encoder, c on
    c and h on h: swapping the bridges' c and h changes the logits."""
    port = Seq2seq(device="cpu", **_seq_cfg("dense", (7, 7)))
    x, _ = _translations(8, 3)
    mod = port.module
    with torch.no_grad():
        base = mod(torch_tree(x))
        for i in range(2):
            c, h = getattr(mod, f"bridge_c_{i}"), getattr(mod,
                                                           f"bridge_h_{i}")
            sd_c, sd_h = c.state_dict(), h.state_dict()
            c.load_state_dict(sd_h)
            h.load_state_dict(sd_c)
            swapped = mod(torch_tree(x))
            c.load_state_dict(sd_c)
            h.load_state_dict(sd_h)
            assert (swapped - base).abs().max() > 1e-3


def test_seq2seq_loss_masks_padding():
    rng = np.random.RandomState(4)
    preds = rng.randn(3, 5, VOCAB + 1).astype(np.float32)
    labels = rng.randint(0, 4, (3, 5)).astype(np.int32)
    got = Seq2seq.default_loss(torch.from_numpy(preds), labels)
    close(float(got), float(ref_seq2seq.Seq2seq.default_loss(preds, labels)),
          TOL)
    zeros = np.zeros((3, 5), np.int32)
    assert float(Seq2seq.default_loss(torch.from_numpy(preds), zeros)) == 0


@pytest.fixture(scope="module")
def fitted_seq2seq():
    """Two layers, the dense bridge, after three Adam steps in both
    packages."""
    ref, port = _seq_pair("dense", (7, 5), seed=3)
    x, y = _translations(24, 5)
    return ref, port, fit_both(ref, port, x, y, 8)


def test_seq2seq_three_adam_steps_match(fitted_seq2seq):
    ref, port, hists = fitted_seq2seq
    xe, ye = _translations(20, 6)
    steps_match(ref, port, hists, xe, ye, 8)


def _min_top2_gap(port, src, tokens, start_id):
    """The smallest top-two logit gap over the steps of a greedy run that
    emitted ``tokens``."""
    tgt = np.concatenate([np.full((len(src), 1), start_id, np.int32),
                          tokens[:, :-1]], 1)
    with torch.no_grad():
        logits = port.module({"src": torch.from_numpy(src),
                              "tgt_in": torch.from_numpy(tgt)}).numpy()
    top2 = np.sort(logits, -1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_seq2seq_saved_model_crosses(tmp_path, fitted_seq2seq, saver):
    ref, port, _ = fitted_seq2seq
    xp, _ = _translations(16, 9)
    loaded = saved_model_crosses(tmp_path, saver, ref, port, xp, 8)
    if saver == "jax":
        np.testing.assert_array_equal(loaded.infer(xp["src"], 1),
                                      ref.infer(xp["src"], 1))


# ------------------------------------------------------ AnomalyDetector --
UNROLL, FEATURES = 8, 2
AD = dict(feature_shape=(UNROLL, FEATURES), hidden_layers=(5, 6, 4),
          dropouts=(0.0, 0.0, 0.0))


def _series(n, seed):
    """A noisy two-feature series with a few spikes."""
    rng = np.random.RandomState(seed)
    t = np.arange(n, dtype=np.float32)
    data = np.stack([np.sin(t / 5), np.cos(t / 7)], 1)
    data += 0.1 * rng.randn(n, FEATURES).astype(np.float32)
    data[rng.randint(0, n, 3), 0] += 3.0
    return data


def _ad_pair(seed=0):
    return pair(ref_anomaly.AnomalyDetector, AnomalyDetector, AD, seed,
                scale=0.6)


def test_unroll_and_detect_anomalies_match():
    data = _series(40, 1)
    x, y = AnomalyDetector.unroll(data, UNROLL)
    rx, ry = ref_anomaly.AnomalyDetector.unroll(data, UNROLL)
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)
    assert x.shape == (40 - UNROLL, UNROLL, FEATURES)
    x1, y1 = AnomalyDetector.unroll(data[:, 0], 4)
    assert x1.shape == (36, 4, 1) and (y1 == data[4:, 0]).all()
    with pytest.raises(ValueError, match="shorter"):
        AnomalyDetector.unroll(data[:5], 5)
    pred = y + np.random.RandomState(2).randn(len(y)).astype(np.float32)
    idx, thr = AnomalyDetector.detect_anomalies(y, pred, 4)
    ridx, rthr = ref_anomaly.AnomalyDetector.detect_anomalies(y, pred, 4)
    np.testing.assert_array_equal(idx, ridx)
    assert thr == rthr
    assert AnomalyDetector.detect_anomalies(y, pred, 0)[1] == float("inf")


def test_anomaly_detector_forward_and_gradients_match():
    ref, port = _ad_pair()
    x, y = AnomalyDetector.unroll(_series(24, 3), UNROLL)
    got = forward_and_gradients_match(ref, port, x, y)
    assert got.shape == (len(x), 1)


def test_anomaly_detector_three_rmsprop_steps_match():
    ref, port = _ad_pair(seed=1)
    assert port.default_optimizer == "rmsprop"
    x, y = AnomalyDetector.unroll(_series(32, 4), UNROLL)
    xe, ye = AnomalyDetector.unroll(_series(28, 5), UNROLL)
    steps_match(ref, port, fit_both(ref, port, x, y, 8), xe, ye, 8)
    pred = port.predict(xe, batch_size=8)
    idx, thr = port.detect_anomalies(ye, pred, 3)
    ridx, rthr = ref.detect_anomalies(ye, ref.predict(xe, batch_size=8), 3)
    np.testing.assert_array_equal(idx, ridx)
    close(thr, rthr, TOL)


def test_anomaly_detector_dropout_between_layers():
    port = AnomalyDetector(device="cpu", feature_shape=(UNROLL, FEATURES))
    assert port._config["dropouts"] == [0.2, 0.2, 0.2]
    x = torch.from_numpy(AnomalyDetector.unroll(_series(24, 6), UNROLL)[0])
    with torch.no_grad():
        ev = port.module(x)
        tr = port.module(x, train=True, rng=torch.Generator().manual_seed(0))
    assert not torch.allclose(ev, tr)
    with pytest.raises(ValueError, match="align"):
        AnomalyDetector(device="cpu", feature_shape=(4, 1),
                        hidden_layers=(3,), dropouts=(0.1, 0.1))
