"""PyTorch port, zoo models slice: ``models/text/classifier.py`` and
``models/text/knrm.py`` held against the JAX package on the CPU.

Each test builds the JAX model and the port's, checks that the port's
parameter paths and shapes are those the JAX model's init traces, moves
every parameter of the port's initial tree by a seeded draw (so that no
weight sits at its initial value: the zero-initialised ones included),
loads that tree into both through ``bridge`` and feeds both the same
seeded numpy inputs. Dropout is off:
the forwards run in eval mode, and where a model's dropout rate is
fixed (TextClassifier's 0.2) both Estimators call the forward as they
do in eval mode. The helpers here serve the other two files of the
slice (``test_torch_port_rec_models.py``, ``test_torch_port_seq_models.
py``).

Tolerance, ``1e-5 * (1 + |ref|)`` elementwise in f32, for the forward,
one step's gradients and the three optimizer steps alike. KNRM's
exact-match kernel (sigma 1e-3) scales a cosine's error near 1 by
1 / sigma^2 = 1e6 in its gradient, so its inputs hold exact matches on
purpose; it passes at 1e-5 all the same: at an exact match the cosine
is a vector's with itself, whose gradient is zero (1 whatever the
vector), so the amplified rounding meets a zero factor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.common import ZooModel as RefZooModel
from analytics_zoo_tpu.models.text import classifier as ref_classifier
from analytics_zoo_tpu.models.text import knrm as ref_knrm
from analytics_zoo_tpu_torch.bridge import (flatten, kernel_layouts,
                                            load_flax_into, nest,
                                            state_dict_from_flax,
                                            variables_from_module)
from analytics_zoo_tpu_torch.models import KNRM, TextClassifier, ZooModel
from analytics_zoo_tpu_torch.models.text import knrm as port_knrm
from analytics_zoo_tpu_torch.utils.tree import tree_map

torch.set_num_threads(2)

TOL = 1e-5


# ------------------------------------------------------ shared helpers --
def close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    excess = np.abs(got - want) - tol * (1 + np.abs(want))
    assert excess.max(initial=-1) <= 0, (what, float(excess.max()))


def host_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def perturbed(variables, seed=0, scale=0.3):
    """The flax tree with every parameter moved by a seeded draw."""
    rng = np.random.RandomState(seed)
    return nest({k: (np.asarray(a) + scale * rng.randn(*np.shape(a)))
                 .astype(np.float32)
                 for k, a in sorted(flatten(host_tree(variables)).items())})


def pair(ref_cls, port_cls, cfg, seed=0, scale=0.3):
    """(the JAX model, the port's model on the CPU) at the same weights:
    the port's initial tree, perturbed, in both. The JAX model's tree
    (traced, not run) must have the port's paths and shapes: flax's
    names, with no rename table."""
    port = port_cls(device="cpu", **cfg)
    tree = perturbed(variables_from_module(port.module), seed, scale)
    ref = ref_cls(**cfg)
    example = ref._example_input()
    want = jax.eval_shape(ref.estimator.adapter.init,
                          jax.random.PRNGKey(0), example)
    assert _shapes(tree) == _shapes(want)
    ref.estimator.variables = jax.tree_util.tree_map(jnp.asarray, tree)
    ref.estimator._ensure_built(example)
    load_flax_into(port.module, tree)
    return ref, port


def _shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in flatten(tree).items()}


def torch_tree(x):
    return tree_map(torch.from_numpy, x)


def forward_and_gradients_match(ref, port, x, y, tol=TOL):
    """The eval-mode forward, then one step's loss and gradients under
    each model's default loss (dropout off). Returns the port's
    forward."""
    variables = ref.estimator.variables

    def loss(params):
        preds = ref.module.apply({**variables, "params": params}, x)
        return ref.estimator.loss_fn(preds, y), preds

    (want_loss, want_preds), want = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(variables["params"])
    want = state_dict_from_flax(host_tree(want),
                                kernel_layouts(port.module))
    for p in port.module.parameters():
        p.grad = None
    preds = port.module(torch_tree(x))
    close(preds.detach().numpy(), want_preds, tol, "forward")
    got_loss = port.estimator.loss_fn(preds, torch.from_numpy(np.asarray(y)))
    got_loss.backward()
    close(got_loss.item(), float(want_loss), tol, "loss")
    got = {k: p.grad for k, p in port.module.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        close(got[k].numpy(), g.numpy(), tol, k)
    return preds.detach().numpy()


def fit_both(ref, port, x, y, batch):
    """Both Estimators take one epoch of steps from the same weights
    (shuffled alike, each model's default optimizer); returns the two
    histories."""
    return (ref.fit((x, y), batch_size=batch, epochs=1),
            port.fit((x, y), batch_size=batch, epochs=1))


def steps_match(ref, port, hists, xe, ye, batch, tol=TOL):
    """After ``fit_both``: the step counts, the losses, the parameters
    and ``evaluate`` agree."""
    ref_hist, port_hist = hists
    assert port.estimator.global_step == ref.estimator.global_step == 3
    close(port_hist[0]["loss"], ref_hist[0]["loss"], tol, "epoch loss")
    want = state_dict_from_flax(host_tree(ref.estimator.variables),
                                kernel_layouts(port.module))
    got = port.module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        close(got[k].numpy(), v.numpy(), tol, k)
    want_eval = ref.evaluate((xe, ye), batch_size=batch)
    got_eval = port.evaluate((xe, ye), batch_size=batch)
    assert set(got_eval) == set(want_eval)
    for k in want_eval:
        close(got_eval[k], want_eval[k], tol, k)


def saved_model_crosses(tmp_path, saver, ref, port, xp, batch):
    """``save_model`` of a fitted model in one package, ``load_model`` in
    the other: the same class, the same predictions, the step count
    kept. Returns the loaded model."""
    path = str(tmp_path / "model")
    src = ref if saver == "jax" else port
    src.save_model(path)
    if saver == "jax":
        loaded = ZooModel.load_model(path, device="cpu")
        assert type(loaded) is type(port)
    else:
        loaded = RefZooModel.load_model(path)
        assert type(loaded) is type(ref)
    assert loaded.estimator.global_step == src.estimator.global_step > 0
    close(np.asarray(loaded.predict(xp, batch_size=batch)),
          np.asarray(src.predict(xp, batch_size=batch)), TOL, "predict")
    return loaded


def dropout_off(ref, port):
    """Both Estimators call the forward as in eval mode (no ``train``
    flag), for a model whose dropout rate is fixed."""
    ref.estimator.adapter._train_kw = None
    port.estimator._takes_train = False


# ------------------------------------------------------- TextClassifier --
VOCAB, SEQ, CLASSES = 40, 8, 5
TC = dict(class_num=CLASSES, vocab=VOCAB, embed_dim=6, sequence_length=SEQ,
          encoder_output_dim=7)
ENCODERS = ["cnn", "lstm", "gru"]


def _docs(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, VOCAB + 1, (n, SEQ)).astype(np.int32)
    return x, rng.randint(0, CLASSES, n).astype(np.int32)


def _tc_pair(encoder, seed=0):
    return pair(ref_classifier.TextClassifier, TextClassifier,
                dict(TC, encoder=encoder), seed)


@pytest.mark.parametrize("encoder", ENCODERS)
def test_text_classifier_forward_and_gradients_match(encoder):
    ref, port = _tc_pair(encoder)
    x, y = _docs(16, 1)
    got = forward_and_gradients_match(ref, port, x, y)
    assert got.shape == (16, CLASSES)


def test_text_classifier_cnn_pads_same():
    """flax's ``nn.Conv`` pads "SAME": the convolution keeps every
    position, so the max over time sees the edges too."""
    port = TextClassifier(device="cpu", **dict(TC, encoder="cnn"))
    x = torch.from_numpy(_docs(4, 5)[0])
    with torch.no_grad():
        h = port.module.conv(port.module.embedding(x))
    assert h.shape == (4, SEQ, TC["encoder_output_dim"])


def test_text_classifier_dropout_in_training_only():
    port = TextClassifier(device="cpu", **dict(TC, encoder="gru"))
    x = torch.from_numpy(_docs(16, 6)[0])
    with torch.no_grad():
        ev = port.module(x)
        assert torch.equal(ev, port.module(x, train=False))
        gen = torch.Generator().manual_seed(0)
        tr = port.module(x, train=True, rng=gen)
        assert not torch.allclose(ev, tr)
        with pytest.raises(ValueError, match="generator"):
            port.module(x, train=True)


@pytest.fixture(scope="module")
def fitted_tc():
    """The LSTM classifier after three Adam steps in both packages
    (dropout off)."""
    ref, port = _tc_pair("lstm", seed=2)
    dropout_off(ref, port)
    x, y = _docs(24, 3)
    return ref, port, fit_both(ref, port, x, y, 8)


def test_text_classifier_three_adam_steps_match(fitted_tc):
    ref, port, hists = fitted_tc
    xe, ye = _docs(20, 4)  # a padded tail batch
    steps_match(ref, port, hists, xe, ye, 8)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_text_classifier_saved_model_crosses(tmp_path, fitted_tc, saver):
    ref, port, _ = fitted_tc
    saved_model_crosses(tmp_path, saver, ref, port, _docs(16, 8)[0], 8)


# ----------------------------------------------------------------- KNRM --
L1, L2, KN = 4, 6, 5
KN_CFG = dict(text1_length=L1, text2_length=L2, vocab=VOCAB, embed_dim=8,
              kernel_num=KN)


def _query_docs(n, seed):
    """``[n, L1 + L2]`` query ++ doc ids with padding (id 0) on both
    sides and exact matches: each doc repeats two of its query's
    tokens."""
    rng = np.random.RandomState(seed)
    q = rng.randint(1, VOCAB + 1, (n, L1))
    d = rng.randint(1, VOCAB + 1, (n, L2))
    d[:, :2] = q[:, rng.randint(0, L1, 2)]
    q[rng.rand(n, L1) < 0.2] = 0
    d[rng.rand(n, L2) < 0.2] = 0
    return np.concatenate([q, d], 1).astype(np.int32)


def _pairs(n, seed):
    """``[n, 2, L1 + L2]`` (pos, neg) pairs sharing a query; the
    positive doc holds exact matches."""
    pos = _query_docs(n, seed)
    neg = _query_docs(n, seed + 100)
    neg[:, :L1] = pos[:, :L1]
    return np.stack([pos, neg], 1)


def _knrm_pair(mode, seed=0):
    return pair(ref_knrm.KNRM, KNRM, dict(KN_CFG, target_mode=mode), seed)


@pytest.mark.parametrize("mode,paired", [("ranking", False),
                                         ("ranking", True),
                                         ("classification", False)])
def test_knrm_forward_and_gradients_match(mode, paired):
    ref, port = _knrm_pair(mode)
    x = _pairs(16, 1) if paired else _query_docs(16, 1)
    if mode == "ranking":
        y = np.zeros(16, np.float32)
    else:
        y = np.random.RandomState(1).randint(0, 2, 16).astype(np.int32)
    got = forward_and_gradients_match(ref, port, x, y)
    width = 1 if mode == "ranking" and not paired else 2
    assert got.shape == (16, width)
    if mode == "classification":
        assert (got[:, 0] == 0).all()


def test_knrm_loss_by_mode():
    assert KNRM(device="cpu", **KN_CFG).estimator.loss_fn.__name__ == \
        "rank_hinge"
    cls = KNRM(device="cpu", target_mode="classification", **KN_CFG)
    assert cls.default_loss == "sparse_categorical_crossentropy"
    assert cls.estimator.loss_fn.__name__ == \
        "sparse_categorical_crossentropy"
    assert KNRM.default_loss == "rank_hinge"
    with pytest.raises(ValueError, match="target_mode"):
        KNRM(device="cpu", target_mode="pointwise", **KN_CFG)


def test_knrm_three_adam_steps_match():
    """Ranking on (pos, neg) pairs with ``rank_hinge``."""
    ref, port = _knrm_pair("ranking", seed=2)
    hists = fit_both(ref, port, _pairs(24, 3), np.zeros(24, np.float32), 8)
    steps_match(ref, port, hists, _pairs(20, 4), np.zeros(20, np.float32),
                8)


def test_knrm_ndcg_and_map_match():
    ref, port = _knrm_pair("ranking", seed=3)
    rows = _query_docs(24, 5)
    rng = np.random.RandomState(5)
    labels = [list(rng.randint(0, 3, k)) for k in (4, 6, 5, 1, 8)]
    assert sum(map(len, labels)) == len(rows)
    for k in (1, 3, 5):
        close(port.evaluate_ndcg(rows, labels, k=k, batch_size=8),
              ref.evaluate_ndcg(rows, labels, k=k, batch_size=8), TOL,
              f"ndcg@{k}")
    close(port.evaluate_map(rows, labels, batch_size=8),
          ref.evaluate_map(rows, labels, batch_size=8), TOL, "map")


def test_knrm_host_helpers_match():
    rng = np.random.RandomState(6)
    labels = [list(rng.randint(0, 3, k)) for k in (3, 5, 2)] + [[0, 0]]
    assert len(list(port_knrm._groups(labels))) == 4
    for (lo, hi, rel), (rlo, rhi, rrel) in zip(
            port_knrm._groups(labels), ref_knrm._groups(labels)):
        assert (lo, hi) == (rlo, rhi)
        np.testing.assert_array_equal(rel, rrel)
        scores = rng.randn(hi - lo).astype(np.float32)
        for k in (1, 2, 5):
            assert port_knrm._ndcg(scores, rel, k) == \
                ref_knrm._ndcg(scores, rel, k)
        assert port_knrm._ap(scores, rel) == ref_knrm._ap(scores, rel)
