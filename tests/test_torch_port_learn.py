"""PyTorch port, learn slice: optimizers, losses, metrics, the dataset,
checkpoints, the Estimator and BERT-SQuAD fine-tuning held against the
JAX package on the CPU.

Inputs are made with numpy and fed to both packages. The slice as a
whole: a small ``BERTSQuAD`` (vocab 512, hidden 128, 2 blocks, 2 heads of
64, intermediate 256, L 128, batch 8, no dropout, f32) at the JAX
package's initial weights (carried over by ``bridge``) takes 3 Adam
steps with shuffling on in both packages; losses, parameters,
``evaluate`` and ``predict`` agree. The slice runs Adam with epsilon
1e-5: some gradients of this model are zero up to rounding (the span
head's bias and the last LayerNorm's bias, since a constant added to
every position's logit leaves the span softmax unchanged; the key
bias, since softmax ignores a constant added to every key's score), and
at epsilon 1e-8 Adam turns that rounding noise, which differs between
the frameworks, into full steps of size lr.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from analytics_zoo_tpu.common import triggers as ref_triggers
from analytics_zoo_tpu.data.dataset import ZooDataset as RefDataset
from analytics_zoo_tpu.learn import metrics as ref_metrics
from analytics_zoo_tpu.learn import objectives as ref_objectives
from analytics_zoo_tpu.learn import optim as ref_optim
from analytics_zoo_tpu.learn.estimator import Estimator as RefEstimator
from analytics_zoo_tpu_torch.bridge import load_flax_into, state_dict_from_flax
from analytics_zoo_tpu_torch.common import triggers
from analytics_zoo_tpu_torch.data import XShards, ZooDataset
from analytics_zoo_tpu_torch.learn import checkpoint as ckpt_lib
from analytics_zoo_tpu_torch.learn import metrics, objectives, optim
from analytics_zoo_tpu_torch.learn.estimator import Estimator
from analytics_zoo_tpu_torch.models.text.bert_squad import (
    BERTSQuAD, squad_span_loss)

torch.set_num_threads(2)


# ------------------------------------------------------------ optimizers --
def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _opt_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"encoder": {"dense": {"kernel": rng.randn(4, 3),
                                  "bias": rng.randn(3)},
                        "ln_attn": {"scale": rng.rand(3) + 0.5,
                                    "bias": rng.randn(3)}},
            "head": {"kernel": rng.randn(3, 2)}}


OPTIMIZERS = [
    ("SGD", dict(lr=0.1)),
    ("SGD", dict(lr=0.05, momentum=0.9, nesterov=True, weight_decay=0.01)),
    ("SGD", dict(lr=0.05, momentum=0.8)),
    ("Adam", dict()),
    ("Adam", dict(lr="Fixed", beta_1=0.8)),
    ("Adam", dict(lr="Warmup")),
    ("AdamWeightDecay", dict(lr=1e-2)),
    ("AdamWeightDecay", dict(lr="Poly", weight_decay=0.1)),
    ("AdamWeightDecay", dict(lr="WarmupDecay")),
    ("RMSprop", dict()),
    ("Adagrad", dict()),
    ("Adadelta", dict()),
]


def _schedule(mod, name):
    return {"Fixed": lambda: mod.Fixed(0.02),
            "Warmup": lambda: mod.Warmup(0.05, 2),
            "WarmupDecay": lambda: mod.Warmup(0.05, 2, total_steps=5),
            "Poly": lambda: mod.Poly(2.0, 4, 0.03)}[name]()


def _make_opt(mod, name, kwargs):
    kw = dict(kwargs)
    if isinstance(kw.get("lr"), str):
        kw["lr"] = _schedule(mod, kw["lr"])
    return getattr(mod, name)(**kw)


def _run_both(name, kwargs, clip_norm=None, clip_value=None, steps=5):
    params = _opt_params()
    rng = np.random.RandomState(1)
    grads = [jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.5).astype(np.float32), params)
        for _ in range(steps)]
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), params)
    jtx = RefEstimator._with_clipping(
        _make_opt(ref_optim, name, kwargs).to_optax(), clip_norm, clip_value)
    jstate = jtx.init(jparams)
    tparams = {k: torch.tensor(v, dtype=torch.float32)
               for k, v in _flat(params).items()}
    ttx = optim.with_clipping(_make_opt(optim, name, kwargs).to_transform(),
                              clip_norm, clip_value)
    tstate = ttx.init(tparams)
    first_update = None
    for g in grads:
        updates, jstate = jtx.update(
            jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tg = {k: torch.from_numpy(v) for k, v in _flat(g).items()}
        tup, tstate = ttx.update(tg, tstate, tparams)
        if first_update is None:
            first_update = tup
        tparams = {k: tparams[k] + tup[k] for k in tparams}
    return _flat(jax.tree_util.tree_map(np.asarray, jparams)), tparams, \
        first_update


class TestOptimizers:
    @pytest.mark.parametrize("name,kwargs", OPTIMIZERS,
                             ids=[f"{n}-{i}" for i, (n, _) in
                                  enumerate(OPTIMIZERS)])
    def test_five_steps_match_optax(self, name, kwargs):
        want, got, _ = _run_both(name, kwargs)
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6,
                                       err_msg=k)

    @pytest.mark.parametrize("clip_norm,clip_value", [
        (0.5, None), (100.0, None), (None, 0.3), (0.7, 0.2)])
    def test_clipping_matches_optax(self, clip_norm, clip_value):
        want, got, _ = _run_both("Adam", dict(lr=0.01), clip_norm,
                                 clip_value)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6,
                                       err_msg=k)

    def test_warmup_from_zero_makes_the_first_update_zero(self):
        _, _, first = _run_both("Adam", dict(lr="Warmup"))
        for t in first.values():
            assert torch.count_nonzero(t) == 0

    def test_weight_decay_mask_follows_flax_names(self):
        opt = optim.AdamWeightDecay()
        assert opt.decays("encoder/dense/kernel")
        assert not opt.decays("encoder/dense/bias")
        assert not opt.decays("encoder/ln_attn/scale")
        assert not opt.decays("bert/embed_ln/scale")

    def test_resolve_optimizer(self):
        assert isinstance(optim.resolve_optimizer("adam"),
                          optim.GradientTransformation)
        with pytest.raises(ValueError):
            optim.resolve_optimizer("lamb")


# --------------------------------------------------- losses and metrics --
def _loss_cases():
    rng = np.random.RandomState(2)
    logits = rng.randn(8, 5).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    sparse = rng.randint(0, 5, 8).astype(np.int32)
    onehot = np.eye(5, dtype=np.float32)[sparse]
    reg = rng.randn(8, 5).astype(np.float32)
    pos = (rng.rand(8, 5) + 0.1).astype(np.float32)
    bin_p = rng.rand(8, 1).astype(np.float32)
    bin_y = (rng.rand(8, 1) > 0.5).astype(np.float32)
    return [
        ("sparse_categorical_crossentropy", logits, sparse),
        ("categorical_crossentropy", logits, onehot),
        ("binary_crossentropy", bin_p, bin_y),
        ("mse", reg, logits), ("mae", reg, logits),
        ("mape", reg, logits), ("msle", pos, pos[::-1].copy()),
        ("hinge", reg, bin_y.repeat(5, 1)),
        ("squared_hinge", reg, bin_y.repeat(5, 1)),
        ("poisson", pos, pos[::-1].copy()),
        ("cosine_proximity", reg, logits),
        ("kld", probs, probs[::-1].copy()),
        ("rank_hinge", reg[:, :2].copy(), sparse),
    ]


class TestLossesAndMetrics:
    @pytest.mark.parametrize("name,preds,labels", _loss_cases(),
                             ids=[c[0] for c in _loss_cases()])
    def test_loss_matches_reference(self, name, preds, labels):
        want = ref_objectives.resolve_loss(name)(jnp.asarray(preds),
                                                 jnp.asarray(labels))
        got = objectives.resolve_loss(name)(torch.from_numpy(preds),
                                            torch.from_numpy(labels))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-6)

    def test_binary_crossentropy_from_logits(self):
        rng = np.random.RandomState(3)
        p, y = rng.randn(8, 1).astype(np.float32), rng.rand(8, 1) > 0.5
        want = ref_objectives.binary_crossentropy(
            jnp.asarray(p), jnp.asarray(y), from_logits=True)
        got = objectives.binary_crossentropy(
            torch.from_numpy(p), torch.from_numpy(y), from_logits=True)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)

    def test_squad_span_loss_matches_reference(self):
        from analytics_zoo_tpu.models.text.bert_squad import (
            squad_span_loss as ref_loss)

        rng = np.random.RandomState(4)
        s, e = (rng.randn(6, 32).astype(np.float32) for _ in range(2))
        y = rng.randint(0, 32, (6, 2)).astype(np.int32)
        want = ref_loss((jnp.asarray(s), jnp.asarray(e)), jnp.asarray(y))
        got = squad_span_loss((torch.from_numpy(s), torch.from_numpy(e)),
                              torch.from_numpy(y))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    @pytest.mark.parametrize("name", [
        "accuracy", "top5", "mae", "mse", "rmse", "auc",
        "binary_crossentropy", "loss"])
    def test_metric_matches_reference(self, name):
        rng = np.random.RandomState(5)
        if name in ("auc", "binary_crossentropy"):
            preds = rng.rand(10, 1).astype(np.float32)
            labels = (rng.rand(10, 1) > 0.5).astype(np.float32)
        elif name in ("accuracy", "top5"):
            preds = rng.randn(10, 7).astype(np.float32)
            labels = rng.randint(0, 7, 10).astype(np.int32)
        else:
            preds = rng.randn(10, 3).astype(np.float32)
            labels = rng.randn(10, 3).astype(np.float32)
        weights = np.ones(10, np.float32)
        weights[-3:] = 0  # padded tail
        if name == "loss":
            ref_m = ref_metrics.resolve_metric(ref_objectives.mean_squared_error)
            port_m = metrics.resolve_metric(objectives.mean_squared_error)
        else:
            ref_m, port_m = (ref_metrics.resolve_metric(name),
                             metrics.resolve_metric(name))
        assert ref_m.name == port_m.name
        want = ref_m.result(ref_m.update(ref_m.update(
            ref_m.empty(), jnp.asarray(preds), jnp.asarray(labels),
            weights=jnp.asarray(weights)), jnp.asarray(preds[:4]),
            jnp.asarray(labels[:4])))
        got = port_m.result(port_m.update(port_m.update(
            port_m.empty(), torch.from_numpy(preds),
            torch.from_numpy(labels), weights=torch.from_numpy(weights)),
            torch.from_numpy(preds[:4]), torch.from_numpy(labels[:4])))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------------------------- the data --
def _features(n=21, seed=6):
    rng = np.random.RandomState(seed)
    return ({"a": rng.randn(n, 3).astype(np.float32),
             "b": np.arange(n, dtype=np.int32)},
            rng.randint(0, 4, n).astype(np.int32))


class TestDataset:
    @pytest.mark.parametrize("shuffle,drop,seed,epoch", [
        (True, True, 0, 0), (True, False, 3, 2), (False, False, 0, 0)])
    def test_batches_match_reference(self, shuffle, drop, seed, epoch):
        x, y = _features()
        want = list(RefDataset(x, y).batches(
            8, shuffle=shuffle, seed=seed, epoch=epoch,
            drop_remainder=drop, with_mask=True))
        got = list(ZooDataset(x, y).batches(
            8, shuffle=shuffle, seed=seed, epoch=epoch,
            drop_remainder=drop, with_mask=True))
        assert len(got) == len(want) == (2 if drop else 3)
        for (gx, gy, gm), (wx, wy, wm) in zip(got, want):
            np.testing.assert_array_equal(gx["a"], wx["a"])
            np.testing.assert_array_equal(gx["b"], wx["b"])
            np.testing.assert_array_equal(gy, wy)
            np.testing.assert_array_equal(gm, wm)

    def test_device_iterator_on_cpu_yields_the_batches(self):
        x, y = _features()
        ds = ZooDataset(x, y)
        host = list(ds.batches(8, seed=1, drop_remainder=False,
                               with_mask=True))
        dev = list(ds.device_iterator(8, device="cpu", seed=1,
                                      drop_remainder=False, with_mask=True))
        assert len(dev) == len(host)
        for (dx, dy, dm), (hx, hy, hm) in zip(dev, host):
            assert isinstance(dx["a"], torch.Tensor)
            np.testing.assert_array_equal(dx["b"].numpy(), hx["b"])
            np.testing.assert_array_equal(dy.numpy(), hy)
            np.testing.assert_array_equal(dm.numpy(), hm)

    def test_mesh_raises_until_the_parallel_item(self):
        x, y = _features()
        with pytest.raises(NotImplementedError, match="parallel and sharded"):
            next(ZooDataset(x, y).batches(8, mesh=object()))

    def test_disk_tier_and_split(self, tmp_path):
        x, y = _features()
        ds = ZooDataset(x, y, memory_type="DISK",
                        cache_dir=str(tmp_path / "c"))
        a, b = ds.split(0.5, seed=1)
        assert (a.num_samples, b.num_samples) == (10, 11)
        merged = np.sort(np.concatenate([a.features["b"], b.features["b"]]))
        np.testing.assert_array_equal(merged, np.arange(21))

    def test_xshards_round_trip(self):
        x, y = _features()
        shards = XShards.partition({"x": x["a"], "y": y}, num_shards=3)
        assert shards.num_partitions() == 3 and len(shards) == 21
        ds = shards.to_dataset()
        np.testing.assert_array_equal(ds.features, x["a"])
        np.testing.assert_array_equal(ds.labels, y)

    def test_triggers_match_reference(self):
        for it in range(7):
            for fin in (False, True):
                kw = dict(epoch=it // 3, iteration=it, epoch_finished=fin,
                          loss=1.0 / (it + 1), score=it / 10.0)
                ps, rs = triggers.TriggerState(**kw), \
                    ref_triggers.TriggerState(**kw)
                pairs = [
                    (triggers.EveryEpoch(), ref_triggers.EveryEpoch()),
                    (triggers.SeveralIteration(2),
                     ref_triggers.SeveralIteration(2)),
                    (triggers.MaxEpoch(1) & triggers.MinLoss(0.3),
                     ref_triggers.MaxEpoch(1) & ref_triggers.MinLoss(0.3)),
                    (triggers.MaxScore(0.4) | triggers.MaxIteration(5),
                     ref_triggers.MaxScore(0.4) |
                     ref_triggers.MaxIteration(5))]
                for p, r in pairs:
                    assert p(ps) == r(rs)


# ------------------------------------------------------------ estimator --
class _MLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(3, 16)
        self.fc2 = nn.Linear(16, 4)

    def forward(self, x, train=False, rng=None):
        return self.fc2(torch.tanh(self.fc1(x["a"])))


def _mlp(seed=0):
    torch.manual_seed(seed)
    return _MLP()


def _est(model, **kw):
    kw.setdefault("optimizer", optim.Adam(lr=0.01))
    return Estimator(model, loss="sparse_categorical_crossentropy",
                     metrics=["accuracy"], device="cpu", **kw)


def _params(est):
    return {k: v.detach().clone() for k, v in est.model.state_dict().items()}


class TestEstimator:
    def test_checkpoint_resume_round_trip(self, tmp_path):
        x, y = _features(48)
        whole = _est(_mlp())
        whole.fit((x, y), batch_size=8, epochs=2)
        ckpt = str(tmp_path / "ckpt")
        first = _est(_mlp())
        first.fit((x, y), batch_size=8, epochs=1, checkpoint_dir=ckpt)
        assert ckpt_lib.latest_step(ckpt) == 6
        for name in ("model.6", "optim.6", "meta.6.json", "latest"):
            assert os.path.isfile(os.path.join(ckpt, name)), name
        _, _, meta = ckpt_lib.load_checkpoint(ckpt, with_optim=False)
        assert meta == {"step": 6, "epoch": 1}
        resumed = _est(_mlp(seed=9))  # other initial weights
        resumed.fit((x, y), batch_size=8, epochs=2, checkpoint_dir=ckpt,
                    resume=True)
        assert (resumed.global_step, resumed.epoch) == (12, 2)
        want, got = _params(whole), _params(resumed)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6)

    def test_retry_from_checkpoint_after_a_failure(self, tmp_path,
                                                   monkeypatch):
        x, y = _features(48)
        est = _est(_mlp())
        real, calls = est._train_step, [0]

        def flaky(xb, yb):
            calls[0] += 1
            if calls[0] == 5:
                raise RuntimeError("injected step failure")
            return real(xb, yb)

        monkeypatch.setattr(est, "_train_step", flaky)
        hist = est.fit((x, y), batch_size=8, epochs=2,
                       checkpoint_dir=str(tmp_path),
                       checkpoint_trigger=triggers.SeveralIteration(2))
        assert est.epoch == 2 and np.isfinite(hist[-1]["loss"])
        # the failed step and the ones after the last snapshot re-ran
        assert calls[0] > 12

    def test_failure_without_checkpoint_raises(self, monkeypatch):
        x, y = _features(16)
        est = _est(_mlp())

        def boom(xb, yb):
            raise RuntimeError("injected")

        monkeypatch.setattr(est, "_train_step", boom)
        with pytest.raises(RuntimeError, match="injected"):
            est.fit((x, y), batch_size=8)

    def test_grad_accum_matches_one_big_batch(self):
        x, y = _features(16)
        a, b = _est(_mlp()), _est(_mlp(), grad_accum_steps=2)
        a.fit((x, y), batch_size=16)
        b.fit((x, y), batch_size=16)
        for k, v in _params(a).items():
            torch.testing.assert_close(_params(b)[k], v, rtol=0, atol=1e-6)

    def test_device_cache_trains(self):
        x, y = _features(40)
        est = _est(_mlp())
        before = _params(est)
        hist = est.fit((x, y), batch_size=8, epochs=2, device_cache=True,
                       validation_data=(x, y))
        assert est.global_step == 10 and len(hist) == 2
        assert np.isfinite(hist[-1]["loss"]) and "val_accuracy" in hist[-1]
        assert any(not torch.equal(v, _params(est)[k])
                   for k, v in before.items())

    def test_validation_evaluate_and_predict(self):
        x, y = _features(21)
        est = _est(_mlp())
        hist = est.fit((x, y), batch_size=8, validation_data=(x, y))
        assert set(hist[0]) == {"epoch", "loss", "seconds", "val_accuracy",
                                "val_loss"}
        res = est.evaluate((x, y), batch_size=8)
        with torch.no_grad():
            logits = est.model({"a": torch.from_numpy(x["a"])})
        want = objectives.sparse_categorical_crossentropy(
            logits, torch.from_numpy(y))
        np.testing.assert_allclose(res["loss"], float(want), rtol=1e-5)
        preds = est.predict(x, batch_size=8)
        assert preds.shape == (21, 4)
        np.testing.assert_allclose(preds, logits.numpy(), atol=1e-6)

    def test_profile_records_stages_and_writes_a_trace(self, tmp_path):
        x, y = _features(24)
        est = _est(_mlp())
        est.fit((x, y), batch_size=8, profile=True,
                trace_dir=str(tmp_path / "trace"))
        summary = est.last_profile.summary()
        assert summary["train_step"]["count"] == 3
        assert summary["data_wait"]["count"] == 3
        assert est.last_profile.input_bound_fraction is not None
        assert os.listdir(tmp_path / "trace")

    def test_unported_branches_raise(self):
        for kw in (dict(mesh=object()), dict(param_spec_fn=lambda p: p),
                   dict(aux_loss_collections=("losses",))):
            with pytest.raises(NotImplementedError, match="parallel and sharded"):
                _est(_mlp(), **kw)


# ------------------------------------------------------- BERT-SQuAD slice --
SMALL = dict(vocab=512, hidden_size=128, n_block=2, n_head=2,
             intermediate_size=256, max_position_len=128,
             hidden_dropout=0.0)
SEQ, BATCH = 128, 8


def _squad_data(n, seed):
    rng = np.random.RandomState(seed)
    x = {"input_ids": rng.randint(0, SMALL["vocab"], (n, SEQ)
                                  ).astype(np.int32)}
    y = np.stack([rng.randint(0, SEQ, n), rng.randint(0, SEQ, n)],
                 axis=1).astype(np.int32)
    return x, y


def fit_both(cfg, x, y):
    """Both packages fit ``BERTSQuAD(**cfg)`` on (``x``, ``y``) for one
    epoch of batch 8, shuffled, with Adam (epsilon 1e-5) from the JAX
    package's initial weights; per-step losses recorded."""
    from analytics_zoo_tpu.models.text.bert_squad import (
        BERTSQuAD as RefSQuAD)

    ref = RefSQuAD(**cfg)
    ref._build_for_load()
    ref.compile(optimizer=ref_optim.Adam(epsilon=1e-5))
    tree = jax.tree_util.tree_map(np.asarray, ref.estimator.variables)
    port = BERTSQuAD(device="cpu", **cfg)
    load_flax_into(port.module, tree)
    port.compile(optimizer=optim.Adam(epsilon=1e-5))

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
    ref_hist = ref.fit((x, y), batch_size=BATCH, epochs=1)
    port_hist = port.fit((x, y), batch_size=BATCH, epochs=1)
    return dict(ref=ref, port=port, tree=tree, ref_losses=ref_losses,
                port_losses=port_losses, ref_hist=ref_hist,
                port_hist=port_hist)


@pytest.fixture(scope="module")
def squad_fit():
    """Both packages fit 3 Adam steps (24 samples, batch 8, shuffled) from
    the JAX package's initial weights; per-step losses recorded."""
    return fit_both(SMALL, *_squad_data(24, 0))


class TestBERTSQuADSlice:
    def test_param_names_are_the_flax_tree(self, squad_fit):
        names = set(optim.param_tree(squad_fit["port"].module))
        flax = set(_flat(squad_fit["tree"]["params"]))
        assert flax <= names
        assert names - flax == {"squad/bert/segment_embed/embedding"}

    def test_step_losses_match(self, squad_fit):
        assert len(squad_fit["port_losses"]) == 3
        np.testing.assert_allclose(squad_fit["port_losses"],
                                   squad_fit["ref_losses"], rtol=1e-4)
        np.testing.assert_allclose(squad_fit["port_hist"][0]["loss"],
                                   squad_fit["ref_hist"][0]["loss"],
                                   rtol=1e-4)

    def test_parameters_after_three_steps_match(self, squad_fit):
        ref_params = jax.tree_util.tree_map(
            np.asarray, squad_fit["ref"].estimator.variables)
        want = state_dict_from_flax(ref_params)
        got = squad_fit["port"].module.state_dict()
        moved = 0
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-4,
                                       err_msg=k)
            moved += int(not np.allclose(
                v.numpy(), state_dict_from_flax(squad_fit["tree"])[k]))
        assert moved > len(want) // 2

    def test_evaluate_and_predict_match(self, squad_fit):
        x, y = _squad_data(20, 1)  # a padded tail batch
        want = squad_fit["ref"].evaluate((x, y), batch_size=BATCH)
        got = squad_fit["port"].evaluate((x, y), batch_size=BATCH)
        assert set(got) == set(want) == {"loss"}
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        ws, we = squad_fit["ref"].predict(x, batch_size=BATCH)
        gs, ge = squad_fit["port"].predict(x, batch_size=BATCH)
        assert gs.shape == ge.shape == (20, SEQ)
        np.testing.assert_allclose(gs, np.asarray(ws), atol=1e-4)
        np.testing.assert_allclose(ge, np.asarray(we), atol=1e-4)
        np.testing.assert_array_equal(BERTSQuAD.decode_spans(gs, ge),
                                      BERTSQuAD.decode_spans(ws, we))

    def test_dropout_training_is_seeded(self):
        """With dropout on, two fits from one seed agree and a third seed
        differs (every dropout draws from the Estimator's generator)."""
        cfg = dict(SMALL, hidden_dropout=0.1, n_block=1)
        x, y = _squad_data(16, 2)
        runs = []
        for seed in (3, 3, 4):
            m = BERTSQuAD(device="cpu", seed=0, **cfg)
            m.compile(seed=seed)
            runs.append(m.fit((x, y), batch_size=BATCH)[0]["loss"])
        assert runs[0] == runs[1] != runs[2]

    def test_save_and_load_after_fit(self, tmp_path, squad_fit):
        port = squad_fit["port"]
        path = str(tmp_path / "m")
        port.save_model(path)
        from analytics_zoo_tpu_torch.models.common import ZooModel

        loaded = ZooModel.load_model(path, device="cpu")
        x, _ = _squad_data(4, 3)
        for a, b in zip(loaded.predict(x), port.predict(x)):
            np.testing.assert_array_equal(a, b)

