"""PyTorch port, Keras slice 3b: ``keras/layers/{convolutional,pooling}.py``
and the Keras layers of ``keras/layers/normalization.py``, held against
the JAX package on the CPU.

Both packages get the same numpy inputs (made from a seed); the port's
weights are the JAX package's, perturbed by a seeded draw so that no
parameter sits at its initial value, and copied across by ``bridge``.
Tolerances: 1e-5 (1 + |ref|) in f32, 1e-4 after a product.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras import Sequential as RefSequential
from analytics_zoo_tpu.keras import layers as RL
from analytics_zoo_tpu.learn import optim as ref_optim
from analytics_zoo_tpu.learn.estimator import Estimator as RefEstimator
from analytics_zoo_tpu_torch.bridge import (flatten, kernel_layouts,
                                            load_flax_into, nest,
                                            state_dict_from_flax,
                                            to_flax_layout,
                                            variables_from_module)
from analytics_zoo_tpu_torch.keras import Sequential
from analytics_zoo_tpu_torch.keras import layers as PL
from analytics_zoo_tpu_torch.keras.layers.transformer import reset_parameters
from analytics_zoo_tpu_torch.learn import optim
from analytics_zoo_tpu_torch.learn.estimator import Estimator
from analytics_zoo_tpu_torch.learn.optim import batch_stats_tree, param_tree

torch.set_num_threads(2)

TOL = 1e-5
PROD_TOL = 1e-4


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    excess = np.abs(got - want) - tol * (1 + np.abs(want))
    assert excess.max(initial=-1) <= 0, (what, float(excess.max()))


def _tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _perturbed(variables, seed=0):
    """The flax tree with every leaf moved by a seeded draw (a running
    variance kept positive)."""
    rng = np.random.RandomState(seed)
    flat = flatten(_tree(variables))
    out = {}
    for k, a in sorted(flat.items()):
        d = 0.3 * rng.randn(*np.shape(a))
        if k.endswith("var"):
            d = np.abs(d)
        out[k] = (np.asarray(a) + d).astype(np.float32)
    return nest(out)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port_module(make, x, variables):
    mod = make(PL).build()
    with torch.no_grad():
        mod(torch.from_numpy(x))
    if variables:
        load_flax_into(mod, variables)
    return mod


def _layer_pair(make, x):
    """(the JAX output, the port's output) of one layer in eval mode at
    the same (perturbed) weights."""
    ref_mod = make(RL).build()
    variables = ref_mod.init(jax.random.PRNGKey(0), x)
    variables = _perturbed(variables) if variables else variables
    want = np.asarray(ref_mod.apply(variables, x))
    mod = _port_module(make, x, variables)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    return want, got


X3 = _rand(3, 11, 4, seed=1)
X4 = _rand(2, 9, 8, 3, seed=2)
X5 = _rand(2, 6, 5, 7, 2, seed=3)

# (case, make(layers), input, tolerance)
LAYER_CASES = [
    ("conv1d_valid", lambda L: L.Convolution1D(5, 3), X3, PROD_TOL),
    ("conv1d_same_stride2", lambda L: L.Convolution1D(
        5, 4, subsample_length=2, border_mode="same",
        activation="relu"), X3, PROD_TOL),
    ("conv1d_no_bias", lambda L: L.Convolution1D(5, 2, bias=False), X3,
     PROD_TOL),
    ("atrous1d_same", lambda L: L.AtrousConvolution1D(
        5, 3, atrous_rate=2, border_mode="same"), X3, PROD_TOL),
    ("conv2d_valid", lambda L: L.Convolution2D(4, 3, 2), X4, PROD_TOL),
    ("conv2d_same_stride2", lambda L: L.Convolution2D(
        4, 3, 3, subsample=(2, 2), border_mode="same",
        activation="tanh"), X4, PROD_TOL),
    ("conv2d_same_stride_mixed", lambda L: L.Convolution2D(
        4, 4, 3, subsample=(3, 2), border_mode="same"), X4, PROD_TOL),
    ("atrous2d_valid", lambda L: L.AtrousConvolution2D(
        4, 3, 3, atrous_rate=(2, 1)), X4, PROD_TOL),
    ("atrous2d_same", lambda L: L.AtrousConvolution2D(
        4, 2, 3, atrous_rate=(2, 2), border_mode="same"), X4, PROD_TOL),
    ("conv3d_valid", lambda L: L.Convolution3D(3, 2, 3, 2), X5, PROD_TOL),
    ("conv3d_same_stride2", lambda L: L.Convolution3D(
        3, 3, subsample=(2, 2, 2), border_mode="same"), X5, PROD_TOL),
    ("deconv2d_valid", lambda L: L.Deconvolution2D(4, 3, 3), X4,
     PROD_TOL),
    ("deconv2d_valid_stride2", lambda L: L.Deconvolution2D(
        4, 3, 2, subsample=(2, 2)), X4, PROD_TOL),
    ("deconv2d_same_stride2", lambda L: L.Deconvolution2D(
        4, 3, 3, subsample=(2, 2), border_mode="same"), X4, PROD_TOL),
    ("deconv2d_same_stride3", lambda L: L.Deconvolution2D(
        4, 2, 4, subsample=(3, 2), border_mode="same"), X4, PROD_TOL),
    ("separable_valid", lambda L: L.SeparableConvolution2D(5, 3, 3), X4,
     PROD_TOL),
    ("separable_same_stride2", lambda L: L.SeparableConvolution2D(
        5, 3, 2, subsample=(2, 2), depth_multiplier=2,
        border_mode="same", activation="relu"), X4, PROD_TOL),
    ("cropping1d", lambda L: L.Cropping1D((2, 3)), X3, 0.0),
    ("cropping2d", lambda L: L.Cropping2D(((1, 2), (0, 3))), X4, 0.0),
    ("cropping3d", lambda L: L.Cropping3D(), X5, 0.0),
    ("zero_padding1d", lambda L: L.ZeroPadding1D((1, 3)), X3, 0.0),
    ("zero_padding2d", lambda L: L.ZeroPadding2D(((2, 0), (1, 1))), X4,
     0.0),
    ("zero_padding3d", lambda L: L.ZeroPadding3D(1), X5, 0.0),
    ("upsampling1d", lambda L: L.UpSampling1D(3), X3, 0.0),
    ("upsampling2d", lambda L: L.UpSampling2D((2, 3)), X4, 0.0),
    ("upsampling3d", lambda L: L.UpSampling3D(), X5, 0.0),
    ("locally_connected1d", lambda L: L.LocallyConnected1D(
        4, 3, subsample_length=2, activation="relu"), X3, PROD_TOL),
    ("locally_connected2d", lambda L: L.LocallyConnected2D(
        4, 3, 2, subsample=(2, 1)), X4, PROD_TOL),
    ("locally_connected2d_no_bias", lambda L: L.LocallyConnected2D(
        3, 2, 2, bias=False), X4, PROD_TOL),
    ("resize_up", lambda L: L.ResizeBilinear(13, 17), X4, PROD_TOL),
    ("resize_down", lambda L: L.ResizeBilinear(4, 3), X4, PROD_TOL),
    ("resize_mixed", lambda L: L.ResizeBilinear(5, 11), X4, PROD_TOL),
    ("max_pool1d", lambda L: L.MaxPooling1D(), X3, 0.0),
    ("max_pool1d_same", lambda L: L.MaxPooling1D(
        3, strides=2, border_mode="same"), X3, 0.0),
    ("max_pool2d_same", lambda L: L.MaxPooling2D(
        (3, 3), strides=(2, 2), border_mode="same"), X4, 0.0),
    ("max_pool2d_valid_strides", lambda L: L.MaxPooling2D(
        (2, 3), strides=(1, 2)), X4, 0.0),
    ("max_pool3d_same", lambda L: L.MaxPooling3D(
        2, border_mode="same"), X5, 0.0),
    ("avg_pool1d_same", lambda L: L.AveragePooling1D(
        4, strides=3, border_mode="same"), X3, TOL),
    ("avg_pool2d", lambda L: L.AveragePooling2D((2, 2)), X4, TOL),
    ("avg_pool2d_same", lambda L: L.AveragePooling2D(
        (3, 2), strides=(2, 3), border_mode="same"), X4, TOL),
    ("avg_pool3d_valid", lambda L: L.AveragePooling3D(
        (2, 2, 3), strides=(1, 2, 2)), X5, TOL),
    ("global_max1d", lambda L: L.GlobalMaxPooling1D(), X3, 0.0),
    ("global_max2d", lambda L: L.GlobalMaxPooling2D(), X4, 0.0),
    ("global_max3d", lambda L: L.GlobalMaxPooling3D(), X5, 0.0),
    ("global_avg1d", lambda L: L.GlobalAveragePooling1D(), X3, TOL),
    ("global_avg2d", lambda L: L.GlobalAveragePooling2D(), X4, TOL),
    ("global_avg3d", lambda L: L.GlobalAveragePooling3D(), X5, TOL),
    ("batch_norm_eval", lambda L: L.BatchNormalization(), X4, TOL),
    ("batch_norm_eval_3d", lambda L: L.BatchNormalization(
        epsilon=1e-2), X3, TOL),
    ("layer_norm", lambda L: L.LayerNormalization(), X3, TOL),
    ("layer_norm_eps", lambda L: L.LayerNormalization(epsilon=1e-2), X4,
     TOL),
    ("lrn2d", lambda L: L.LRN2D(alpha=0.1, beta=0.5, n=3), X4, TOL),
    ("lrn2d_default", lambda L: L.LRN2D(), 3 * X4, TOL),
]


@pytest.mark.parametrize("make,x,tol", [c[1:] for c in LAYER_CASES],
                         ids=[c[0] for c in LAYER_CASES])
def test_layer_matches_reference(make, x, tol):
    want, got = _layer_pair(make, x)
    _close(got, want, tol)


# the layers that hold parameters, with an input
PARAM_CASES = {
    "conv1d": (lambda L: L.Convolution1D(5, 3), X3),
    "conv2d": (lambda L: L.Convolution2D(4, 3, 2), X4),
    "conv3d": (lambda L: L.Convolution3D(3, 2, 3, 2), X5),
    "conv1d_no_bias": (lambda L: L.Convolution1D(5, 2, bias=False), X3),
    "deconv2d": (lambda L: L.Deconvolution2D(4, 3, 2, subsample=(2, 2)),
                 X4),
    "separable": (lambda L: L.SeparableConvolution2D(
        5, 3, 3, depth_multiplier=2), X4),
    "locally_connected1d": (lambda L: L.LocallyConnected1D(4, 3), X3),
    "locally_connected2d": (lambda L: L.LocallyConnected2D(4, 3, 2), X4),
    "batch_norm": (lambda L: L.BatchNormalization(), X4),
    "layer_norm": (lambda L: L.LayerNormalization(), X3),
    "share_conv2d": (lambda L: L.ShareConvolution2D(4, 3, 3), X4),
}


@pytest.mark.parametrize("case", sorted(PARAM_CASES))
def test_parameter_trees_match_flax(case):
    """flax's exact tree (names and shapes, ``batch_stats`` included);
    biases, scales and running statistics at flax's initial values."""
    make, x = PARAM_CASES[case]
    want = flatten(_tree(make(RL).build().init(jax.random.PRNGKey(0), x)))
    mod = make(PL).build()
    with torch.no_grad():
        mod(torch.from_numpy(x))
    reset_parameters(mod, 0)
    got = flatten(variables_from_module(mod))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if not k.endswith("kernel"):
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def _spread(w, fan_in):
    w = np.asarray(w, np.float64) * math.sqrt(fan_in)
    return float(w.std()), float(np.abs(w).max())


# flax's lecun_normal: std 1/sqrt(fan_in), truncated at 2 / 0.8796
TRUNC = 2.0 / 0.87962566103423978


@pytest.mark.parametrize("case,make,x,fan_in", [
    ("conv1d", lambda L: L.Convolution1D(256, 5), _rand(1, 9, 200), 1000),
    ("conv3d", lambda L: L.Convolution3D(64, 3), _rand(1, 4, 4, 4, 32),
     864),
    ("deconv2d", lambda L: L.Deconvolution2D(64, 3, 3),
     _rand(1, 4, 4, 64), 576),
    # fan_in = patch x positions: flax's variance_scaling over the 3-D
    # [positions, patch, out] shape
    ("locally_connected1d", lambda L: L.LocallyConnected1D(64, 3),
     _rand(1, 34, 32), 96 * 32),
], ids=lambda v: v if isinstance(v, str) else "")
def test_kernel_spread_matches_flax(case, make, x, fan_in):
    kernel = [k for k in flatten(_tree(make(RL).build().init(
        jax.random.PRNGKey(0), x))) if k.endswith("kernel")][0]
    want = flatten(_tree(make(RL).build().init(
        jax.random.PRNGKey(0), x)))[kernel]
    mod = make(PL).build()
    with torch.no_grad():
        mod(torch.from_numpy(x))
    reset_parameters(mod, 0)
    got = flatten(variables_from_module(mod))[kernel]
    (got_std, got_max), (want_std, want_max) = (
        _spread(got, fan_in), _spread(want, fan_in))
    assert abs(want_std - 1.0) < 0.02, want_std
    assert abs(got_std / want_std - 1.0) < 0.02, (got_std, want_std)
    for m in (got_max, want_max):
        assert TRUNC * 0.98 < m <= TRUNC * (1 + 1e-6), (got_max, want_max)


# ------------------------------------------------------------ bridge --

# the layers whose kernel the rank rule would misread: a 3-D or 5-D
# convolution, a transposed one, and the unshared [positions, patch,
# out] kernel
LAYOUT_CASES = ["conv1d", "conv3d", "deconv2d", "locally_connected1d",
                "locally_connected2d"]


@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_bridge_layout_keyed_on_the_module(case):
    """flax -> port -> flax is the identity, the port's module computes
    the reference's output from the loaded tree, and the layout comes
    from the module (``kernel_layouts``), not the rank."""
    make, x = PARAM_CASES[case]
    ref_mod = make(RL).build()
    tree = _perturbed(ref_mod.init(jax.random.PRNGKey(0), x), seed=4)
    mod = _port_module(make, x, tree)
    back = flatten(variables_from_module(mod))
    want = flatten(tree)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(ref_mod.apply(tree, x)), PROD_TOL, case)
    layouts = kernel_layouts(mod)
    assert set(layouts.values()) == {
        "flax" if case.startswith("locally") else "conv"}
    # without the module's layouts a 3-D or 5-D kernel is read as a
    # Dense's, which is not this layer's weight
    if case != "deconv2d":
        plain = state_dict_from_flax(tree)
        sd = mod.state_dict()
        assert any(plain[k].shape != sd[k].shape
                   or not torch.equal(plain[k], sd[k]) for k in sd)


def _seq(L, Sequential, case):
    make = PARAM_CASES[case][0]
    return Sequential([make(L), L.Flatten(), L.Dense(3)])


@pytest.mark.parametrize("case", LAYOUT_CASES)
@pytest.mark.parametrize("saver", ["jax", "port"])
def test_weights_cross_between_packages(tmp_path, case, saver):
    """``save_weights`` after one Adam step in one package,
    ``load_weights`` in the other into a fresh model: the same
    predictions (the optimizer state's kernels take the same layout)."""
    x = PARAM_CASES[case][1]
    x = np.concatenate([x] * (8 // x.shape[0] + 1))[:8]
    y = _rand(8, 3, seed=5)
    ref = _seq(RL, RefSequential, case)
    port = _seq(PL, lambda ls: Sequential(ls, device="cpu"), case)
    for m in (ref, port):
        m.compile(optimizer="adam", loss="mse")
    src, dst = (ref, port) if saver == "jax" else (port, ref)
    src.fit(x, y, batch_size=8, nb_epoch=1)
    path = str(tmp_path / "w")
    src.save_weights(path)
    dst.load_weights(path)
    _close(dst.predict(x, batch_size=8), src.predict(x, batch_size=8),
           PROD_TOL, case)
    # and one more step on each side from there agrees too
    for m in (src, dst):
        m.fit(x, y, batch_size=8, nb_epoch=1)
    _close(dst.predict(x, batch_size=8), src.predict(x, batch_size=8),
           PROD_TOL, case)


def test_port_round_trip_keeps_every_weight(tmp_path):
    """The port's own ``save_weights``/``load_weights`` over a model
    holding every parametrized layer of this file: predictions bit for
    bit."""
    def build():
        return Sequential([
            PL.Convolution2D(4, 3, 3, border_mode="same"),
            PL.BatchNormalization(), PL.SeparableConvolution2D(4, 2, 2),
            PL.Deconvolution2D(3, 2, 2, subsample=(2, 2)),
            PL.LocallyConnected2D(2, 3, 3), PL.LayerNormalization(),
            PL.Flatten(), PL.Dense(3)], device="cpu", seed=3)

    x, y = X4, _rand(2, 3, seed=6)
    m = build().compile(optimizer="adam", loss="mse")
    m.fit(x, y, batch_size=2, nb_epoch=2)
    path = str(tmp_path / "w")
    m.save_weights(path)
    fresh = build().compile(optimizer="adam", loss="mse")
    fresh.load_weights(path)
    np.testing.assert_array_equal(fresh.predict(x, batch_size=2),
                                  m.predict(x, batch_size=2))


# ----------------------------------------------------------- training --

ADAM_EPS = 1e-3


def _cnn(L, S):
    return S([L.Convolution2D(4, 3, 3, border_mode="same"),
              L.BatchNormalization(), L.Activation("relu"),
              L.MaxPooling2D(border_mode="same"),
              L.Convolution2D(3, 2, 2), L.AveragePooling2D(),
              L.Flatten(), L.Dense(5)])


@functools.lru_cache(maxsize=None)
def _cnn_reference():
    """The JAX CNN materialized once, its variables perturbed."""
    x = _rand(16, 9, 8, 3, seed=7)
    ref = _cnn(RL, RefSequential)
    ref.predict(x[:8], batch_size=8)
    return x, _perturbed(ref.estimator.variables, seed=8)


def test_three_adam_steps_with_batch_norm():
    """Both packages take 3 Adam steps of a small CNN with
    ``BatchNormalization`` through ``compile``/``fit`` from the same
    weights and running statistics: the losses, every parameter and the
    ``batch_stats`` agree, and ``evaluate``."""
    x, variables = _cnn_reference()
    x = np.concatenate([x, x[:8]])
    y = np.random.RandomState(9).randint(0, 5, 24).astype(np.int32)
    ref = _cnn(RL, RefSequential)
    ref.predict(x[:8], batch_size=8)
    ref.estimator.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    port = _cnn(PL, lambda ls: Sequential(ls, device="cpu"))
    port.materialize(x)
    load_flax_into(port.module, variables)
    ref.compile(optimizer=ref_optim.Adam(epsilon=ADAM_EPS),
                loss="sparse_categorical_crossentropy",
                metrics=["accuracy"])
    port.compile(optimizer=optim.Adam(epsilon=ADAM_EPS),
                 loss="sparse_categorical_crossentropy",
                 metrics=["accuracy"])
    ref_hist = ref.fit(x, y, batch_size=8, nb_epoch=1)
    hist = port.fit(x, y, batch_size=8, nb_epoch=1)
    assert port.estimator.global_step == 3
    _close(hist[0]["loss"], ref_hist[0]["loss"], TOL, "loss")
    want = flatten(_tree(ref.estimator.variables))
    got = flatten(variables_from_module(port.module))
    assert sorted(got) == sorted(want)
    assert any(k.startswith("batch_stats/") for k in want)
    for k, w in want.items():
        _close(got[k], w, PROD_TOL, k)
    want_eval = ref.evaluate(x[:16], y[:16], batch_size=8)
    got_eval = port.evaluate(x[:16], y[:16], batch_size=8)
    for k in want_eval:
        _close(got_eval[k], want_eval[k], PROD_TOL, k)


def test_batch_norm_train_step_statistics():
    """One train-mode forward: the normalized output and the updated
    running statistics (momentum 0.99) match flax's."""
    make = PARAM_CASES["batch_norm"][0]
    x = 2.0 + 3.0 * X4
    ref_mod = make(RL).build()
    tree = _perturbed(ref_mod.init(jax.random.PRNGKey(0), x), seed=10)
    want, upd = ref_mod.apply(tree, x, train=True, mutable=["batch_stats"])
    mod = _port_module(make, x, tree)
    got = mod(torch.from_numpy(x), train=True)
    _close(got.detach().numpy(), np.asarray(want), TOL, "out")
    stats = {k: b.numpy() for k, b in batch_stats_tree(mod).items()}
    for k, w in flatten(_tree(upd["batch_stats"])).items():
        _close(stats[k], w, TOL, k)


def test_batch_norm_grad_accum_keeps_the_last_microbatch_statistics():
    """Under ``grad_accum_steps=2`` both Estimators keep one update of
    the running statistics from the pre-step ones, with the last
    microbatch's batch statistics."""
    x, variables = _cnn_reference()
    y = np.random.RandomState(11).randint(0, 5, 16).astype(np.int32)
    ref_est = RefEstimator(_cnn(RL, RefSequential)._build_module(),
                           loss="sparse_categorical_crossentropy",
                           optimizer=ref_optim.Adam(epsilon=ADAM_EPS),
                           grad_accum_steps=2)
    ref_est.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    port = _cnn(PL, lambda ls: Sequential(ls, device="cpu"))
    port.materialize(x)
    load_flax_into(port.module, variables)
    est = Estimator(port.module, loss="sparse_categorical_crossentropy",
                    optimizer=optim.Adam(epsilon=ADAM_EPS), device="cpu",
                    grad_accum_steps=2)
    ref_est.fit((x, y), batch_size=16, epochs=1)
    est.fit((x, y), batch_size=16, epochs=1)
    want = flatten(_tree(ref_est.variables["batch_stats"]))
    got = {k: b.numpy() for k, b in batch_stats_tree(port.module).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], PROD_TOL, k)


def _text_cnn(L, S, vocab=50, embed=8, filters=6, classes=4):
    """The chip's CNN text classifier at small widths."""
    return S([L.Embedding(vocab, embed),
              L.Convolution1D(filters, 5, activation="relu"),
              L.GlobalMaxPooling1D(), L.Dropout(0.2),
              L.Dense(7, activation="relu"), L.Dense(classes)])


def test_text_cnn_gradient_matches_reference():
    """One step's gradient of the CNN text classifier (dropout off) at
    the same weights, within 1e-4."""
    ids = np.random.RandomState(12).randint(0, 50, (8, 20)).astype(np.int32)
    y = np.random.RandomState(13).randint(0, 4, 8).astype(np.int32)
    ref = _text_cnn(RL, RefSequential)
    ref_mod = ref._build_module()
    tree = _perturbed(ref_mod.init(jax.random.PRNGKey(0), ids), seed=14)

    def ref_loss(params):
        logits = ref_mod.apply({"params": params}, ids)
        return -jnp.mean(jnp.take_along_axis(
            jax.nn.log_softmax(logits), y[:, None], axis=1))

    want = flatten(_tree(jax.grad(ref_loss)(tree["params"])))
    port = _text_cnn(PL, lambda ls: Sequential(ls, device="cpu"))
    port.materialize(ids)
    load_flax_into(port.module, tree)
    logits = port.module(torch.from_numpy(ids))
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.from_numpy(y).long())
    loss.backward()
    layouts = kernel_layouts(port.module)
    got = {k: to_flax_layout(k, p.grad.numpy(), layouts)
           for k, p in param_tree(port.module).items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        _close(got[k], w, PROD_TOL, k)


def test_constructor_errors_match_reference():
    for L in (RL, PL):
        with pytest.raises(ValueError, match="border_mode"):
            L.Convolution2D(3, 2, 2, border_mode="full")
        with pytest.raises(ValueError, match="expected 2 values"):
            L.Convolution2D(3, (2, 2, 2))
