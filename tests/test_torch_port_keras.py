"""PyTorch port, Keras slice 3a: ``keras/{engine,activations}.py``,
``keras/layers/{base,core,advanced_activations,merge}.py`` and
``utils/nest.py``, held against the JAX package on the CPU.

Both packages get the same numpy inputs (made from a seed); the port's
weights are the JAX package's, perturbed by a seeded draw so that no
parameter sits at its constant initial value, and copied across by
``bridge``. Dropout and noise are off (eval mode) except in the
statistics tests of the train-mode RNG layers, whose streams differ
between the packages. Tolerances: 1e-5 (1 + |ref|) in f32, 1e-4 after a
product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras import Input as RefInput
from analytics_zoo_tpu.keras import Model as RefModel
from analytics_zoo_tpu.keras import Sequential as RefSequential
from analytics_zoo_tpu.keras import activations as ref_activations
from analytics_zoo_tpu.keras import layers as RL
from analytics_zoo_tpu.utils import nest as ref_nest
from analytics_zoo_tpu_torch.bridge import (flatten, load_flax_into,
                                            variables_from_module)
from analytics_zoo_tpu_torch.keras import Input, Model, Sequential
from analytics_zoo_tpu_torch.keras import activations
from analytics_zoo_tpu_torch.keras import layers as PL
from analytics_zoo_tpu_torch.keras.layers.transformer import reset_parameters
from analytics_zoo_tpu_torch.learn.optim import param_tree
from analytics_zoo_tpu_torch.utils import nest

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
    """The flax tree with every parameter moved by a seeded draw."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.3 * rng.randn(*np.shape(a))).astype(
            np.float32), _tree(variables))


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _torch(x):
    if isinstance(x, (list, tuple)):
        return type(x)(_torch(v) for v in x)
    return torch.from_numpy(x)


def _numpy(t):
    if isinstance(t, (list, tuple)):
        return type(t)(_numpy(v) for v in t)
    return t.detach().numpy()


def _layer_pair(make, x):
    """(the JAX output, the port's output) of one layer in eval mode at
    the same (perturbed) weights."""
    ref_mod = make(RL, jnp).build()
    variables = ref_mod.init(jax.random.PRNGKey(0), x)
    variables = _perturbed(variables) if variables else variables
    want = ref_mod.apply(variables, x)
    mod = make(PL, torch).build()
    with torch.no_grad():
        mod(_torch(x))
        if variables:
            load_flax_into(mod, variables)
        got = mod(_torch(x))
    return jax.tree_util.tree_map(np.asarray, want), _numpy(got)


X2 = _rand(6, 5, seed=1)
X3 = _rand(6, 3, 4, seed=2)
X4 = _rand(4, 3, 4, 5, seed=3)
X5 = _rand(2, 3, 2, 4, 5, seed=4)
PAIR = [_rand(6, 5, seed=5), _rand(6, 5, seed=6)]
TRIPLE = PAIR + [_rand(6, 5, seed=7)]
MASKED = X3.copy()
MASKED[1, 2] = 0.0
MASKED[3, :] = 0.0
MASKED[4, 0, :2] = 0.0

# (case, make(layers, xp), input, tolerance)
LAYER_CASES = [
    ("dense_relu", lambda L, xp: L.Dense(6, activation="relu"), X2,
     PROD_TOL),
    ("dense_no_bias", lambda L, xp: L.Dense(6, bias=False), X3, PROD_TOL),
    ("activation_gelu", lambda L, xp: L.Activation("gelu"), X2, TOL),
    ("activation_fn", lambda L, xp: L.Activation(xp.tanh), X2, TOL),
    ("dropout_eval", lambda L, xp: L.Dropout(0.3), X2, 0.0),
    ("gaussian_noise_eval", lambda L, xp: L.GaussianNoise(0.5), X2, 0.0),
    ("gaussian_dropout_eval", lambda L, xp: L.GaussianDropout(0.3), X2,
     0.0),
    ("flatten", lambda L, xp: L.Flatten(), X4, 0.0),
    ("reshape", lambda L, xp: L.Reshape((4, 3)), X3, 0.0),
    ("reshape_inferred", lambda L, xp: L.Reshape((2, -1)), X3, 0.0),
    ("permute", lambda L, xp: L.Permute((3, 1, 2)), X4, 0.0),
    ("repeat_vector", lambda L, xp: L.RepeatVector(3), X2, 0.0),
    ("lambda", lambda L, xp: L.Lambda(lambda x: xp.tanh(x) * 2.0 - x), X2,
     TOL),
    ("input_layer", lambda L, xp: L.InputLayer(), X2, 0.0),
    ("highway", lambda L, xp: L.Highway(), X2, PROD_TOL),
    ("highway_relu", lambda L, xp: L.Highway(activation="relu"), X3,
     PROD_TOL),
    ("srelu", lambda L, xp: L.SReLU(), 2 * X3, TOL),
    ("masking_3d", lambda L, xp: L.Masking(0.0), MASKED, 0.0),
    ("masking_4d", lambda L, xp: L.Masking(0.0), np.where(
        np.abs(X4) < 0.3, 0.0, X4).astype(np.float32), 0.0),
    ("masking_2d", lambda L, xp: L.Masking(0.0), MASKED[:, 0], 0.0),
    ("maxout_dense", lambda L, xp: L.MaxoutDense(5, nb_feature=3), X2,
     PROD_TOL),
    ("spatial_dropout1d_eval", lambda L, xp: L.SpatialDropout1D(0.4), X3,
     0.0),
    ("spatial_dropout2d_eval", lambda L, xp: L.SpatialDropout2D(0.4), X4,
     0.0),
    ("spatial_dropout3d_eval", lambda L, xp: L.SpatialDropout3D(0.4), X5,
     0.0),
    ("gaussian_sampler_eval", lambda L, xp: L.GaussianSampler(), PAIR, 0.0),
    ("leaky_relu", lambda L, xp: L.LeakyReLU(0.1), X2, TOL),
    ("elu", lambda L, xp: L.ELU(0.7), X2, TOL),
    ("thresholded_relu", lambda L, xp: L.ThresholdedReLU(0.5), X2, 0.0),
    ("prelu", lambda L, xp: L.PReLU(), X3, TOL),
    ("merge_sum", lambda L, xp: L.Merge(mode="sum"), TRIPLE, TOL),
    ("merge_mul", lambda L, xp: L.Merge(mode="mul"), TRIPLE, TOL),
    ("merge_max", lambda L, xp: L.Merge(mode="max"), TRIPLE, 0.0),
    ("merge_ave", lambda L, xp: L.Merge(mode="ave"), TRIPLE, TOL),
    ("merge_concat", lambda L, xp: L.Merge(mode="concat", concat_axis=1),
     [X3, X3[:, :2]], 0.0),
    ("merge_dot", lambda L, xp: L.Merge(mode="dot"), PAIR, PROD_TOL),
    ("merge_cos", lambda L, xp: L.Merge(mode="cos", dot_axes=1), PAIR,
     PROD_TOL),
    ("merge_cos_zero", lambda L, xp: L.Merge(mode="cos"),
     [PAIR[0], np.zeros_like(PAIR[1])], TOL),
    ("mm_2d", lambda L, xp: L.MM(trans_b=True), PAIR, PROD_TOL),
    ("mm_3d", lambda L, xp: L.MM(trans_a=True), [X3, X3[:, :, :2]],
     PROD_TOL),
    ("select_table", lambda L, xp: L.SelectTable(1), TRIPLE, 0.0),
    ("split_tensor", lambda L, xp: L.SplitTensor(1, 2), X3, 0.0),
]


@pytest.mark.parametrize("make,x,tol", [c[1:] for c in LAYER_CASES],
                         ids=[c[0] for c in LAYER_CASES])
def test_layer_matches_reference(make, x, tol):
    want, got = _layer_pair(make, x)
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
    else:
        _close(got, want, tol)


def test_layer_parameter_names_and_initial_values():
    """Each layer with parameters holds flax's names and shapes, and
    its constants start where flax's do (Highway's gate bias -2, SReLU's
    0, 0.2, 1, 1, PReLU's 0.25)."""
    x = X3
    for make in (lambda L: L.Highway(), lambda L: L.SReLU(),
                 lambda L: L.PReLU(), lambda L: L.MaxoutDense(5),
                 lambda L: L.Dense(6, bias=False)):
        ref_mod = make(RL).build()
        want = flatten(_tree(ref_mod.init(jax.random.PRNGKey(0), x)))
        mod = make(PL).build()
        with torch.no_grad():
            mod(_torch(x))
        reset_parameters(mod, 0)
        got = flatten(variables_from_module(mod))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].shape == w.shape, k
            if not k.endswith("kernel"):
                np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("name", sorted(ref_activations._ACTIVATIONS))
def test_activation_registry(name):
    x = np.linspace(-6, 6, 97, dtype=np.float32).reshape(1, 97)
    x = np.concatenate([x, _rand(3, 97, seed=8) * 3])
    want = np.asarray(ref_activations.get(name)(jnp.asarray(x)))
    got = activations.get(name)(torch.from_numpy(x)).numpy()
    _close(got, want, TOL, name)


def test_activation_registry_names_and_errors():
    assert set(activations._ACTIVATIONS) == set(ref_activations._ACTIVATIONS)
    assert len(activations._ACTIVATIONS) == 14
    assert activations.get(None) is activations.linear
    assert activations.get(torch.tanh) is torch.tanh
    assert activations.get("ReLU") is activations.get("relu")
    for get in (activations.get, ref_activations.get):
        with pytest.raises(ValueError, match="unknown activation"):
            get("nope")


@pytest.mark.parametrize("make,x", [
    (lambda L: L.MM(), [X4, X4]),
    (lambda L: L.MM(), [X2, X3]),
    (lambda L: L.MM(), [X2]),
    (lambda L: L.SplitTensor(0, 2), X3),
    (lambda L: L.SplitTensor(2, 2), X2),
    (lambda L: L.Merge(mode="nope"), PAIR),
    (lambda L: L.Merge(), X2),
    (lambda L: L.SelectTable(0), X2),
    (lambda L: L.GaussianSampler(), X2),
], ids=["mm_4d", "mm_ranks", "mm_one", "split_uneven", "split_dim",
        "merge_mode", "merge_not_list", "select_not_list", "sampler_one"])
def test_layer_errors_match_reference(make, x):
    with pytest.raises(ValueError):
        make(RL).build().init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError):
        make(PL).build()(_torch(x))


def test_constructor_errors_match_reference():
    for L in (RL, PL):
        for bad in (lambda: L.GaussianDropout(1.0),
                    lambda: L.SpatialDropout2D(-0.1)):
            with pytest.raises(ValueError):
                bad()
        with pytest.raises(TypeError, match="symbolic KTensors"):
            L.Dense(3)(X2)


# ------------------------------------------------------ train-mode RNG --

N_STAT = 200_000


def _train_outputs(make, x, seed=0):
    """One train-mode draw of the layer in each package."""
    ref_mod = make(RL).build()
    variables = ref_mod.init(jax.random.PRNGKey(0), x)
    want = ref_mod.apply(variables, x, train=True,
                         rngs={"dropout": jax.random.PRNGKey(seed)})
    mod = make(PL).build()
    gen = torch.Generator().manual_seed(seed)
    got = mod(_torch(x), train=True, rng=gen)
    return np.asarray(want, np.float64), got.numpy().astype(np.float64)


@pytest.mark.parametrize("make,sigma", [
    (lambda L: L.GaussianNoise(0.5), 0.5),
    (lambda L: L.GaussianDropout(0.3), (0.3 / 0.7) ** 0.5),
], ids=["gaussian_noise", "gaussian_dropout"])
def test_gaussian_noise_statistics(make, sigma):
    x = np.ones((N_STAT // 100, 100), np.float32)
    for out in _train_outputs(make, x):
        assert abs(out.mean() - 1.0) < 0.01
        assert abs(out.std() / sigma - 1.0) < 0.01


def test_dropout_statistics():
    x = np.ones((N_STAT // 100, 100), np.float32)
    for out in _train_outputs(lambda L: L.Dropout(0.3), x):
        assert abs((out == 0).mean() - 0.3) < 0.01
        np.testing.assert_allclose(out[out != 0], 1 / 0.7, rtol=1e-6)


@pytest.mark.parametrize("make,shape", [
    (lambda L: L.SpatialDropout1D(0.4), (400, 5, 100)),
    (lambda L: L.SpatialDropout2D(0.4), (400, 3, 4, 100)),
    (lambda L: L.SpatialDropout3D(0.4), (400, 2, 2, 3, 100)),
], ids=["1d", "2d", "3d"])
def test_spatial_dropout_statistics(make, shape):
    """Whole channels dropped: each (sample, channel) all kept or all
    zero, about 40% zero, the kept ones scaled by 1 / 0.6."""
    x = np.ones(shape, np.float32)
    for out in _train_outputs(make, x):
        per = out.reshape(shape[0], -1, shape[-1])
        assert (per.min(axis=1) == per.max(axis=1)).all()
        assert abs((per[:, 0] == 0).mean() - 0.4) < 0.02
        np.testing.assert_allclose(out[out != 0], 1 / 0.6, rtol=1e-6)


def test_gaussian_sampler_statistics():
    mean = np.full((N_STAT // 100, 100), 0.5, np.float32)
    log_var = np.full_like(mean, np.log(0.25))
    for out in _train_outputs(lambda L: L.GaussianSampler(),
                              [mean, log_var]):
        assert abs(out.mean() - 0.5) < 0.01
        assert abs(out.std() / 0.5 - 1.0) < 0.01


def test_rng_layers_need_a_generator_in_training():
    for make in (lambda L: L.GaussianNoise(0.5), lambda L: L.Dropout(0.5),
                 lambda L: L.GaussianDropout(0.3),
                 lambda L: L.SpatialDropout1D(0.3)):
        with pytest.raises(ValueError, match="generator"):
            make(PL).build()(torch.ones(2, 3, 4), train=True)


# ------------------------------------------------------------- nest --


STRUCT = {"b": (1, [2, None, {"z": 3, "a": 4}]), "a": 5,
          "c": {"y": (6,), "x": []}}


def test_nest_matches_reference():
    assert nest.flatten(STRUCT) == ref_nest.flatten(STRUCT)
    flat = [10 * v for v in nest.flatten(STRUCT)]
    assert (nest.pack_sequence_as(STRUCT, flat)
            == ref_nest.pack_sequence_as(STRUCT, flat))
    assert (nest.map_structure(lambda v: v + 1, STRUCT)
            == ref_nest.map_structure(lambda v: v + 1, STRUCT))
    nest.assert_same_structure(STRUCT, nest.map_structure(str, STRUCT))
    for other in ({"a": 1}, [1, 2], (1, 2), {**STRUCT, "a": (5,)}):
        for lib in (nest, ref_nest):
            with pytest.raises(ValueError):
                lib.assert_same_structure(STRUCT, other)
    for lib in (nest, ref_nest):
        with pytest.raises(ValueError):
            lib.pack_sequence_as(STRUCT, flat[:-1])
        lib.assert_same_structure([1, (2, 3)], [4, (5, 6)])
        with pytest.raises(ValueError):
            lib.assert_same_structure([1, 2], (1, 2))


# ----------------------------------------------------- the engine --


def _pair_models(build, x, seed=0):
    """(JAX model, port model) of ``build(layers, Input, Model,
    Sequential)``, both materialized at the JAX model's perturbed
    weights."""
    ref = build(RL, RefInput, RefModel, RefSequential, jnp)
    ref.predict(x, batch_size=8)
    ref.estimator.variables = jax.tree_util.tree_map(
        jnp.asarray, _perturbed(ref.estimator.variables, seed))
    port = build(PL, Input, lambda i, o: Model(i, o, device="cpu"),
                 lambda ls: Sequential(ls, device="cpu"), torch)
    port.materialize(x)
    load_flax_into(port.module, _tree(ref.estimator.variables))
    return ref, port


def _mlp(L, Input, Model, Sequential, xp):
    return Sequential([L.Dense(8, activation="relu"), L.Dropout(0.1),
                       L.PReLU(), L.Highway(), L.Dense(3)])


def _branches(L, Input, Model, Sequential, xp):
    inp = Input((5,))
    a = L.Dense(6)(inp)
    b = L.Dense(6, activation="tanh")(inp)
    h = L.concatenate([a, b])
    return Model(inp, L.Dense(2)(L.SReLU()(h)))


def _two_inputs(L, Input, Model, Sequential, xp):
    i1, i2 = Input((5,)), Input((4,))
    h = L.merge_add([L.Dense(6)(i1), L.Dense(6, activation="relu")(i2)])
    out = L.Merge(mode="mul")([L.MaxoutDense(3, nb_feature=2)(h),
                               L.Dense(3)(i2)])
    return Model([i1, i2], out)


def _diamond(L, Input, Model, Sequential, xp):
    inp = Input((4,))
    shared = L.Dense(4, activation="tanh")
    h1 = shared(inp)
    h2 = shared(inp)
    return Model(inp, L.Merge(mode="sum")([h1, h2]))


def _sugar(L, Input, Model, Sequential, xp):
    i1, i2 = Input((5,)), Input((5,))
    a = L.Dense(5)(i1)
    b = L.Dense(5, activation="sigmoid")(i2)
    out = a * 2.0 + b - 1.0
    out = -(out / (b + 1.0)) + 3.0 * a - (2.0 / (b + 2.0)) + (1.0 - a)
    return Model([i1, i2], out)


GRAPHS = {"sequential": (_mlp, X2), "branches": (_branches, X2),
          "two_inputs": (_two_inputs, (X2, X2[:, :4])),
          "diamond": (_diamond, X2[:, :4]),
          "sugar": (_sugar, (X2, _rand(6, 5, seed=9)))}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_forward_matches_reference(name):
    build, x = GRAPHS[name]
    ref, port = _pair_models(build, x)
    want = ref.predict(x, batch_size=8)
    got = port.predict(x, batch_size=8)
    _close(got, want, PROD_TOL, name)
    # the same parameter tree, flax's paths
    want_tree = flatten(_tree(ref.estimator.variables))
    got_tree = flatten(variables_from_module(port.module))
    assert sorted(got_tree) == sorted(want_tree)
    for k, w in want_tree.items():
        np.testing.assert_array_equal(got_tree[k], w, err_msg=k)


def test_sequential_parameter_paths():
    """The port's paths for the reference's example Sequential are
    flax's: stateless layers hold no entry but keep their index."""
    ref, port = _pair_models(_mlp, X2)
    assert sorted(param_tree(port.module)) == [
        "modules_0/Dense_0/bias", "modules_0/Dense_0/kernel",
        "modules_2/alpha", "modules_3/gate/bias", "modules_3/gate/kernel",
        "modules_3/transform/bias", "modules_3/transform/kernel",
        "modules_4/Dense_0/bias", "modules_4/Dense_0/kernel"]


def test_multi_input_forms():
    """A two-input model takes its inputs splatted (the Estimator's
    form) or as one tuple or list (``InferenceModel``'s)."""
    _, port = _pair_models(_two_inputs, GRAPHS["two_inputs"][1])
    x1, x2 = (torch.from_numpy(a) for a in GRAPHS["two_inputs"][1])
    with torch.no_grad():
        splat = port.module(x1, x2)
        for packed in ((x1, x2), [x1, x2]):
            torch.testing.assert_close(port.module(packed), splat,
                                       rtol=0, atol=0)
        with pytest.raises(ValueError, match="expects 2 inputs"):
            port.module(x1)


def test_shared_layer_one_set_of_parameters():
    """A layer called twice in one graph: one module under its first
    index, so the bridge loads flax's tree (which has ``modules_0``
    alone) and hands the same tree back."""
    ref, port = _pair_models(_diamond, X2[:, :4])
    mod = port.module
    assert mod.modules_0 is mod.modules_1
    assert sorted(param_tree(mod)) == ["modules_0/Dense_0/bias",
                                       "modules_0/Dense_0/kernel"]
    assert any(k.startswith("modules_1.") for k in mod.state_dict())
    tree = _tree(ref.estimator.variables)
    load_flax_into(mod, tree)  # no key reported missing
    back = flatten(variables_from_module(mod))
    assert sorted(back) == sorted(flatten(tree))
    with pytest.raises(KeyError, match="missing"):
        load_flax_into(mod, {"params": {"modules_2": {}}})


def test_layer_in_two_models_has_its_own_parameters():
    """As each of the reference's Estimators inits its own variables, a
    layer put into two models holds separate parameters in each."""
    x = _rand(16, 5, seed=15)
    dense = PL.Dense(3)
    inp = Input((5,))
    m1 = Model(inp, dense(inp), device="cpu")
    m2 = Sequential([dense, PL.Activation("tanh")], device="cpu",
                    seed=1)
    m1.compile(optimizer="sgd", loss="mse")
    before = m2.predict(x, batch_size=8)
    m1.fit(x, _rand(16, 3, seed=10), batch_size=8, nb_epoch=2)
    p1, p2 = (param_tree(m.module)["modules_0/Dense_0/kernel"]
              for m in (m1, m2))
    assert p1 is not p2
    np.testing.assert_array_equal(m2.predict(x, batch_size=8), before)
    # the reference holds the same: the second model's variables are its
    # own
    rdense = RL.Dense(3)
    rinp = RefInput((5,))
    r1 = RefModel(rinp, rdense(rinp))
    r2 = RefSequential([rdense, RL.Activation("tanh")])
    r1.compile(optimizer="sgd", loss="mse")
    rbefore = r2.predict(x, batch_size=8)
    r1.fit(x, _rand(16, 3, seed=10), batch_size=8, nb_epoch=2)
    np.testing.assert_array_equal(r2.predict(x, batch_size=8), rbefore)


def test_three_adam_steps_match():
    """Both packages take 3 Adam steps (24 samples, batch 8, shuffled
    alike) from the same weights: the losses, the parameters and
    ``evaluate`` agree."""
    x = _rand(24, 5, seed=11)
    y = np.random.RandomState(12).randint(0, 3, 24).astype(np.int32)

    def build(L, Input, Model, Sequential, xp):
        return Sequential([L.Dense(8, activation="relu"), L.PReLU(),
                           L.Highway(), L.SReLU(), L.Dense(3)])

    ref, port = _pair_models(build, x)
    for m in (ref, port):
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    ref_hist = ref.fit(x, y, batch_size=8, nb_epoch=1)
    hist = port.fit(x, y, batch_size=8, nb_epoch=1)
    assert port.estimator.global_step == ref.estimator.global_step == 3
    _close(hist[0]["loss"], ref_hist[0]["loss"], TOL, "loss")
    want = flatten(_tree(ref.estimator.variables))
    got = flatten(variables_from_module(port.module))
    for k, w in want.items():
        _close(got[k], w, TOL, k)
    want_eval = ref.evaluate(x[:20], y[:20], batch_size=8)
    got_eval = port.evaluate(x[:20], y[:20], batch_size=8)
    assert set(got_eval) == set(want_eval) == {"accuracy", "loss"}
    for k in want_eval:
        _close(got_eval[k], want_eval[k], TOL, k)


def test_compile_before_data_and_after_training():
    """``compile()`` before any data only records the configuration;
    recompiling a trained model keeps its weights and counters."""
    m = Sequential([PL.Dense(4, activation="relu"), PL.Dense(2)],
                   device="cpu")
    m.compile(optimizer="adam", loss="mse")
    assert not m.materialized and m.estimator is None
    with pytest.raises(RuntimeError, match="compile"):
        Sequential([PL.Dense(2)], device="cpu").fit(X2, X2[:, :2])
    m.fit(X2, X2[:, :2], batch_size=3, nb_epoch=2)
    assert m.estimator.global_step == 4
    before = m.predict(X2, batch_size=6)
    m.compile(optimizer="sgd", loss="mae")
    assert m.estimator.global_step == 4 and m.estimator.epoch == 2
    np.testing.assert_array_equal(m.predict(X2, batch_size=6), before)
    with pytest.raises(RuntimeError, match="cannot add layers"):
        m.add(PL.Dense(3))


def test_seeded_weights_are_reproducible():
    xs = []
    for seed in (3, 3, 4):
        m = Sequential([PL.Dense(4), PL.Highway()], device="cpu",
                       seed=seed)
        xs.append(m.predict(X2, batch_size=6))
    np.testing.assert_array_equal(xs[0], xs[1])
    assert not np.array_equal(xs[0], xs[2])
    # Highway's gate bias starts at -2 in the seeded model too
    np.testing.assert_array_equal(
        param_tree(m.module)["modules_1/gate/bias"].detach().numpy(),
        np.full(4, -2.0, np.float32))


def test_summaries_raise_not_implemented():
    m = Sequential([PL.Dense(2)], device="cpu")
    for call in (lambda: m.set_tensorboard("/nonexistent", "app"),
                 m.get_train_summary,
                 lambda: m.get_validation_summary("accuracy")):
        with pytest.raises(NotImplementedError, match="the rest"):
            call()


def test_input_and_model_errors():
    a = Input((3,))
    with pytest.raises(ValueError, match="not an Input"):
        Model(PL.Dense(2)(a), PL.Dense(2)(a), device="cpu")
    other = Input((3,))
    m = Model(a, PL.Dense(2)(other), device="cpu")
    with pytest.raises(ValueError, match="not among the model inputs"):
        m.module
    with pytest.raises(ValueError, match="empty Sequential"):
        Sequential(device="cpu").module
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Sequential([PL.Dense(2)])


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_weights_cross_between_packages(tmp_path, saver):
    """``save_weights`` after a fit in one package, ``load_weights`` in
    the other into a fresh compiled model (the port's before any data):
    the same predictions and step count; the diamond's shared layer
    too."""
    x, y = _rand(24, 4, seed=13), _rand(24, 4, seed=14)
    for name, build in (("mlp", lambda L, I, M, S: S(
            [L.Dense(8, activation="relu"), L.PReLU(), L.Highway(),
             L.Dense(4)])),
            ("diamond", lambda L, I, M, S: _diamond(L, I, M, S, None))):
        path = str(tmp_path / f"{saver}_{name}")
        ref = build(RL, RefInput, RefModel, RefSequential)
        port = build(PL, Input, lambda i, o: Model(i, o, device="cpu"),
                     lambda ls: Sequential(ls, device="cpu"))
        for m in (ref, port):
            m.compile(optimizer="adam", loss="mse")
        src, dst = (ref, port) if saver == "jax" else (port, ref)
        src.fit(x, y, batch_size=8, nb_epoch=1)
        src.save_weights(path)
        dst.load_weights(path)
        got = dst.predict(x, batch_size=8)
        assert dst.estimator.global_step == 3
        _close(got, src.predict(x, batch_size=8), TOL, name)


def test_save_before_build_raises():
    m = Sequential([PL.Dense(2)], device="cpu").compile(loss="mse")
    with pytest.raises(ValueError, match="not built"):
        m.save_weights("/nonexistent")
