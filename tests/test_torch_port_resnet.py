"""PyTorch port, ResNet slice: the flax-semantics BatchNorm, ``ResNet18``
at an even and an odd image size (flax's asymmetric "SAME" pads at
stride 2 and the -inf pool pad on the first, symmetric pads on the
second), a narrow bottleneck ``ResNet`` standing in for ResNet-50's
block, BatchNorm statistics under ``grad_accum_steps``, and
``ImageClassifier`` checkpoints in both directions, held against the JAX
package on the CPU.

Inputs are made from a seed with numpy; the port's weights and running
statistics are copied from the JAX package's initial variables through
``bridge``. f32 within 1e-4 (of 1 + |reference|), bf16 within 2e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from analytics_zoo_tpu.keras.layers.normalization import (
    SampledBatchNorm as RefSampledBatchNorm)
from analytics_zoo_tpu.learn import objectives as ref_objectives
from analytics_zoo_tpu.learn import optim as ref_optim
from analytics_zoo_tpu.learn.estimator import Estimator as RefEstimator
from analytics_zoo_tpu.models.common import ZooModel as RefZooModel
from analytics_zoo_tpu.models.image import resnet as ref_resnet
from analytics_zoo_tpu.models.image.classifier import (
    ImageClassifier as RefImageClassifier)
from analytics_zoo_tpu_torch.bridge import (
    flatten, from_flax_layout, load_flax_into, state_dict_from_flax,
    to_flax_layout, variables_from_module)
from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.keras.layers.normalization import (
    BatchNorm, SampledBatchNorm, batch_norm)
from analytics_zoo_tpu_torch.keras.layers.transformer import reset_parameters
from analytics_zoo_tpu_torch.learn import checkpoint as ckpt_lib
from analytics_zoo_tpu_torch.learn import objectives, optim
from analytics_zoo_tpu_torch.learn.estimator import Estimator
from analytics_zoo_tpu_torch.learn.optim import batch_stats_tree, param_tree
from analytics_zoo_tpu_torch.models import ImageClassifier, ZooModel
from analytics_zoo_tpu_torch.models.image import resnet
from analytics_zoo_tpu_torch.models.image.resnet import same_pads

torch.set_num_threads(2)

F32, BF16 = 1e-4, 2e-2
# Adam's epsilon in the Estimator runs. f32 conv gradients carry about
# 1e-6 of rounding (sums over 10^4-10^6 products, in another order in
# each framework), and Adam divides each gradient by sqrt(v) + epsilon:
# at the default 1e-8 an element whose gradient is near 0 turns that
# rounding into an update error of up to lr, at 1e-3 into at most
# lr * 1e-3 a step, while the typical element (|g| about 1e-2) still
# takes an Adam step (the learn slice's tests raise it to 1e-5 for the
# same reason)
ADAM_EPS = 1e-3
CLASSES = 10
NETS = {
    # name: (reference factory, port factory, image size)
    "resnet18_even": (functools.partial(ref_resnet.ResNet18, CLASSES),
                      functools.partial(resnet.ResNet18, CLASSES), 64),
    "resnet18_odd": (functools.partial(ref_resnet.ResNet18, CLASSES),
                     functools.partial(resnet.ResNet18, CLASSES), 33),
    "bottleneck": (
        functools.partial(ref_resnet.ResNet, (1, 1, 1, 1), CLASSES,
                          ref_resnet.BottleneckBlock, 8),
        functools.partial(resnet.ResNet, (1, 1, 1, 1), CLASSES,
                          resnet.BottleneckBlock, 8), 64),
}


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) - tol * (1.0 + np.abs(want))
    assert err.max() <= 0, f"{what}: max excess {err.max():.3g}"


def _images(n, size, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, size, size, 3).astype(np.float32),
            rng.randint(0, CLASSES, n).astype(np.int32))


def _tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


# ------------------------------------------------------------ BatchNorm --
def test_same_pads_are_flax_pads():
    for size in (7, 8, 33, 64, 112, 113):
        for k, s in ((3, 2), (1, 2), (3, 1), (1, 1), (7, 2)):
            want = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
            assert same_pads(size, k, s) == tuple(want), (size, k, s)


class _FlaxBN(fnn.Module):
    dtype: object
    stat_rows: int = 0

    @fnn.compact
    def __call__(self, x, train):
        if self.stat_rows:
            return RefSampledBatchNorm(
                use_running_average=not train, momentum=0.9, epsilon=1e-5,
                dtype=self.dtype, stat_rows=self.stat_rows, name="bn")(x)
        return fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                             epsilon=1e-5, dtype=self.dtype, name="bn")(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stat_rows", [0, 3])
def test_batch_norm_matches_flax(dtype, stat_rows):
    """Train output and both running statistics after two steps, then
    the eval output, against flax ``nn.BatchNorm`` (or the reference's
    ``SampledBatchNorm`` with ``stat_rows``); ``batch_norm`` picks the
    class from ``zoo.models.bn_stat_rows``."""
    tol = F32 if dtype == "float32" else BF16
    rng = np.random.RandomState(3)
    xs = [(rng.randn(8, 5, 5, 6) * 2 + 1).astype(np.float32)
          for _ in range(3)]
    flax_bn = _FlaxBN(jnp.dtype(dtype), stat_rows)
    variables = flax_bn.init(jax.random.PRNGKey(0), xs[0], False)
    variables = {"params": {"bn": {
        "scale": jnp.asarray(rng.rand(6) + 0.5, jnp.float32),
        "bias": jnp.asarray(rng.randn(6), jnp.float32)}},
        "batch_stats": variables["batch_stats"]}
    cfg = get_config()
    old = cfg.get("zoo.models.bn_stat_rows")
    cfg.set("zoo.models.bn_stat_rows", stat_rows)
    try:
        bn = batch_norm(getattr(torch, dtype), momentum=0.9,
                        epsilon=1e-5)(6)
    finally:
        cfg.set("zoo.models.bn_stat_rows", old)
    assert type(bn) is (SampledBatchNorm if stat_rows else BatchNorm)
    wrapper = torch.nn.Module()
    wrapper.bn = bn
    load_flax_into(wrapper, _tree(variables))
    # the input a bf16 backbone gives its norms: bf16 on both sides
    xs = [np.asarray(jnp.asarray(x, jnp.dtype(dtype)).astype(jnp.float32))
          for x in xs]
    for x in xs[:2]:
        want, new = flax_bn.apply(variables, jnp.asarray(x, dtype), True,
                                  mutable=["batch_stats"])
        variables = {"params": variables["params"], **new}
        with torch.no_grad():
            got = bn(torch.from_numpy(x).to(getattr(torch, dtype)),
                     train=True)
        assert got.dtype == getattr(torch, dtype)
        _close(got.float().numpy(), np.asarray(want, np.float32), tol,
               "train output")
        stats = _tree(variables["batch_stats"]["bn"])
        _close(bn.mean.numpy(), stats["mean"], 1e-5, "running mean")
        _close(bn.var.numpy(), stats["var"], 1e-5, "running var")
    want = flax_bn.apply(variables, jnp.asarray(xs[2], dtype), False)
    with torch.no_grad():
        got = bn(torch.from_numpy(xs[2]).to(getattr(torch, dtype)))
    _close(got.float().numpy(), np.asarray(want, np.float32), tol,
           "eval output")


def test_running_variance_is_biased_with_flax_momentum():
    bn = BatchNorm(4, momentum=0.9, epsilon=1e-5)
    x = torch.randn(3, 7, 4, generator=torch.Generator().manual_seed(0))
    bn(x, train=True)
    rows = x.reshape(-1, 4)
    torch.testing.assert_close(bn.mean, 0.1 * rows.mean(0))
    torch.testing.assert_close(
        bn.var, 0.9 + 0.1 * rows.var(0, unbiased=False))


# --------------------------------------------------------------- ResNet --
def _initial_variables(name):
    """Seeded variables for one net, drawn by the port and written as
    flax's tree, with every BatchNorm's scale, bias and running
    statistics drawn too (at their initial 1, 0, 0, 1, or a residual
    scale of 0, much of the net would see no gradient)."""
    net = NETS[name][1]()
    reset_parameters(net, 7)
    rng = np.random.RandomState(8)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.numel()
                m.weight.copy_(torch.from_numpy(rng.rand(c) + 0.5))
                m.bias.copy_(torch.from_numpy(rng.randn(c) * 0.2))
                m.mean.copy_(torch.from_numpy(rng.randn(c) * 0.2))
                m.var.copy_(torch.from_numpy(rng.rand(c) + 0.5))
    return variables_from_module(net)


def _ref_loss(module, params, stats, x, y):
    logits, new = module.apply({"params": params, "batch_stats": stats},
                               x, train=True, mutable=["batch_stats"])
    return ref_objectives.sparse_categorical_crossentropy(logits, y)


def _ref_estimator(name, variables, dtype=jnp.float32, **kwargs):
    est = RefEstimator(NETS[name][0](dtype=dtype),
                       loss="sparse_categorical_crossentropy",
                       optimizer=ref_optim.Adam(epsilon=ADAM_EPS), **kwargs)
    est.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    return est


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


# the type of the 3 Adam steps. In f32 a pre-activation within rounding
# of 0 takes the other side of a ReLU in about one element of 10^5; at
# ResNet18's widths a few do in every step, each moving its gradient
# entries by up to a tenth, so f32 trajectories part by more than 1e-4
# within 3 steps. ResNet18 takes them in f64 (the same arithmetic
# without that rounding), the narrow bottleneck net in f32.
FIT_DTYPE = {"resnet18_even": "float64", "resnet18_odd": "float64",
             "bottleneck": "float32"}
# f64: both take Adam's bias corrections in f64 (optax under x64, the
# port for f64 moments)
FIT_TOL = {"float32": F32, "float64": 1e-5}


@functools.lru_cache(maxsize=None)
def _reference_runs(name):
    """The JAX package's side for one net at ``_initial_variables``: the
    f32 eval forward, and the train forward with the statistics it
    leaves; the loss and gradients of that step in f64; then 3 Adam
    steps through its Estimator's ``fit`` (24 images, batch 8, shuffled)
    and its eval-mode ``predict``, in ``FIT_DTYPE``."""
    module, _, size = NETS[name]
    variables = _initial_variables(name)
    x, y = _images(8, size, 1)
    net = module()
    eval_logits, (logits, new) = jax.jit(lambda v, x: (
        net.apply(v, x, train=False),
        net.apply(v, x, train=True, mutable=["batch_stats"])))(variables, x)
    xf, yf = _images(24, size, 2)
    fit_dt = FIT_DTYPE[name]
    with jax.enable_x64(True):
        loss, grads = jax.jit(jax.value_and_grad(functools.partial(
            _ref_loss, module(dtype=jnp.float64))))(
                _f64(variables["params"]), _f64(variables["batch_stats"]),
                x.astype(np.float64), y)
        loss, grads = float(loss), _tree(grads)
    with jax.enable_x64(fit_dt == "float64"):
        cast = _f64 if fit_dt == "float64" else (lambda t: t)
        est = _ref_estimator(name, cast(variables), dtype=jnp.dtype(fit_dt))
        fit_data = (xf.astype(fit_dt), yf)
        hist = est.fit(fit_data, batch_size=8, epochs=1)
        fitted_logits = np.asarray(est.predict(x.astype(fit_dt),
                                               batch_size=8))
        fitted = _tree(est.variables)
    return dict(variables=variables, x=x, y=y, logits=np.asarray(logits),
                stats=_tree(new["batch_stats"]), loss64=loss, grads64=grads,
                eval_logits=np.asarray(eval_logits), fit_data=fit_data,
                fit_loss=hist[0]["loss"], fitted=fitted,
                fitted_logits=fitted_logits)


def _port_net(name, variables, dtype=torch.float32):
    net = NETS[name][1](dtype=dtype).to(
        torch.float64 if dtype == torch.float64 else torch.float32)
    load_flax_into(net, variables)
    return net


def _variables(net):
    """The port's variables under flax's flattened paths and axes, in
    the module's own type (``variables_from_module`` writes f32)."""
    out = {f"params/{k}": to_flax_layout(k, p.detach().numpy())
           for k, p in param_tree(net).items()}
    out.update({f"batch_stats/{k}": b.numpy()
                for k, b in batch_stats_tree(net).items()})
    return out


@pytest.mark.parametrize("name", sorted(NETS))
def test_forward_and_stats_match(name):
    """f32: the eval forward, the train forward and the running
    statistics it leaves."""
    ref = _reference_runs(name)
    net = _port_net(name, ref["variables"])
    x = torch.from_numpy(ref["x"])
    with torch.no_grad():
        _close(net(x).numpy(), ref["eval_logits"], F32, "eval logits")
        _close(net(x, train=True).numpy(), ref["logits"], F32,
               "train logits")
    want = flatten(ref["stats"])
    got = {k: b.numpy() for k, b in batch_stats_tree(net).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], F32, k)


@pytest.mark.parametrize("name", sorted(NETS))
def test_gradients_match(name):
    """The loss and every parameter's gradient of one train step, both
    packages in f64 (see ``FIT_DTYPE`` on f32's ReLU flips)."""
    ref = _reference_runs(name)
    net = _port_net(name, ref["variables"], torch.float64)
    x = torch.from_numpy(ref["x"]).double()
    loss = objectives.sparse_categorical_crossentropy(
        net(x, train=True), torch.from_numpy(ref["y"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss64"], rtol=1e-10)
    want = flatten(ref["grads64"])
    got = {k: to_flax_layout(k, p.grad.numpy())
           for k, p in param_tree(net).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], 1e-9, k)


@pytest.mark.parametrize("name", sorted(NETS))
def test_three_adam_steps_match(name):
    """Both Estimators take 3 Adam steps from the same variables (the
    shuffles alike): parameters, running statistics, the epoch loss and
    ``predict`` (eval mode) after them agree."""
    ref = _reference_runs(name)
    fit_dt = FIT_DTYPE[name]
    tol = FIT_TOL[fit_dt]
    net = _port_net(name, ref["variables"], getattr(torch, fit_dt))
    est = Estimator(net, loss="sparse_categorical_crossentropy",
                    optimizer=optim.Adam(epsilon=ADAM_EPS), device="cpu")
    hist = est.fit(ref["fit_data"], batch_size=8, epochs=1)
    assert est.global_step == 3
    want = flatten(ref["fitted"])
    got = _variables(net)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        _close(got[k], v, tol, k)
    _close(est.predict(ref["x"].astype(fit_dt), batch_size=8),
           ref["fitted_logits"], tol, "predict")
    np.testing.assert_allclose(hist[0]["loss"], ref["fit_loss"], rtol=tol)


@pytest.mark.parametrize("name,train", [("resnet18_even", False),
                                        ("bottleneck", False),
                                        ("bottleneck", True)])
def test_bf16_forward_matches(name, train):
    """bf16 compute, f32 parameters, bf16 logits, within 2e-2 of flax's.
    The train forward's reference is applied op by op, as the port runs:
    under ``jit`` XLA on the CPU fuses bf16 elementwise chains in f32 and
    rounds fewer intermediates, which train-mode BatchNorm amplifies.
    ResNet18's train forward is not held here: its bf16 roundings
    compound through train-mode BatchNorm over 32 rows at stage 3 to
    about 2.2e-2 of its logits."""
    ref = _reference_runs(name)
    module = NETS[name][0](dtype=jnp.bfloat16)
    if train:
        want, _ = module.apply(ref["variables"], ref["x"], train=True,
                               mutable=["batch_stats"])
    else:
        want = jax.jit(functools.partial(module.apply, train=False))(
            ref["variables"], ref["x"])
    net = _port_net(name, ref["variables"], torch.bfloat16)
    with torch.no_grad():
        got = net(torch.from_numpy(ref["x"]), train=train)
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in net.parameters())
    _close(got.float().numpy(), np.asarray(want, np.float32), BF16,
           "logits")


def test_residual_scale_starts_at_zero():
    """The last BatchNorm of each residual branch (``bn2`` of a basic
    block, ``bn3`` of a bottleneck) starts with scale 0, as the
    reference's ``scale_init=nn.initializers.zeros``; every other scale
    at 1, the running statistics at 0 and 1; the tree has the reference's
    paths and shapes."""
    for name, last in (("resnet18_odd", "bn2"), ("bottleneck", "bn3")):
        module, port_net, size = NETS[name]
        shapes = jax.eval_shape(functools.partial(module().init, train=False),
                                jax.random.PRNGKey(0),
                                jnp.zeros((1, size, size, 3)))
        net = port_net()
        reset_parameters(net, 5)
        port = variables_from_module(net)
        assert jax.tree_util.tree_map(np.shape, port) == \
            jax.tree_util.tree_map(lambda a: a.shape, shapes)
        scales = {k: v for k, v in flatten(port["params"]).items()
                  if k.endswith("/scale")}
        zero = {k for k in scales if k.endswith(f"/{last}/scale")}
        assert len(zero) == sum(NETS[name][0]().stage_sizes)
        for k, v in scales.items():
            assert (v == (0.0 if k in zero else 1.0)).all(), k
        for k, v in flatten(port["batch_stats"]).items():
            assert (v == (1.0 if k.endswith("/var") else 0.0)).all(), k


def test_grad_accum_keeps_the_last_microbatch_statistics():
    """Under ``grad_accum_steps=2`` both Estimators normalize each
    microbatch with its own statistics and keep the last microbatch's
    update from the pre-step running statistics (the reference's
    ``_accum_grads``), not two compounded updates."""
    name = "bottleneck"
    variables = _reference_runs(name)["variables"]
    x, y = _images(16, NETS[name][2], 4)
    ref_est = _ref_estimator(name, variables, grad_accum_steps=2)
    net = _port_net(name, variables)
    est = Estimator(net, loss="sparse_categorical_crossentropy",
                    optimizer=optim.Adam(epsilon=ADAM_EPS), device="cpu", grad_accum_steps=2)
    ref_est.fit((x, y), batch_size=16, epochs=1)
    est.fit((x, y), batch_size=16, epochs=1)
    want = flatten(_tree(ref_est.variables["batch_stats"]))
    got = {k: b.numpy() for k, b in batch_stats_tree(net).items()}
    for k in want:
        _close(got[k], want[k], F32, k)
    for k, v in state_dict_from_flax(_tree(ref_est.variables)).items():
        _close(net.state_dict()[k].numpy(), v.numpy(), F32, k)
    # unshuffled, by hand: the stem's statistics are one update from the
    # pre-step ones with the second microbatch's batch statistics
    net = _port_net(name, variables)
    est = Estimator(net, loss="sparse_categorical_crossentropy",
                    optimizer=optim.Adam(epsilon=ADAM_EPS), device="cpu", grad_accum_steps=2)
    with torch.no_grad():
        h = net.stem_conv(torch.from_numpy(x[8:]))
    stem = net.stem_bn
    pre_mean, pre_var = stem.mean.clone(), stem.var.clone()
    est._ensure_built()
    est._train_step(torch.from_numpy(x), torch.from_numpy(y))
    rows = h.reshape(-1, h.shape[-1])
    torch.testing.assert_close(stem.mean, 0.9 * pre_mean
                               + 0.1 * rows.mean(0))
    torch.testing.assert_close(stem.var, 0.9 * pre_var
                               + 0.1 * rows.var(0, unbiased=False))


# ------------------------------------------- ImageClassifier checkpoints --
IMG = dict(class_num=CLASSES, backbone="resnet18", image_size=32)


@pytest.fixture(scope="module")
def ref_classifier(tmp_path_factory):
    """The JAX package's ImageClassifier after one fit step, with its
    checkpoint directory."""
    ref = RefImageClassifier(**IMG)
    x, y = _images(8, 32, 5)
    # seeded weights drawn by the port (a JAX init would compile the net
    # once more)
    ref.estimator.variables = jax.tree_util.tree_map(
        jnp.asarray, variables_from_module(
            ImageClassifier(device="cpu", seed=4, **IMG).module))
    ckpt = str(tmp_path_factory.mktemp("ref_ckpt"))
    ref.fit((x, y), batch_size=8, epochs=1, checkpoint_dir=ckpt)
    return ref, ckpt


def _uint8_images(n, seed):
    return np.random.RandomState(seed).randint(
        0, 256, (n, 32, 32, 3)).astype(np.uint8)


def test_jax_saved_classifier_loads_in_the_port(tmp_path, ref_classifier):
    ref, _ = ref_classifier
    path = str(tmp_path / "jax_saved")
    ref.save_model(path)
    loaded = ZooModel.load_model(path, device="cpu")
    assert isinstance(loaded, ImageClassifier)
    assert loaded.estimator.global_step == 1
    x = _uint8_images(8, 6)
    _close(loaded.predict(x, batch_size=8),
           np.asarray(ref.predict(x, batch_size=8)), F32, "predict")
    # the running statistics came across, not the initial (0, 1)
    stats = batch_stats_tree(loaded.module)
    assert not np.allclose(stats["backbone/stem_bn/var"].numpy(), 1.0)


def test_port_saved_classifier_loads_in_jax(tmp_path):
    port = ImageClassifier(device="cpu", seed=1, **IMG)
    port.fit(_images(8, 32, 7), batch_size=8, epochs=1)
    path = str(tmp_path / "port_saved")
    port.save_model(path)
    tree = variables_from_module(port.module)
    assert set(tree) == {"params", "batch_stats"}
    assert tree["params"]["backbone"]["stem_conv"]["kernel"].shape == (
        7, 7, 3, 64)
    loaded = RefZooModel.load_model(path)
    assert loaded.estimator.global_step == 1
    # Adam's moments of a conv kernel in flax's axes
    conv = "backbone/stage1_block0/conv2/kernel"
    want_mu = port.estimator.opt_state[0]["mu"][conv].permute(2, 3, 1, 0)
    got_mu = flatten(_tree(loaded.estimator.opt_state[0].mu))[conv]
    assert got_mu.shape == (3, 3, 128, 128)
    np.testing.assert_array_equal(got_mu, want_mu.numpy())
    x = _uint8_images(8, 8)
    _close(np.asarray(loaded.predict(x, batch_size=8)),
           port.predict(x, batch_size=8), F32, "predict")


def test_resume_restores_conv_moments_in_torch_axes(tmp_path,
                                                    ref_classifier):
    """``fit(resume=True)`` from the JAX package's checkpoint restores
    the weights, the statistics and Adam's moments of every conv kernel,
    ``[kh, kw, in, out]`` there and ``[out, in, kh, kw]`` here."""
    ref, ckpt = ref_classifier
    port = ImageClassifier(device="cpu", seed=3, **IMG)
    port.fit(_images(8, 32, 5), batch_size=8, epochs=1,
             checkpoint_dir=ckpt, resume=True)
    assert (port.estimator.global_step, port.estimator.epoch) == (1, 1)
    _, opt_tree, _ = ckpt_lib.load_checkpoint(ckpt)
    want_mu = flatten(opt_tree["0"]["mu"])
    mu = port.estimator.opt_state[0]["mu"]
    conv = "backbone/stage1_block0/conv1/kernel"
    assert mu[conv].shape == (128, 64, 3, 3)
    np.testing.assert_array_equal(mu[conv].permute(2, 3, 1, 0).numpy(),
                                  want_mu[conv])
    for k, v in want_mu.items():
        np.testing.assert_array_equal(mu[k].numpy(), from_flax_layout(k, v))
    want = state_dict_from_flax(_tree(ref.estimator.variables))
    for k, v in port.module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)


def test_all_reference_backbones_build():
    """Every name of the reference's ``_BACKBONES`` builds on the CPU at 3
    classes and its smallest image size and classifies a uint8 image;
    an unknown name raises the reference's ``ValueError``."""
    from analytics_zoo_tpu.models.image.classifier import (
        _BACKBONES as REF_BACKBONES)

    smallest = {"alexnet": 64, "inception-v3": 75}
    for name in sorted(REF_BACKBONES):
        size = smallest.get(name, 32)
        model = ImageClassifier(class_num=3, backbone=name, image_size=size,
                                device="cpu")
        x = np.zeros((1, size, size, 3), np.uint8)
        assert model.predict(x, batch_size=1).shape == (1, 3), name
    with pytest.raises(ValueError, match="unknown backbone"):
        ImageClassifier(class_num=3, backbone="resnet99", device="cpu")
