"""PyTorch port, image models slice: the ten classification backbones of
``models/image/backbones.py`` and ``ImageClassifier`` over them, held
against the JAX package on the CPU.

For every backbone: the parameter and ``batch_stats`` paths and shapes
at 1000 classes against flax's ``init`` tree (``jax.eval_shape``, which
compiles nothing), and an eval-mode forward at the smallest image size
it takes (32; AlexNet 64, Inception-v3 75), Inception-v1 and
MobileNet-v2 again at 33 (flax's symmetric and asymmetric pads at
stride 2). One train step's loss, gradients, train-mode logits and the
BatchNorm statistics it leaves for Inception-v1 (branches, the SAME
max pool), MobileNet-v2 (depthwise convolutions, relu6, the residual),
SqueezeNet (biased convolutions, the f32 conv head) and a DenseNet-BC
of two layers a block (DenseNet-121's transitions), dropout 0, in f64. MobileNet-v1 in bf16; MobileNet-v2 under
``zoo.models.bn_stat_rows``. (``ImageClassifier("mobilenet-v2")``
saved by each package and loaded by the other is held in
``test_torch_port_detection.py`` beside the detectors' saves, which
keeps each file's time under 90 s on one worker.)

Weights are the port's seeded draw with every BatchNorm's scale, bias
and running statistics and every bias drawn too, carried to flax by
``bridge``; inputs come from a seed with numpy. The reference runs
under ``jax.jit``, one compiled function a model shared by its checks.
f32 within 1e-4 (1 + |ref|), bf16 within 2e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common.config import get_config as ref_get_config
from analytics_zoo_tpu.learn import objectives as ref_objectives
from analytics_zoo_tpu.models.image import backbones as ref_bb
from analytics_zoo_tpu.models.image.classifier import (
    _BACKBONES as REF_BACKBONES)
from analytics_zoo_tpu_torch.bridge import (flatten, kernel_layouts,
                                            load_flax_into,
                                            state_dict_from_flax,
                                            variables_from_module)
from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.keras.layers.normalization import (
    BatchNorm, SampledBatchNorm)
from analytics_zoo_tpu_torch.learn import objectives
from analytics_zoo_tpu_torch.learn.optim import batch_stats_tree, param_tree
from analytics_zoo_tpu_torch.models import ImageClassifier
from analytics_zoo_tpu_torch.models.image import backbones
from analytics_zoo_tpu_torch.models.image.classifier import (
    _BACKBONES as PORT_BACKBONES)

torch.set_num_threads(2)

F32, BF16 = 1e-4, 2e-2
CLASSES = 10
# name: (reference class, port class, smallest image size, whether it
# takes a dropout rate, whether its fc6 is built for the image size)
NETS = {
    "inception-v1": (ref_bb.InceptionV1, backbones.InceptionV1, 32, True,
                     False),
    "inception-v3": (ref_bb.InceptionV3, backbones.InceptionV3, 75, True,
                     False),
    "mobilenet": (ref_bb.MobileNetV1, backbones.MobileNetV1, 32, True,
                  False),
    "mobilenet-v2": (ref_bb.MobileNetV2, backbones.MobileNetV2, 32, False,
                     False),
    "vgg16": (ref_bb.VGG16, backbones.VGG16, 32, True, True),
    "vgg19": (ref_bb.VGG19, backbones.VGG19, 32, True, True),
    "alexnet": (ref_bb.AlexNet, backbones.AlexNet, 64, True, True),
    "squeezenet": (ref_bb.SqueezeNet, backbones.SqueezeNet, 32, True,
                   False),
    "densenet121": (ref_bb.DenseNet, backbones.DenseNet, 32, False, False),
    "densenet161": (ref_bb.densenet161, backbones.densenet161, 32, False,
                    False),
}
# DenseNet-121's train step takes about 40 s to trace and compile on the
# CPU (58 dense layers); its blocks, transitions (C // 2, the 2 x 2
# average pool) and final norm are held on a DenseNet-BC of the same
# class, growth and stem with two layers a block
SPECS = {**NETS, "densenet-bc": (
    functools.partial(ref_bb.DenseNet, stage_sizes=(2, 2, 2, 2)),
    functools.partial(backbones.DenseNet, stage_sizes=(2, 2, 2, 2)), 32,
    False, False)}
# the backbones whose train step is held here
STEP_NETS = ("inception-v1", "mobilenet-v2", "squeezenet", "densenet-bc")
FORWARD_CASES = [(name, NETS[name][2]) for name in sorted(NETS)] + [
    ("inception-v1", 33), ("mobilenet-v2", 33)]
FORWARD_ROWS, STEP_ROWS = 2, 4


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    excess = np.abs(got - want) - tol * (1.0 + np.abs(want))
    assert excess.max() <= 0, f"{what}: max excess {excess.max():.3g}"


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_net(name, classes=CLASSES, **kwargs):
    ref_cls, _, _, drops, _ = SPECS[name]
    if drops:
        kwargs.setdefault("dropout_rate", 0.0)
    return ref_cls(num_classes=classes, **kwargs)


def _port_net(name, size, classes=CLASSES, **kwargs):
    _, port_cls, _, drops, sized = SPECS[name]
    if drops:
        kwargs.setdefault("dropout_rate", 0.0)
    if sized:
        kwargs["image_size"] = size
    return port_cls(num_classes=classes, **kwargs)


def _draw(net, seed):
    """Seeded weights for ``net``: kernels normal at 1 / sqrt(fan_in)
    (a quicker draw than the layers' truncated one: the values only
    need to be spread), every bias, BatchNorm scale and running
    statistic drawn too."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.numel()
                m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.2)
                m.mean.copy_(torch.randn(c, generator=gen) * 0.2)
                m.var.copy_(torch.rand(c, generator=gen) + 0.5)
                continue
            for name, p in m.named_parameters(recurse=False):
                scale = (p[0].numel() ** -0.5 if name == "weight" else 0.2)
                p.copy_(torch.randn(p.shape, generator=gen) * scale)
    return net


def _images(n, size, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, size, size, 3).astype(np.float32),
            rng.randint(0, CLASSES, n).astype(np.int32))


def _ref_loss(module, variables, x, y):
    def loss(params):
        logits, new = module.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            train=True, mutable=["batch_stats"])
        return (ref_objectives.sparse_categorical_crossentropy(logits, y),
                (logits, new["batch_stats"]))
    return loss


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@functools.lru_cache(maxsize=None)
def _reference(name, size):
    """The port's seeded net at ``size`` (f32) and the JAX package's
    eval-mode logits at its weights on ``FORWARD_ROWS`` images, from one
    jitted function. For ``STEP_NETS`` at their smallest size the same
    function also takes one train step on ``STEP_ROWS`` images, all of
    it in f64 (the port's f32 forward is held against the f64 logits):
    in f32 a train-mode BatchNorm over 4 rows at a 1 x 1 map turns
    rounding into 1e-4 of the logits, and a pre-activation within
    rounding of 0 flips its ReLU."""
    net = _draw(_port_net(name, size), seed=len(name))
    variables = variables_from_module(net)
    x, _ = _images(FORWARD_ROWS, size, 1)
    out = {"net": net, "x": x, "variables": variables}
    if name not in STEP_NETS or size != SPECS[name][2]:
        module = _ref_net(name)
        out["eval"] = np.asarray(jax.jit(functools.partial(
            module.apply, train=False))(variables, x))
        return out
    xs, ys = _images(STEP_ROWS, size, 2)
    with jax.enable_x64(True):
        module = _ref_net(name, dtype=jnp.float64)

        def run(v, x, xs, ys):
            (loss, (logits, stats)), grads = jax.value_and_grad(
                _ref_loss(module, v, xs, ys), has_aux=True)(v["params"])
            return (module.apply(v, x, train=False), loss, logits, stats,
                    grads)

        ev, loss, logits, stats, grads = _host(jax.jit(run)(
            _f64(variables), x.astype(np.float64), xs.astype(np.float64),
            ys))
    out.update(eval=ev, xs=xs, ys=ys, loss=float(loss), logits=logits,
               stats=stats, grads=grads)
    return out


def _flax_shape(path, shape, layouts):
    """A port parameter's shape in flax's axes."""
    if path.endswith("kernel"):
        if layouts.get(path) == "conv" or len(shape) == 4:
            return tuple(shape[2:]) + (shape[1], shape[0])
        return (shape[-1],) + tuple(shape[:-1])
    return tuple(shape)


# ----------------------------------------------------------- the trees --
@pytest.mark.parametrize("name", sorted(NETS))
def test_tree_matches_flax(name):
    """At 1000 classes: every parameter and running statistic under
    flax's path with flax's shape, and nothing else (the module built
    on the meta device, flax's tree traced by ``jax.eval_shape``)."""
    size = NETS[name][2]
    want = jax.eval_shape(
        functools.partial(_ref_net(name, 1000).init, train=False),
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    want = {f"{c}/{k}": tuple(v.shape) for c in want
            for k, v in flatten(want[c]).items()}
    with torch.device("meta"):
        net = _port_net(name, size, 1000)
    layouts = kernel_layouts(net)
    got = {f"params/{k}": _flax_shape(k, tuple(p.shape), layouts)
           for k, p in param_tree(net).items()}
    got.update({f"batch_stats/{k}": tuple(b.shape)
                for k, b in batch_stats_tree(net).items()})
    assert sorted(got) == sorted(want)
    assert got == want


# ------------------------------------------------------------ forwards --
@pytest.mark.parametrize("name,size", FORWARD_CASES)
def test_eval_forward_matches(name, size):
    """f32, eval mode: the logits of ``FORWARD_ROWS`` seeded images."""
    ref = _reference(name, size)
    with torch.no_grad():
        got = ref["net"](torch.from_numpy(ref["x"]))
    assert got.dtype == torch.float32
    _close(got.numpy(), ref["eval"], F32, f"{name}@{size}")


@pytest.mark.parametrize("name", STEP_NETS)
def test_train_step_matches(name):
    """Dropout 0, both packages in f64: one train step's loss, every
    gradient, the train-mode logits and the running statistics the step
    leaves."""
    ref = _reference(name, SPECS[name][2])
    net = _port_net(name, SPECS[name][2], dtype=torch.float64).double()
    load_flax_into(net, ref["variables"])
    logits = net(torch.from_numpy(ref["xs"]).double(), train=True)
    loss = objectives.sparse_categorical_crossentropy(
        logits, torch.from_numpy(ref["ys"]))
    loss.backward()
    _close(logits.detach().numpy(), ref["logits"], F32, "train logits")
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=F32)
    want = state_dict_from_flax(ref["grads"], kernel_layouts(net))
    got = {k: p.grad for k, p in net.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        _close(got[k].numpy(), g.numpy(), F32, f"grad {k}")
    want = flatten(ref["stats"])
    got = {k: b.numpy() for k, b in batch_stats_tree(net).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], F32, f"stats {k}")


def test_bf16_forward_matches():
    """MobileNet-v1 in bf16 (the depthwise convolutions, the norms and
    the pooled features in bf16, the head in f32): f32 parameters and
    logits within 2e-2 of flax's."""
    ref = _reference("mobilenet", 32)
    net = _port_net("mobilenet", 32, dtype=torch.bfloat16)
    load_flax_into(net, ref["variables"])
    assert all(p.dtype == torch.float32 for p in net.parameters())
    want = jax.jit(functools.partial(
        _ref_net("mobilenet", dtype=jnp.bfloat16).apply, train=False))(
            ref["variables"], ref["x"])
    with torch.no_grad():
        got = net(torch.from_numpy(ref["x"]))
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want, np.float32), BF16, "bf16 logits")


def test_sampled_batch_norm_matches():
    """Under ``zoo.models.bn_stat_rows`` = 4 both packages build
    ``SampledBatchNorm`` (statistics from the first 4 of 8 rows, in f32
    in both): MobileNet-v2's train-mode logits at 64 x 64 and the
    statistics it leaves, the rest of the net in f64 (in f32 the
    rounding of 52 train-mode norms adds up to 1e-4 of the logits)."""
    ref = _reference("mobilenet-v2", 32)
    xs = _images(8, 64, 3)[0].astype(np.float64)
    cfgs = (get_config(), ref_get_config())
    old = [c.get("zoo.models.bn_stat_rows") for c in cfgs]
    try:
        for c in cfgs:
            c.set("zoo.models.bn_stat_rows", 4)
        net = _port_net("mobilenet-v2", 64, dtype=torch.float64).double()
        with jax.enable_x64(True):
            want, new = _host(jax.jit(functools.partial(
                _ref_net("mobilenet-v2", dtype=jnp.float64).apply,
                train=True, mutable=["batch_stats"]))(
                    _f64(ref["variables"]), xs))
    finally:
        for c, v in zip(cfgs, old):
            c.set("zoo.models.bn_stat_rows", v)
    assert isinstance(net.stem_bn, SampledBatchNorm)
    load_flax_into(net, ref["variables"])
    with torch.no_grad():
        got = net(torch.from_numpy(xs), train=True)
    _close(got.numpy(), want, F32, "train logits")
    want = flatten(new["batch_stats"])
    for k, b in batch_stats_tree(net).items():
        _close(b.numpy(), want[k], F32, f"stats {k}")


def test_unknown_backbone_raises_and_every_name_is_known():
    assert sorted(REF_BACKBONES) == sorted(PORT_BACKBONES)
    with pytest.raises(ValueError, match="unknown backbone"):
        ImageClassifier(class_num=3, backbone="resnet99", device="cpu")
