"""Classic CNN backbones: Inception v1/v3, MobileNet v1/v2, VGG-16/19,
AlexNet, SqueezeNet and DenseNet-121/161.

The counterpart of ``analytics_zoo_tpu/models/image/backbones.py``, with
its class and module names (``stem_conv1``, ``mixed3a/b3r_bn``,
``block4/dw_conv``, ``fire2/expand3``, ``dense1/l0_conv1``,
``mixedC0/b7_2/conv``, ``head``, ...), so ``bridge.py`` maps each flax
tree onto them with no rename table. Each is an ``nn.Module`` whose
``forward(x, train=False, rng=None)`` takes NHWC images and returns
``[N, num_classes]`` logits; ``rng`` (a ``torch.Generator``) draws the
dropout masks in training, as the Estimator passes its own.

Built from the port's layers, as ``resnet.py``: ``Conv`` (cuDNN on
``channels_last`` views; ``groups`` for the depthwise convolutions),
``pool`` (flax's pads: -inf for max, zeros counted by the average),
``batch_norm`` (epsilon 1e-3, momentum 0.9, or ``SampledBatchNorm``
under ``zoo.models.bn_stat_rows``, read when the model is built),
``Dense`` and ``dropout``. Under ``dtype=torch.bfloat16`` the
convolutions, the norms and VGG's and AlexNet's ``fc6``/``fc7`` compute
in bf16; every ``head``, and SqueezeNet's biased ``head_conv``, in f32
on an input cast to f32.

torch needs at construction every shape flax infers at the first call:
each convolution's input channels (the concatenations of Inception's
branches, DenseNet's growing stack and its transitions' ``C // 2``),
and the input width of ``fc6``, which depends on the image size. So
``VGG16``, ``VGG19`` and ``AlexNet`` take an ``image_size`` (default
224; ``ImageClassifier`` passes its own): the one signature difference
from the reference. Their flatten into ``fc6`` is in ``(h, w, c)``
order, as the reference's NHWC reshape.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.layers.convolutional import Conv
from analytics_zoo_tpu_torch.keras.layers.normalization import batch_norm
from analytics_zoo_tpu_torch.keras.layers.pooling import pool
from analytics_zoo_tpu_torch.keras.layers.transformer import (
    Dense, dropout)

Dtype = Optional[torch.dtype]


def _norm(dtype: Dtype):
    """The backbones' BatchNorm constructor (the reference's ``_norm``):
    exact, or sampled statistics under ``zoo.models.bn_stat_rows``."""
    return batch_norm(dtype, momentum=0.9, epsilon=1e-3)


def _conv(cin: int, cout: int, kernel, strides=(1, 1), padding="SAME",
          dtype: Dtype = torch.float32, use_bias: bool = False,
          groups: int = 1) -> Conv:
    return Conv(cin, cout, kernel, strides, padding=padding,
                use_bias=use_bias, groups=groups, dtype=dtype)


def _head(x: torch.Tensor, head: Dense) -> torch.Tensor:
    """The f32 classifier over globally averaged features."""
    return head(x.float())


def _drop(x: torch.Tensor, rate: float, train: bool,
          rng: Optional[torch.Generator]) -> torch.Tensor:
    return dropout(x, rate, rng) if train else x


def _max_pool(x, window=(3, 3), strides=(2, 2), padding="VALID"):
    return pool(x, "max", window, strides, padding)


class InceptionBlock(nn.Module):
    """One GoogLeNet mixed block: 1x1 | 1x1-3x3 | 1x1-5x5 | pool-1x1
    branches concatenated on channels."""

    def __init__(self, in_features: int, b1: int, b3_reduce: int, b3: int,
                 b5_reduce: int, b5: int, pool_proj: int,
                 dtype: Dtype = torch.float32):
        super().__init__()
        norm = _norm(dtype)
        for name, cin, cout, k in (
                ("b1", in_features, b1, 1), ("b3r", in_features, b3_reduce, 1),
                ("b3", b3_reduce, b3, 3), ("b5r", in_features, b5_reduce, 1),
                ("b5", b5_reduce, b5, 5), ("bp", in_features, pool_proj, 1)):
            self.add_module(f"{name}_conv", _conv(cin, cout, (k, k),
                                                  dtype=dtype))
            self.add_module(f"{name}_bn", norm(cout))
        self.out_features = b1 + b3 + b5 + pool_proj

    def _unit(self, h, name, train):
        h = getattr(self, f"{name}_conv")(h)
        return F.relu(getattr(self, f"{name}_bn")(h, train))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        br1 = self._unit(x, "b1", train)
        br3 = self._unit(self._unit(x, "b3r", train), "b3", train)
        br5 = self._unit(self._unit(x, "b5r", train), "b5", train)
        brp = self._unit(_max_pool(x, strides=(1, 1), padding="SAME"), "bp",
                         train)
        return torch.cat([br1, br3, br5, brp], dim=-1)


# GoogLeNet table: (b1, b3_reduce, b3, b5_reduce, b5, pool_proj)
_INCEPTION_CFG = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}
# the stages of mixed blocks, a stride-2 max pool before each
_INCEPTION_STAGES = (("3a", "3b"), ("4a", "4b", "4c", "4d", "4e"),
                     ("5a", "5b"))


class InceptionV1(nn.Module):
    """GoogLeNet with batch-norm, without the auxiliary heads."""

    def __init__(self, num_classes: int = 1000, dropout_rate: float = 0.4,
                 dtype: Dtype = torch.float32):
        super().__init__()
        norm = _norm(dtype)
        self.dropout_rate = dropout_rate
        self.stem_conv1 = _conv(3, 64, (7, 7), (2, 2), dtype=dtype)
        self.stem_bn1 = norm(64)
        self.stem_conv2 = _conv(64, 64, (1, 1), dtype=dtype)
        self.stem_bn2 = norm(64)
        self.stem_conv3 = _conv(64, 192, (3, 3), dtype=dtype)
        self.stem_bn3 = norm(192)
        c = 192
        for stage in _INCEPTION_STAGES:
            for key in stage:
                block = InceptionBlock(c, *_INCEPTION_CFG[key], dtype=dtype)
                self.add_module(f"mixed{key}", block)
                c = block.out_features
        self.head = Dense(c, num_classes, dtype=torch.float32)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.relu(self.stem_bn1(self.stem_conv1(x), train))
        x = _max_pool(x, padding="SAME")
        x = F.relu(self.stem_bn2(self.stem_conv2(x), train))
        x = F.relu(self.stem_bn3(self.stem_conv3(x), train))
        for stage in _INCEPTION_STAGES:
            x = _max_pool(x, padding="SAME")
            for key in stage:
                x = getattr(self, f"mixed{key}")(x, train)
        x = _drop(x.mean(dim=(1, 2)), self.dropout_rate, train, rng)
        return _head(x, self.head)


class _SeparableBlock(nn.Module):
    """Depthwise 3x3 + pointwise 1x1, each BN-relu (MobileNet v1 unit)."""

    def __init__(self, in_features: int, filters: int,
                 strides: Tuple[int, int] = (1, 1),
                 dtype: Dtype = torch.float32):
        super().__init__()
        norm = _norm(dtype)
        self.dw_conv = _conv(in_features, in_features, (3, 3), strides,
                             dtype=dtype, groups=in_features)
        self.dw_bn = norm(in_features)
        self.pw_conv = _conv(in_features, filters, (1, 1), dtype=dtype)
        self.pw_bn = norm(filters)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.relu(self.dw_bn(self.dw_conv(x), train))
        return F.relu(self.pw_bn(self.pw_conv(x), train))


def _width(f: int, width: float) -> int:
    return max(8, int(f * width))


class MobileNetV1(nn.Module):
    """MobileNet v1 with a width multiplier."""

    _PLAN = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
             (512, 2)] + [(512, 1)] * 5 + [(1024, 2), (1024, 1)]

    def __init__(self, num_classes: int = 1000, width: float = 1.0,
                 dropout_rate: float = 0.001, dtype: Dtype = torch.float32):
        super().__init__()
        norm = _norm(dtype)
        self.dropout_rate = dropout_rate
        c = _width(32, width)
        self.stem_conv = _conv(3, c, (3, 3), (2, 2), dtype=dtype)
        self.stem_bn = norm(c)
        self.n_blocks = len(self._PLAN)
        for i, (filters, stride) in enumerate(self._PLAN):
            f = _width(filters, width)
            self.add_module(f"block{i + 1}", _SeparableBlock(
                c, f, (stride, stride), dtype=dtype))
            c = f
        self.head = Dense(c, num_classes, dtype=torch.float32)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem_conv(x), train))
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i + 1}")(x, train)
        x = _drop(x.mean(dim=(1, 2)), self.dropout_rate, train, rng)
        return _head(x, self.head)


class VGG16(nn.Module):
    """VGG-16 (configuration D) with batch-norm; fc6/fc7 at 4096.
    ``image_size`` sets ``fc6``'s input width (the feature map left
    after five 2x2 pools, flattened in (h, w, c) order)."""

    _PLAN = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

    def __init__(self, num_classes: int = 1000, dropout_rate: float = 0.5,
                 dtype: Dtype = torch.float32, image_size: int = 224):
        super().__init__()
        norm = _norm(dtype)
        self.dropout_rate = dropout_rate
        self.names = []
        c, s = 3, image_size
        for st, (filters, reps) in enumerate(self._PLAN):
            for r in range(reps):
                name = f"{st + 1}_{r + 1}"
                self.add_module(f"conv{name}",
                                _conv(c, filters, (3, 3), dtype=dtype))
                self.add_module(f"bn{name}", norm(filters))
                self.names.append(name)
                c = filters
            self.names.append(None)  # the stage's 2x2 max pool
            s //= 2
        self.fc6 = Dense(s * s * c, 4096, dtype=dtype)
        self.fc7 = Dense(4096, 4096, dtype=dtype)
        self.head = Dense(4096, num_classes, dtype=torch.float32)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        for name in self.names:
            if name is None:
                x = _max_pool(x, (2, 2), (2, 2))
                continue
            x = getattr(self, f"conv{name}")(x)
            x = F.relu(getattr(self, f"bn{name}")(x, train))
        return _fc_head(self, x, train, rng)


def _fc_head(net, x, train, rng):
    """VGG's and AlexNet's classifier: the NHWC map flattened in (h, w,
    c) order, fc6 and fc7 (relu, dropout) in the net's dtype, the head
    in f32."""
    x = x.reshape(x.shape[0], -1)
    for fc in (net.fc6, net.fc7):
        x = _drop(F.relu(fc(x)), net.dropout_rate, train, rng)
    return _head(x, net.head)


class VGG19(VGG16):
    """VGG-19 (configuration E): the last three stages at four convs."""

    _PLAN = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]


def _valid(size: int, k: int, s: int) -> int:
    return (size - k) // s + 1


class AlexNet(nn.Module):
    """AlexNet with batch-norm in place of LRN. ``image_size`` sets
    ``fc6``'s input width."""

    def __init__(self, num_classes: int = 1000, dropout_rate: float = 0.5,
                 dtype: Dtype = torch.float32, image_size: int = 224):
        super().__init__()
        norm = _norm(dtype)
        self.dropout_rate = dropout_rate
        for i, (cin, cout, k, st) in enumerate(
                ((3, 96, 11, 4), (96, 256, 5, 1), (256, 384, 3, 1),
                 (384, 384, 3, 1), (384, 256, 3, 1))):
            self.add_module(f"conv{i + 1}", _conv(cin, cout, (k, k),
                                                  (st, st), dtype=dtype))
            self.add_module(f"bn{i + 1}", norm(cout))
        s = -(-image_size // 4)
        for _ in range(3):
            s = _valid(s, 3, 2)
        self.fc6 = Dense(s * s * 256, 4096, dtype=dtype)
        self.fc7 = Dense(4096, 4096, dtype=dtype)
        self.head = Dense(4096, num_classes, dtype=torch.float32)

    def _unit(self, x, i, train):
        return F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x),
                                               train))

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _max_pool(self._unit(x, 1, train))
        x = _max_pool(self._unit(x, 2, train))
        for i in (3, 4, 5):
            x = self._unit(x, i, train)
        return _fc_head(self, _max_pool(x), train, rng)


class _FireModule(nn.Module):
    """SqueezeNet fire module: 1x1 squeeze, then parallel 1x1 + 3x3
    expands (with biases) concatenated on channels."""

    def __init__(self, in_features: int, squeeze: int, expand: int,
                 dtype: Dtype = torch.float32):
        super().__init__()
        self.squeeze = _conv(in_features, squeeze, (1, 1), dtype=dtype)
        self.squeeze_bn = _norm(dtype)(squeeze)
        self.expand1 = _conv(squeeze, expand, (1, 1), dtype=dtype,
                             use_bias=True)
        self.expand3 = _conv(squeeze, expand, (3, 3), dtype=dtype,
                             use_bias=True)
        self.out_features = 2 * expand

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        s = F.relu(self.squeeze_bn(self.squeeze(x), train))
        return torch.cat([F.relu(self.expand1(s)), F.relu(self.expand3(s))],
                         dim=-1)


class SqueezeNet(nn.Module):
    """SqueezeNet v1.1: fire modules, a max pool after fire3 and fire5,
    and a biased f32 conv classifier over global average pooling; the
    dropout is elementwise on the 4-D map before it."""

    _FIRES = ((2, 16, 64), (3, 16, 64), None, (4, 32, 128), (5, 32, 128),
              None, (6, 48, 192), (7, 48, 192), (8, 64, 256), (9, 64, 256))

    def __init__(self, num_classes: int = 1000, dropout_rate: float = 0.5,
                 dtype: Dtype = torch.float32):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.stem = _conv(3, 64, (3, 3), (2, 2), dtype=dtype)
        self.stem_bn = _norm(dtype)(64)
        c = 64
        for spec in self._FIRES:
            if spec is not None:
                fire = _FireModule(c, *spec[1:], dtype=dtype)
                self.add_module(f"fire{spec[0]}", fire)
                c = fire.out_features
        self.head_conv = _conv(c, num_classes, (1, 1), dtype=torch.float32,
                               use_bias=True)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _max_pool(F.relu(self.stem_bn(self.stem(x), train)))
        for spec in self._FIRES:
            x = (_max_pool(x) if spec is None
                 else getattr(self, f"fire{spec[0]}")(x, train))
        x = _drop(x, self.dropout_rate, train, rng)
        x = self.head_conv(x.float())
        return F.relu(x).mean(dim=(1, 2))


class _DenseBlock(nn.Module):
    """DenseNet block: each layer concatenates its ``growth`` new maps
    (bottleneck 1x1 -> 3x3) onto the running stack."""

    def __init__(self, in_features: int, layers: int, growth: int,
                 dtype: Dtype = torch.float32):
        super().__init__()
        norm = _norm(dtype)
        self.layers = layers
        c = in_features
        for i in range(layers):
            self.add_module(f"l{i}_bn1", norm(c))
            self.add_module(f"l{i}_conv1", _conv(c, 4 * growth, (1, 1),
                                                 dtype=dtype))
            self.add_module(f"l{i}_bn2", norm(4 * growth))
            self.add_module(f"l{i}_conv2", _conv(4 * growth, growth, (3, 3),
                                                 dtype=dtype))
            c += growth
        self.out_features = c

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.layers):
            h = F.relu(getattr(self, f"l{i}_bn1")(x, train))
            h = getattr(self, f"l{i}_conv1")(h)
            h = F.relu(getattr(self, f"l{i}_bn2")(h, train))
            h = getattr(self, f"l{i}_conv2")(h)
            x = torch.cat([x, h], dim=-1)
        return x


class DenseNet(nn.Module):
    """DenseNet-BC; the default configuration is DenseNet-121,
    ``densenet161()`` the reference's 161 variant. A transition halves
    the channels (``C // 2``) and the size (a 2x2 average pool, floor)."""

    def __init__(self, num_classes: int = 1000,
                 stage_sizes: Sequence[int] = (6, 12, 24, 16),
                 growth: int = 32, stem_features: int = 64,
                 dtype: Dtype = torch.float32):
        super().__init__()
        norm = _norm(dtype)
        self.n_stages = len(stage_sizes)
        self.stem_conv = _conv(3, stem_features, (7, 7), (2, 2), dtype=dtype)
        self.stem_bn = norm(stem_features)
        c = stem_features
        for s, layers in enumerate(stage_sizes):
            block = _DenseBlock(c, layers, growth, dtype=dtype)
            self.add_module(f"dense{s + 1}", block)
            c = block.out_features
            if s < self.n_stages - 1:
                self.add_module(f"trans{s + 1}_bn", norm(c))
                self.add_module(f"trans{s + 1}_conv",
                                _conv(c, c // 2, (1, 1), dtype=dtype))
                c //= 2
        self.final_bn = norm(c)
        self.head = Dense(c, num_classes, dtype=torch.float32)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem_conv(x), train))
        x = _max_pool(x, padding="SAME")
        for s in range(self.n_stages):
            x = getattr(self, f"dense{s + 1}")(x, train)
            if s < self.n_stages - 1:
                x = F.relu(getattr(self, f"trans{s + 1}_bn")(x, train))
                x = getattr(self, f"trans{s + 1}_conv")(x)
                x = pool(x, "avg", (2, 2), (2, 2), "VALID")
        x = F.relu(self.final_bn(x, train))
        return _head(x.mean(dim=(1, 2)), self.head)


def densenet161(num_classes: int = 1000,
                dtype: Dtype = torch.float32) -> DenseNet:
    """The reference's DenseNet-161 (growth 48, deeper stages)."""
    return DenseNet(num_classes=num_classes, stage_sizes=(6, 12, 36, 24),
                    growth=48, stem_features=96, dtype=dtype)


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0, 6)


class _InvertedResidual(nn.Module):
    """MobileNet v2 block: 1x1 expand -> depthwise 3x3 -> 1x1 project,
    residual at stride 1 when the widths match; relu6."""

    def __init__(self, in_features: int, filters: int,
                 strides: Tuple[int, int] = (1, 1), expand_ratio: int = 6,
                 dtype: Dtype = torch.float32):
        super().__init__()
        norm = _norm(dtype)
        c = in_features
        self.expands = expand_ratio != 1
        if self.expands:
            c = in_features * expand_ratio
            self.expand = _conv(in_features, c, (1, 1), dtype=dtype)
            self.expand_bn = norm(c)
        self.dw = _conv(c, c, (3, 3), strides, dtype=dtype, groups=c)
        self.dw_bn = norm(c)
        self.project = _conv(c, filters, (1, 1), dtype=dtype)
        self.project_bn = norm(filters)
        self.residual = tuple(strides) == (1, 1) and in_features == filters

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = x
        if self.expands:
            h = _relu6(self.expand_bn(self.expand(h), train))
        h = _relu6(self.dw_bn(self.dw(h), train))
        h = self.project_bn(self.project(h), train)
        return x + h if self.residual else h


class MobileNetV2(nn.Module):
    """MobileNet v2 (no dropout)."""

    # (expand_ratio, filters, repeats, first_stride)
    _PLAN = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
             (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

    def __init__(self, num_classes: int = 1000, width: float = 1.0,
                 dtype: Dtype = torch.float32):
        super().__init__()
        norm = _norm(dtype)
        c = _width(32, width)
        self.stem = _conv(3, c, (3, 3), (2, 2), dtype=dtype)
        self.stem_bn = norm(c)
        idx = 0
        for t, f, reps, s0 in self._PLAN:
            for r in range(reps):
                s = s0 if r == 0 else 1
                self.add_module(f"block{idx}", _InvertedResidual(
                    c, _width(f, width), (s, s), expand_ratio=t,
                    dtype=dtype))
                c = _width(f, width)
                idx += 1
        self.n_blocks = idx
        out = max(1280, _width(1280, width))
        self.head_conv = _conv(c, out, (1, 1), dtype=dtype)
        self.head_bn = norm(out)
        self.head = Dense(out, num_classes, dtype=torch.float32)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _relu6(self.stem_bn(self.stem(x), train))
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x, train)
        x = _relu6(self.head_bn(self.head_conv(x), train))
        return _head(x.mean(dim=(1, 2)), self.head)


class _ConvBN(nn.Module):
    """Conv (no bias), BatchNorm, relu: Inception v3's unit."""

    def __init__(self, in_features: int, filters: int, kernel,
                 strides=(1, 1), padding: str = "SAME",
                 dtype: Dtype = torch.float32):
        super().__init__()
        self.conv = _conv(in_features, filters, kernel, strides, padding,
                          dtype=dtype)
        self.bn = _norm(dtype)(filters)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x), train))


_S2 = ((2, 2), "VALID")


def _avg_pool(x):
    return pool(x, "avg", (3, 3), (1, 1), "SAME")


def _cat(*xs):
    return torch.cat(xs, dim=-1)


class _MixedA(nn.Module):
    """Inception-v3 35x35 block: 1x1 | 5x5 | double-3x3 | pool-proj."""

    def __init__(self, in_features: int, pool_features: int,
                 dtype: Dtype = torch.float32):
        super().__init__()
        c = in_features
        self.b1 = _ConvBN(c, 64, (1, 1), dtype=dtype)
        self.b5_1 = _ConvBN(c, 48, (1, 1), dtype=dtype)
        self.b5_2 = _ConvBN(48, 64, (5, 5), dtype=dtype)
        self.b3_1 = _ConvBN(c, 64, (1, 1), dtype=dtype)
        self.b3_2 = _ConvBN(64, 96, (3, 3), dtype=dtype)
        self.b3_3 = _ConvBN(96, 96, (3, 3), dtype=dtype)
        self.bp = _ConvBN(c, pool_features, (1, 1), dtype=dtype)
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b1 = self.b1(x, train)
        b5 = self.b5_2(self.b5_1(x, train), train)
        b3 = self.b3_3(self.b3_2(self.b3_1(x, train), train), train)
        bp = self.bp(_avg_pool(x), train)
        return _cat(b1, b5, b3, bp)


class _MixedB(nn.Module):
    """Inception-v3 35->17 reduction."""

    def __init__(self, in_features: int, dtype: Dtype = torch.float32):
        super().__init__()
        c = in_features
        self.b3 = _ConvBN(c, 384, (3, 3), *_S2, dtype=dtype)
        self.bd_1 = _ConvBN(c, 64, (1, 1), dtype=dtype)
        self.bd_2 = _ConvBN(64, 96, (3, 3), dtype=dtype)
        self.bd_3 = _ConvBN(96, 96, (3, 3), *_S2, dtype=dtype)
        self.out_features = 384 + 96 + c

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b3 = self.b3(x, train)
        bd = self.bd_3(self.bd_2(self.bd_1(x, train), train), train)
        return _cat(b3, bd, _max_pool(x))


class _MixedC(nn.Module):
    """Inception-v3 17x17 block with factorized 7x1/1x7 convs."""

    def __init__(self, in_features: int, c7: int,
                 dtype: Dtype = torch.float32):
        super().__init__()
        c = in_features
        self.b1 = _ConvBN(c, 192, (1, 1), dtype=dtype)
        self.b7_1 = _ConvBN(c, c7, (1, 1), dtype=dtype)
        self.b7_2 = _ConvBN(c7, c7, (1, 7), dtype=dtype)
        self.b7_3 = _ConvBN(c7, 192, (7, 1), dtype=dtype)
        self.bd_1 = _ConvBN(c, c7, (1, 1), dtype=dtype)
        self.bd_2 = _ConvBN(c7, c7, (7, 1), dtype=dtype)
        self.bd_3 = _ConvBN(c7, c7, (1, 7), dtype=dtype)
        self.bd_4 = _ConvBN(c7, c7, (7, 1), dtype=dtype)
        self.bd_5 = _ConvBN(c7, 192, (1, 7), dtype=dtype)
        self.bp = _ConvBN(c, 192, (1, 1), dtype=dtype)
        self.out_features = 4 * 192

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b1 = self.b1(x, train)
        b7 = self.b7_3(self.b7_2(self.b7_1(x, train), train), train)
        bd = x
        for unit in (self.bd_1, self.bd_2, self.bd_3, self.bd_4, self.bd_5):
            bd = unit(bd, train)
        bp = self.bp(_avg_pool(x), train)
        return _cat(b1, b7, bd, bp)


class _MixedD(nn.Module):
    """Inception-v3 17->8 reduction."""

    def __init__(self, in_features: int, dtype: Dtype = torch.float32):
        super().__init__()
        c = in_features
        self.b3_1 = _ConvBN(c, 192, (1, 1), dtype=dtype)
        self.b3_2 = _ConvBN(192, 320, (3, 3), *_S2, dtype=dtype)
        self.b7_1 = _ConvBN(c, 192, (1, 1), dtype=dtype)
        self.b7_2 = _ConvBN(192, 192, (1, 7), dtype=dtype)
        self.b7_3 = _ConvBN(192, 192, (7, 1), dtype=dtype)
        self.b7_4 = _ConvBN(192, 192, (3, 3), *_S2, dtype=dtype)
        self.out_features = 320 + 192 + c

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b3 = self.b3_2(self.b3_1(x, train), train)
        b7 = x
        for unit in (self.b7_1, self.b7_2, self.b7_3, self.b7_4):
            b7 = unit(b7, train)
        return _cat(b3, b7, _max_pool(x))


class _MixedE(nn.Module):
    """Inception-v3 8x8 block with split 1x3/3x1 branches."""

    def __init__(self, in_features: int, dtype: Dtype = torch.float32):
        super().__init__()
        c = in_features
        self.b1 = _ConvBN(c, 320, (1, 1), dtype=dtype)
        self.b3_1 = _ConvBN(c, 384, (1, 1), dtype=dtype)
        self.b3_a = _ConvBN(384, 384, (1, 3), dtype=dtype)
        self.b3_b = _ConvBN(384, 384, (3, 1), dtype=dtype)
        self.bd_1 = _ConvBN(c, 448, (1, 1), dtype=dtype)
        self.bd_2 = _ConvBN(448, 384, (3, 3), dtype=dtype)
        self.bd_a = _ConvBN(384, 384, (1, 3), dtype=dtype)
        self.bd_b = _ConvBN(384, 384, (3, 1), dtype=dtype)
        self.bp = _ConvBN(c, 192, (1, 1), dtype=dtype)
        self.out_features = 320 + 4 * 384 + 192

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b1 = self.b1(x, train)
        b3 = self.b3_1(x, train)
        b3 = _cat(self.b3_a(b3, train), self.b3_b(b3, train))
        bd = self.bd_2(self.bd_1(x, train), train)
        bd = _cat(self.bd_a(bd, train), self.bd_b(bd, train))
        bp = self.bp(_avg_pool(x), train)
        return _cat(b1, b3, bd, bp)


class InceptionV3(nn.Module):
    """Inception-v3: factorized-conv mixed blocks, without the auxiliary
    head. Its published input is 299 x 299; the smallest it takes is
    75."""

    def __init__(self, num_classes: int = 1000, dropout_rate: float = 0.5,
                 dtype: Dtype = torch.float32):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.stem1 = _ConvBN(3, 32, (3, 3), *_S2, dtype=dtype)
        self.stem2 = _ConvBN(32, 32, (3, 3), padding="VALID", dtype=dtype)
        self.stem3 = _ConvBN(32, 64, (3, 3), dtype=dtype)
        self.stem4 = _ConvBN(64, 80, (1, 1), dtype=dtype)
        self.stem5 = _ConvBN(80, 192, (3, 3), padding="VALID", dtype=dtype)
        self.blocks = []
        c = 192
        for name, cls, kw in (
                [(f"mixedA{i}", _MixedA, {"pool_features": pf})
                 for i, pf in enumerate((32, 64, 64))]
                + [("mixedB", _MixedB, {})]
                + [(f"mixedC{i}", _MixedC, {"c7": c7})
                   for i, c7 in enumerate((128, 160, 160, 192))]
                + [("mixedD", _MixedD, {})]
                + [(f"mixedE{i}", _MixedE, {}) for i in range(2)]):
            block = cls(c, dtype=dtype, **kw)
            self.add_module(name, block)
            self.blocks.append(name)
            c = block.out_features
        self.head = Dense(c, num_classes, dtype=torch.float32)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.stem3(self.stem2(self.stem1(x, train), train), train)
        x = _max_pool(x)
        x = _max_pool(self.stem5(self.stem4(x, train), train))
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        x = _drop(x.mean(dim=(1, 2)), self.dropout_rate, train, rng)
        return _head(x, self.head)
