"""ResNet family (v1.5, NHWC).

The counterpart of ``analytics_zoo_tpu/models/image/resnet.py``:
``BottleneckBlock``, ``BasicBlock``, ``ResNet``, ``ResNet18`` and
``ResNet50``, with the reference's module names (``stem_conv``,
``stage0_block0/conv1``, ``proj_bn``, ``head``, ...), so ``bridge.py``
maps the flax tree onto them with no rename table.

Images are NHWC, as in the reference. ``Conv`` runs ``F.conv2d`` on
``x.permute(0, 3, 1, 2)``, which is already a ``channels_last`` tensor,
with its weight kept ``channels_last`` too, so bf16 convolutions reach
cuDNN's NHWC kernels without a transpose; every activation stays NHWC
in memory.

flax's ``"SAME"`` padding is asymmetric where the window does not fit
evenly: a 3x3 window at stride 2 over an even size pads (0, 1), not
torch's (1, 1) (``padding=1`` would shift every window by a pixel).
``same_pads`` gives flax's pads and ``Conv`` and ``max_pool_same`` pad
explicitly where they differ, the pool with -inf, as
``nn.max_pool(..., padding="SAME")`` does.

Numerics follow flax's: parameters stay f32; a layer given ``dtype``
computes in it (``F.conv2d`` and the head in bf16 under
``dtype=torch.bfloat16``, the logits bf16); BatchNorm is the port's
flax ``nn.BatchNorm`` (``keras/layers/normalization.py``, momentum 0.9,
epsilon 1e-5), with the residual branch's last norm's scale starting at
0.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.layers.normalization import batch_norm
from analytics_zoo_tpu_torch.keras.layers.transformer import (
    Dense, lecun_normal_)

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax's (``lax.padtype_to_pads``) "SAME" pads of one spatial axis:
    ``ceil(size / s)`` outputs, the extra pad at the end."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _pad_nhwc(x: torch.Tensor, pads: Pads, value: float = 0.0):
    (top, bottom), (left, right) = pads
    return F.pad(x, (0, 0, left, right, top, bottom), value=value)


class Conv(nn.Module):
    """flax ``nn.Conv`` without a bias over NHWC input: weight
    ``[out, in, kh, kw]`` (``channels_last`` in memory; flax's kernel is
    ``[kh, kw, in, out]``), ``padding`` "SAME" or explicit
    ``((top, bottom), (left, right))``."""

    seeded_init = True  # keras.layers.transformer.reset_parameters
    flax_weight_name = "kernel"  # learn.optim.param_tree

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1),
                 padding: Union[str, Pads] = "SAME",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_features, *self.kernel_size).contiguous(
                memory_format=torch.channels_last))

    def reset_parameters(self, gen: torch.Generator) -> None:
        # lecun_normal over the fan-in, flax's Conv default
        lecun_normal_(self.weight, self.weight[0].numel(), gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = (self.dtype if self.dtype is not None
              else torch.promote_types(x.dtype, torch.float32))
        if self.padding == "SAME":
            pads = tuple(same_pads(x.shape[1 + i], self.kernel_size[i],
                                   self.strides[i]) for i in range(2))
        else:
            pads = tuple(tuple(p) for p in self.padding)
        x = x.to(dt)
        if all(lo == hi for lo, hi in pads):
            sym = (pads[0][0], pads[1][0])
        else:
            x, sym = _pad_nhwc(x, pads), (0, 0)
        return _nhwc(F.conv2d(_nchw(x), self.weight.to(dt), None,
                              self.strides, sym))


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), strides=(s, s), padding="SAME")`` over
    NHWC: -inf pads at flax's sides."""
    pads = tuple(same_pads(x.shape[1 + i], k, s) for i in range(2))
    if any(pads[0] + pads[1]):
        x = _pad_nhwc(x, pads, float("-inf"))
    return _nhwc(F.max_pool2d(_nchw(x), k, s))


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, filters: int,
                 strides: Tuple[int, int] = (1, 1),
                 projection: bool = False,
                 dtype: Optional[torch.dtype] = torch.float32):
        super().__init__()
        norm = batch_norm(dtype, momentum=0.9, epsilon=1e-5)
        out = 4 * filters
        self.conv1 = Conv(in_features, filters, (1, 1), dtype=dtype)
        self.bn1 = norm(filters)
        self.conv2 = Conv(filters, filters, (3, 3), strides, dtype=dtype)
        self.bn2 = norm(filters)
        self.conv3 = Conv(filters, out, (1, 1), dtype=dtype)
        self.bn3 = norm(out, scale_init=0.0)
        self.projection = projection
        if projection:
            self.proj_conv = Conv(in_features, out, (1, 1), strides,
                                  dtype=dtype)
            self.proj_bn = norm(out)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = (self.proj_bn(self.proj_conv(x), train)
                    if self.projection else x)
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, filters: int,
                 strides: Tuple[int, int] = (1, 1),
                 projection: bool = False,
                 dtype: Optional[torch.dtype] = torch.float32):
        super().__init__()
        norm = batch_norm(dtype, momentum=0.9, epsilon=1e-5)
        self.conv1 = Conv(in_features, filters, (3, 3), strides, dtype=dtype)
        self.bn1 = norm(filters)
        self.conv2 = Conv(filters, filters, (3, 3), dtype=dtype)
        self.bn2 = norm(filters, scale_init=0.0)
        self.projection = projection
        if projection:
            self.proj_conv = Conv(in_features, filters, (1, 1), strides,
                                  dtype=dtype)
            self.proj_bn = norm(filters)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        residual = (self.proj_bn(self.proj_conv(x), train)
                    if self.projection else x)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """stage_sizes e.g. (3, 4, 6, 3) for ResNet-50; NHWC images with
    ``in_features`` channels (3, RGB) in, ``[N, num_classes]`` logits
    out."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 block=BottleneckBlock, num_filters: int = 64,
                 dtype: Optional[torch.dtype] = torch.float32,
                 in_features: int = 3):
        super().__init__()
        self.stem_conv = Conv(in_features, num_filters, (7, 7), (2, 2),
                              padding=((3, 3), (3, 3)), dtype=dtype)
        self.stem_bn = batch_norm(dtype, momentum=0.9,
                                  epsilon=1e-5)(num_filters)
        self.block_names = []
        width = num_filters
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                filters = num_filters * 2 ** i
                name = f"stage{i}_block{j}"
                self.add_module(name, block(width, filters, strides,
                                            projection=(j == 0),
                                            dtype=dtype))
                self.block_names.append(name)
                width = filters * block.expansion
        self.head = Dense(width, num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem_conv(x), train))
        x = max_pool_same(x, 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return self.head(x.mean(dim=(1, 2)))


def ResNet18(num_classes: int = 1000,
             dtype: Optional[torch.dtype] = torch.float32) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), num_classes=num_classes,
                  block=BasicBlock, dtype=dtype)


def ResNet50(num_classes: int = 1000,
             dtype: Optional[torch.dtype] = torch.float32) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes,
                  block=BottleneckBlock, dtype=dtype)
