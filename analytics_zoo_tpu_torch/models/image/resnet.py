"""ResNet family (v1.5, NHWC).

The counterpart of ``analytics_zoo_tpu/models/image/resnet.py``:
``BottleneckBlock``, ``BasicBlock``, ``ResNet``, ``ResNet18`` and
``ResNet50``, with the reference's module names (``stem_conv``,
``stage0_block0/conv1``, ``proj_bn``, ``head``, ...), so ``bridge.py``
maps the flax tree onto them with no rename table.

Images are NHWC, as in the reference. The convolutions are the Keras
layers' ``Conv`` (``keras/layers/convolutional.py``) without a bias:
``F.conv2d`` on ``x.permute(0, 3, 1, 2)``, which is already a
``channels_last`` tensor, with its weight kept ``channels_last`` too,
so bf16 convolutions reach cuDNN's NHWC kernels without a transpose;
every activation stays NHWC in memory.

flax's ``"SAME"`` padding is asymmetric where the window does not fit
evenly: a 3x3 window at stride 2 over an even size pads (0, 1), not
torch's (1, 1) (``padding=1`` would shift every window by a pixel).
``same_pads`` gives flax's pads, and ``Conv`` and the stem's max pool
(``keras/layers/pooling.py`` ``pool``) pad explicitly where they
differ, the pool with -inf, as ``nn.max_pool(..., padding="SAME")``
does.

Numerics follow flax's: parameters stay f32; a layer given ``dtype``
computes in it (``F.conv2d`` and the head in bf16 under
``dtype=torch.bfloat16``, the logits bf16); BatchNorm is the port's
flax ``nn.BatchNorm`` (``keras/layers/normalization.py``, momentum 0.9,
epsilon 1e-5), with the residual branch's last norm's scale starting at
0.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.layers.convolutional import (  # noqa: F401
    Conv, same_pads)
from analytics_zoo_tpu_torch.keras.layers.normalization import batch_norm
from analytics_zoo_tpu_torch.keras.layers.pooling import pool
from analytics_zoo_tpu_torch.keras.layers.transformer import Dense


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, filters: int,
                 strides: Tuple[int, int] = (1, 1),
                 projection: bool = False,
                 dtype: Optional[torch.dtype] = torch.float32):
        super().__init__()
        norm = batch_norm(dtype, momentum=0.9, epsilon=1e-5)
        out = 4 * filters
        self.conv1 = Conv(in_features, filters, (1, 1), use_bias=False,
                          dtype=dtype)
        self.bn1 = norm(filters)
        self.conv2 = Conv(filters, filters, (3, 3), strides, use_bias=False,
                          dtype=dtype)
        self.bn2 = norm(filters)
        self.conv3 = Conv(filters, out, (1, 1), use_bias=False,
                          dtype=dtype)
        self.bn3 = norm(out, scale_init=0.0)
        self.projection = projection
        if projection:
            self.proj_conv = Conv(in_features, out, (1, 1), strides,
                                  use_bias=False, dtype=dtype)
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
        self.conv1 = Conv(in_features, filters, (3, 3), strides,
                          use_bias=False, dtype=dtype)
        self.bn1 = norm(filters)
        self.conv2 = Conv(filters, filters, (3, 3), use_bias=False,
                          dtype=dtype)
        self.bn2 = norm(filters, scale_init=0.0)
        self.projection = projection
        if projection:
            self.proj_conv = Conv(in_features, filters, (1, 1), strides,
                                  use_bias=False, dtype=dtype)
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
                              padding=((3, 3), (3, 3)), use_bias=False,
                              dtype=dtype)
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

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        # ``rng``: the backbones' common signature (no dropout here)
        x = F.relu(self.stem_bn(self.stem_conv(x), train))
        x = pool(x, "max", (3, 3), (2, 2), "SAME")
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
