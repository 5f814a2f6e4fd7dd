"""Torch-style elementwise, shape and threshold layers: the counterpart
of ``analytics_zoo_tpu/keras/layers/torch_ops.py``, its 30 layers with
the same arguments.

``CAdd``, ``CMul``, ``Mul`` and ``Scale`` learn their parameters under
the reference's names (``bias`` starting at 0, ``weight`` at 1); the
rest hold none. ``dim`` arguments count the non-batch axes, as the
reference's. ``RReLU`` draws its training slopes from the training
generator ``rng``; ``LayerNorm`` is the Keras ``LayerNormalization``
under the torch spelling; ``ShareConvolution2D`` makes a
``Convolution2D``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.layers.base import (FnModule, KerasLayer,
                                                       need_rng)
from analytics_zoo_tpu_torch.keras.layers.convolutional import (
    Convolution2D, channels_first, channels_last, pad_spatial, same_pads)
from analytics_zoo_tpu_torch.keras.layers.normalization import (
    LayerNormalization as _LayerNormalization)

__all__ = [
    "AddConstant", "MulConstant", "CAdd", "CMul", "Mul", "Scale",
    "Exp", "Log", "Sqrt", "Square", "Power", "Negative", "Identity",
    "Expand", "ExpandDim", "Squeeze", "Select", "Narrow", "Max",
    "Threshold", "BinaryThreshold", "HardShrink", "SoftShrink",
    "HardTanh", "RReLU", "Softmax", "LayerNorm", "GetShape",
    "WithinChannelLRN2D", "ShareConvolution2D",
]


def _axis(dim: int, ndim: int) -> int:
    """Reference layers count dims EXCLUDING batch; negative dims count
    from the end. Out-of-range dims raise rather than silently landing
    on the batch axis."""
    if dim >= ndim - 1 or dim < -(ndim - 1):
        raise ValueError(f"dim {dim} out of range for {ndim - 1} "
                         "non-batch dims")
    return dim % ndim if dim < 0 else dim + 1


def _expand_axis(dim: int, ndim: int) -> int:
    """Like ``_axis`` but the insertion point may sit one past the last
    existing non-batch dim."""
    if dim > ndim - 1 or dim < -ndim:
        raise ValueError(f"dim {dim} out of range to insert into "
                         f"{ndim - 1} non-batch dims")
    return dim % (ndim + 1) if dim < 0 else dim + 1


class _FnLayer(KerasLayer):
    """KerasLayer over a pure function of the input."""

    def _fn(self, x):
        raise NotImplementedError

    def _make_module(self):
        return FnModule(self._fn)


# ------------------------------------------------------- const math --
class AddConstant(_FnLayer):
    """x + c (ref: AddConstant.scala)."""

    def __init__(self, constant: float, **kwargs):
        super().__init__(**kwargs)
        self.constant = float(constant)

    def _fn(self, x):
        return x + self.constant


class MulConstant(_FnLayer):
    """x * c (ref: MulConstant.scala)."""

    def __init__(self, constant: float, **kwargs):
        super().__init__(**kwargs)
        self.constant = float(constant)

    def _fn(self, x):
        return x * self.constant


class Exp(_FnLayer):
    def _fn(self, x):
        return torch.exp(x)


class Log(_FnLayer):
    def _fn(self, x):
        return torch.log(x)


class Sqrt(_FnLayer):
    def _fn(self, x):
        return torch.sqrt(x)


class Square(_FnLayer):
    def _fn(self, x):
        return torch.square(x)


class Power(_FnLayer):
    """(shift + scale * x) ** power (ref: Power.scala semantics)."""

    def __init__(self, power: float, scale: float = 1.0,
                 shift: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.power, self.scale, self.shift = power, scale, shift

    def _fn(self, x):
        return (self.shift + self.scale * x) ** self.power


class Negative(_FnLayer):
    def _fn(self, x):
        return -x


class Identity(_FnLayer):
    def _fn(self, x):
        return x


# -------------------------------------------------- learned scaling --
class _AffineModule(nn.Module):
    """``x * weight + bias`` with either part optional: ``weight`` and
    ``bias`` of ``shape`` starting at 1 and 0."""

    seeded_init = True  # keras.layers.transformer.reset_parameters

    def __init__(self, shape, weight: bool, bias: bool):
        super().__init__()
        self.weight = (nn.Parameter(torch.ones(shape)) if weight else None)
        self.bias = nn.Parameter(torch.zeros(shape)) if bias else None

    def reset_parameters(self, gen: Optional[torch.Generator] = None):
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        if self.weight is not None:
            x = x * self.weight
        if self.bias is not None:
            x = x + self.bias
        return x


class _AffineLayer(KerasLayer):
    weight = bias = False

    def __init__(self, shape: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        self.shape = tuple(int(s) for s in shape)

    def _make_module(self):
        return _AffineModule(self.shape, self.weight, self.bias)


class CAdd(_AffineLayer):
    """Learned per-element bias of the given shape, broadcast onto the
    input (ref: CAdd.scala)."""

    bias = True


class CMul(_AffineLayer):
    """Learned per-element scale (ref: CMul.scala)."""

    weight = True


class Mul(_AffineLayer):
    """Single learned scalar multiplier (ref: Mul.scala)."""

    weight = True

    def __init__(self, **kwargs):
        super().__init__((), **kwargs)


class Scale(_AffineLayer):
    """Learned affine x*w + b of the given broadcast shape
    (ref: Scale.scala = CMul then CAdd)."""

    weight = bias = True


# ------------------------------------------------------- shape ops --
class Expand(_FnLayer):
    """Broadcast size-1 dims to the target shape (batch dim excluded;
    ref: Expand.scala / InternalExpand)."""

    def __init__(self, shape: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        self.shape = tuple(int(s) for s in shape)

    def _fn(self, x):
        return torch.broadcast_to(x, (x.shape[0],) + self.shape)


class ExpandDim(_FnLayer):
    """Insert a size-1 axis (ref: ExpandDim.scala); ``dim`` counts
    non-batch axes like the reference."""

    def __init__(self, dim: int, **kwargs):
        super().__init__(**kwargs)
        self.dim = int(dim)

    def _fn(self, x):
        return torch.unsqueeze(x, _expand_axis(self.dim, x.ndim))


class Squeeze(_FnLayer):
    """Drop size-1 axes (ref: Squeeze.scala); ``dim`` non-batch."""

    def __init__(self, dim: Optional[int] = None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim

    def _fn(self, x):
        if self.dim is None:
            return x.reshape(tuple(s for i, s in enumerate(x.shape)
                                   if i == 0 or s != 1))
        axis = _axis(self.dim, x.ndim)
        if x.shape[axis] != 1:
            raise ValueError(f"cannot squeeze axis {axis} of size "
                             f"{x.shape[axis]}")
        return torch.squeeze(x, axis)


class Select(_FnLayer):
    """Index one slice along a non-batch dim (ref: Select.scala)."""

    def __init__(self, dim: int, index: int, **kwargs):
        super().__init__(**kwargs)
        self.dim, self.index = int(dim), int(index)

    def _fn(self, x):
        return torch.select(x, _axis(self.dim, x.ndim), self.index)


class Narrow(_FnLayer):
    """Slice ``length`` elements from ``offset`` along a non-batch dim
    (ref: Narrow.scala)."""

    def __init__(self, dim: int, offset: int, length: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.dim, self.offset, self.length = int(dim), int(offset), \
            int(length)

    def _fn(self, x):
        return torch.narrow(x, _axis(self.dim, x.ndim), self.offset,
                            self.length)


class Max(_FnLayer):
    """Max over a non-batch dim (ref: Max.scala / InternalMax)."""

    def __init__(self, dim: int, keepdims: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.dim, self.keepdims = int(dim), keepdims

    def _fn(self, x):
        return torch.amax(x, dim=_axis(self.dim, x.ndim),
                          keepdim=self.keepdims)


class GetShape(_FnLayer):
    """The input's shape, one row per sample [B, ndim], int32
    (ref: GetShape.scala returns the bare shape; the per-row form
    survives predict's chunked batching)."""

    def _fn(self, x):
        shape = torch.tensor(x.shape, dtype=torch.int32, device=x.device)
        return shape.expand(x.shape[0], x.ndim)


# ----------------------------------------------- threshold family --
class Threshold(_FnLayer):
    """x if x > th else value (ref: Threshold.scala)."""

    def __init__(self, th: float = 1e-6, value: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.th, self.value = th, value

    def _fn(self, x):
        return torch.where(x > self.th, x, self.value)


class BinaryThreshold(_FnLayer):
    """1 where x > th else 0 (ref: BinaryThreshold.scala)."""

    def __init__(self, th: float = 1e-6, **kwargs):
        super().__init__(**kwargs)
        self.th = th

    def _fn(self, x):
        return (x > self.th).to(torch.float32)


class HardShrink(_FnLayer):
    """0 inside [-lambda, lambda] (ref: HardShrink.scala)."""

    def __init__(self, value: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.value = value

    def _fn(self, x):
        return torch.where(torch.abs(x) > self.value, x, 0.0)


class SoftShrink(_FnLayer):
    """Shrink toward zero by lambda (ref: SoftShrink.scala)."""

    def __init__(self, value: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.value = value

    def _fn(self, x):
        return (torch.where(x > self.value, x - self.value, 0.0)
                + torch.where(x < -self.value, x + self.value, 0.0))


class HardTanh(_FnLayer):
    """Clip to [min_value, max_value] (ref: HardTanh.scala)."""

    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 **kwargs):
        super().__init__(**kwargs)
        self.min_value, self.max_value = min_value, max_value

    def _fn(self, x):
        return torch.clamp(x, self.min_value, self.max_value)


class _RReLUModule(nn.Module):
    def __init__(self, lower: float, upper: float):
        super().__init__()
        self.lower = lower
        self.upper = upper

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        if train:
            slope = torch.empty_like(x).uniform_(
                self.lower, self.upper, generator=need_rng(rng, "RReLU"))
        else:
            slope = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, x * slope)


class RReLU(KerasLayer):
    """Randomized leaky ReLU: slope ~ U[lower, upper] in training,
    the mean slope at inference (ref: RReLU.scala)."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 **kwargs):
        super().__init__(**kwargs)
        self.lower, self.upper = lower, upper

    def _make_module(self):
        return _RReLUModule(self.lower, self.upper)


class Softmax(_FnLayer):
    """Softmax over the last dim (ref: Softmax.scala)."""

    def _fn(self, x):
        return torch.softmax(x, dim=-1)


class LayerNorm(_LayerNormalization):
    """Last-dim layer normalization with learned scale/bias
    (ref: LayerNorm.scala / InternalLayerNorm) -- the torch-style
    (eps) spelling of :class:`LayerNormalization`."""

    def __init__(self, eps: float = 1e-5, **kwargs):
        # the reference exposes (nOutput, eps); nOutput is inferred here
        kwargs.pop("n_output", None)
        super().__init__(epsilon=eps, **kwargs)


# ------------------------------------------------------ conv extras --
class WithinChannelLRN2D(_FnLayer):
    """Local response normalization pooled WITHIN each channel over a
    spatial window (ref: WithinChannelLRN2D.scala; channels-last): the
    mean of x^2 over the "SAME" window's in-bounds cells."""

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75, **kwargs):
        super().__init__(**kwargs)
        self.size, self.alpha, self.beta = size, alpha, beta

    def _fn(self, x):
        k = self.size
        pads = tuple(same_pads(x.shape[1 + i], k, 1) for i in range(2))

        def window_sum(t):
            return F.avg_pool2d(channels_first(pad_spatial(t, pads)), k,
                                1, divisor_override=1)

        summed = window_sum(torch.square(x))
        count = window_sum(torch.ones_like(x[..., :1]))
        denom = (1.0 + self.alpha * channels_last(summed / count)) \
            ** self.beta
        return x / denom


class ShareConvolution2D(KerasLayer):
    """A ``Convolution2D``: BigDL's ShareConvolution shared its weight
    storage across replicas, and here there is one weight copy by
    construction (ref: ShareConvolution2D.scala)."""

    def __new__(cls, *args, **kwargs):
        return Convolution2D(*args, **kwargs)
