"""Convolution, padding, cropping and upsampling layers: the counterpart
of ``analytics_zoo_tpu/keras/layers/convolutional.py``, its 19 layers
with the same arguments and flax's parameter names and initial values.

Channels last, as the reference: ``[B, L, C]``, ``[B, H, W, C]`` and
``[B, D, H, W, C]``. ``Conv`` (flax ``nn.Conv`` of any rank) runs
``F.conv{1,2,3}d`` on the input with its channel axis moved second,
which for 2-D and 3-D is a ``channels_last`` view, so cuDNN reads the
activations in place. Its weight is ``[out, in / groups, *k]`` (flax's
kernel is ``[*k, in / groups, out]``); it declares
``flax_layout = "conv"``, so ``bridge.py`` moves the axes at every rank.

flax's "SAME" pads where the window does not fit evenly put the extra
pad at the end (``same_pads``), with the window's dilated extent; the
convolution pads explicitly where the two sides differ.
``Deconvolution2D`` is flax's ``ConvTranspose`` (``transpose_kernel``
off: the kernel is not flipped): the input dilated by the strides,
padded as ``lax.conv_transpose`` pads, then correlated with the kernel.
``LocallyConnected*`` keeps flax's ``[positions, patch, out]`` kernel
(``flax_layout = "flax"``). ``ResizeBilinear`` is
``jax.image.resize(..., "bilinear")``: half-pixel centres, and an
antialiasing triangle filter when it shrinks.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras import activations
from analytics_zoo_tpu_torch.keras.layers.base import (FnModule, KerasLayer,
                                                       lazy_child)
from analytics_zoo_tpu_torch.keras.layers.transformer import lecun_normal_

Pads = Tuple[Tuple[int, int], ...]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _tup(v, n):
    if isinstance(v, (tuple, list)):
        if len(v) != n:
            raise ValueError(f"expected {n} values, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * n


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax's (``lax.padtype_to_pads``) "SAME" pads of one spatial axis
    for a window of extent ``k``: ``ceil(size / s)`` outputs, the extra
    pad at the end."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def pad_spatial(x: torch.Tensor, pads: Pads, value: float = 0.0):
    """``x`` (channels last) padded by ``pads`` on its spatial axes."""
    flat = [0, 0]
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


def channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


def conv_pads(x: torch.Tensor, padding, kernel, strides, dilation) -> Pads:
    """The per-axis (low, high) pads of flax's ``padding`` ("SAME",
    "VALID" or explicit pairs) over channels-last ``x``."""
    n = len(kernel)
    if padding == "VALID":
        return ((0, 0),) * n
    if padding == "SAME":
        return tuple(same_pads(x.shape[1 + i], (kernel[i] - 1)
                               * dilation[i] + 1, strides[i])
                     for i in range(n))
    return tuple(tuple(p) for p in padding)


class Conv(nn.Module):
    """flax ``nn.Conv`` over channels-last input of rank 1, 2 or 3:
    weight ``[out, in / groups, *kernel]`` (``channels_last`` in memory
    at rank 2), bias ``[out]``; ``padding`` "SAME", "VALID" or explicit
    ``((lo, hi), ...)``. Parameters stay f32; given ``dtype`` it
    computes in it (the backbones' bf16), else in the promotion of the
    input and f32."""

    seeded_init = True  # keras.layers.transformer.reset_parameters
    flax_weight_name = "kernel"  # learn.optim.param_tree
    flax_layout = "conv"  # bridge.kernel_layouts

    def __init__(self, in_features: int, features: int,
                 kernel: Sequence[int], strides: Sequence[int] = None,
                 padding="SAME", dilation: Sequence[int] = None,
                 use_bias: bool = True, groups: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        n = len(kernel)
        self.kernel = tuple(kernel)
        self.strides = tuple(strides or (1,) * n)
        self.dilation = tuple(dilation or (1,) * n)
        self.padding = padding
        self.groups = groups
        self.dtype = dtype
        weight = torch.empty(features, in_features // groups, *self.kernel)
        if n == 2:
            weight = weight.contiguous(memory_format=torch.channels_last)
        self.weight = nn.Parameter(weight)
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def reset_parameters(self, gen: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def _in(self, x: torch.Tensor):
        """``x`` and the parameters in the compute dtype."""
        dt = (self.dtype if self.dtype is not None
              else torch.promote_types(x.dtype, torch.float32))
        bias = self.bias.to(dt) if self.bias is not None else None
        return x.to(dt), self.weight.to(dt), bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = self._in(x)
        pads = conv_pads(x, self.padding, self.kernel, self.strides,
                         self.dilation)
        if all(lo == hi for lo, hi in pads):
            sym = tuple(lo for lo, _ in pads)
        else:
            x, sym = pad_spatial(x, pads), 0
        y = _CONV[len(self.kernel)](channels_first(x), weight, bias,
                                    self.strides, sym, self.dilation,
                                    self.groups)
        return channels_last(y)


def transpose_pads(k: int, s: int, padding: str) -> Tuple[int, int]:
    """``lax.conv_transpose``'s pads of one axis for a (dilated) kernel
    extent ``k`` and stride ``s``."""
    if padding == "SAME":
        pad_len = k + s - 2
        lo = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        lo = k - 1
    return lo, pad_len - lo


class ConvTranspose(Conv):
    """flax ``nn.ConvTranspose`` (``transpose_kernel=False``) over
    channels-last input: weight ``[out, in, *kernel]`` (flax's
    ``[*kernel, in, out]``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = self._in(x)
        n = len(self.kernel)
        if any(s > 1 for s in self.strides):
            # lhs dilation: s - 1 zeros between neighbouring inputs
            shape = [x.shape[0]] + [(x.shape[1 + i] - 1) * self.strides[i]
                                    + 1 for i in range(n)] + [x.shape[-1]]
            dilated = x.new_zeros(shape)
            dilated[(slice(None),) + tuple(
                slice(None, None, s) for s in self.strides)] = x
            x = dilated
        pads = tuple(transpose_pads((k - 1) * d + 1, s, self.padding)
                     for k, s, d in zip(self.kernel, self.strides,
                                        self.dilation))
        y = _CONV[n](channels_first(pad_spatial(x, pads)), weight, bias, 1,
                     0, self.dilation)
        return channels_last(y)


class _ConvModule(nn.Module):
    """One ``Conv_0`` (or ``ConvTranspose_0``) and an activation."""

    def __init__(self, features: int, kernel, strides, padding: str,
                 dilation, activation: Callable, use_bias: bool,
                 transpose: bool = False):
        super().__init__()
        self.cfg = dict(features=features, kernel=kernel, strides=strides,
                        padding=padding.upper(), dilation=dilation,
                        use_bias=use_bias)
        self.transpose = transpose
        self.activation = activation

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        cls = ConvTranspose if self.transpose else Conv
        conv = lazy_child(self, f"{cls.__name__}_0",
                          lambda: cls(x.shape[-1], **self.cfg), x)
        return self.activation(conv(x))


class _ConvBase(KerasLayer):
    rank = 2
    transpose = False

    def __init__(self, nb_filter: int, kernel, subsample=1,
                 activation=None, border_mode: str = "valid",
                 bias: bool = True, dilation_rate=1, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = nb_filter
        self.kernel = _tup(kernel, self.rank)
        self.subsample = _tup(subsample, self.rank)
        self.dilation = _tup(dilation_rate, self.rank)
        self.activation = activations.get(activation)
        if border_mode not in ("valid", "same"):
            raise ValueError(f"border_mode must be valid/same, "
                             f"got {border_mode!r}")
        self.border_mode = border_mode
        self.bias = bias

    def _make_module(self):
        return _ConvModule(self.nb_filter, self.kernel, self.subsample,
                           self.border_mode, self.dilation,
                           self.activation, self.bias, self.transpose)


class Convolution1D(_ConvBase):
    rank = 1

    def __init__(self, nb_filter, filter_length, subsample_length=1,
                 **kwargs):
        super().__init__(nb_filter, filter_length,
                         subsample=subsample_length, **kwargs)


class Convolution2D(_ConvBase):
    rank = 2

    def __init__(self, nb_filter, nb_row, nb_col=None, subsample=(1, 1),
                 **kwargs):
        kernel = (nb_row, nb_col) if nb_col is not None else nb_row
        super().__init__(nb_filter, kernel, subsample=subsample, **kwargs)


class Convolution3D(_ConvBase):
    rank = 3

    def __init__(self, nb_filter, kernel_dim1, kernel_dim2=None,
                 kernel_dim3=None, subsample=(1, 1, 1), **kwargs):
        kernel = ((kernel_dim1, kernel_dim2, kernel_dim3)
                  if kernel_dim2 is not None else kernel_dim1)
        super().__init__(nb_filter, kernel, subsample=subsample, **kwargs)


class AtrousConvolution1D(Convolution1D):
    def __init__(self, nb_filter, filter_length, atrous_rate=1, **kwargs):
        super().__init__(nb_filter, filter_length,
                         dilation_rate=atrous_rate, **kwargs)


class AtrousConvolution2D(Convolution2D):
    def __init__(self, nb_filter, nb_row, nb_col=None, atrous_rate=(1, 1),
                 **kwargs):
        super().__init__(nb_filter, nb_row, nb_col,
                         dilation_rate=atrous_rate, **kwargs)


class Deconvolution2D(Convolution2D):
    """Transposed conv (ref: keras/layers/Deconvolution2D.scala)."""

    transpose = True


class _SeparableConv2DModule(nn.Module):
    def __init__(self, features: int, kernel, strides, padding: str,
                 depth_multiplier: int, activation: Callable,
                 use_bias: bool):
        super().__init__()
        self.features = features
        self.kernel = kernel
        self.strides = strides
        self.padding = padding.upper()
        self.depth_multiplier = depth_multiplier
        self.activation = activation
        self.use_bias = use_bias

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        in_ch = x.shape[-1]
        mid = in_ch * self.depth_multiplier
        depth = lazy_child(self, "depthwise", lambda: Conv(
            in_ch, mid, self.kernel, self.strides, self.padding,
            use_bias=False, groups=in_ch), x)
        point = lazy_child(self, "pointwise", lambda: Conv(
            mid, self.features, (1,) * len(self.kernel),
            use_bias=self.use_bias), x)
        return self.activation(point(depth(x)))


class SeparableConvolution2D(KerasLayer):
    """(ref: keras/layers/SeparableConvolution2D.scala)."""

    def __init__(self, nb_filter, nb_row, nb_col=None, subsample=(1, 1),
                 depth_multiplier: int = 1, activation=None,
                 border_mode: str = "valid", bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = nb_filter
        self.kernel = (nb_row, nb_col if nb_col is not None else nb_row)
        self.subsample = _tup(subsample, 2)
        self.depth_multiplier = depth_multiplier
        self.activation = activations.get(activation)
        self.border_mode = border_mode
        self.bias = bias

    def _make_module(self):
        return _SeparableConv2DModule(
            self.nb_filter, self.kernel, self.subsample, self.border_mode,
            self.depth_multiplier, self.activation, self.bias)


# -------------------------------------------------- crop / pad / upsample ---


def _crop_layer(rank, name):
    class _Cropping(KerasLayer):
        def __init__(self, cropping=None, **kwargs):
            super().__init__(**kwargs)
            if cropping is None:
                cropping = ((1, 1),) * rank if rank > 1 else (1, 1)
            if rank == 1:
                cropping = (tuple(cropping),)
            self.cropping = tuple(tuple(c) for c in cropping)

        def _make_module(self):
            crops = self.cropping

            def fn(x):
                slices = [slice(None)]
                for lo, hi in crops:
                    slices.append(slice(lo, x.shape[len(slices)] - hi))
                return x[tuple(slices)]

            return FnModule(fn)

    _Cropping.__name__ = _Cropping.__qualname__ = name
    return _Cropping


Cropping1D = _crop_layer(1, "Cropping1D")
Cropping2D = _crop_layer(2, "Cropping2D")
Cropping3D = _crop_layer(3, "Cropping3D")


def _pad_layer(rank, name):
    class _ZeroPadding(KerasLayer):
        def __init__(self, padding=1, **kwargs):
            super().__init__(**kwargs)
            if isinstance(padding, int):
                padding = ((padding, padding),) * rank
            elif rank == 1 and isinstance(padding, (tuple, list)) and \
                    len(padding) == 2 and isinstance(padding[0], int):
                padding = (tuple(padding),)
            else:
                padding = tuple(
                    (p, p) if isinstance(p, int) else tuple(p)
                    for p in padding)
            self.padding = padding

        def _make_module(self):
            pads = self.padding
            return FnModule(lambda x: pad_spatial(x, pads))

    _ZeroPadding.__name__ = _ZeroPadding.__qualname__ = name
    return _ZeroPadding


ZeroPadding1D = _pad_layer(1, "ZeroPadding1D")
ZeroPadding2D = _pad_layer(2, "ZeroPadding2D")
ZeroPadding3D = _pad_layer(3, "ZeroPadding3D")


def _upsample_layer(rank, name):
    class _UpSampling(KerasLayer):
        def __init__(self, size=2, **kwargs):
            super().__init__(**kwargs)
            self.size = _tup(size, rank)

        def _make_module(self):
            size = self.size

            def fn(x):
                for axis, s in enumerate(size):
                    x = torch.repeat_interleave(x, s, dim=axis + 1)
                return x

            return FnModule(fn)

    _UpSampling.__name__ = _UpSampling.__qualname__ = name
    return _UpSampling


UpSampling1D = _upsample_layer(1, "UpSampling1D")
UpSampling2D = _upsample_layer(2, "UpSampling2D")
UpSampling3D = _upsample_layer(3, "UpSampling3D")


class _LocallyConnectedModule(nn.Module):
    """Unshared convolution: one kernel per output position, the
    patches gathered once and contracted with the ``[positions, patch,
    out]`` kernel in one batched product."""

    seeded_init = True  # keras.layers.transformer.reset_parameters
    flax_weight_name = "kernel"  # learn.optim.param_tree
    flax_layout = "flax"  # bridge.kernel_layouts

    def __init__(self, units: int, kernel, strides, activation: Callable,
                 use_bias: bool):
        super().__init__()
        self.units = units
        self.kernel = tuple(kernel)
        self.strides = tuple(strides)
        self.activation = activation
        self.use_bias = use_bias

    def reset_parameters(self, gen: torch.Generator) -> None:
        w = self._parameters.get("weight")
        if w is None:
            return
        # flax's lecun_normal over the 3-D shape: fan_in = patch x
        # positions
        lecun_normal_(w, w.shape[0] * w.shape[1], gen)
        if self.use_bias:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        k, s = self.kernel, self.strides
        b = x.shape[0]
        out_sizes = tuple((x.shape[1 + i] - k[i]) // s[i] + 1
                          for i in range(len(k)))
        # [B, *out, C, *k] windows, flattened in flax's (*k, C) order
        patches = x
        for i in range(len(k)):
            patches = patches.unfold(1 + i, k[i], s[i])
        n_pos = math.prod(out_sizes)
        nk = len(k)
        patches = patches.permute(
            0, *range(1, 1 + nk), *range(2 + nk, 2 + 2 * nk), 1 + nk)
        patches = patches.reshape(b, n_pos, -1)
        patch = patches.shape[-1]
        w = self._parameters.get("weight")
        if w is None:
            w = nn.Parameter(torch.empty(n_pos, patch, self.units,
                                         device=x.device))
            self.register_parameter("weight", w)
            if self.use_bias:
                self.register_parameter("bias", nn.Parameter(torch.zeros(
                    n_pos, self.units, device=x.device)))
        y = torch.einsum("bpk,pku->bpu",
                         patches.to(torch.promote_types(x.dtype,
                                                        torch.float32)), w)
        if self.use_bias:
            y = y + self.bias
        return self.activation(y.reshape((b,) + out_sizes + (self.units,)))


class LocallyConnected1D(KerasLayer):
    """Conv1D without weight sharing, 'valid' padding only
    (ref: keras/layers/LocallyConnected1D.scala)."""

    def __init__(self, nb_filter: int, filter_length: int,
                 activation=None, subsample_length: int = 1,
                 bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = nb_filter
        self.filter_length = filter_length
        self.activation = activations.get(activation)
        self.subsample_length = subsample_length
        self.bias = bias

    def _make_module(self):
        return _LocallyConnectedModule(
            self.nb_filter, (self.filter_length,),
            (self.subsample_length,), self.activation, self.bias)


class LocallyConnected2D(KerasLayer):
    """Conv2D without weight sharing, 'valid' padding only
    (ref: keras/layers/LocallyConnected2D.scala; channels-last)."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, subsample: Tuple[int, int] = (1, 1),
                 bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = nb_filter
        self.nb_row = nb_row
        self.nb_col = nb_col
        self.activation = activations.get(activation)
        self.subsample = tuple(subsample)
        self.bias = bias

    def _make_module(self):
        return _LocallyConnectedModule(
            self.nb_filter, (self.nb_row, self.nb_col), self.subsample,
            self.activation, self.bias)


class ResizeBilinear(KerasLayer):
    """Bilinear resize of [B, H, W, C] feature maps
    (ref: keras/layers/ResizeBilinear.scala)."""

    def __init__(self, output_height: int, output_width: int, **kwargs):
        super().__init__(**kwargs)
        self.output_height = output_height
        self.output_width = output_width

    def _make_module(self):
        size = (self.output_height, self.output_width)

        def fn(x):
            # jax.image.resize's antialias defaults to True: a triangle
            # filter widened by the shrink factor where the map shrinks
            y = F.interpolate(channels_first(x.float()), size=size,
                              mode="bilinear", align_corners=False,
                              antialias=True)
            return channels_last(y)

        return FnModule(fn)
