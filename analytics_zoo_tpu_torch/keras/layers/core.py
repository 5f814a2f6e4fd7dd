"""Core layers: the counterpart of
``analytics_zoo_tpu/keras/layers/core.py``, its 19 layers with the same
arguments, initial values and parameter names.

A layer that holds parameters makes them at its first forward from the
input's width (``base.lazy_child``/``lazy_param``) and fills them in
``reset_parameters``: Dense weights by flax's ``lecun_normal``, biases
0, Highway's gate bias -2, SReLU's ``t_left``, ``a_left``, ``t_right``
and ``a_right`` 0, 0.2, 1 and 1. The noise layers draw from the
training generator ``rng`` and are the identity outside training.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from analytics_zoo_tpu_torch.keras import activations
from analytics_zoo_tpu_torch.keras.layers.base import (
    FnModule, KerasLayer, lazy_child, lazy_param, need_rng)
from analytics_zoo_tpu_torch.keras.layers.transformer import Dense as _Dense
from analytics_zoo_tpu_torch.keras.layers.transformer import dropout


class _DenseModule(nn.Module):
    def __init__(self, units: int, activation: Callable, use_bias: bool):
        super().__init__()
        self.units = units
        self.activation = activation
        self.use_bias = use_bias

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        dense = lazy_child(self, "Dense_0", lambda: _Dense(
            x.shape[-1], self.units, use_bias=self.use_bias), x)
        return self.activation(dense(x))


class Dense(KerasLayer):
    """(ref: keras/layers/Dense.scala)."""

    def __init__(self, output_dim: int, activation=None, bias: bool = True,
                 **kwargs):
        super().__init__(**kwargs)
        self.output_dim = output_dim
        self.activation = activations.get(activation)
        self.bias = bias

    def _make_module(self):
        return _DenseModule(self.output_dim, self.activation, self.bias)


class Activation(KerasLayer):
    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self.activation = activations.get(activation)

    def _make_module(self):
        return FnModule(self.activation)


class _DropoutModule(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        return dropout(x, self.rate, rng) if train else x


class Dropout(KerasLayer):
    """(ref: keras/layers/Dropout.scala)."""

    def __init__(self, p: float, **kwargs):
        super().__init__(**kwargs)
        self.p = p

    def _make_module(self):
        return _DropoutModule(self.p)


def _normal(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(x.shape, generator=gen, device=x.device,
                       dtype=x.dtype)


class _GaussianNoiseModule(nn.Module):
    def __init__(self, sigma: float):
        super().__init__()
        self.sigma = sigma

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        if not train:
            return x
        return x + self.sigma * _normal(x, need_rng(rng, "GaussianNoise"))


class GaussianNoise(KerasLayer):
    """(ref: keras/layers/GaussianNoise.scala)."""

    def __init__(self, sigma: float, **kwargs):
        super().__init__(**kwargs)
        self.sigma = sigma

    def _make_module(self):
        return _GaussianNoiseModule(self.sigma)


class Flatten(KerasLayer):
    def _make_module(self):
        return FnModule(lambda x: x.reshape(x.shape[0], -1))


class Reshape(KerasLayer):
    """target_shape excludes the batch dim; one -1 allowed
    (ref: keras/layers/Reshape.scala)."""

    def __init__(self, target_shape: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        self.target_shape = tuple(target_shape)

    def _make_module(self):
        ts = self.target_shape
        return FnModule(lambda x: x.reshape((x.shape[0],) + ts))


class Permute(KerasLayer):
    """1-based dim indices excluding batch (keras1 convention,
    ref: keras/layers/Permute.scala)."""

    def __init__(self, dims: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        self.dims = tuple(dims)

    def _make_module(self):
        perm = (0,) + self.dims
        return FnModule(lambda x: x.permute(perm))


class RepeatVector(KerasLayer):
    """[B, D] -> [B, n, D] (ref: keras/layers/RepeatVector.scala)."""

    def __init__(self, n: int, **kwargs):
        super().__init__(**kwargs)
        self.n = n

    def _make_module(self):
        n = self.n
        return FnModule(
            lambda x: torch.repeat_interleave(x[:, None, :], n, dim=1))


class Lambda(KerasLayer):
    """Wrap an arbitrary function of torch tensors
    (ref: api/autograd Lambda.scala / CustomLoss pattern)."""

    def __init__(self, fn: Callable, **kwargs):
        super().__init__(**kwargs)
        self.fn = fn

    def _make_module(self):
        return FnModule(self.fn)


class InputLayer(KerasLayer):
    def _make_module(self):
        return FnModule(lambda x: x)


class _HighwayModule(nn.Module):
    def __init__(self, activation: Callable):
        super().__init__()
        self.activation = activation

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        d = x.shape[-1]
        transform = lazy_child(self, "transform", lambda: _Dense(d, d), x)
        gate = lazy_child(self, "gate",
                          lambda: _Dense(d, d, bias_init=-2.0), x)
        h = self.activation(transform(x))
        t = torch.sigmoid(gate(x))
        return h * t + x * (1.0 - t)


class Highway(KerasLayer):
    """(ref: keras/layers/Highway.scala; gate bias init -2 per paper)."""

    def __init__(self, activation="tanh", **kwargs):
        super().__init__(**kwargs)
        self.activation = activations.get(activation)

    def _make_module(self):
        return _HighwayModule(self.activation)


class _SReLUModule(nn.Module):
    """S-shaped ReLU with learnable (t_left, a_left, t_right, a_right)
    per channel (ref: keras/layers/SReLU.scala; Jin et al. 2015)."""

    seeded_init = True  # keras.layers.transformer.reset_parameters
    INIT = (("t_left", 0.0), ("a_left", 0.2), ("t_right", 1.0),
            ("a_right", 1.0))

    def reset_parameters(self, gen: Optional[torch.Generator] = None):
        with torch.no_grad():
            for name, value in self.INIT:
                if name in self._parameters:
                    self._parameters[name].fill_(value)

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        shape = (x.shape[-1],)
        t_l, a_l, t_r, a_r = (lazy_param(self, name, shape, value, x)
                              for name, value in self.INIT)
        below = t_l + a_l * (x - t_l)
        above = t_r + a_r * (x - t_r)
        return torch.where(x < t_l, below, torch.where(x > t_r, above, x))


class SReLU(KerasLayer):
    def _make_module(self):
        return _SReLUModule()


class Masking(KerasLayer):
    """Zero out timesteps whose features ALL equal ``mask_value``
    (ref: keras/layers/Masking.scala): [B, T, ...] -> same shape with
    masked steps zeroed; no mask channel propagates."""

    def __init__(self, mask_value: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.mask_value = mask_value

    def _make_module(self):
        mv = self.mask_value

        def fn(x):
            keep = (x != mv).flatten(2).any(-1) if x.ndim > 2 else x != mv
            shape = keep.shape + (1,) * (x.ndim - keep.ndim)
            return x * keep.reshape(shape).to(x.dtype)

        return FnModule(fn)


class _MaxoutDenseModule(nn.Module):
    def __init__(self, units: int, nb_feature: int, use_bias: bool):
        super().__init__()
        self.units = units
        self.nb_feature = nb_feature
        self.use_bias = use_bias

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        dense = lazy_child(self, "Dense_0", lambda: _Dense(
            x.shape[-1], self.units * self.nb_feature,
            use_bias=self.use_bias), x)
        y = dense(x)
        y = y.reshape(y.shape[:-1] + (self.nb_feature, self.units))
        return torch.amax(y, dim=-2)


class MaxoutDense(KerasLayer):
    """Max over ``nb_feature`` linear pieces
    (ref: keras/layers/MaxoutDense.scala)."""

    def __init__(self, output_dim: int, nb_feature: int = 4,
                 bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.output_dim = output_dim
        self.nb_feature = nb_feature
        self.bias = bias

    def _make_module(self):
        return _MaxoutDenseModule(self.output_dim, self.nb_feature,
                                  self.bias)


class _GaussianDropoutModule(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        if not train or self.rate <= 0:
            return x
        stddev = (self.rate / (1.0 - self.rate)) ** 0.5
        return x * (1.0 + stddev * _normal(
            x, need_rng(rng, "GaussianDropout")))


def _check_rate(p: float) -> None:
    if not 0.0 <= p < 1.0:
        raise ValueError(f"p must be in [0, 1), got {p}")


class GaussianDropout(KerasLayer):
    """Multiplicative 1-centered gaussian noise
    (ref: keras/layers/GaussianDropout.scala)."""

    def __init__(self, p: float, **kwargs):
        super().__init__(**kwargs)
        _check_rate(p)
        self.p = p

    def _make_module(self):
        return _GaussianDropoutModule(self.p)


class _SpatialDropoutModule(nn.Module):
    def __init__(self, rate: float, spatial_ndim: int):
        super().__init__()
        self.rate = rate
        self.spatial_ndim = spatial_ndim

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        if not train or self.rate <= 0:
            return x
        # drop whole channels: mask [B, 1, ..., 1, C]
        shape = (x.shape[0],) + (1,) * self.spatial_ndim + (x.shape[-1],)
        keep = torch.empty(shape, device=x.device, dtype=x.dtype).bernoulli_(
            1.0 - self.rate, generator=need_rng(rng, "SpatialDropout"))
        return x * keep / (1.0 - self.rate)


class _SpatialDropoutBase(KerasLayer):
    spatial_ndim = 1

    def __init__(self, p: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        _check_rate(p)
        self.p = p

    def _make_module(self):
        return _SpatialDropoutModule(self.p, self.spatial_ndim)


class SpatialDropout1D(_SpatialDropoutBase):
    """Channel-wise dropout on [B, T, C]
    (ref: keras/layers/SpatialDropout1D.scala; channels-last)."""

    spatial_ndim = 1


class SpatialDropout2D(_SpatialDropoutBase):
    """Channel-wise dropout on [B, H, W, C]
    (ref: keras/layers/SpatialDropout2D.scala)."""

    spatial_ndim = 2


class SpatialDropout3D(_SpatialDropoutBase):
    """Channel-wise dropout on [B, D, H, W, C]
    (ref: keras/layers/SpatialDropout3D.scala)."""

    spatial_ndim = 3


class _GaussianSamplerModule(nn.Module):
    def forward(self, xs, train: bool = False,
                rng: Optional[torch.Generator] = None):
        if not isinstance(xs, (list, tuple)) or len(xs) != 2:
            raise ValueError("GaussianSampler expects [mean, log_var]")
        mean, log_var = xs
        if not train:
            return mean
        eps = _normal(mean, need_rng(rng, "GaussianSampler"))
        return mean + torch.exp(0.5 * log_var) * eps


class GaussianSampler(KerasLayer):
    """VAE reparameterization: sample N(mean, exp(log_var)) while
    training, mean at inference (ref: keras/layers/GaussianSampler.scala
    -- the reference samples unconditionally; returning the mean at
    inference is the standard VAE deployment behavior)."""

    def _make_module(self):
        return _GaussianSamplerModule()
