"""Normalization with flax's semantics: the counterpart of
``analytics_zoo_tpu/keras/layers/normalization.py``.

``SampledBatchNorm`` and ``batch_norm`` are the image backbones',
``BatchNorm`` is the port's flax ``nn.BatchNorm``, and the Keras layers
``BatchNormalization`` (momentum 0.99, epsilon 1e-3: a ``BatchNorm``
named ``BatchNorm_0``, made at the first forward from the input's last
axis), ``LayerNormalization`` (epsilon 1e-5, a ``LayerNorm_0``) and
``LRN2D`` wrap them. The two batch norms normalize over the last axis (NHWC
images), keep their parameters f32 (``weight`` is flax's ``scale``) and
their running statistics as the f32 buffers ``mean`` and ``var``,
which ``bridge.py`` maps onto the ``batch_stats`` collection.

flax's rules, not ``nn.BatchNorm2d``'s:

- ``momentum`` m is the weight of the old statistics:
  ``ra = m * ra + (1 - m) * batch`` (torch's momentum is 1 - m);
- the running variance folds in the **biased** batch variance (torch
  folds in the unbiased one);
- statistics are taken in f32 (at least), the result is in ``dtype``
  (or the promotion of the input and f32), ``epsilon`` is the caller's;
- ``forward(x, train=False)`` reads the running statistics.

``BatchNorm``'s training forward takes flax's statistics, E[x] and
E[x^2] - E[x]^2 clipped at 0, in f32 (two reductions over the
``[rows, features]`` view, no f32 copy of a bf16 input), normalizes in
one ``torch.native_batch_norm`` pass handed those statistics, and its
backward is ``native_batch_norm_backward`` at the same mean and 1 /
sqrt(var + epsilon): the gradient of flax's formula. (torch's own batch
statistics, by Welford's method, differ from flax's by more than f32
rounding where the variance is small against the squared mean.)
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.layers.base import (FnModule, KerasLayer,
                                                       lazy_child)
from analytics_zoo_tpu_torch.keras.layers.transformer import LayerNorm


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis. ``scale_init`` is the
    initial value of every scale (0 for the residual branches' last
    norm, as ``scale_init=nn.initializers.zeros`` in the reference)."""

    seeded_init = True  # keras.layers.transformer.reset_parameters
    flax_weight_name = "scale"  # learn.optim.param_tree

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-3, dtype: Optional[torch.dtype] = None,
                 scale_init: float = 1.0):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale_init = scale_init
        self.weight = nn.Parameter(torch.full((features,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(self.scale_init)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def _out_dtype(self, x: torch.Tensor) -> torch.dtype:
        return (self.dtype if self.dtype is not None
                else torch.promote_types(x.dtype, torch.float32))

    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        with torch.no_grad():
            self.mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
            self.var.mul_(m).add_(var.detach(), alpha=1.0 - m)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self._out_dtype(x)
        # normalize at the wider of the input's and the result's types
        rows = x.reshape(-1, x.shape[-1]).to(
            torch.promote_types(x.dtype, dt))
        if not train:
            y = F.batch_norm(rows, self.mean, self.var, self.weight,
                             self.bias, False, 0.0, self.epsilon)
        else:
            with torch.no_grad():
                mean, var = batch_stats(rows)
            self._update(mean, var)
            y = _TrainNorm.apply(rows, self.weight, self.bias, mean, var,
                                 self.epsilon)
        return y.reshape(x.shape).to(dt)


def batch_stats(rows: torch.Tensor):
    """flax's batch statistics of ``[rows, features]``, in f32 or the
    input's wider type: E[x] and E[x^2] - E[x]^2 clipped at 0
    (``use_fast_variance``)."""
    n = rows.shape[0]
    dt = torch.promote_types(rows.dtype, torch.float32)
    mean = rows.mean(0, dtype=dt)
    sq = torch.linalg.vector_norm(rows, 2, dim=0, dtype=dt).square() / n
    return mean, torch.clamp(sq - mean.square(), min=0.0)


class _TrainNorm(torch.autograd.Function):
    """``(x - mean) / sqrt(var + eps) * weight + bias`` at the given batch
    statistics, differentiated as batch statistics of ``x``."""

    @staticmethod
    def forward(ctx, rows, weight, bias, mean, var, eps):
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(rows, weight, mean, invstd)
        ctx.eps = eps
        y, _, _ = torch.native_batch_norm(rows, weight, bias, mean, var,
                                          False, 0.0, eps)
        return y

    @staticmethod
    def backward(ctx, gy):
        rows, weight, mean, invstd = ctx.saved_tensors
        gx, gw, gb = torch.ops.aten.native_batch_norm_backward(
            gy.contiguous(), rows, weight, None, None, mean, invstd, True,
            ctx.eps, list(ctx.needs_input_grad[:3]))
        return gx, gw, gb, None, None, None


class SampledBatchNorm(BatchNorm):
    """BatchNorm whose training statistics come from the first
    ``stat_rows`` rows of the batch (0, or a batch no larger, = the
    whole batch), every row still normalized: the reference's opt-in
    trade of a noisier estimate for a smaller statistics pass
    (``zoo.models.bn_stat_rows``). Its arithmetic follows the
    reference's, E[x^2] - E[x]^2 in f32 clipped at 0 and ``x * inv +
    (bias - mean * inv)`` in ``dtype`` (the input's when None); at
    inference, the running statistics through the same formula."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-3, dtype: Optional[torch.dtype] = None,
                 scale_init: float = 1.0, stat_rows: int = 0):
        super().__init__(features, momentum, epsilon, dtype, scale_init)
        self.stat_rows = stat_rows

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            mean, var = self.mean, self.var
        else:
            k = self.stat_rows
            xs = x if k <= 0 or k >= x.shape[0] else x[:k]
            xf = xs.float().reshape(-1, x.shape[-1])
            mean = xf.mean(0)
            var = torch.clamp(xf.square().mean(0) - mean.square(), min=0.0)
            self._update(mean, var)
        dt = self.dtype or x.dtype
        inv = torch.rsqrt(var + self.epsilon) * self.weight
        return x.to(dt) * inv.to(dt) + (self.bias - mean * inv).to(dt)


def batch_norm(dtype: Optional[torch.dtype], momentum: float = 0.9,
               epsilon: float = 1e-3):
    """The backbones' BatchNorm factory: ``BatchNorm``, or
    ``SampledBatchNorm`` when ``zoo.models.bn_stat_rows`` is set. Read
    when the model is built (the reference reads it at trace time); the
    returned constructor takes ``features`` and ``scale_init``."""
    from analytics_zoo_tpu_torch.common.config import get_config

    rows = int(get_config().get("zoo.models.bn_stat_rows", 0) or 0)
    if rows > 0:
        return functools.partial(SampledBatchNorm, momentum=momentum,
                                 epsilon=epsilon, dtype=dtype,
                                 stat_rows=rows)
    return functools.partial(BatchNorm, momentum=momentum, epsilon=epsilon,
                             dtype=dtype)


class _BatchNormModule(nn.Module):
    def __init__(self, momentum: float, epsilon: float):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        bn = lazy_child(self, "BatchNorm_0", lambda: BatchNorm(
            x.shape[-1], momentum=self.momentum, epsilon=self.epsilon), x)
        return bn(x, train=train)


class BatchNormalization(KerasLayer):
    """(ref: keras/layers/BatchNormalization.scala; the running
    statistics are flax's ``batch_stats``, which the Estimator keeps)."""

    def __init__(self, momentum: float = 0.99, epsilon: float = 1e-3,
                 **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.epsilon = epsilon

    def _make_module(self):
        return _BatchNormModule(self.momentum, self.epsilon)


class _LayerNormModule(nn.Module):
    def __init__(self, epsilon: float):
        super().__init__()
        self.epsilon = epsilon

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        ln = lazy_child(self, "LayerNorm_0",
                        lambda: LayerNorm(x.shape[-1], eps=self.epsilon), x)
        return ln(x)


class LayerNormalization(KerasLayer):
    """(ref: TransformerLayer.scala's internal LayerNorm)."""

    def __init__(self, epsilon: float = 1e-5, **kwargs):
        super().__init__(**kwargs)
        self.epsilon = epsilon

    def _make_module(self):
        return _LayerNormModule(self.epsilon)


class LRN2D(KerasLayer):
    """Local response normalization across channels on [B, H, W, C]
    (ref: keras/layers/LRN2D.scala):
    ``x / (k + alpha/n * sum_{local n channels} x^2)^beta``."""

    def __init__(self, alpha: float = 1e-4, k: float = 1.0,
                 beta: float = 0.75, n: int = 5, **kwargs):
        super().__init__(**kwargs)
        self.alpha, self.k, self.beta, self.n = alpha, k, beta, n

    def _make_module(self):
        alpha, k, beta, n = self.alpha, self.k, self.beta, self.n

        def fn(x):
            c = x.shape[-1]
            half = n // 2
            padded = F.pad(x * x, (half, half))
            acc = torch.zeros_like(x)
            for i in range(n):
                acc = acc + padded[..., i:i + c]
            return x / torch.pow(k + (alpha / n) * acc, beta)

        return FnModule(fn)
