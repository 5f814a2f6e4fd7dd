"""Activation registry: the counterpart of
``analytics_zoo_tpu/keras/activations.py``, the same 14 names on torch
ops, in flax's forms: ``gelu`` is the tanh approximation (``jax.nn.gelu``'s
default), ``hard_sigmoid`` is ``clip(0.2 x + 0.5, 0, 1)``, and softmax and
log_softmax run over the last axis."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F


def linear(x):
    return x


def hard_sigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


_ACTIVATIONS = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "hard_sigmoid": hard_sigmoid,
    "linear": linear,
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "silu": F.silu,
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
}


def get(name: Optional[Union[str, Callable]]) -> Callable:
    if name is None:
        return linear
    if callable(name):
        return name
    key = name.lower()
    if key not in _ACTIVATIONS:
        raise ValueError(
            f"unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[key]
