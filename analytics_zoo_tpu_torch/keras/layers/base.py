"""KerasLayer base: a declarative layer config that builds an
``nn.Module``.

The counterpart of ``analytics_zoo_tpu/keras/layers/base.py``. Every
built module has the uniform signature ``forward(x, train=False,
rng=None)`` (``rng``: the ``torch.Generator`` that dropout and noise
draw from in training), so Sequential and graph execution thread both
blindly.

Shapes are known only when data arrives, as under flax's ``init``: a
layer whose parameters depend on its input width makes them at its
first forward (``lazy_child``, ``lazy_param``), on the input's device,
unfilled; ``KerasNet`` runs that forward on a one-row probe batch and
then fills every parameter from a seeded generator
(``keras.layers.transformer.reset_parameters``). Parameter and module
names are flax's (``Dense_0``, ``gate``, ``alpha``), so ``bridge.py``
and the checkpoints map them one for one.

``build()`` makes a new module at each call: a model builds each of its
layers once (a layer called twice in one graph shares its parameters),
and a layer put into two models gets parameters of its own in each, as
each of the reference's Estimators inits its own.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional

import torch
from torch import nn

_uid = itertools.count()


class KerasLayer:
    def __init__(self, name: Optional[str] = None, input_shape=None):
        self.name = name or f"{type(self).__name__.lower()}_{next(_uid)}"
        self.input_shape = (tuple(input_shape)
                            if input_shape is not None else None)

    def build(self) -> nn.Module:
        """A new (unmaterialized) module implementing this layer."""
        return self._make_module()

    def _make_module(self) -> nn.Module:
        raise NotImplementedError

    def __call__(self, x):
        """Symbolic call on KTensor(s): records a graph Node."""
        from analytics_zoo_tpu_torch.keras.engine import KTensor, Node

        inputs = list(x) if isinstance(x, (list, tuple)) else [x]
        if not all(isinstance(t, KTensor) for t in inputs):
            raise TypeError(
                "layers are called on symbolic KTensors (from Input()); "
                "to run on data, put the layer in a Sequential/Model and "
                "call predict")
        node = Node(self, inputs)
        return KTensor(node)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"


class FnModule(nn.Module):
    """Stateless layer module from a pure function."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        return self.fn(x)


def lazy_child(module: nn.Module, name: str, make: Callable[[], nn.Module],
               x: torch.Tensor) -> nn.Module:
    """``module``'s child ``name``, made by ``make()`` on ``x``'s device
    at the first call (flax's compact submodule)."""
    child = module._modules.get(name)
    if child is None:
        with torch.device(x.device):
            child = make()
        module.add_module(name, child)
    return child


def lazy_param(module: nn.Module, name: str, shape, value: float,
               x: torch.Tensor) -> nn.Parameter:
    """``module``'s parameter ``name``, made at the first call as
    ``shape`` filled with ``value`` on ``x``'s device (flax's compact
    ``self.param`` with a constant initializer). The module refills it
    in ``reset_parameters``."""
    p = module._parameters.get(name)
    if p is None:
        p = nn.Parameter(torch.full(tuple(shape), float(value),
                                    device=x.device))
        module.register_parameter(name, p)
    return p


def need_rng(rng: Optional[torch.Generator], layer: str
             ) -> torch.Generator:
    """The training generator, or a ValueError naming ``layer``."""
    if rng is None:
        raise ValueError(
            f"{layer} in training needs a generator: pass "
            "rng=torch.Generator(device) to the model's forward")
    return rng
