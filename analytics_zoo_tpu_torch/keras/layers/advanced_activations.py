"""Advanced activation layers: the counterpart of
``analytics_zoo_tpu/keras/layers/advanced_activations.py`` (ref:
zoo/.../keras/layers/{LeakyReLU,ELU,PReLU,ThresholdedReLU}.scala)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.layers.base import (FnModule, KerasLayer,
                                                       lazy_param)


class LeakyReLU(KerasLayer):
    def __init__(self, alpha: float = 0.3, **kwargs):
        super().__init__(**kwargs)
        self.alpha = alpha

    def _make_module(self):
        a = self.alpha
        return FnModule(lambda x: torch.where(x >= 0, x, a * x))


class ELU(KerasLayer):
    def __init__(self, alpha: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.alpha = alpha

    def _make_module(self):
        a = self.alpha
        return FnModule(lambda x: F.elu(x, alpha=a))


class ThresholdedReLU(KerasLayer):
    def __init__(self, theta: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.theta = theta

    def _make_module(self):
        t = self.theta
        return FnModule(lambda x: torch.where(x > t, x, torch.zeros_like(x)))


class _PReLUModule(nn.Module):
    """``alpha``, one per channel, starts at 0.25."""

    seeded_init = True  # keras.layers.transformer.reset_parameters

    def reset_parameters(self, gen: Optional[torch.Generator] = None):
        if "alpha" in self._parameters:
            with torch.no_grad():
                self.alpha.fill_(0.25)

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        alpha = lazy_param(self, "alpha", (x.shape[-1],), 0.25, x)
        return torch.where(x >= 0, x, alpha * x)


class PReLU(KerasLayer):
    def _make_module(self):
        return _PReLUModule()
