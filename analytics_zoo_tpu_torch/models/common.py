"""ZooModel: base class for the built-in model zoo.

The counterpart of ``analytics_zoo_tpu/models/common.py``, with its
on-disk layout, so a directory saved by either package loads in the
other: ``config.json`` -- ``{"class": <registered class name>, "config":
<constructor kwargs>}`` -- and ``weights/``, an Estimator checkpoint
(``learn/checkpoint.py``: flax msgpack ``model.<step>`` and
``optim.<step>``, ``meta.<step>.json``, ``latest``); so
``ZooModel.load_model(path)`` rebuilds the exact model, with its
optimizer state and counters (``InferenceModel.load_zoo`` reads the
weights alone).

``fit``, ``evaluate``, ``predict`` and ``compile`` go through an
``Estimator`` (``learn/estimator.py``) built from the subclass's
``default_loss``, ``default_optimizer`` and ``default_metrics``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Sequence, Type

import torch

from analytics_zoo_tpu_torch.bridge import load_flax_into
from analytics_zoo_tpu_torch.common.context import resolve_device
from analytics_zoo_tpu_torch.common.log import get_logger
from analytics_zoo_tpu_torch.keras.layers.transformer import reset_parameters
from analytics_zoo_tpu_torch.learn.checkpoint import load_checkpoint
from analytics_zoo_tpu_torch.learn.estimator import Estimator, recompiled

logger = get_logger(__name__)

_MODEL_REGISTRY: Dict[str, Type["ZooModel"]] = {}


class ZooModel:
    """Base: subclasses define ``_build_module() -> nn.Module`` and
    ``_example_input()`` plus the loss/optimizer/metrics defaults, and
    register with @register_model.

    ``device`` (None = CUDA, raising without a GPU) is where the module
    lives; ``seed`` seeds its initial weights and the Estimator's
    dropout generator."""

    # subclasses override
    default_loss: Any = None
    default_optimizer: Any = "adam"
    default_metrics: Sequence[Any] = ()

    def __init__(self, device=None, seed: int = 0, **kwargs):
        self._config = dict(kwargs)
        self.device = resolve_device(device)
        self.seed = seed
        module = self._build_module()
        reset_parameters(module, seed)
        self.module = module.to(self.device).eval()
        self.estimator = Estimator(
            self.module, loss=self.default_loss,
            optimizer=self.default_optimizer,
            metrics=self.default_metrics, seed=seed, device=self.device)

    def _build_module(self) -> torch.nn.Module:
        raise NotImplementedError

    def _example_input(self):
        raise NotImplementedError

    # ------------------------------------------------------------ engine --
    def compile(self, loss=None, optimizer=None, metrics=None, **kwargs):
        """Re-configure the training engine (Keras-style); trained weights
        carry over (recompiling changes the optimizer, not the model)."""
        self.estimator = recompiled(
            self.estimator, self.module,
            loss=loss if loss is not None else self.default_loss,
            optimizer=(optimizer if optimizer is not None
                       else self.default_optimizer),
            metrics=metrics if metrics is not None else self.default_metrics,
            seed=kwargs.pop("seed", self.seed), device=self.device, **kwargs)
        return self

    def fit(self, data, batch_size: int = 256, epochs: int = 1, **kwargs):
        return self.estimator.fit(data, batch_size=batch_size,
                                  epochs=epochs, **kwargs)

    def evaluate(self, data, batch_size: int = 256):
        return self.estimator.evaluate(data, batch_size=batch_size)

    def predict(self, data, batch_size: int = 256) -> Any:
        """Batched inference over host arrays (an array, or a dict/tuple
        of them sharing the leading axis); returns numpy."""
        return self.estimator.predict(data, batch_size=batch_size)

    # ------------------------------------------------------- persistence --
    def save_model(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump({"class": type(self).__name__,
                       "config": self._config}, f)
        self.estimator.save(os.path.join(path, "weights"))

    @staticmethod
    def load_model(path: str, device=None,
                   with_optim: bool = True) -> "ZooModel":
        """The model saved at ``path`` by either package, with its
        optimizer state and counters; with ``with_optim`` false the
        weights alone (an inference load: no optimizer state is built
        or read)."""
        with open(os.path.join(path, "config.json")) as f:
            meta = json.load(f)
        cls = _MODEL_REGISTRY.get(meta["class"])
        if cls is None:
            raise ValueError(f"unknown model class {meta['class']!r}; "
                             f"known: {sorted(_MODEL_REGISTRY)}")
        model = cls(device=device, **meta["config"])
        weights = os.path.join(path, "weights")
        if with_optim:
            model.estimator.load(weights)
        else:
            variables, _, _ = load_checkpoint(weights, with_optim=False)
            load_flax_into(model.module, variables)
        return model

    def summary(self) -> str:
        lines = [f"{type(self).__name__}("]
        for k, v in self._config.items():
            lines.append(f"  {k}={v},")
        lines.append(")")
        n = sum(p.numel() for p in self.module.parameters())
        lines.append(f"total params: {n:,}")
        return "\n".join(lines)


def register_model(cls: Type[ZooModel]) -> Type[ZooModel]:
    _MODEL_REGISTRY[cls.__name__] = cls
    return cls
