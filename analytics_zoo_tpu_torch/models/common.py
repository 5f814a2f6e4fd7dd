"""ZooModel: base class for the built-in model zoo.

The counterpart of ``analytics_zoo_tpu/models/common.py``. A saved
model directory holds ``config.json`` -- ``{"class": <registered class
name>, "config": <constructor kwargs>}``, the reference's schema -- and
``weights/state_dict.pt``, the module's torch ``state_dict``; so
``ZooModel.load_model(path)`` rebuilds the exact model.

Training (``fit``/``evaluate``/``compile``) belongs to the learn slice
of the port (ROADMAP queue 1) and raises until then.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Type

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import resolve_device
from analytics_zoo_tpu_torch.common.log import get_logger
from analytics_zoo_tpu_torch.keras.layers.transformer import reset_parameters
from analytics_zoo_tpu_torch.utils.tree import tree_leaves, tree_map

logger = get_logger(__name__)

_MODEL_REGISTRY: Dict[str, Type["ZooModel"]] = {}

WEIGHTS_FILE = "state_dict.pt"

_LEARN_SLICE = ("training is not ported yet: fit/evaluate/compile arrive "
                "with the learn slice (ROADMAP queue 1)")


class ZooModel:
    """Base: subclasses define ``_build_module() -> nn.Module`` and
    ``_example_input()``, and register with @register_model.

    ``device`` (None = CUDA, raising without a GPU) is where the module
    lives; ``seed`` seeds its initial weights."""

    def __init__(self, device=None, seed: int = 0, **kwargs):
        self._config = dict(kwargs)
        self.device = resolve_device(device)
        module = self._build_module()
        reset_parameters(module, seed)
        self.module = module.to(self.device).eval()

    def _build_module(self) -> torch.nn.Module:
        raise NotImplementedError

    def _example_input(self):
        raise NotImplementedError

    # ------------------------------------------------------------ engine --
    def compile(self, loss=None, optimizer=None, metrics=None, **kwargs):
        raise NotImplementedError(_LEARN_SLICE)

    def fit(self, data, batch_size: int = 256, epochs: int = 1, **kwargs):
        raise NotImplementedError(_LEARN_SLICE)

    def evaluate(self, data, batch_size: int = 256):
        raise NotImplementedError(_LEARN_SLICE)

    def predict(self, data, batch_size: int = 256) -> Any:
        """Batched inference over host arrays (a tensor, or a dict/tuple
        of them sharing the leading axis); returns numpy."""
        leaves = tree_leaves(data)
        n = np.asarray(leaves[0]).shape[0]
        outs = []
        with torch.inference_mode():
            for s in range(0, n, batch_size):
                x = tree_map(lambda a: torch.as_tensor(
                    np.asarray(a)[s:s + batch_size]).to(self.device), data)
                outs.append(tree_map(
                    lambda t: t.float().cpu().numpy(), self.module(x)))
        return _concat(outs)

    # ------------------------------------------------------- persistence --
    def save_model(self, path: str) -> None:
        os.makedirs(os.path.join(path, "weights"), exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump({"class": type(self).__name__,
                       "config": self._config}, f)
        torch.save({k: v.detach().cpu()
                    for k, v in self.module.state_dict().items()},
                   os.path.join(path, "weights", WEIGHTS_FILE))

    @staticmethod
    def load_model(path: str, device=None) -> "ZooModel":
        with open(os.path.join(path, "config.json")) as f:
            meta = json.load(f)
        cls = _MODEL_REGISTRY.get(meta["class"])
        if cls is None:
            raise ValueError(f"unknown model class {meta['class']!r}; "
                             f"known: {sorted(_MODEL_REGISTRY)}")
        model = cls(device=device, **meta["config"])
        state = torch.load(os.path.join(path, "weights", WEIGHTS_FILE),
                           map_location=model.device, weights_only=True)
        model.module.load_state_dict(state)
        return model

    def summary(self) -> str:
        lines = [f"{type(self).__name__}("]
        for k, v in self._config.items():
            lines.append(f"  {k}={v},")
        lines.append(")")
        n = sum(p.numel() for p in self.module.parameters())
        lines.append(f"total params: {n:,}")
        return "\n".join(lines)


def _concat(parts):
    """Concatenate per-batch output trees along the batch axis."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_concat([p[i] for p in parts])
                           for i in range(len(first)))
    return np.concatenate(parts)


def register_model(cls: Type[ZooModel]) -> Type[ZooModel]:
    _MODEL_REGISTRY[cls.__name__] = cls
    return cls
