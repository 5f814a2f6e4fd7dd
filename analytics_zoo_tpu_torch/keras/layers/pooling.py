"""Pooling layers: the counterpart of
``analytics_zoo_tpu/keras/layers/pooling.py``, its 12 layers, channels
last.

flax's rules: "SAME" pads as ``convolutional.same_pads`` says (the extra
pad at the end), with -inf for the max and zeros for the average, which
counts the pads (flax's ``avg_pool`` has ``count_include_pad=True``); the
pads are explicit, then ``F.{max,avg}_pool{1,2,3}d`` runs unpadded on
the channels-first view.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.keras.layers.base import FnModule, KerasLayer
from analytics_zoo_tpu_torch.keras.layers.convolutional import (
    _tup, channels_first, channels_last, pad_spatial, same_pads)

_POOL = {("max", 1): F.max_pool1d, ("max", 2): F.max_pool2d,
         ("max", 3): F.max_pool3d, ("avg", 1): F.avg_pool1d,
         ("avg", 2): F.avg_pool2d, ("avg", 3): F.avg_pool3d}


def pool(x: torch.Tensor, op: str, window, strides, padding: str):
    """flax's ``nn.max_pool`` / ``nn.avg_pool`` over channels-last
    ``x``."""
    if padding == "SAME":
        pads = tuple(same_pads(x.shape[1 + i], window[i], strides[i])
                     for i in range(len(window)))
        if any(p for pair in pads for p in pair):
            x = pad_spatial(x, pads, float("-inf") if op == "max" else 0.0)
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    y = _POOL[op, len(window)](channels_first(x), window, strides)
    return channels_last(y)


def _pool_layer(rank, op, name):
    class _Pool(KerasLayer):
        def __init__(self, pool_size=2, strides=None,
                     border_mode: str = "valid", **kwargs):
            super().__init__(**kwargs)
            self.pool_size = _tup(pool_size, rank)
            self.strides = (_tup(strides, rank) if strides is not None
                            else self.pool_size)
            self.border_mode = border_mode.upper()

        def _make_module(self):
            ps, st, pad = self.pool_size, self.strides, self.border_mode
            return FnModule(lambda x: pool(x, op, ps, st, pad))

    _Pool.__name__ = _Pool.__qualname__ = name
    return _Pool


MaxPooling1D = _pool_layer(1, "max", "MaxPooling1D")
MaxPooling2D = _pool_layer(2, "max", "MaxPooling2D")
MaxPooling3D = _pool_layer(3, "max", "MaxPooling3D")
AveragePooling1D = _pool_layer(1, "avg", "AveragePooling1D")
AveragePooling2D = _pool_layer(2, "avg", "AveragePooling2D")
AveragePooling3D = _pool_layer(3, "avg", "AveragePooling3D")


def _global_pool_layer(rank, op, name):
    class _GlobalPool(KerasLayer):
        def _make_module(self):
            axes = tuple(range(1, rank + 1))
            if op == "max":
                return FnModule(lambda x: torch.amax(x, dim=axes))
            return FnModule(lambda x: torch.mean(x, dim=axes))

    _GlobalPool.__name__ = _GlobalPool.__qualname__ = name
    return _GlobalPool


GlobalMaxPooling1D = _global_pool_layer(1, "max", "GlobalMaxPooling1D")
GlobalMaxPooling2D = _global_pool_layer(2, "max", "GlobalMaxPooling2D")
GlobalMaxPooling3D = _global_pool_layer(3, "max", "GlobalMaxPooling3D")
GlobalAveragePooling1D = _global_pool_layer(1, "avg",
                                            "GlobalAveragePooling1D")
GlobalAveragePooling2D = _global_pool_layer(2, "avg",
                                            "GlobalAveragePooling2D")
GlobalAveragePooling3D = _global_pool_layer(3, "avg",
                                            "GlobalAveragePooling3D")
