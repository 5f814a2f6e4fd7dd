"""Anomaly detection by LSTM forecasting.

The counterpart of ``analytics_zoo_tpu/models/anomaly.py``: stacked
LSTMs, each followed by dropout in training, then a ``Dense(1)`` head on
the last step predict the next value of a feature series; the
``anomaly_size`` largest forecast errors are flagged (``unroll`` and
``detect_anomalies`` are the reference's numpy).

flax binds the cells at the model's level, so the tree holds
``OptimizedLSTMCell_0..n-1`` and ``head``; each layer runs torch's fused
LSTM (``keras.layers.recurrent.run_fused``). The default optimizer is
RMSprop, optax's (``rsqrt(nu + eps)``, ``learn/optim.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.keras.layers.recurrent import LSTMCell, run_fused
from analytics_zoo_tpu_torch.keras.layers.transformer import Dense, dropout
from analytics_zoo_tpu_torch.models.common import ZooModel, register_model


class AnomalyDetectorNet(nn.Module):
    """float ``[B, unroll, features]`` -> ``[B, 1]``."""

    def __init__(self, in_features: int, hidden_layers: Tuple[int, ...],
                 dropouts: Tuple[float, ...]):
        super().__init__()
        self.dropouts = tuple(dropouts)
        width = in_features
        for i, units in enumerate(hidden_layers):
            self.add_module(f"OptimizedLSTMCell_{i}",
                            LSTMCell(width, units))
            width = units
        self.head = Dense(width, 1)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        for i, rate in enumerate(self.dropouts):
            h = run_fused([getattr(self, f"OptimizedLSTMCell_{i}")], h)
            if train:
                h = dropout(h, rate, rng)
        return self.head(h[:, -1])


@register_model
class AnomalyDetector(ZooModel):
    """Input ``[B, unroll, features]``; the regression target is the
    next value."""

    default_loss = "mse"
    default_optimizer = "rmsprop"
    default_metrics = ("mse",)

    def __init__(self, feature_shape: Sequence[int],
                 hidden_layers: Sequence[int] = (8, 32, 15),
                 dropouts: Sequence[float] = (0.2, 0.2, 0.2), device=None,
                 seed: int = 0):
        if len(hidden_layers) != len(dropouts):
            raise ValueError("hidden_layers and dropouts must align")
        super().__init__(device=device, seed=seed,
                         feature_shape=list(feature_shape),
                         hidden_layers=list(hidden_layers),
                         dropouts=list(dropouts))

    def _build_module(self):
        c = self._config
        return AnomalyDetectorNet(
            in_features=c["feature_shape"][-1],
            hidden_layers=tuple(c["hidden_layers"]),
            dropouts=tuple(c["dropouts"]))

    def _example_input(self):
        return np.zeros((1,) + tuple(self._config["feature_shape"]),
                        np.float32)

    @staticmethod
    def unroll(data, unroll_length: int):
        """Sliding windows: ``[N, F]`` -> (x ``[M, unroll, F]``, y
        ``[M]``), y the next step's first feature."""
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data[:, None]
        n = len(data) - unroll_length
        if n <= 0:
            raise ValueError("series shorter than unroll_length")
        x = np.stack([data[i:i + unroll_length] for i in range(n)])
        y = data[unroll_length:, 0]
        return x, y

    @staticmethod
    def detect_anomalies(y_true, y_pred, anomaly_size: int):
        """Indices (sorted) and threshold of the ``anomaly_size``
        largest forecast errors."""
        y_true = np.asarray(y_true).reshape(-1)
        y_pred = np.asarray(y_pred).reshape(-1)
        dist = np.abs(y_true - y_pred)
        idx = np.argsort(-dist)[:anomaly_size]
        threshold = float(dist[idx[-1]]) if len(idx) else float("inf")
        return np.sort(idx), threshold
