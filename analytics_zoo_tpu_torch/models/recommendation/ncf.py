"""Neural Collaborative Filtering (NCF).

The counterpart of ``analytics_zoo_tpu/models/recommendation/ncf.py``:
GMF (the elementwise product of the mf embeddings) beside an MLP over
the concatenated embeddings, concatenated into class logits. The
modules are the port's flax mirrors (``Embed``, ``Dense`` of
``keras/layers/transformer.py``) under the reference's names
(``mlp_user_embed``, ``mlp_dense_{k}``, ``mf_user_embed``, ``head``,
...), so ``bridge.py`` maps the flax tree with no rename table. Ids are
1-based: each table has ``count + 1`` rows.

Labels are 1-based ratings in ``[1, class_num]``; the loss and the
accuracy shift them to 0-based classes, and predictions name class c as
label c + 1.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.layers.transformer import Dense, Embed
from analytics_zoo_tpu_torch.learn.metrics import Accuracy, Metric
from analytics_zoo_tpu_torch.learn.objectives import (
    sparse_categorical_crossentropy)
from analytics_zoo_tpu_torch.models.common import register_model
from analytics_zoo_tpu_torch.models.recommendation.base import Recommender


class NeuralCFNet(nn.Module):
    """int [B, 2] of 1-based (user, item) ids -> [B, class_num] logits."""

    def __init__(self, user_count: int, item_count: int,
                 class_num: int = 2, user_embed: int = 20,
                 item_embed: int = 20,
                 hidden_layers: Tuple[int, ...] = (40, 20, 10),
                 include_mf: bool = True, mf_embed: int = 20):
        super().__init__()
        self.mlp_user_embed = Embed(user_count + 1, user_embed)
        self.mlp_item_embed = Embed(item_count + 1, item_embed)
        width = user_embed + item_embed
        self.n_hidden = len(hidden_layers)
        for k, units in enumerate(hidden_layers):
            self.add_module(f"mlp_dense_{k}", Dense(width, units))
            width = units
        self.include_mf = include_mf
        if include_mf:
            self.mf_user_embed = Embed(user_count + 1, mf_embed)
            self.mf_item_embed = Embed(item_count + 1, mf_embed)
            width += mf_embed
        self.head = Dense(width, class_num)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        user, item = x[..., 0], x[..., 1]
        h = torch.cat([self.mlp_user_embed(user),
                       self.mlp_item_embed(item)], -1)
        for k in range(self.n_hidden):
            h = F.relu(getattr(self, f"mlp_dense_{k}")(h))
        if self.include_mf:
            h = torch.cat([h, self.mf_user_embed(user)
                           * self.mf_item_embed(item)], -1)
        return self.head(h)


def _shifted_ce(preds, labels):
    """Cross entropy with 1-based rating labels."""
    labels = torch.as_tensor(labels, device=preds.device).reshape(-1)
    return sparse_categorical_crossentropy(preds, labels.long() - 1)


class _RatingAccuracy(Metric):
    """Accuracy against 1-based rating labels."""

    name = "accuracy"
    greater_is_better = True

    def __init__(self):
        self._inner = Accuracy()

    def empty(self, device=None):
        return self._inner.empty(device)

    def update(self, state, preds, labels, weights=None):
        labels = torch.as_tensor(labels, device=preds.device).long() - 1
        return self._inner.update(state, preds, labels, weights)

    def result(self, state):
        return self._inner.result(state)


@register_model
class NeuralCF(Recommender):
    """NCF recommender. Labels are 1-based ratings in ``[1,
    class_num]`` (the MovieLens explicit-feedback convention)."""

    default_loss = staticmethod(_shifted_ce)
    default_optimizer = "adam"

    @property
    def default_metrics(self):
        return (_RatingAccuracy(),)

    def __init__(self, user_count: int, item_count: int, class_num: int = 2,
                 user_embed: int = 20, item_embed: int = 20,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 include_mf: bool = True, mf_embed: int = 20,
                 device=None, seed: int = 0):
        self.user_count = user_count
        self.item_count = item_count
        self.class_num = class_num
        super().__init__(device=device, seed=seed, user_count=user_count,
                         item_count=item_count, class_num=class_num,
                         user_embed=user_embed, item_embed=item_embed,
                         hidden_layers=list(hidden_layers),
                         include_mf=include_mf, mf_embed=mf_embed)

    def _build_module(self):
        c = self._config
        return NeuralCFNet(
            user_count=c["user_count"], item_count=c["item_count"],
            class_num=c["class_num"], user_embed=c["user_embed"],
            item_embed=c["item_embed"],
            hidden_layers=tuple(c["hidden_layers"]),
            include_mf=c["include_mf"], mf_embed=c["mf_embed"])

    def _example_input(self):
        return np.ones((1, 2), np.int32)
