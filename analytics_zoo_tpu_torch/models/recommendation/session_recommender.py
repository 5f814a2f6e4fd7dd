"""Session-based recommender (GRU4Rec-style).

The counterpart of ``analytics_zoo_tpu/models/recommendation/
session_recommender.py``: an item embedding, stacked GRUs over the
session read at the last step, optionally beside an MLP over the sum of
the user's purchase-history embeddings, then a softmax head over the
item catalog (``item_count + 1`` classes, id 0 the pad).

The history sum takes every slot's embedding, padding id 0's included,
with no mask, as the reference's does. flax binds the GRU cells at the
model's level, so the tree holds ``GRUCell_0..n-1`` beside
``item_embed``, ``mlp_{i}`` and ``head``; each GRU runs torch's fused
recurrence (``keras.layers.recurrent.run_fused``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.layers.recurrent import GRUCell, run_fused
from analytics_zoo_tpu_torch.keras.layers.transformer import Dense, Embed
from analytics_zoo_tpu_torch.learn.objectives import (
    sparse_categorical_crossentropy)
from analytics_zoo_tpu_torch.models.common import (register_model,
                                                   softmax_probs,
                                                   topk_with_probs)
from analytics_zoo_tpu_torch.models.recommendation.base import Recommender


class SessionRecommenderNet(nn.Module):
    """int ``[B, session_length]`` item ids, or ``{"session", "history"}``
    -> ``[B, item_count + 1]`` logits."""

    def __init__(self, item_count: int, item_embed: int,
                 rnn_hidden_layers: Tuple[int, ...], include_history: bool,
                 mlp_hidden_layers: Tuple[int, ...]):
        super().__init__()
        self.include_history = include_history
        self.item_embed = Embed(item_count + 1, item_embed)
        width = item_embed
        self.n_rnn = len(rnn_hidden_layers)
        for i, units in enumerate(rnn_hidden_layers):
            self.add_module(f"GRUCell_{i}", GRUCell(width, units))
            width = units
        if include_history:
            hist_width = item_embed
            self.n_mlp = len(mlp_hidden_layers)
            for i, units in enumerate(mlp_hidden_layers):
                self.add_module(f"mlp_{i}", Dense(hist_width, units))
                hist_width = units
            width += hist_width
        self.head = Dense(width, item_count + 1)

    def forward(self, x) -> torch.Tensor:
        if isinstance(x, dict):
            session, history = x["session"], x.get("history")
        else:
            session, history = x, None
        h = self.item_embed(session)
        for i in range(self.n_rnn):
            h = run_fused([getattr(self, f"GRUCell_{i}")], h)
        h = h[:, -1]
        if self.include_history and history is not None:
            hist = self.item_embed(history).sum(dim=1)
            for i in range(self.n_mlp):
                hist = F.relu(getattr(self, f"mlp_{i}")(hist))
            h = torch.cat([h, hist], dim=-1)
        return self.head(h)


def _next_item_ce(preds, labels):
    """Cross entropy against the next item id."""
    labels = torch.as_tensor(labels, device=preds.device).reshape(-1)
    return sparse_categorical_crossentropy(preds, labels.long())


@register_model
class SessionRecommender(Recommender):
    """Item ids are 1-based; labels are the next item id."""

    default_loss = staticmethod(_next_item_ce)
    default_optimizer = "adam"
    default_metrics = ("top5",)

    def __init__(self, item_count: int, item_embed: int = 100,
                 rnn_hidden_layers: Sequence[int] = (40, 20),
                 session_length: int = 10, include_history: bool = False,
                 mlp_hidden_layers: Sequence[int] = (40, 20),
                 history_length: int = 5, device=None, seed: int = 0):
        self.item_count = item_count
        super().__init__(
            device=device, seed=seed, item_count=item_count,
            item_embed=item_embed,
            rnn_hidden_layers=list(rnn_hidden_layers),
            session_length=session_length,
            include_history=include_history,
            mlp_hidden_layers=list(mlp_hidden_layers),
            history_length=history_length)

    def _build_module(self):
        c = self._config
        return SessionRecommenderNet(
            item_count=c["item_count"], item_embed=c["item_embed"],
            rnn_hidden_layers=tuple(c["rnn_hidden_layers"]),
            include_history=c["include_history"],
            mlp_hidden_layers=tuple(c["mlp_hidden_layers"]))

    def _example_input(self):
        c = self._config
        x = {"session": np.ones((1, c["session_length"]), np.int32)}
        if c["include_history"]:
            x["history"] = np.ones((1, c["history_length"]), np.int32)
        return x

    def recommend_for_session(self, sessions, max_items: int = 5,
                              zero_based_label: bool = False,
                              batch_size: int = 256):
        """Top-K next items per session: ``[(item_id, prob), ...]`` per
        row; ``zero_based_label`` shifts the ids to a 0-based catalog."""
        probs = softmax_probs(self.predict(sessions, batch_size=batch_size))
        probs[:, 0] = 0.0  # id 0 is padding, never recommended
        top = topk_with_probs(probs, max_items)
        if zero_based_label:
            top = [[(i - 1, p) for i, p in row] for row in top]
        return top

    # the session API replaces pair scoring: the inherited pair methods
    # would embed user ids as items
    def predict_user_item_pair(self, pairs, batch_size: int = 1024):
        raise NotImplementedError(
            "SessionRecommender recommends from item sessions; use "
            "recommend_for_session")

    def recommend_for_user(self, *a, **k):
        raise NotImplementedError(
            "SessionRecommender has no user ids; use "
            "recommend_for_session")

    def recommend_for_item(self, *a, **k):
        raise NotImplementedError(
            "SessionRecommender has no user ids; use "
            "recommend_for_session")
