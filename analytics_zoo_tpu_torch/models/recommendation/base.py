"""Recommender base: user/item pair scoring and top-K recommendation.

The counterpart of ``analytics_zoo_tpu/models/recommendation/base.py``:
candidate (user, item) pairs are scored in batches through ``predict``
and ranked by probability on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from analytics_zoo_tpu_torch.models.common import ZooModel, softmax_probs


@dataclass
class UserItemFeature:
    user_id: int
    item_id: int
    label: int = 0


@dataclass
class UserItemPrediction:
    user_id: int
    item_id: int
    prediction: int
    probability: float


class Recommender(ZooModel):
    """Subclasses score (user, item) int pairs via predict()."""

    def _pair_matrix(self, users, items) -> np.ndarray:
        return np.stack([np.asarray(users, np.int32),
                         np.asarray(items, np.int32)], axis=1)

    def _pair_features(self, users, items):
        """Model input for (user, item) candidate pairs: the raw id
        matrix (a model that scores richer features overrides this)."""
        return self._pair_matrix(users, items)

    def _candidate_range(self, count_attr: str, what: str) -> np.ndarray:
        count = getattr(self, count_attr, None)
        if count is None:
            raise ValueError(
                f"{type(self).__name__}.recommend needs explicit "
                f"candidate_{what} (the model defines no {what} "
                "universe)")
        return np.arange(1, count + 1)

    def _scored(self, users, items, batch_size) -> List[UserItemPrediction]:
        probs = self.predict(self._pair_features(users, items),
                             batch_size=batch_size)
        return [self._to_prediction(int(u), int(i), p)
                for u, i, p in zip(users, items, probs)]

    def predict_user_item_pair(
            self, pairs: Sequence[UserItemFeature],
            batch_size: int = 1024) -> List[UserItemPrediction]:
        return self._scored([p.user_id for p in pairs],
                            [p.item_id for p in pairs], batch_size)

    def recommend_for_user(self, user_id: int, max_items: int,
                           candidate_items: Sequence[int] = None,
                           batch_size: int = 1024
                           ) -> List[UserItemPrediction]:
        """Top-K items for one user, by probability."""
        items = np.asarray(candidate_items if candidate_items is not None
                           else self._candidate_range("item_count",
                                                      "items"), np.int32)
        preds = self._scored(np.full_like(items, user_id), items,
                             batch_size)
        preds.sort(key=lambda r: -r.probability)
        return preds[:max_items]

    def recommend_for_item(self, item_id: int, max_users: int,
                           candidate_users: Sequence[int] = None,
                           batch_size: int = 1024
                           ) -> List[UserItemPrediction]:
        """Top-K users for one item, by probability."""
        users = np.asarray(candidate_users if candidate_users is not None
                           else self._candidate_range("user_count",
                                                      "users"), np.int32)
        preds = self._scored(users, np.full_like(users, item_id),
                             batch_size)
        preds.sort(key=lambda r: -r.probability)
        return preds[:max_users]

    def _to_prediction(self, user, item, probs) -> UserItemPrediction:
        probs = np.asarray(probs).reshape(-1)
        if probs.shape[0] > 1:  # class logits -> softmax
            sm = softmax_probs(probs[None])[0]
            cls = int(np.argmax(sm))
            # class index c encodes label c + 1 (ratings are 1-based)
            return UserItemPrediction(int(user), int(item), cls + 1,
                                      float(sm[cls]))
        score = float(1.0 / (1.0 + np.exp(-probs[0])))
        return UserItemPrediction(int(user), int(item),
                                  int(score > 0.5), score)
