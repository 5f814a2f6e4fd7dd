"""BERT fine-tune estimators: sequence classification and NER.

The counterpart of ``analytics_zoo_tpu/models/text/bert_estimators.py``
(``_BERTHeadModule``, ``BERTClassifier``, ``BERTNER`` with
``token_cross_entropy``). The encoder computes in the configured
``dtype`` (``"bfloat16"`` for serving); the head stays f32. ``fit``
trains through the Estimator with the reference's defaults (sparse
categorical cross-entropy, Adam, accuracy for ``BERTClassifier``; the
per-token cross-entropy that skips ``IGNORE_INDEX`` for ``BERTNER``).
A padded batch passes ``attention_mask``, which every encoder layer
hands to attention as its key-padding mask; on the card that keeps the
flash kernels. The SQuAD sibling is ``bert_squad.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.layers.transformer import (
    BERTModule, Dense, dropout)
from analytics_zoo_tpu_torch.models.common import (
    ZooModel, register_model, torch_dtype as _torch_dtype)


class _BERTHeadModule(nn.Module):
    """BERT encoder + a classification head: pooled [CLS] (sequence
    tasks) or every token (NER)."""

    def __init__(self, vocab: int, num_classes: int, per_token: bool,
                 hidden_size: int = 768, n_block: int = 12,
                 n_head: int = 12, intermediate_size: int = 3072,
                 max_position_len: int = 512, hidden_dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.per_token = per_token
        self.hidden_dropout = hidden_dropout
        self.bert = BERTModule(
            vocab=vocab, hidden_size=hidden_size, n_block=n_block,
            n_head=n_head, intermediate_size=intermediate_size,
            max_position_len=max_position_len,
            hidden_dropout=hidden_dropout, attn_dropout=0.0, dtype=dtype)
        self.head = Dense(hidden_size, num_classes)

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        seq, pooled = self.bert(x, train=train, rng=rng)
        h = seq if self.per_token else pooled
        if train:
            h = dropout(h, self.hidden_dropout, rng)
        return self.head(h.float())


class _BERTEstimatorBase(ZooModel):
    default_loss = "sparse_categorical_crossentropy"
    default_optimizer = "adam"
    default_metrics = ("accuracy",)
    per_token = False

    def __init__(self, num_classes: int, vocab: int,
                 hidden_size: int = 768, n_block: int = 12,
                 n_head: int = 12, intermediate_size: int = 3072,
                 max_position_len: int = 512,
                 hidden_dropout: float = 0.1, dtype: str = "float32",
                 device=None, seed: int = 0):
        super().__init__(device=device, seed=seed,
                         num_classes=num_classes, vocab=vocab,
                         hidden_size=hidden_size, n_block=n_block,
                         n_head=n_head,
                         intermediate_size=intermediate_size,
                         max_position_len=max_position_len,
                         hidden_dropout=hidden_dropout, dtype=dtype)

    def _build_module(self):
        c = self._config
        return _BERTHeadModule(
            vocab=c["vocab"], num_classes=c["num_classes"],
            per_token=self.per_token, hidden_size=c["hidden_size"],
            n_block=c["n_block"], n_head=c["n_head"],
            intermediate_size=c["intermediate_size"],
            max_position_len=c["max_position_len"],
            hidden_dropout=c["hidden_dropout"],
            dtype=_torch_dtype(c["dtype"]))

    def _example_input(self):
        return {"input_ids": np.zeros((1, 16), np.int32)}


@register_model
class BERTClassifier(_BERTEstimatorBase):
    """Sequence classification over the pooled [CLS]. Input
    ``{"input_ids", optional "token_type_ids"/"attention_mask"}`` or a
    bare ``input_ids`` tensor; output ``[B, num_classes]`` f32 logits."""

    per_token = False


IGNORE_INDEX = -1


def token_cross_entropy(preds, labels):
    """Per-token mean CE: preds ``[B, L, C]`` logits, labels ``[B, L]``
    ids. Positions labelled ``IGNORE_INDEX`` (-1) -- padding --
    contribute nothing to the loss."""
    c = preds.shape[-1]
    logp = F.log_softmax(preds.float().reshape(-1, c), -1)
    ids = torch.as_tensor(labels, device=preds.device).reshape(-1).long()
    keep = (ids != IGNORE_INDEX).float()
    nll = -logp.gather(-1, ids.clamp(min=0)[:, None])[:, 0]
    return (nll * keep).sum() / keep.sum().clamp(min=1.0)


@register_model
class BERTNER(_BERTEstimatorBase):
    """Token-level tagging. fit expects ``x = {"input_ids",
    "attention_mask", optional "token_type_ids"}`` and ``y = [B, L]``
    int tag ids, with padding positions labelled ``IGNORE_INDEX`` (-1);
    predictions are ``[B, L, num_classes]`` f32 logits."""

    per_token = True
    default_loss = staticmethod(token_cross_entropy)
    default_metrics = ()  # per-token; see token_accuracy

    @staticmethod
    def decode_tags(logits) -> np.ndarray:
        """[B, L, C] logits -> [B, L] argmax tag ids."""
        return np.argmax(np.asarray(logits), axis=-1)

    @staticmethod
    def token_accuracy(logits, labels) -> float:
        """Accuracy over real tokens only (labels == IGNORE_INDEX are
        padding and excluded)."""
        tags = BERTNER.decode_tags(logits)
        labels = np.asarray(labels)
        keep = labels != IGNORE_INDEX
        total = max(int(keep.sum()), 1)
        return float(((tags == labels) & keep).sum() / total)
