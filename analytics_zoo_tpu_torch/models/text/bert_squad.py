"""BERT-SQuAD: extractive question answering fine-tune.

The counterpart of ``analytics_zoo_tpu/models/text/bert_squad.py``: the
BERT encoder and a per-token 2-class span head (the shared
``_BERTHeadModule``, under the name ``squad`` as in the reference's
parameter tree) emitting start/end logits, trained with the mean of the
start and end cross-entropies. Pass ``dtype="bfloat16"`` to run the
encoder in bf16 (parameters stay f32; the head, the loss and the span
log-softmax stay f32). On the card, attention runs through the flash
kernels in both directions when ``zoo.ops.attention_impl`` selects them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.models.common import ZooModel, register_model
from analytics_zoo_tpu_torch.models.text.bert_estimators import (
    _BERTHeadModule, _torch_dtype)


def squad_span_loss(preds, labels):
    """Mean of start/end cross-entropies.

    preds: (start_logits [B, L], end_logits [B, L]);
    labels: [B, 2] int (start, end) positions.
    """
    start_logits, end_logits = preds
    labels = torch.as_tensor(labels, device=start_logits.device).long()
    start_ll = F.log_softmax(start_logits.float(), -1)
    end_ll = F.log_softmax(end_logits.float(), -1)
    start_loss = -start_ll.gather(-1, labels[:, 0:1])[:, 0]
    end_loss = -end_ll.gather(-1, labels[:, 1:2])[:, 0]
    return ((start_loss + end_loss) / 2.0).mean()


class BERTForSQuAD(nn.Module):
    """BERT encoder + span head -> (start_logits, end_logits)."""

    def __init__(self, vocab: int, hidden_size: int = 768,
                 n_block: int = 12, n_head: int = 12,
                 intermediate_size: int = 3072,
                 max_position_len: int = 512, hidden_dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.squad = _BERTHeadModule(
            vocab=vocab, num_classes=2, per_token=True,
            hidden_size=hidden_size, n_block=n_block, n_head=n_head,
            intermediate_size=intermediate_size,
            max_position_len=max_position_len,
            hidden_dropout=hidden_dropout, dtype=dtype)

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        start, end = self.squad(x, train=train, rng=rng).unbind(-1)
        return start, end


@register_model
class BERTSQuAD(ZooModel):
    """fit expects x = {"input_ids", optional "token_type_ids" /
    "attention_mask"} (or bare ``input_ids``), y = [B, 2] (start, end)
    positions; predict returns the (start, end) span logits."""

    default_loss = staticmethod(squad_span_loss)
    default_optimizer = "adam"
    default_metrics = ()

    def __init__(self, vocab: int, hidden_size: int = 768,
                 n_block: int = 12, n_head: int = 12,
                 intermediate_size: int = 3072,
                 max_position_len: int = 512,
                 hidden_dropout: float = 0.1, dtype: str = "float32",
                 device=None, seed: int = 0):
        super().__init__(device=device, seed=seed, vocab=vocab,
                         hidden_size=hidden_size, n_block=n_block,
                         n_head=n_head,
                         intermediate_size=intermediate_size,
                         max_position_len=max_position_len,
                         hidden_dropout=hidden_dropout, dtype=dtype)

    def _build_module(self):
        c = self._config
        return BERTForSQuAD(
            vocab=c["vocab"], hidden_size=c["hidden_size"],
            n_block=c["n_block"], n_head=c["n_head"],
            intermediate_size=c["intermediate_size"],
            max_position_len=c["max_position_len"],
            hidden_dropout=c["hidden_dropout"],
            dtype=_torch_dtype(c["dtype"]))

    def _example_input(self):
        return {"input_ids": np.zeros((1, 16), np.int32)}

    @staticmethod
    def decode_spans(start_logits, end_logits,
                     max_answer_len: int = 30) -> np.ndarray:
        """Best (start, end) span per sample with end >= start and
        length <= max_answer_len."""
        start_logits = np.asarray(start_logits)
        end_logits = np.asarray(end_logits)
        b, l = start_logits.shape
        valid = np.triu(np.ones((l, l), bool))
        valid &= ~np.triu(np.ones((l, l), bool), k=max_answer_len)
        out = np.zeros((b, 2), np.int32)
        for i in range(b):
            scores = start_logits[i][:, None] + end_logits[i][None, :]
            scores = np.where(valid, scores, -np.inf)
            out[i] = divmod(int(np.argmax(scores)), l)
        return out
