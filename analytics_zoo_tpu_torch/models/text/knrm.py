"""KNRM: kernel-pooling neural ranking model.

The counterpart of ``analytics_zoo_tpu/models/text/knrm.py`` (Xiong et
al. 2017): query and doc token ids -> one shared embedding -> cosine
translation matrix -> RBF kernel pooling -> ``Dense(1)`` score. Trained
with ``rank_hinge`` on (pos, neg) pairs for ranking, or as 2-class
logits for classification.

Carried over exactly: padding id 0 masked out on both sides, the norm
floor ``1e-8``, the soft-TF clipped at ``1e-10`` before its log and
scaled by 0.01, and the kernels' means spread over [-1, 1] with the
last one the exact-match kernel (mean 1, sigma ``exact_sigma``). The
host helpers ``_groups``, ``_ndcg`` and ``_ap`` behind ``evaluate_ndcg``
and ``evaluate_map`` are the reference's numpy.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.keras.layers.transformer import Dense, Embed
from analytics_zoo_tpu_torch.models.common import ZooModel, register_model


class KNRMNet(nn.Module):
    """int ``[B, L1 + L2]`` (query ++ doc) -> ``[B, 1]`` scores, or
    ``[B, 2, L1 + L2]`` (pos, neg) pairs -> ``[B, 2]`` (what
    ``rank_hinge`` reads; pairs live inside one sample so an epoch's
    shuffle cannot split them); in classification mode ``[B, 2]``
    logits ``(0, score)``."""

    def __init__(self, text1_length: int, text2_length: int, vocab: int,
                 embed_dim: int, kernel_num: int = 21, sigma: float = 0.1,
                 exact_sigma: float = 0.001, target_mode: str = "ranking"):
        super().__init__()
        self.text1_length = text1_length
        self.target_mode = target_mode
        self.embedding = Embed(vocab + 1, embed_dim)
        self.head = Dense(kernel_num, 1)
        ks = kernel_num
        self.register_buffer("mus", torch.tensor(
            [1.0 if i == ks - 1 else -1.0 + (2 * i + 1) / (ks - 1)
             for i in range(ks)], dtype=torch.float32), persistent=False)
        self.register_buffer("sigmas", torch.tensor(
            [exact_sigma if i == ks - 1 else sigma for i in range(ks)],
            dtype=torch.float32), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ids = x.long()
        paired = ids.dim() == 3
        if paired:
            b, two, ll = ids.shape
            ids = ids.reshape(b * two, ll)
        q_ids = ids[:, :self.text1_length]
        d_ids = ids[:, self.text1_length:]
        q, d = self.embedding(q_ids), self.embedding(d_ids)
        qn = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        dn = d / d.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        sim = torch.einsum("bqe,bde->bqd", qn, dn)  # [B, Lq, Ld]
        k = torch.exp(-(sim[..., None] - self.mus).square()
                      / (2 * self.sigmas.square()))  # [B, Lq, Ld, K]
        qmask = (q_ids > 0).float()[:, :, None, None]
        dmask = (d_ids > 0).float()[:, None, :, None]
        k = k * qmask * dmask
        soft_tf = k.sum(dim=2)  # [B, Lq, K]
        log_k = torch.log(soft_tf.clamp_min(1e-10)) * 0.01
        phi = (log_k * qmask[:, :, 0]).sum(dim=1)  # [B, K]
        score = self.head(phi)
        if self.target_mode == "classification":
            return torch.cat([torch.zeros_like(score), score], -1)
        if paired:
            return score.reshape(b, two)
        return score


@register_model
class KNRM(ZooModel):
    """``target_mode``: "ranking" (a score, ``rank_hinge`` on (pos, neg)
    pairs) or "classification" (2-class logits)."""

    default_loss = "rank_hinge"
    default_optimizer = "adam"

    def __init__(self, text1_length: int, text2_length: int,
                 vocab: int = 20000, embed_dim: int = 50,
                 kernel_num: int = 21, sigma: float = 0.1,
                 exact_sigma: float = 0.001, target_mode: str = "ranking",
                 device=None, seed: int = 0):
        if target_mode not in ("ranking", "classification"):
            raise ValueError(f"bad target_mode {target_mode!r}")
        if target_mode == "classification":
            self.default_loss = "sparse_categorical_crossentropy"
        super().__init__(device=device, seed=seed,
                         text1_length=text1_length,
                         text2_length=text2_length, vocab=vocab,
                         embed_dim=embed_dim, kernel_num=kernel_num,
                         sigma=sigma, exact_sigma=exact_sigma,
                         target_mode=target_mode)

    def _build_module(self):
        c = self._config
        return KNRMNet(
            text1_length=c["text1_length"], text2_length=c["text2_length"],
            vocab=c["vocab"], embed_dim=c["embed_dim"],
            kernel_num=c["kernel_num"], sigma=c["sigma"],
            exact_sigma=c["exact_sigma"], target_mode=c["target_mode"])

    def _example_input(self):
        c = self._config
        return np.ones((1, c["text1_length"] + c["text2_length"]),
                       np.int32)

    # ------------------------------------------------- ranking metrics --
    def evaluate_ndcg(self, query_doc_ids, labels, k: int = 5,
                      batch_size: int = 256) -> float:
        """NDCG@k over grouped (query, [docs]) relations:
        ``query_doc_ids`` is ``[N, L1 + L2]``, one row per (q, d) pair;
        ``labels`` a list of per-query relevance lists aligned with
        contiguous row groups."""
        scores = np.asarray(self.predict(query_doc_ids,
                                         batch_size=batch_size)).reshape(-1)
        return float(np.mean([_ndcg(scores[lo:hi], rel, k)
                              for lo, hi, rel in _groups(labels)]))

    def evaluate_map(self, query_doc_ids, labels,
                     batch_size: int = 256) -> float:
        """Mean average precision over the same groups."""
        scores = np.asarray(self.predict(query_doc_ids,
                                         batch_size=batch_size)).reshape(-1)
        return float(np.mean([_ap(scores[lo:hi], rel)
                              for lo, hi, rel in _groups(labels)]))


def _groups(labels):
    lo = 0
    for rel in labels:
        hi = lo + len(rel)
        yield lo, hi, np.asarray(rel, np.float32)
        lo = hi


def _ndcg(scores, rel, k):
    order = np.argsort(-scores)[:k]
    gains = (2 ** rel[order] - 1) / np.log2(np.arange(2, len(order) + 2))
    ideal_order = np.argsort(-rel)[:k]
    ideal = (2 ** rel[ideal_order] - 1) / np.log2(
        np.arange(2, len(ideal_order) + 2))
    denom = ideal.sum()
    return gains.sum() / denom if denom > 0 else 0.0


def _ap(scores, rel):
    order = np.argsort(-scores)
    rel_sorted = rel[order] > 0
    if not rel_sorted.any():
        return 0.0
    precision = np.cumsum(rel_sorted) / np.arange(1, len(rel_sorted) + 1)
    return float((precision * rel_sorted).sum() / rel_sorted.sum())
