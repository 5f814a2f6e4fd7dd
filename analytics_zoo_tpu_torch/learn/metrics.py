"""Validation metrics.

The counterpart of ``analytics_zoo_tpu/learn/metrics.py``. Each metric is
a state machine over tensors: ``empty(device)`` -> state dict,
``update(state, preds, labels, weights=None)`` -> state (on the device,
no host sync), ``result(state)`` -> scalar tensor. ``weights`` is an
optional [B] 0/1 mask excluding padded samples.
"""

from __future__ import annotations

from typing import Any

import torch

from analytics_zoo_tpu_torch.utils.tree import tree_leaves, tree_map


class Metric:
    name: str = "metric"
    # True if larger is better (used by MaxScore triggers)
    greater_is_better: bool = True

    def empty(self, device=None) -> Any:
        raise NotImplementedError

    def update(self, state: Any, preds, labels, weights=None) -> Any:
        raise NotImplementedError

    def result(self, state: Any):
        raise NotImplementedError


def _batch_weights(preds, weights) -> torch.Tensor:
    leaf = tree_leaves(preds)[0]
    if weights is None:
        return torch.ones(leaf.shape[0], dtype=torch.float32,
                          device=leaf.device)
    return torch.as_tensor(weights, device=leaf.device).float()


class _MeanMetric(Metric):
    """Streaming weighted mean of a per-sample statistic."""

    def empty(self, device=None):
        return {"total": torch.zeros((), device=device),
                "count": torch.zeros((), device=device)}

    def _per_sample(self, preds, labels) -> torch.Tensor:
        """Return a [B] float statistic, one value per sample."""
        raise NotImplementedError

    def update(self, state, preds, labels, weights=None):
        stat = self._per_sample(preds, labels)
        w = _batch_weights(preds, weights)
        return {"total": state["total"] + (stat * w).sum(),
                "count": state["count"] + w.sum()}

    def result(self, state):
        return state["total"] / torch.clamp(state["count"], min=1.0)


class Accuracy(_MeanMetric):
    """Sparse top-1 accuracy; handles [B,C] logits/probs, [B] binary
    scores, or hard predictions."""

    name = "accuracy"

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold

    def _per_sample(self, preds, labels):
        labels = torch.as_tensor(labels, device=preds.device)
        if labels.ndim >= 2 and labels.ndim == preds.ndim and \
                labels.shape[-1] > 1:
            labels = labels.argmax(-1)  # one-hot -> sparse
        labels = labels.reshape(labels.shape[0], -1)[:, 0]
        if preds.ndim > 1 and preds.shape[-1] > 1:
            hard = preds.argmax(-1).reshape(preds.shape[0], -1)[:, 0]
        else:
            flat = preds.reshape(preds.shape[0], -1)[:, 0]
            hard = (flat > self.threshold).long()
        return (hard == labels.to(hard.dtype)).float()


Top1Accuracy = Accuracy


class TopKAccuracy(_MeanMetric):
    def __init__(self, k: int = 5):
        self.k = k
        self.name = f"top{k}_accuracy"

    def _per_sample(self, preds, labels):
        labels = torch.as_tensor(labels, device=preds.device).reshape(-1)
        topk = torch.argsort(preds, dim=-1, stable=True)[:, -self.k:]
        return (topk == labels[:, None].long()).any(-1).float()


def Top5Accuracy():
    return TopKAccuracy(5)


def _rows(preds, labels):
    preds = preds.reshape(preds.shape[0], -1)
    labels = torch.as_tensor(labels, device=preds.device)
    return preds, labels.reshape(labels.shape[0], -1).to(preds.dtype)


class MAE(_MeanMetric):
    name = "mae"
    greater_is_better = False

    def _per_sample(self, preds, labels):
        p, y = _rows(preds, labels)
        return (p - y).abs().mean(-1)


class MSE(_MeanMetric):
    name = "mse"
    greater_is_better = False

    def _per_sample(self, preds, labels):
        p, y = _rows(preds, labels)
        return torch.square(p - y).mean(-1)


class RMSE(MSE):
    name = "rmse"

    def result(self, state):
        return torch.sqrt(super().result(state))


class Loss(_MeanMetric):
    """Mean of a loss function over the eval set. The loss fn returns a
    batch mean, so per-sample values come from vmapping it over
    singleton batches (keeps padding-masked eval exact)."""

    name = "loss"
    greater_is_better = False

    def __init__(self, loss_fn):
        self.loss_fn = loss_fn

    def _per_sample(self, preds, labels):
        def one(p, t):
            return self.loss_fn(tree_map(lambda a: a[None], p),
                                tree_map(lambda a: a[None], t))

        return torch.func.vmap(one)(preds, labels)


class AUC(Metric):
    """Streaming ROC-AUC via fixed-threshold TP/FP histograms (the binned
    estimator TF/Keras uses). ``from_logits=True`` (the default) squashes
    scores with a sigmoid first; pass False for scores in [0, 1]."""

    name = "auc"

    def __init__(self, num_thresholds: int = 200,
                 from_logits: bool = True):
        self.num_thresholds = num_thresholds
        self.from_logits = from_logits

    def empty(self, device=None):
        return {k: torch.zeros(self.num_thresholds, device=device)
                for k in ("tp", "fp", "tn", "fn")}

    def update(self, state, preds, labels, weights=None):
        scores = preds.reshape(-1).float()
        if self.from_logits:
            scores = torch.sigmoid(scores)
        y = torch.as_tensor(labels, device=preds.device).reshape(-1).float()
        w = (torch.ones_like(scores) if weights is None
             else torch.as_tensor(weights, device=preds.device
                                  ).float().reshape(-1))
        eps = 1e-7
        th = torch.linspace(0.0 - eps, 1.0 + eps, self.num_thresholds,
                            device=preds.device)
        pred_pos = (scores[None, :] > th[:, None]).float()
        pos = (y[None, :] > 0.5).float()
        return {
            "tp": state["tp"] + (w * pred_pos * pos).sum(-1),
            "fp": state["fp"] + (w * pred_pos * (1 - pos)).sum(-1),
            "fn": state["fn"] + (w * (1 - pred_pos) * pos).sum(-1),
            "tn": state["tn"] + (w * (1 - pred_pos) * (1 - pos)).sum(-1),
        }

    def result(self, state):
        tpr = state["tp"] / torch.clamp(state["tp"] + state["fn"], min=1e-7)
        fpr = state["fp"] / torch.clamp(state["fp"] + state["tn"], min=1e-7)
        # thresholds ascend -> fpr/tpr descend; integrate with trapezoid
        return ((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0).sum()


class BinaryCrossEntropy(_MeanMetric):
    name = "binary_crossentropy"
    greater_is_better = False

    def _per_sample(self, preds, labels):
        p = torch.clamp(preds.reshape(preds.shape[0], -1), 1e-7, 1 - 1e-7)
        y = torch.as_tensor(labels, device=preds.device).reshape(
            p.shape).float()
        ll = y * torch.log(p) + (1 - y) * torch.log(1 - p)
        return -ll.mean(-1)


_REGISTRY = {
    "accuracy": Accuracy, "acc": Accuracy, "top1": Accuracy,
    "top5": Top5Accuracy, "top5accuracy": Top5Accuracy,
    "mae": MAE, "mse": MSE, "rmse": RMSE, "auc": AUC,
    "binary_crossentropy": BinaryCrossEntropy,
}


def resolve_metric(m) -> Metric:
    if isinstance(m, Metric):
        return m
    if isinstance(m, str):
        key = m.lower().replace("_accuracy", "") if m.lower() in (
            "top5_accuracy",) else m.lower()
        if key in _REGISTRY:
            return _REGISTRY[key]()
        raise ValueError(f"unknown metric {m!r}")
    if callable(m):
        # assume a loss-like callable
        metric = Loss(m)
        metric.name = getattr(m, "__name__", "loss")
        return metric
    raise TypeError(f"cannot interpret metric {m!r}")
