"""Loss functions (objectives).

The counterpart of ``analytics_zoo_tpu/learn/objectives.py``: every loss
is ``fn(preds, labels) -> scalar batch mean`` on tensors, with the same
formulas and clipping constants. Integer labels are cast to int64 for
``gather``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_EPS = 1e-7


def _like(labels, preds: torch.Tensor) -> torch.Tensor:
    """``labels`` as a tensor of ``preds``' dtype and shape."""
    return torch.as_tensor(labels, device=preds.device).to(
        preds.dtype).reshape(preds.shape)


def sparse_categorical_crossentropy(preds, labels, from_logits: bool = True):
    labels = torch.as_tensor(labels, device=preds.device).reshape(-1).long()
    if from_logits:
        logp = F.log_softmax(preds, -1)
    else:
        logp = torch.log(torch.clamp(preds, _EPS, 1.0))
    nll = -logp.gather(-1, labels[:, None])
    return nll.mean()


def categorical_crossentropy(preds, labels, from_logits: bool = True):
    labels = torch.as_tensor(labels, device=preds.device).float()
    if from_logits:
        logp = F.log_softmax(preds, -1)
    else:
        logp = torch.log(torch.clamp(preds, _EPS, 1.0))
    return -(labels * logp).sum(-1).mean()


def binary_crossentropy(preds, labels, from_logits: bool = False):
    y = torch.as_tensor(labels, device=preds.device).float().reshape(
        preds.shape)
    if from_logits:
        return (torch.clamp(preds, min=0) - preds * y +
                torch.log1p(torch.exp(-preds.abs()))).mean()
    p = torch.clamp(preds, _EPS, 1 - _EPS)
    return -(y * torch.log(p) + (1 - y) * torch.log(1 - p)).mean()


def mean_squared_error(preds, labels):
    return torch.square(preds - _like(labels, preds)).mean()


def mean_absolute_error(preds, labels):
    return (preds - _like(labels, preds)).abs().mean()


def mean_absolute_percentage_error(preds, labels):
    y = _like(labels, preds)
    return 100.0 * ((y - preds) / torch.clamp(y.abs(), min=_EPS)).abs().mean()


def mean_squared_logarithmic_error(preds, labels):
    y = _like(labels, preds)
    return torch.square(torch.log1p(torch.clamp(y, min=0)) -
                        torch.log1p(torch.clamp(preds, min=0))).mean()


def hinge(preds, labels):
    y = torch.where(_like(labels, preds) > 0, 1.0, -1.0)
    return torch.clamp(1.0 - y * preds, min=0.0).mean()


def squared_hinge(preds, labels):
    y = torch.where(_like(labels, preds) > 0, 1.0, -1.0)
    return torch.square(torch.clamp(1.0 - y * preds, min=0.0)).mean()


def poisson(preds, labels):
    y = _like(labels, preds)
    return (preds - y * torch.log(preds + _EPS)).mean()


def cosine_proximity(preds, labels):
    y = _like(labels, preds)
    p = preds / torch.clamp(torch.linalg.norm(preds, dim=-1, keepdim=True),
                            min=_EPS)
    y = y / torch.clamp(torch.linalg.norm(y, dim=-1, keepdim=True), min=_EPS)
    return -(p * y).sum(-1).mean()


def kullback_leibler_divergence(preds, labels):
    y = torch.clamp(_like(labels, preds), _EPS, 1.0)
    p = torch.clamp(preds, _EPS, 1.0)
    return (y * torch.log(y / p)).sum(-1).mean()


def rank_hinge(preds, labels, margin: float = 1.0):
    """Pairwise ranking hinge over interleaved (pos, neg) pairs: preds
    [B,2] rows of (pos, neg), or flat [2B] laid out
    pos0,neg0,pos1,neg1,..."""
    flat = preds.reshape(-1)
    pos, neg = flat[0::2], flat[1::2]
    return torch.clamp(margin - pos + neg, min=0.0).mean()


_REGISTRY = {
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "categorical_crossentropy": categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "mse": mean_squared_error, "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error, "mean_absolute_error": mean_absolute_error,
    "mape": mean_absolute_percentage_error,
    "mean_absolute_percentage_error": mean_absolute_percentage_error,
    "msle": mean_squared_logarithmic_error,
    "mean_squared_logarithmic_error": mean_squared_logarithmic_error,
    "hinge": hinge, "squared_hinge": squared_hinge, "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "kld": kullback_leibler_divergence,
    "kullback_leibler_divergence": kullback_leibler_divergence,
    "rank_hinge": rank_hinge,
}


def resolve_loss(loss):
    if callable(loss):
        return loss
    if isinstance(loss, str):
        key = loss.lower()
        if key in _REGISTRY:
            return _REGISTRY[key]
        raise ValueError(f"unknown loss {loss!r}")
    raise TypeError(f"cannot interpret loss {loss!r}")
