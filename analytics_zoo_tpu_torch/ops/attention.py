"""Attention dispatch: the K1 CUDA kernel on the card, plain PyTorch on
the CPU.

The counterpart of ``analytics_zoo_tpu/ops/attention.py``, with the same
semantics: the causal diagonal is aligned bottom-right (``tril`` with
``k = lk - lq``), causal with ``lq > lk`` is rejected, ``mask`` is any
``[B, H, Lq, Lk]``-broadcastable tensor with 1 = attend, and
``key_padding_mask`` is ``[B, Lk]`` with 1 = real token. The dispatch
reads the same ``zoo.ops.attention_impl`` and
``zoo.ops.attention_flash_min_seq`` keys. Where the reference takes
JAX's stock Pallas kernel (key-padding masks, head_dim not a multiple
of 64), the port has no kernel yet (ROADMAP K5) and raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def _causal_keep(lq: int, lk: int, device) -> torch.Tensor:
    return torch.ones(lq, lk, dtype=torch.bool, device=device).tril(lk - lq)


def reference_attention(q, k, v, mask=None, causal: bool = False,
                        scale: Optional[float] = None):
    """Exact attention in the input dtype (the reference's
    single source of truth)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        keep = _causal_keep(q.shape[2], k.shape[2], q.device)
        logits = logits.masked_fill(~keep, NEG_INF)
    if mask is not None:
        logits = logits.masked_fill(~mask.bool(), NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _einsum_attention(q, k, v, mask=None, causal: bool = False,
                      scale: Optional[float] = None):
    """Scores and softmax in f32, probabilities dropped back to the value
    dtype for the PV product: the reference's dispatched non-flash
    path."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        keep = _causal_keep(q.shape[2], k.shape[2], q.device)
        logits = logits.masked_fill(~keep, NEG_INF)
    if mask is not None:
        logits = logits.masked_fill(~mask.bool(), NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def dot_product_attention(q, k, v, mask=None, key_padding_mask=None,
                          causal: bool = False,
                          scale: Optional[float] = None,
                          dropout_rate: float = 0.0,
                          dropout_rng: Optional[torch.Generator] = None):
    """q, k, v: [B, H, L, D]. Returns [B, H, Lq, D]. ``dropout_rng`` is a
    ``torch.Generator`` on the tensors' device."""
    d = q.shape[-1]
    l, lk = q.shape[2], k.shape[2]
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    if causal and l > lk:
        # with the bottom-right-aligned diagonal the first lq-lk rows
        # attend to nothing; every backend would return garbage for them
        raise ValueError("causal attention requires len(q) <= len(kv)")

    from analytics_zoo_tpu_torch.common.config import get_config

    cfg = get_config()
    impl = cfg.get("zoo.ops.attention_impl")
    if impl == "auto" and max(l, lk) <= int(
            cfg.get("zoo.ops.attention_flash_min_seq")):
        # the threshold is the reference's (measured on a TPU); its
        # H100 crossover is an open question in PERF.md
        impl = "einsum"
    flash_ok = (impl != "einsum"
                and mask is None and dropout_rate == 0.0
                and q.is_cuda
                and l % 128 == 0 and lk % 128 == 0)
    if flash_ok and d % 64 == 0 and key_padding_mask is None:
        from analytics_zoo_tpu_torch.ops.flash_attention import (
            flash_attention)

        return flash_attention(q, k, v, causal, scale)
    if flash_ok and d <= 128 and (not causal or l == lk):
        raise NotImplementedError(
            "flash attention with a key-padding mask or head_dim % 64 != 0 "
            "needs the kv-valid-mask kernel (ROADMAP queue 2, K5), which "
            "the PyTorch port has not ported yet; set "
            "zoo.ops.attention_impl=einsum to take the plain path")

    if key_padding_mask is not None:
        pm = key_padding_mask[:, None, None, :].bool()
        mask = pm if mask is None else (mask.bool() & pm)
    if dropout_rate == 0.0:
        return _einsum_attention(q, k, v, mask=mask, causal=causal,
                                 scale=scale)
    if dropout_rate > 0.0 and dropout_rng is not None:
        # dropout needs the materialized probs; inline the reference math
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
        if causal:
            logits = logits.masked_fill(~_causal_keep(l, lk, q.device),
                                        NEG_INF)
        if mask is not None:
            logits = logits.masked_fill(~mask.bool(), NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        keep = torch.bernoulli(torch.full_like(probs, 1.0 - dropout_rate),
                               generator=dropout_rng)
        probs = probs * keep / (1.0 - dropout_rate)
        return torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return reference_attention(q, k, v, mask=mask, causal=causal,
                               scale=scale)
