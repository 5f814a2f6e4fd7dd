"""Attention dispatch: the flash-attention CUDA kernels (K1 forward, K2
and K3 backward, K5b both ways at other head dims up to 128, K1-K3 at
192, 256, 320, 384, 448 and 512) on the card, plain PyTorch on the CPU.

The counterpart of ``analytics_zoo_tpu/ops/attention.py``, with the same
semantics: the causal diagonal is aligned bottom-right (``tril`` with
``k = lk - lq``), causal with ``lq > lk`` is rejected, ``mask`` is any
``[B, H, Lq, Lk]``-broadcastable tensor with 1 = attend, and
``key_padding_mask`` is ``[B, Lk]`` with 1 = real token. The dispatch
reads the same ``zoo.ops.attention_impl`` and
``zoo.ops.attention_flash_min_seq`` keys and keeps the reference's
flash gates (L and Lk multiples of 128, no ``mask``, no dropout).

A key-padding mask keeps the flash path on the card: K1-K3 take it
(K5a). There the port follows ``_einsum_attention``, not the TPU's stock
kernel. On the TPU the reference hands the mask to JAX's stock Pallas
``flash_attention`` as segment ids, with ``q_seg = kv_seg`` when
``lq == lk``, so a padded query row attends only to padded keys; the
einsum path (and ``reference_attention``) lets every query row attend
to the real keys. The two agree on real rows, which are all that BERT's
losses and metrics read (padding is ``IGNORE_INDEX``); the port gives
the einsum path's values at every row, including a row that sees no key
(the mean of V, see ``flash_attention``).

Where the reference takes the stock kernel at a head_dim that is not a
multiple of 64 (``d <= 128``, causal only at ``lq == lk``, with or
without a key-padding mask; TinyGenLM's prefill, a MiniLM-sized BERT's
fine-tune), the port launches K5b, the same kernels instantiated at that
head dim, through ``flash_attention``: K1 forward, and under autograd
K1-lse, K2 and K3, with the einsum path's semantics at every row as for
K5a. A head dim that is not a multiple of 8 runs zero-padded to the next
one (``flash_attention``).

At a head dim above 128 the reference runs its own Pallas kernels when D
is a multiple of 64 and there is no key-padding mask (its stock-kernel
branch stops at 128), and the einsum path otherwise. The port has K1,
K1-lse, K2 and K3 at D in {192, 256, 320, 384, 448, 512} (TinyGenLM's
prefill at Gemma-2B's head dim of 256 and DeepSeek-V4-Flash's of 512,
causal LMs trained at GPT-J-6B's 256 and at 512) and takes them for
such a call, with or without a gradient. A masked call above 128 takes
the einsum path, as in the reference; so does every D above 512 (the
reference's Pallas kernels, still to port there: ROADMAP section 2,
item 2), with the reference's values.
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


def _flash_route(impl: str, on_cuda: bool, l: int, lk: int, d: int,
                 causal: bool, has_mask: bool, dropout_rate: float,
                 has_key_padding_mask: bool = False,
                 needs_grad: bool = False) -> Optional[str]:
    """Where the reference would take a flash kernel on its accelerator
    and the port has one: "kernels" (K1-K3, with or without a key-padding
    mask up to D = 128, without one at 192 to 512), "k5b" (the stock
    kernel at head_dim % 64 != 0: K5b, forward and backward) or None (the
    einsum path). ``has_mask`` is an arbitrary ``mask``; ``needs_grad``
    says autograd records a gradient through the call. Every route has
    both directions (K1, or K1-lse, K2 and K3), so a gradient no longer
    changes it."""
    if (impl == "einsum" or has_mask or dropout_rate != 0.0
            or not on_cuda or l % 128 or lk % 128):
        return None
    if d > 128:
        # the reference's Pallas kernels at D % 64 == 0, unmasked (its
        # stock-kernel branch stops at 128); the port has K1-K3 up to 512,
        # the rest are still to port (ROADMAP section 2, item 2)
        if has_key_padding_mask or d % 64 or d > 512:
            return None
        return "kernels"
    if d % 64 == 0:
        return "kernels"
    if not causal or l == lk:
        return "k5b"
    return None


def dot_product_attention(q, k, v, mask=None, key_padding_mask=None,
                          causal: bool = False,
                          scale: Optional[float] = None,
                          dropout_rate: float = 0.0,
                          dropout_rng: Optional[torch.Generator] = None):
    """q, k, v: [B, H, L, D]. Returns [B, H, Lq, D]. ``dropout_rng`` is a
    ``torch.Generator`` on the tensors' device, required when
    ``dropout_rate > 0``. The flash path is differentiable at every head
    dim it takes: under autograd on CUDA it runs K1 with logsumexp forward
    and K2/K3 backward (``flash_attention.FlashAttention``), with
    ``key_padding_mask`` when one is given."""
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
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    route = _flash_route(impl, q.is_cuda, l, lk, d, causal,
                         mask is not None, dropout_rate,
                         key_padding_mask is not None, needs_grad)
    if route is not None:
        # "kernels": K1 (K1-lse, K2, K3 under autograd); "k5b": the same
        # kernels at this head dim
        from analytics_zoo_tpu_torch.ops.flash_attention import (
            flash_attention)

        return flash_attention(q, k, v, causal, scale,
                               key_padding_mask=key_padding_mask)

    if key_padding_mask is not None:
        pm = key_padding_mask[:, None, None, :].bool()
        mask = pm if mask is None else (mask.bool() & pm)
    if dropout_rate == 0.0:
        return _einsum_attention(q, k, v, mask=mask, causal=causal,
                                 scale=scale)
    if dropout_rng is None:
        # the reference skips the dropout here; the port refuses to
        raise ValueError(f"attention dropout at rate {dropout_rate} needs "
                         "dropout_rng, a torch.Generator on the tensors' "
                         "device")
    # dropout needs the materialized probs; inline the reference math
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        logits = logits.masked_fill(~_causal_keep(l, lk, q.device), NEG_INF)
    if mask is not None:
        logits = logits.masked_fill(~mask.bool(), NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    keep = torch.empty_like(probs).bernoulli_(1.0 - dropout_rate,
                                              generator=dropout_rng)
    probs = probs * keep / (1.0 - dropout_rate)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)
