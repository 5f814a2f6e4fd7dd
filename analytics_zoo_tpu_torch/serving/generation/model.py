"""Causal-transformer LM with explicit prefill / decode-step math.

The counterpart of ``analytics_zoo_tpu/serving/generation/model.py``: the
same parameter tree (a plain dict of f32 tensors, drawn from
``np.random.RandomState(seed)`` in the reference's order, so one seed
gives bit-identical parameters in both packages) and the same three
functions. The forward splits the way the serving path splits: a
*prefill* over the whole prompt (compute-bound, bucketed on prompt
length; its attention goes through the port's ``dot_product_attention``
with ``causal=True``, which on the card launches K5b at head dims that
are not a multiple of 64) and a *decode step* for one position per slot
against the paged KV pool (memory-bound, fixed shape, stock torch ops).

Pre-LN transformer block; learned positional embeddings; ReLU MLP; no
biases in the projections; all f32, so greedy argmax parity between the
prefill path, the paged decode step and the re-run-the-whole-prefix
reference is a float-noise question with margins, not a dtype question.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import resolve_device

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class GenModelConfig:
    """Geometry of a :class:`TinyGenLM` (and of the KV pool serving
    it -- the engine reads layers/heads/head_dim from here)."""

    vocab: int = 64
    dim: int = 32
    heads: int = 2
    head_dim: int = 16
    layers: int = 2
    max_len: int = 256
    mlp_ratio: int = 2
    seed: int = 0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GenModelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown generation model fields: {sorted(unknown)} "
                f"(known: {sorted(known)})")
        return cls(**{k: int(v) for k, v in d.items()})


def _ln(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * scale + bias


class TinyGenLM:
    """Seeded parameter factory + the prefill / decode-step forwards.

    All methods are functions of ``(params, inputs)``; the engine owns
    the pool, the slot state and the device placement of inputs.
    Callers run them without autograd (the engine under
    ``torch.inference_mode()``)."""

    def __init__(self, config: GenModelConfig):
        self.config = config

    # ------------------------------------------------------- params --
    def init_params(self, pos_len: Optional[int] = None,
                    device=None) -> Dict[str, Any]:
        """Deterministic f32 parameter tree on ``device`` (None = CUDA).
        ``pos_len`` sizes the positional table (the engine passes its
        prefill-ladder top so padded prefill buckets never index past
        it). The draws are the reference's, in its order."""
        c = self.config
        device = resolve_device(device)
        pos_len = int(pos_len or c.max_len)
        rng = np.random.RandomState(c.seed)

        def mat(*shape, scale=None):
            scale = scale if scale is not None else 1.0 / np.sqrt(
                shape[0])
            return torch.from_numpy(
                rng.normal(0.0, scale, shape).astype(np.float32)).to(
                    device)

        def full(value):
            return torch.full((c.dim,), value, dtype=torch.float32,
                              device=device)

        inner = c.heads * c.head_dim
        blocks = []
        for _ in range(c.layers):
            blocks.append({
                "ln1_s": full(1.0), "ln1_b": full(0.0),
                "wq": mat(c.dim, inner), "wk": mat(c.dim, inner),
                "wv": mat(c.dim, inner), "wo": mat(inner, c.dim),
                "ln2_s": full(1.0), "ln2_b": full(0.0),
                "w1": mat(c.dim, c.dim * c.mlp_ratio),
                "w2": mat(c.dim * c.mlp_ratio, c.dim),
            })
        return {
            # the reference's deliberately hot init (unit-scale
            # embeddings and head, strong positional signal): greedy
            # trajectories stay distinct per (prompt, position), so
            # cross-slot contamination cannot hide behind a fixed point
            "embed": mat(c.vocab, c.dim, scale=1.0),
            "pos": mat(pos_len, c.dim, scale=1.0),
            "blocks": blocks,
            "lnf_s": full(1.0),
            "lnf_b": full(0.0),
            "head": mat(c.dim, c.vocab, scale=1.0),
        }

    # ------------------------------------------------------ prefill --
    def prefill(self, params, tokens) -> Tuple[Any, Any, Any]:
        """Full causal forward over ``tokens`` [B, L] (an integer tensor
        on the parameters' device).

        Returns ``(logits [B, L, vocab], k, v)`` with k/v stacked
        [layers, B, L, heads, head_dim] -- the cache chunks the engine
        scatters into the page pool. Attention goes through the ops
        dispatch, so on the card a prefill bucket of 128 tokens or more
        launches the flash kernel (K5b at this model's head dims) when
        ``zoo.ops.attention_impl`` allows it."""
        from analytics_zoo_tpu_torch.ops.attention import (
            dot_product_attention)

        c = self.config
        b, l = tokens.shape
        tokens = tokens.long()
        x = params["embed"][tokens] + params["pos"][:l][None]
        ks, vs = [], []
        for blk in params["blocks"]:
            h = _ln(x, blk["ln1_s"], blk["ln1_b"])
            q = (h @ blk["wq"]).reshape(b, l, c.heads, c.head_dim)
            k = (h @ blk["wk"]).reshape(b, l, c.heads, c.head_dim)
            v = (h @ blk["wv"]).reshape(b, l, c.heads, c.head_dim)
            o = dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True)
            x = x + o.transpose(1, 2).reshape(
                b, l, c.heads * c.head_dim) @ blk["wo"]
            h2 = _ln(x, blk["ln2_s"], blk["ln2_b"])
            x = x + torch.relu(h2 @ blk["w1"]) @ blk["w2"]
            ks.append(k)
            vs.append(v)
        logits = _ln(x, params["lnf_s"], params["lnf_b"]) @ params["head"]
        return logits, torch.stack(ks), torch.stack(vs)

    # -------------------------------------------------- decode step --
    def decode_step(self, params, tokens, positions, gather_kv,
                    write_kv):
        """One position per slot: ``tokens``/``positions`` are [S].

        The cache is abstracted behind two callbacks so this math stays
        pool-layout-agnostic: ``write_kv(layer, k, v)`` commits this
        position's [S, H, D] k/v, ``gather_kv(layer)`` returns the
        slot-table context ``(K, V)`` as [S, T, H, D] plus the
        attendable-position mask [S, T]. Returns logits [S, vocab]."""
        c = self.config
        x = params["embed"][tokens.long()] + params["pos"][positions.long()]
        for li, blk in enumerate(params["blocks"]):
            h = _ln(x, blk["ln1_s"], blk["ln1_b"])
            q = (h @ blk["wq"]).reshape(-1, c.heads, c.head_dim)
            k = (h @ blk["wk"]).reshape(-1, c.heads, c.head_dim)
            v = (h @ blk["wv"]).reshape(-1, c.heads, c.head_dim)
            write_kv(li, k, v)
            bk, bv, mask = gather_kv(li)
            scores = torch.einsum("shd,sthd->sht", q, bk)
            scores = scores / np.sqrt(c.head_dim)
            scores = scores.masked_fill(~mask[:, None, :], NEG_INF)
            probs = torch.softmax(scores, dim=-1)
            o = torch.einsum("sht,sthd->shd", probs.to(bv.dtype), bv)
            x = x + o.reshape(-1, c.heads * c.head_dim) @ blk["wo"]
            h2 = _ln(x, blk["ln2_s"], blk["ln2_b"])
            x = x + torch.relu(h2 @ blk["w1"]) @ blk["w2"]
        return _ln(x, params["lnf_s"], params["lnf_b"]) @ params["head"]

    # ---------------------------------------------------- reference --
    def reference_generate(self, params, prompt, max_new_tokens: int,
                           eos: int = -1) -> np.ndarray:
        """Greedy generation by re-running the full prefill on the
        growing prefix every token -- the unbatched, cache-free
        reference the engine's paged decode is held against. The prefix
        is not padded, so its attention mostly takes the einsum path
        (the reference's own behaviour)."""
        device = params["embed"].device
        toks = list(np.asarray(prompt, np.int32).reshape(-1))
        out = []
        with torch.inference_mode():
            for _ in range(int(max_new_tokens)):
                arr = torch.as_tensor(np.asarray(toks, np.int64)[None],
                                      device=device)
                logits, _, _ = self.prefill(params, arr)
                nxt = int(torch.argmax(logits[0, -1]))
                out.append(nxt)
                toks.append(nxt)
                if eos >= 0 and nxt == eos:
                    break
        return np.asarray(out, np.int32)
