"""Transformer and BERT layers as ``nn.Module``s.

The counterpart of ``analytics_zoo_tpu/keras/layers/transformer.py``
(``MultiHeadSelfAttention``, ``TransformerBlock``, ``BERTModule``).
Attention goes through ``ops.attention.dot_product_attention``, which
takes the K1 CUDA kernel on the card.

Numerics follow flax's: parameters stay f32; ``Dense`` and ``LayerNorm``
given a ``dtype`` compute in it (LayerNorm statistics in f32); a layer
without one computes in the promotion of its input and f32, so the
embedding LayerNorm, the pooler and the head stay f32.

Parameter names match the reference's flax tree one for one
(``bert.encoder_0.attention.qkv.weight`` is
``params/bert/encoder_0/attention/qkv/kernel``); ``bridge.py`` maps one
onto the other. Dense weights are stored ``[out, in]``, and the fused
qkv projection keeps its section axis: weight ``[3, H, H_in]`` (the
reference's ``[H_in, 3, H]`` kernel with the input axis moved last),
bias ``[3, H]``.

Training passes ``train=True`` and ``rng``, a ``torch.Generator`` on the
activations' device, which every dropout draws from (hidden and
attention-prob dropout alike); a dropout that should run without one
raises rather than being skipped.

The sequence-parallel ring branch of the reference (``seq_axis``) and
``TransformerModule`` are still to be ported (ROADMAP queue 1).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.ops.attention import dot_product_attention


def _out_dtype(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(
        x.dtype, torch.float32)


class Dense(nn.Module):
    """flax ``nn.Dense`` / ``nn.DenseGeneral`` over the last axis:
    ``out_shape`` may be a tuple (the fused qkv's ``(3, H)``)."""

    def __init__(self, in_features: int, out_shape,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.out_shape = (tuple(out_shape) if isinstance(out_shape, tuple)
                          else (int(out_shape),))
        self.in_features = in_features
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(*self.out_shape, in_features))
        self.bias = nn.Parameter(torch.zeros(*self.out_shape))

    def reset_parameters(self, gen: torch.Generator) -> None:
        # lecun_normal, flax's Dense default
        std = 1.0 / math.sqrt(self.in_features)
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=gen)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _out_dtype(x, self.dtype)
        n_out = self.bias.numel()
        y = F.linear(x.to(dt), self.weight.reshape(n_out, -1).to(dt),
                     self.bias.reshape(n_out).to(dt))
        return y.reshape(*x.shape[:-1], *self.out_shape)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: statistics in f32, result in ``dtype``
    (or the promotion of the input and f32)."""

    def __init__(self, features: int, eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(_out_dtype(x, self.dtype))


class Embed(nn.Module):
    """flax ``nn.Embed`` (f32 table)."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, features))

    def reset_parameters(self, gen: torch.Generator) -> None:
        # flax's default embed init: variance scaling, fan_in = features
        std = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=gen)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.weight)


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawing its mask from ``gen`` (``F.dropout``
    takes no generator): each element kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)``, as flax's
    ``nn.Dropout``. Callers apply it only in training."""
    if rate == 0.0:
        return x
    if gen is None:
        raise ValueError(
            f"dropout at rate {rate} in training needs a generator: pass "
            "rng=torch.Generator(device) to the module's forward")
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=gen)
    return x * keep / (1.0 - rate)


def reset_parameters(module: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter of ``module`` from one CPU generator seeded
    with ``seed`` (submodules in registration order)."""
    gen = torch.Generator().manual_seed(int(seed))
    for m in module.modules():
        fn = getattr(m, "reset_parameters", None)
        if fn is not None and isinstance(m, (Dense, LayerNorm, Embed,
                                             BERTModule)):
            fn(gen)
    return module


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, hidden_size: int, n_head: int,
                 attn_dropout: float = 0.0, causal: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 seq_axis: Optional[str] = None):
        super().__init__()
        if seq_axis is not None:
            raise NotImplementedError(
                "seq_axis (ring attention) is not ported yet (ROADMAP "
                "queue 1: parallel and sharded inference)")
        self.hidden_size = hidden_size
        self.n_head = n_head
        self.attn_dropout = attn_dropout
        self.causal = causal
        # fused projection, sections on their own axis (the reference's
        # megatron layout): weight [3, H, H_in], bias [3, H]
        self.qkv = Dense(hidden_size, (3, hidden_size), dtype=dtype)
        self.proj = Dense(hidden_size, hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor, mask=None, key_padding_mask=None,
                train: bool = False, rng: Optional[torch.Generator] = None):
        b, l, _ = x.shape
        hd = self.hidden_size // self.n_head
        qkv = self.qkv(x).reshape(b, l, 3, self.n_head, hd)
        # [B, nh, L, hd] views into the projection: the flash kernels
        # read them in place (strided rows); unbind's backward stacks
        # the three gradients back into one [B, L, 3, nh, hd] tensor
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        out = dot_product_attention(
            q, k, v, mask=mask, key_padding_mask=key_padding_mask,
            causal=self.causal,
            dropout_rate=self.attn_dropout if train else 0.0,
            dropout_rng=rng if train else None)
        out = out.transpose(1, 2).reshape(b, l, self.hidden_size)
        return self.proj(out)


class TransformerBlock(nn.Module):
    """Post-LN encoder-or-decoder block."""

    def __init__(self, hidden_size: int, n_head: int,
                 intermediate_size: int, hidden_dropout: float = 0.1,
                 attn_dropout: float = 0.1, causal: bool = False,
                 activation: str = "gelu", ln_eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None,
                 seq_axis: Optional[str] = None):
        super().__init__()
        self.hidden_dropout = hidden_dropout
        # "gelu" keeps the tanh approximation; "gelu_exact" is the erf
        # form BERT uses -- the two diverge ~1e-3
        self.activation = activation
        self.attention = MultiHeadSelfAttention(
            hidden_size, n_head, attn_dropout=attn_dropout, causal=causal,
            dtype=dtype, seq_axis=seq_axis)
        self.ln_attn = LayerNorm(hidden_size, eps=ln_eps, dtype=dtype)
        self.ffn_in = Dense(hidden_size, intermediate_size, dtype=dtype)
        self.ffn_out = Dense(intermediate_size, hidden_size, dtype=dtype)
        self.ln_ffn = LayerNorm(hidden_size, eps=ln_eps, dtype=dtype)

    def _act(self, t: torch.Tensor) -> torch.Tensor:
        if self.activation == "gelu_exact":
            return F.gelu(t)
        if self.activation == "gelu":
            return F.gelu(t, approximate="tanh")
        return F.relu(t)

    def forward(self, x, mask=None, key_padding_mask=None,
                train: bool = False, rng: Optional[torch.Generator] = None):
        attn = self.attention(x, mask=mask,
                              key_padding_mask=key_padding_mask,
                              train=train, rng=rng)
        if train:
            attn = dropout(attn, self.hidden_dropout, rng)
        x = self.ln_attn(x + attn)
        h = self.ffn_out(self._act(self.ffn_in(x)))
        if train:
            h = dropout(h, self.hidden_dropout, rng)
        return self.ln_ffn(x + h)


class BERTModule(nn.Module):
    """BERT encoder: token + position + segment embeddings, post-LN
    encoder blocks, tanh pooler over [CLS].

    Input: ``input_ids`` [B, L] alone, or a dict with ``input_ids`` and
    optional ``token_type_ids`` / ``attention_mask`` (1 = real token).
    Returns (sequence_output [B, L, H], pooled_output [B, H]).
    """

    def __init__(self, vocab: int, hidden_size: int = 768,
                 n_block: int = 12, n_head: int = 12,
                 intermediate_size: int = 3072,
                 max_position_len: int = 512, type_vocab: int = 2,
                 hidden_dropout: float = 0.1, attn_dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None,
                 seq_axis: Optional[str] = None):
        super().__init__()
        self.n_block = n_block
        self.hidden_dropout = hidden_dropout
        self.token_embed = Embed(vocab, hidden_size)
        self.position_embed = nn.Parameter(
            torch.empty(max_position_len, hidden_size))
        self.segment_embed = Embed(type_vocab, hidden_size)
        self.embed_ln = LayerNorm(hidden_size, eps=1e-12)
        for i in range(n_block):
            self.add_module(f"encoder_{i}", TransformerBlock(
                hidden_size, n_head, intermediate_size,
                hidden_dropout=hidden_dropout, attn_dropout=attn_dropout,
                causal=False, activation="gelu_exact", ln_eps=1e-12,
                dtype=dtype, seq_axis=seq_axis))
        self.pooler = Dense(hidden_size, hidden_size)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.position_embed.normal_(0.0, 0.02, generator=gen)

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        if isinstance(x, dict):
            ids = x["input_ids"]
            segs = x.get("token_type_ids")
            attn_mask = x.get("attention_mask")
        else:
            ids, segs, attn_mask = x, None, None
        l = ids.shape[1]
        h = self.token_embed(ids) + self.position_embed[None, :l]
        if segs is not None:
            h = h + self.segment_embed(segs)
        h = self.embed_ln(h)
        if train:
            h = dropout(h, self.hidden_dropout, rng)
        # the padding mask stays [B, L] (no materialized 4-D mask), as
        # bytes (nonzero = real): the form the flash kernels read, made
        # once here instead of once per layer
        if attn_mask is not None:
            attn_mask = attn_mask.ne(0).view(torch.uint8)
        for i in range(self.n_block):
            h = getattr(self, f"encoder_{i}")(
                h, key_padding_mask=attn_mask, train=train, rng=rng)
        pooled = torch.tanh(self.pooler(h[:, 0]))
        return h, pooled
