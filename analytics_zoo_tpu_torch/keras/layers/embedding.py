"""Embedding layers: the counterpart of
``analytics_zoo_tpu/keras/layers/embedding.py`` (``Embedding``,
``WordEmbedding``, ``SparseEmbedding``, ``SparseDense``).

``Embedding``'s table is the parameter ``weight`` (flax's
``embedding``), drawn as the reference's ``nn.initializers.uniform(
scale=0.05)``: U[0, 0.05), not Keras's +-0.05; given ``weights`` it
starts at those. ``trainable=False`` stops its gradient (the optimizer
then sees zeros, as under ``jax.lax.stop_gradient``). On the card the
gather and its backward are ``F.embedding``'s.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras import activations
from analytics_zoo_tpu_torch.keras.layers.base import KerasLayer
from analytics_zoo_tpu_torch.keras.layers.core import _DenseModule
from analytics_zoo_tpu_torch.keras.layers.transformer import Embed


class _EmbedModule(nn.Module):
    seeded_init = True  # keras.layers.transformer.reset_parameters
    flax_weight_name = "embedding"  # learn.optim.param_tree

    def __init__(self, vocab: int, dim: int,
                 init_weights: Optional[np.ndarray] = None,
                 trainable: bool = True):
        super().__init__()
        self.init_weights = init_weights
        self.trainable = trainable
        self.weight = nn.Parameter(torch.empty(vocab, dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            if self.init_weights is not None:
                self.weight.copy_(torch.from_numpy(self.init_weights))
            else:
                self.weight.uniform_(0.0, 0.05, generator=gen)

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        table = self.weight if self.trainable else self.weight.detach()
        return F.embedding(x.long(), table)


class Embedding(KerasLayer):
    """(ref: keras/layers/Embedding.scala). ids in [0, input_dim)."""

    def __init__(self, input_dim: int, output_dim: int, weights=None,
                 trainable: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.weights = weights
        self.trainable = trainable

    def _make_module(self):
        init = None
        if self.weights is not None:
            init = np.asarray(self.weights, np.float32)
            if init.shape != (self.input_dim, self.output_dim):
                raise ValueError(
                    f"weights shape {init.shape} != "
                    f"{(self.input_dim, self.output_dim)}")
        return _EmbedModule(self.input_dim, self.output_dim, init,
                            self.trainable)


class WordEmbedding(Embedding):
    """Pretrained word vectors, frozen by default
    (ref: keras/layers/WordEmbedding.scala -- loads GloVe; here the
    embedding matrix is passed directly or via ``from_glove``)."""

    def __init__(self, input_dim: int, output_dim: int, weights=None,
                 trainable: bool = False, **kwargs):
        super().__init__(input_dim, output_dim, weights=weights,
                         trainable=trainable, **kwargs)

    @staticmethod
    def from_glove(path: str, word_index: dict, trainable: bool = False
                   ) -> "WordEmbedding":
        """Build from a GloVe text file restricted to ``word_index``
        (word -> id, ids in [1, n]; id 0 is the padding row)."""
        dim = None
        vectors = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip().split(" ")
                word = parts[0]
                if word in word_index:
                    vec = np.asarray(parts[1:], np.float32)
                    dim = len(vec)
                    vectors[word] = vec
        if dim is None:
            raise ValueError(f"no words of word_index found in {path!r}")
        n = max(word_index.values()) + 1
        table = np.zeros((n, dim), np.float32)
        for w, i in word_index.items():
            if w in vectors:
                table[i] = vectors[w]
        return WordEmbedding(n, dim, weights=table, trainable=trainable)


class _SparseEmbedModule(nn.Module):
    """Bags of ids ``[B, K]`` padded with 0 (the "no entry" slot):
    flax's ``nn.Embed`` of ``vocab + 1`` rows as ``embedding``, the pad
    rows masked out, then summed, averaged or divided by sqrt(count)."""

    def __init__(self, vocab: int, dim: int, combiner: str):
        super().__init__()
        if combiner not in ("sum", "mean", "sqrtn"):
            raise ValueError(combiner)
        self.combiner = combiner
        self.embedding = Embed(vocab + 1, dim)

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        ids = x.long()
        emb = self.embedding(ids)                          # [B, K, D]
        mask = (ids > 0).to(emb.dtype)[..., None]          # [B, K, 1]
        summed = torch.sum(emb * mask, dim=-2)
        if self.combiner == "sum":
            return summed
        count = torch.clamp_min(torch.sum(mask, dim=-2), 1.0)
        if self.combiner == "mean":
            return summed / count
        return summed / torch.sqrt(count)


class SparseEmbedding(KerasLayer):
    """Embedding-sum over variable-length id bags encoded as 0-padded
    [B, K] ids (ref: keras/layers/SparseEmbedding.scala over
    SparseTensor input; combiner semantics of
    tf.nn.embedding_lookup_sparse)."""

    def __init__(self, input_dim: int, output_dim: int,
                 combiner: str = "sum", **kwargs):
        super().__init__(**kwargs)
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.combiner = combiner

    def _make_module(self):
        return _SparseEmbedModule(self.input_dim, self.output_dim,
                                  self.combiner)


class SparseDense(KerasLayer):
    """Dense layer over sparse-coded inputs that arrive 0-padded dense
    (ref: keras/layers/SparseDense.scala takes SparseTensor rows): a
    ``Dense``, kept as a type of its own for the API."""

    def __init__(self, output_dim: int, activation=None,
                 bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.output_dim = output_dim
        self.activation = activations.get(activation)
        self.bias = bias

    def _make_module(self):
        return _DenseModule(self.output_dim, self.activation, self.bias)
