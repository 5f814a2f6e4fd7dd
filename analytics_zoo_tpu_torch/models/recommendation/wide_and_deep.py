"""Wide & Deep recommender.

The counterpart of ``analytics_zoo_tpu/models/recommendation/
wide_and_deep.py``: a linear "wide" path over sparse crossed features
beside a "deep" MLP over embeddings, indicators and continuous
features, their logits summed.

Features are a dict:

- ``wide``       int ``[B, n_wide]``: active indices into the summed wide
                 dimension (1-based, 0 pads);
- ``embed``      int ``[B, n_embed]``: one id per embedding column;
- ``indicator``  float ``[B, sum(indicator_dims)]``: a multi-hot block;
- ``continuous`` float ``[B, n_cont]``.

A key may be missing where its columns are empty. The wide path is a
gather from ``wide_weight`` ``[wide_dim + 1, class_num]`` (row 0 the
pad, masked out of the sum) plus ``wide_bias``, both zero-initialised
and held at the model's top level as in the reference's tree; the deep
path's layers are ``embed_{i}``, ``dense_{k}`` and ``deep_head``.
Labels are 1-based ratings (NCF's loss and accuracy).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.layers.transformer import Dense, Embed
from analytics_zoo_tpu_torch.models.common import register_model
from analytics_zoo_tpu_torch.models.recommendation.base import Recommender
from analytics_zoo_tpu_torch.models.recommendation.ncf import (
    _RatingAccuracy, _shifted_ce)


@dataclass
class ColumnFeatureInfo:
    """The feature columns and their sizes (saved in a model's config as
    a dict)."""

    wide_base_cols: List[str] = field(default_factory=list)
    wide_base_dims: List[int] = field(default_factory=list)
    wide_cross_cols: List[str] = field(default_factory=list)
    wide_cross_dims: List[int] = field(default_factory=list)
    indicator_cols: List[str] = field(default_factory=list)
    indicator_dims: List[int] = field(default_factory=list)
    embed_cols: List[str] = field(default_factory=list)
    embed_in_dims: List[int] = field(default_factory=list)
    embed_out_dims: List[int] = field(default_factory=list)
    continuous_cols: List[str] = field(default_factory=list)

    @property
    def wide_dim(self) -> int:
        return sum(self.wide_base_dims) + sum(self.wide_cross_dims)

    @property
    def indicator_dim(self) -> int:
        return sum(self.indicator_dims)


class WideAndDeepNet(nn.Module):
    """A feature dict -> ``[B, class_num]`` logits."""

    def __init__(self, model_type: str, class_num: int, wide_dim: int,
                 embed_in_dims: Tuple[int, ...],
                 embed_out_dims: Tuple[int, ...], indicator_dim: int,
                 n_continuous: int,
                 hidden_layers: Tuple[int, ...] = (40, 20, 10)):
        super().__init__()
        self.wide = model_type in ("wide_n_deep", "wide")
        self.deep = model_type in ("wide_n_deep", "deep")
        if self.wide:
            self.wide_weight = nn.Parameter(
                torch.zeros(wide_dim + 1, class_num))
            self.wide_bias = nn.Parameter(torch.zeros(class_num))
        if self.deep:
            self.n_embed = len(embed_in_dims)
            self.indicator_dim = indicator_dim
            self.n_continuous = n_continuous
            width = indicator_dim + n_continuous
            for i, (din, dout) in enumerate(zip(embed_in_dims,
                                                embed_out_dims)):
                self.add_module(f"embed_{i}", Embed(din + 1, dout))
                width += dout
            if not width:
                raise ValueError("deep path has no input columns")
            self.n_hidden = len(hidden_layers)
            for k, units in enumerate(hidden_layers):
                self.add_module(f"dense_{k}", Dense(width, units))
                width = units
            self.deep_head = Dense(width, class_num)

    def forward(self, x) -> torch.Tensor:
        logits = None
        if self.wide:
            idx = x["wide"].long()
            gathered = F.embedding(idx, self.wide_weight)
            # pad slots (index 0) add nothing, however many a row has
            gathered = gathered * (idx > 0)[..., None]
            logits = gathered.sum(dim=1) + self.wide_bias
        if self.deep:
            parts = []
            if self.n_embed:
                ids = x["embed"]
                parts += [getattr(self, f"embed_{i}")(ids[:, i])
                          for i in range(self.n_embed)]
            if self.indicator_dim:
                parts.append(x["indicator"].float())
            if self.n_continuous:
                parts.append(x["continuous"].float())
            h = torch.cat(parts, dim=-1)
            for k in range(self.n_hidden):
                h = F.relu(getattr(self, f"dense_{k}")(h))
            deep = self.deep_head(h)
            logits = deep if logits is None else logits + deep
        return logits


@register_model
class WideAndDeep(Recommender):
    """Labels are 1-based ratings. ``column_info`` is a
    ``ColumnFeatureInfo``, its dict, or its fields as keywords."""

    default_loss = staticmethod(_shifted_ce)
    default_optimizer = "adam"

    @property
    def default_metrics(self):
        return (_RatingAccuracy(),)

    def __init__(self, model_type: str = "wide_n_deep", class_num: int = 2,
                 column_info: ColumnFeatureInfo = None,
                 hidden_layers: Sequence[int] = (40, 20, 10), device=None,
                 seed: int = 0, **ci_kwargs):
        if model_type not in ("wide_n_deep", "wide", "deep"):
            raise ValueError(f"unknown model_type {model_type!r}")
        info = column_info or ColumnFeatureInfo(**ci_kwargs)
        if isinstance(info, dict):
            info = ColumnFeatureInfo(**info)
        self.column_info = info
        super().__init__(
            device=device, seed=seed, model_type=model_type,
            class_num=class_num, column_info=dict(info.__dict__),
            hidden_layers=list(hidden_layers))

    def _build_module(self):
        c = self._config
        info = ColumnFeatureInfo(**c["column_info"])
        return WideAndDeepNet(
            model_type=c["model_type"], class_num=c["class_num"],
            wide_dim=info.wide_dim,
            embed_in_dims=tuple(info.embed_in_dims),
            embed_out_dims=tuple(info.embed_out_dims),
            indicator_dim=info.indicator_dim,
            n_continuous=len(info.continuous_cols),
            hidden_layers=tuple(c["hidden_layers"]))

    # the Recommender's ranking methods score candidate (user, item)
    # pairs; W&D scores feature dicts, so a pluggable assembler builds
    # them (from a feature table, a join, ...)
    def set_feature_assembler(self, assembler) -> "WideAndDeep":
        """``assembler(user_ids [N], item_ids [N]) -> feature dict`` (the
        convention of ``fit``); enables ``predict_user_item_pair``,
        ``recommend_for_user`` and ``recommend_for_item``."""
        self._assembler = assembler
        return self

    def _pair_features(self, users, items):
        """Candidate pairs -> feature dict through the assembler (W&D
        defines no user or item universe, so the ranking methods also
        need explicit candidates)."""
        if getattr(self, "_assembler", None) is None:
            raise RuntimeError(
                "WideAndDeep scores feature dicts; call "
                "set_feature_assembler(fn) first (fn(user_ids, "
                "item_ids) -> feature dict), or build features and "
                "call predict directly")
        return self._assembler(np.asarray(users, np.int32),
                               np.asarray(items, np.int32))

    def _example_input(self):
        info = self.column_info
        x = {}
        if self._config["model_type"] in ("wide_n_deep", "wide"):
            x["wide"] = np.zeros(
                (1, max(len(info.wide_base_cols)
                        + len(info.wide_cross_cols), 1)), np.int32)
        if info.embed_cols:
            x["embed"] = np.zeros((1, len(info.embed_cols)), np.int32)
        if info.indicator_dim:
            x["indicator"] = np.zeros((1, info.indicator_dim), np.float32)
        if info.continuous_cols:
            x["continuous"] = np.zeros(
                (1, len(info.continuous_cols)), np.float32)
        return x
