"""Merge layers: the counterpart of
``analytics_zoo_tpu/keras/layers/merge.py`` (ref:
zoo/.../keras/layers/Merge.scala -- modes sum/mul/max/ave/concat/dot/cos;
keras functional merge helpers; MM, SelectTable, SplitTensor), raising
where the reference raises."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from analytics_zoo_tpu_torch.keras.layers.base import KerasLayer


class _MergeModule(nn.Module):
    def __init__(self, mode: str, concat_axis: int, dot_axes: int):
        super().__init__()
        self.mode = mode
        self.concat_axis = concat_axis
        self.dot_axes = dot_axes

    def forward(self, xs, train: bool = False,
                rng: Optional[torch.Generator] = None):
        if not isinstance(xs, (list, tuple)):
            raise ValueError("Merge expects a list of inputs")
        mode = self.mode
        if mode == "concat":
            return torch.cat(list(xs), dim=self.concat_axis)
        if mode in ("sum", "ave"):
            out = xs[0]
            for x in xs[1:]:
                out = out + x
            return out / len(xs) if mode == "ave" else out
        if mode == "mul":
            out = xs[0]
            for x in xs[1:]:
                out = out * x
            return out
        if mode == "max":
            out = xs[0]
            for x in xs[1:]:
                out = torch.maximum(out, x)
            return out
        if mode == "dot":
            a, b = xs
            return torch.sum(a * b, dim=self.dot_axes, keepdim=True)
        if mode == "cos":
            a, b = xs
            ax = self.dot_axes
            na = torch.linalg.vector_norm(a, dim=ax, keepdim=True)
            nb = torch.linalg.vector_norm(b, dim=ax, keepdim=True)
            return (torch.sum(a * b, dim=ax, keepdim=True)
                    / torch.clamp_min(na * nb, 1e-7))
        raise ValueError(f"unknown merge mode {mode!r}")


class Merge(KerasLayer):
    def __init__(self, mode: str = "sum", concat_axis: int = -1,
                 dot_axes: int = -1, **kwargs):
        super().__init__(**kwargs)
        self.mode = mode
        self.concat_axis = concat_axis
        self.dot_axes = dot_axes

    def _make_module(self):
        return _MergeModule(self.mode, self.concat_axis, self.dot_axes)


def concatenate(tensors: Sequence, axis: int = -1):
    return Merge(mode="concat", concat_axis=axis)(list(tensors))


def add(tensors: Sequence):
    return Merge(mode="sum")(list(tensors))


def multiply(tensors: Sequence):
    return Merge(mode="mul")(list(tensors))


def average(tensors: Sequence):
    return Merge(mode="ave")(list(tensors))


def maximum(tensors: Sequence):
    return Merge(mode="max")(list(tensors))


def dot(tensors: Sequence, axes: int = -1):
    return Merge(mode="dot", dot_axes=axes)(list(tensors))


class _MMModule(nn.Module):
    def __init__(self, trans_a: bool, trans_b: bool):
        super().__init__()
        self.trans_a = trans_a
        self.trans_b = trans_b

    def forward(self, xs, train: bool = False,
                rng: Optional[torch.Generator] = None):
        if not isinstance(xs, (list, tuple)) or len(xs) != 2:
            raise ValueError("MM expects exactly two input tensors")
        a, b = xs
        if a.ndim not in (2, 3) or b.ndim != a.ndim:
            raise ValueError(
                "MM inputs must both be 2D or both be 3D, got "
                f"{a.ndim}D and {b.ndim}D")
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)


class MM(KerasLayer):
    """Matrix multiply of a two-tensor table, with optional transposes;
    2D inputs multiply directly, 3D inputs batch-multiply
    (ref: zoo/.../keras/layers/InternalMM.scala:37-150)."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False,
                 **kwargs):
        super().__init__(**kwargs)
        self.trans_a = trans_a
        self.trans_b = trans_b

    def _make_module(self):
        return _MMModule(self.trans_a, self.trans_b)


class _SelectTableModule(nn.Module):
    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, xs, train: bool = False,
                rng: Optional[torch.Generator] = None):
        if not isinstance(xs, (list, tuple)):
            raise ValueError("SelectTable expects a table (list) input")
        return xs[self.index]


class SelectTable(KerasLayer):
    """Select element ``index`` (0-based) from a table input -- either a
    list of graph tensors or the output of :class:`SplitTensor`
    (ref: zoo/.../keras/layers/SelectTable.scala:42-60)."""

    def __init__(self, index: int, **kwargs):
        super().__init__(**kwargs)
        self.index = index

    def _make_module(self):
        return _SelectTableModule(self.index)


class _SplitTensorModule(nn.Module):
    def __init__(self, dimension: int, num: int):
        super().__init__()
        self.dimension = dimension
        self.num = num

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        if not 0 <= self.dimension < x.ndim - 1:
            raise ValueError(
                f"dimension must be in [0, {x.ndim - 2}] (0-based, "
                f"batch dim excluded), got {self.dimension}")
        axis = self.dimension + 1  # input dims exclude the batch dim
        if x.shape[axis] % self.num:
            raise ValueError(
                f"dimension {self.dimension} (size {x.shape[axis]}) not "
                f"divisible into {self.num} chunks")
        return tuple(torch.split(x, x.shape[axis] // self.num, dim=axis))


class SplitTensor(KerasLayer):
    """Split a tensor into a ``num``-element table along ``dimension``
    (0-based, batch dim excluded -- the reference's convention,
    ref: zoo/.../keras/layers/SplitTensor.scala:39-58). Pair with
    :class:`SelectTable` to route table elements through a branching
    graph."""

    def __init__(self, dimension: int, num: int, **kwargs):
        super().__init__(**kwargs)
        self.dimension = dimension
        self.num = num

    def _make_module(self):
        return _SplitTensorModule(self.dimension, self.num)
