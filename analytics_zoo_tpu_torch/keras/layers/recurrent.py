"""Recurrent layers: the counterpart of
``analytics_zoo_tpu/keras/layers/recurrent.py`` (``SimpleRNN``,
``LSTM``, ``GRU``, ``ConvLSTM2D``, ``ConvLSTM3D``, ``Bidirectional``,
``TimeDistributed``).

The parameters are flax's cells', under flax's names: an LSTM holds
``OptimizedLSTMCell_0`` with ``ii/if/ig/io`` (no bias) and
``hi/hf/hg/ho`` (bias), a GRU ``GRUCell_0`` with ``ir/iz/in`` (bias),
``hr/hz`` (none) and ``hn`` (bias), a SimpleRNN ``SimpleCell_0`` with
``i`` (bias) and ``h`` (none), each a ``Dense``; input kernels draw
flax's ``lecun_normal``, recurrent ones an orthogonal matrix, biases 0.

The recurrence is torch's fused RNN (cuDNN's on the card), handed flat
weights assembled from those at each forward: torch's gate order (i, f,
g, o for the LSTM; r, z, n for the GRU) with the hidden biases as
``b_ih`` and zeros as ``b_hh``, except the GRU's ``hn`` bias, which sits
inside r * (W_hn h + b_hn) in both. The Keras layers' carry starts at
zeros; ``run_fused`` also takes an initial carry and returns the final
one (the zoo's Seq2seq hands its encoder's carries to its decoder).
``go_backwards`` runs the reversed sequence and flips the outputs back
(flax's ``nn.RNN(reverse=True, keep_order=True)``), so without
``return_sequences`` the last state is at position 0. ``Bidirectional``
over a recurrent layer runs both directions in one bidirectional call.

``ConvLSTM*`` is flax's ``ConvLSTMCell``: ``ih`` and ``hh`` convolutions
("SAME", bias) whose output splits into i, g, f, o, with 1 added to f
before its sigmoid; ``ih`` runs once over every step, ``hh`` once a
step.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from analytics_zoo_tpu_torch.keras.layers.base import KerasLayer, lazy_child
from analytics_zoo_tpu_torch.keras.layers.convolutional import Conv
from analytics_zoo_tpu_torch.keras.layers.transformer import Dense


class RecurrentDense(Dense):
    """A cell's hidden-to-hidden ``Dense``: flax's ``orthogonal()``
    kernel."""

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            nn.init.orthogonal_(self.weight, generator=gen)
            if self.bias is not None:
                self.bias.zero_()


class _Cell(nn.Module):
    """A flax cell's Dense children: ``i{g}`` on the input and
    ``h{g}`` on the carry, for each gate ``g`` in torch's order."""

    gates = ()
    input_bias = False
    hidden_bias = ()  # the gates whose hidden Dense has a bias
    fused = None  # torch._VF's function

    def __init__(self, in_features: int, units: int):
        super().__init__()
        self.units = units
        for g in self.gates:
            self.add_module(f"i{g}", Dense(in_features, units,
                                           use_bias=self.input_bias))
        for g in self.gates:
            self.add_module(f"h{g}", RecurrentDense(
                units, units, use_bias=g in self.hidden_bias))

    def flat_weights(self) -> List[torch.Tensor]:
        """``[w_ih, w_hh, b_ih, b_hh]`` in torch's layout."""
        m = self._modules
        w_ih = torch.cat([m[f"i{g}"].weight for g in self.gates])
        w_hh = torch.cat([m[f"h{g}"].weight for g in self.gates])
        zero = w_ih.new_zeros(self.units)
        if self.input_bias:
            b_ih = torch.cat([m[f"i{g}"].bias for g in self.gates])
        else:
            b_ih = torch.cat([m[f"h{g}"].bias for g in self.gates])
        b_hh = torch.cat([m[f"h{g}"].bias
                          if self.input_bias and g in self.hidden_bias
                          else zero for g in self.gates])
        return [w_ih, w_hh, b_ih, b_hh]


class LSTMCell(_Cell):
    """flax ``nn.OptimizedLSTMCell``."""

    gates = ("i", "f", "g", "o")
    hidden_bias = gates
    fused = "lstm"


class GRUCell(_Cell):
    """flax ``nn.GRUCell``."""

    gates = ("r", "z", "n")
    input_bias = True
    hidden_bias = ("n",)
    fused = "gru"


class SimpleCell(_Cell):
    """flax ``nn.SimpleCell`` (tanh)."""

    gates = ("",)
    input_bias = True
    fused = "rnn_tanh"


_CELLS = {"lstm": ("OptimizedLSTMCell_0", LSTMCell),
          "gru": ("GRUCell_0", GRUCell),
          "simple": ("SimpleCell_0", SimpleCell)}


def run_fused(cells: List[_Cell], x: torch.Tensor, initial_carry=None,
              return_carry: bool = False):
    """Every step's output ``[B, T, H * len(cells)]`` of torch's fused
    RNN over ``x`` ``[B, T, C]``: one cell forward, or two (forward,
    backward) run as one bidirectional call.

    With one cell, ``initial_carry`` is a carry in flax's form (the
    LSTM's ``(c, h)``, the GRU's and SimpleRNN's ``h``, each ``[B, H]``;
    default zeros), and ``return_carry`` returns ``(final carry,
    outputs)`` as flax's ``nn.RNN(..., return_carry=True)``. torch's
    LSTM state is ``(h, c)``: the two are swapped here and nowhere
    else."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    kind = cells[0].fused
    if (initial_carry is not None or return_carry) and len(cells) > 1:
        raise ValueError("an initial or final carry needs one cell")
    weights = [w for c in cells for w in c.flat_weights()]
    if initial_carry is None:
        h0 = x.new_zeros(len(cells), x.shape[0], cells[0].units)
        hx = (h0, h0) if kind == "lstm" else h0
    elif kind == "lstm":
        c0, h0 = initial_carry
        hx = (h0.to(x.dtype)[None].contiguous(),
              c0.to(x.dtype)[None].contiguous())
    else:
        hx = initial_carry.to(x.dtype)[None].contiguous()
    # cuDNN keeps what its backward needs only in training mode
    out = getattr(torch._VF, kind)(x, hx, weights, True, 1, 0.0,
                                   torch.is_grad_enabled(), len(cells) > 1,
                                   True)
    if not return_carry:
        return out[0]
    carry = (out[2][0], out[1][0]) if kind == "lstm" else out[1][0]
    return carry, out[0]


class ConvLSTMCell(nn.Module):
    """flax ``nn.ConvLSTMCell`` (strides 1, "SAME", bias)."""

    def __init__(self, in_features: int, units: int, kernel):
        super().__init__()
        self.units = units
        self.ih = Conv(in_features, 4 * units, kernel, padding="SAME")
        self.hh = Conv(units, 4 * units, kernel, padding="SAME")

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """Every step's hidden state of ``x`` ``[B, T, *spatial, C]``."""
        b, t = x.shape[:2]
        xs = self.ih(x.reshape((b * t,) + x.shape[2:]))
        xs = xs.reshape((b, t) + xs.shape[1:])
        h = xs.new_zeros(xs.shape[:1] + xs.shape[2:-1] + (self.units,))
        c = torch.zeros_like(h)
        outs = []
        for step in range(t):
            gates = xs[:, step] + self.hh(h)
            i, g, f, o = torch.split(gates, self.units, dim=-1)
            f = torch.sigmoid(f + 1.0)
            c = f * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=1)


def _last(seq: torch.Tensor, reverse: bool, return_sequences: bool):
    if return_sequences:
        return seq
    return seq[:, 0 if reverse else -1]


class _RNNModule(nn.Module):
    def __init__(self, cell_type: str, units: int, return_sequences: bool,
                 reverse: bool = False, conv_kernel=None):
        super().__init__()
        self.cell_type = cell_type
        self.units = units
        self.return_sequences = return_sequences
        self.reverse = reverse
        self.conv_kernel = conv_kernel

    def cell(self, x: torch.Tensor) -> nn.Module:
        """The cell, made at the first call from ``x``'s width."""
        if self.cell_type == "convlstm":
            return lazy_child(self, "ConvLSTMCell_0", lambda: ConvLSTMCell(
                x.shape[-1], self.units, self.conv_kernel), x)
        name, cls = _CELLS[self.cell_type]
        return lazy_child(self, name,
                          lambda: cls(x.shape[-1], self.units), x)

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        cell = self.cell(x)
        if self.reverse:
            x = x.flip(1)
        seq = (cell.run(x) if isinstance(cell, ConvLSTMCell)
               else run_fused([cell], x))
        if self.reverse:
            seq = seq.flip(1)
        return _last(seq, self.reverse, self.return_sequences)


class _RecurrentBase(KerasLayer):
    cell_type = "simple"

    def __init__(self, output_dim: int, return_sequences: bool = False,
                 go_backwards: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.output_dim = output_dim
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards

    def _make_module(self):
        return _RNNModule(self.cell_type, self.output_dim,
                          self.return_sequences, reverse=self.go_backwards)


class SimpleRNN(_RecurrentBase):
    cell_type = "simple"


class LSTM(_RecurrentBase):
    cell_type = "lstm"


class GRU(_RecurrentBase):
    cell_type = "gru"


class _ConvLSTMBase(KerasLayer):
    rank = 2

    def __init__(self, nb_filter: int, nb_kernel: int,
                 return_sequences: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = nb_filter
        self.nb_kernel = nb_kernel
        self.return_sequences = return_sequences

    def _make_module(self):
        return _RNNModule("convlstm", self.nb_filter, self.return_sequences,
                          conv_kernel=(self.nb_kernel,) * self.rank)


class ConvLSTM2D(_ConvLSTMBase):
    """x: [B, T, H, W, C] (ref: keras/layers/ConvLSTM2D.scala;
    channels-last)."""

    rank = 2


class ConvLSTM3D(_ConvLSTMBase):
    """x: [B, T, D, H, W, C] (ref: keras/layers/ConvLSTM3D.scala;
    channels-last)."""

    rank = 3


_MERGE = {"concat": lambda f, b: torch.cat([f, b], dim=-1),
          "sum": lambda f, b: f + b, "mul": lambda f, b: f * b,
          "ave": lambda f, b: (f + b) / 2.0}


class _BidirectionalModule(nn.Module):
    def __init__(self, fwd: _RNNModule, bwd: _RNNModule, merge_mode: str):
        super().__init__()
        self.fwd = fwd
        self.bwd = bwd
        self.merge_mode = merge_mode

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        if self.merge_mode not in _MERGE:
            raise ValueError(self.merge_mode)
        # one bidirectional call; its backward direction's outputs come
        # aligned with the input, as flax's keep_order gives them
        seq = run_fused([self.fwd.cell(x), self.bwd.cell(x)], x)
        units, ret = self.fwd.units, self.fwd.return_sequences
        f = _last(seq[..., :units], False, ret)
        b = _last(seq[..., units:], True, ret)
        return _MERGE[self.merge_mode](f, b)


class Bidirectional(KerasLayer):
    """(ref: keras/layers/Bidirectional.scala) over a ``SimpleRNN``,
    ``LSTM`` or ``GRU``."""

    def __init__(self, layer: _RecurrentBase, merge_mode: str = "concat",
                 **kwargs):
        super().__init__(**kwargs)
        self.layer = layer
        self.merge_mode = merge_mode

    def _make_module(self):
        fwd, bwd = (_RNNModule(self.layer.cell_type, self.layer.output_dim,
                               self.layer.return_sequences, reverse=r)
                    for r in (False, True))
        return _BidirectionalModule(fwd, bwd, self.merge_mode)


class _TimeDistributedModule(nn.Module):
    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        b, t = x.shape[0], x.shape[1]
        out = self.inner(x.reshape((b * t,) + x.shape[2:]), train=train,
                         rng=rng)
        return out.reshape((b, t) + out.shape[1:])


class TimeDistributed(KerasLayer):
    """Apply a layer to every timestep with shared weights
    (ref: keras/layers/TimeDistributed.scala)."""

    def __init__(self, layer: KerasLayer, **kwargs):
        super().__init__(**kwargs)
        self.layer = layer

    def _make_module(self):
        return _TimeDistributedModule(self.layer.build())
