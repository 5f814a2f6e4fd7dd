"""Seq2seq encoder-decoder model.

The counterpart of ``analytics_zoo_tpu/models/seq2seq.py``: a
stacked-LSTM encoder, a state bridge ("pass" hands each encoder layer's
final carry to the decoder layer of the same index; "dense" passes it
through ``tanh(Dense)``, ``bridge_c_{i}`` on c and ``bridge_h_{i}`` on
h), a stacked-LSTM decoder, teacher-forced for training, and greedy
``infer``. Token ids; id 0 is padding and the loss skips it.

flax binds the cells at the model's level in creation order, so the
encoder's cells are ``OptimizedLSTMCell_0..n-1`` and the decoder's
``OptimizedLSTMCell_n..2n-1``, beside ``embed`` (shared by source and
target), the bridges and ``head``. Each layer runs torch's fused LSTM
(``keras.layers.recurrent.run_fused``), whose carries are flax's
``(c, h)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.keras.layers.recurrent import LSTMCell, run_fused
from analytics_zoo_tpu_torch.keras.layers.transformer import Dense, Embed
from analytics_zoo_tpu_torch.models.common import ZooModel, register_model


class Seq2seqNet(nn.Module):
    """Teacher-forced forward: ``{"src": [B, Ls], "tgt_in": [B, Lt]}``
    (or the pair as a tuple) -> logits ``[B, Lt, vocab + 1]``."""

    def __init__(self, vocab: int, embed_dim: int,
                 hidden_sizes: Tuple[int, ...], bridge: str = "pass"):
        super().__init__()
        if bridge not in ("pass", "dense"):
            raise ValueError(f"unknown bridge {bridge!r}")
        self.n = n = len(hidden_sizes)
        self.bridge = bridge
        for side in range(2):  # the encoder's cells, then the decoder's
            width = embed_dim
            for i, hsz in enumerate(hidden_sizes):
                self.add_module(f"OptimizedLSTMCell_{side * n + i}",
                                LSTMCell(width, hsz))
                width = hsz
        if bridge == "dense":
            for i, hsz in enumerate(hidden_sizes):
                self.add_module(f"bridge_c_{i}", Dense(hsz, hsz))
                self.add_module(f"bridge_h_{i}", Dense(hsz, hsz))
        self.embed = Embed(vocab + 1, embed_dim)
        self.head = Dense(width, vocab + 1)

    def _cell(self, k: int) -> LSTMCell:
        return getattr(self, f"OptimizedLSTMCell_{k}")

    def forward(self, x) -> torch.Tensor:
        src, tgt_in = (x["src"], x["tgt_in"]) if isinstance(x, dict) else x
        h = self.embed(src)
        states = []
        for i in range(self.n):
            carry, h = run_fused([self._cell(i)], h, return_carry=True)
            states.append(carry)
        if self.bridge == "dense":
            states = [(torch.tanh(getattr(self, f"bridge_c_{i}")(c)),
                       torch.tanh(getattr(self, f"bridge_h_{i}")(hh)))
                      for i, (c, hh) in enumerate(states)]
        d = self.embed(tgt_in)
        for i in range(self.n):
            d = run_fused([self._cell(self.n + i)], d,
                          initial_carry=states[i])
        return self.head(d)


@register_model
class Seq2seq(ZooModel):
    """Train on ``{"src", "tgt_in"}`` against labels ``tgt_out`` (the
    target shifted by one)."""

    default_optimizer = "adam"

    @staticmethod
    def default_loss(preds, labels):
        """Cross entropy over the time dimension, padding (label 0)
        masked out."""
        labels = torch.as_tensor(labels, device=preds.device).long()
        logp = torch.log_softmax(preds.float(), -1)
        nll = -logp.gather(-1, labels[..., None])[..., 0]
        mask = (labels > 0).float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)

    def __init__(self, vocab: int, embed_dim: int = 128,
                 hidden_sizes=(128,), bridge: str = "pass",
                 max_len: int = 32, device=None, seed: int = 0):
        super().__init__(device=device, seed=seed, vocab=vocab,
                         embed_dim=embed_dim,
                         hidden_sizes=list(hidden_sizes), bridge=bridge,
                         max_len=max_len)

    def _build_module(self):
        c = self._config
        return Seq2seqNet(vocab=c["vocab"], embed_dim=c["embed_dim"],
                          hidden_sizes=tuple(c["hidden_sizes"]),
                          bridge=c["bridge"])

    def _example_input(self):
        return {"src": np.ones((1, 4), np.int32),
                "tgt_in": np.ones((1, 4), np.int32)}

    @torch.no_grad()
    def infer(self, src, start_id: int, max_len: Optional[int] = None,
              host_loop: bool = False) -> np.ndarray:
        """Greedy generation: ``[B, max_len]`` int32 tokens.

        Each step reruns the teacher-forced forward over the whole
        ``max_len`` window (the target buffer holds ``start_id`` and the
        tokens emitted so far, zeros after) and takes the argmax at the
        step's position, as the reference does. By default the loop
        stays on the device: the argmax is written into the buffer
        there, and the tokens are copied to the host once, at the end.
        ``host_loop=True`` copies each step's logits to the host and
        takes the argmax there (the reference's per-token loop)."""
        max_len = max_len or self._config["max_len"]
        module = self.module
        src_t = torch.as_tensor(np.asarray(src, np.int32),
                                device=self.device)
        b = src_t.shape[0]
        if host_loop:
            tgt_in = np.zeros((b, max_len), np.int32)
            tgt_in[:, 0] = start_id
            out = np.zeros((b, max_len), np.int32)
            for t in range(max_len):
                logits = module({"src": src_t, "tgt_in": torch.as_tensor(
                    tgt_in, device=self.device)}).cpu().numpy()
                tok = logits[:, t].argmax(-1).astype(np.int32)
                out[:, t] = tok
                if t + 1 < max_len:
                    tgt_in[:, t + 1] = tok
            return out
        # one column wider than the window, so the write at t + 1 needs
        # no bounds branch; the forward always sees buf[:, :max_len]
        buf = torch.zeros((b, max_len + 1), dtype=torch.int32,
                          device=self.device)
        buf[:, 0] = start_id
        for t in range(max_len):
            logits = module({"src": src_t, "tgt_in": buf[:, :max_len]})
            buf[:, t + 1] = logits[:, t].argmax(-1).to(torch.int32)
        return buf[:, 1:].cpu().numpy()
