"""Text classification model.

The counterpart of ``analytics_zoo_tpu/models/text/classifier.py``:
token ids -> embedding -> CNN / LSTM / GRU encoder -> dropout (training
only) -> ``Dense(128)`` + relu -> class logits.

The encoders follow flax's: the CNN is ``nn.Conv(encoder_output_dim,
(5,))``, which pads "SAME", so the max over time sees the edge positions
too; the recurrent ones are a single ``nn.RNN`` over a flax cell, read at
the last step. flax binds a cell passed to ``nn.RNN`` at the parent's
level, so the tree holds ``OptimizedLSTMCell_0`` or ``GRUCell_0`` beside
``embedding``, ``fc`` and ``head``, and the modules here carry those
names. The recurrence is torch's fused RNN (cuDNN on the card) through
``keras.layers.recurrent.run_fused``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.layers.convolutional import Conv
from analytics_zoo_tpu_torch.keras.layers.recurrent import (GRUCell,
                                                            LSTMCell,
                                                            run_fused)
from analytics_zoo_tpu_torch.keras.layers.transformer import (Dense, Embed,
                                                              dropout)
from analytics_zoo_tpu_torch.models.common import ZooModel, register_model

DROPOUT = 0.2


class TextClassifierNet(nn.Module):
    """int ``[B, L]`` token ids -> ``[B, class_num]`` logits."""

    def __init__(self, class_num: int, vocab: int, embed_dim: int,
                 encoder: str = "cnn", encoder_output_dim: int = 256,
                 sequence_length: int = 500):
        super().__init__()
        self.encoder = encoder
        self.embedding = Embed(vocab + 1, embed_dim)
        if encoder == "cnn":
            self.conv = Conv(embed_dim, encoder_output_dim, (5,),
                             padding="SAME")
        elif encoder == "lstm":
            self.OptimizedLSTMCell_0 = LSTMCell(embed_dim,
                                                encoder_output_dim)
        elif encoder == "gru":
            self.GRUCell_0 = GRUCell(embed_dim, encoder_output_dim)
        else:
            raise ValueError(f"unknown encoder {encoder!r}")
        self.fc = Dense(encoder_output_dim, 128)
        self.head = Dense(128, class_num)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.embedding(x)
        if self.encoder == "cnn":
            h = F.relu(self.conv(h)).amax(dim=1)  # max over time
        else:
            cell = (self.OptimizedLSTMCell_0 if self.encoder == "lstm"
                    else self.GRUCell_0)
            h = run_fused([cell], h)[:, -1]
        if train:
            h = dropout(h, DROPOUT, rng)
        h = F.relu(self.fc(h))
        return self.head(h)


@register_model
class TextClassifier(ZooModel):
    """Labels are 0-based class ids."""

    default_loss = "sparse_categorical_crossentropy"
    default_optimizer = "adam"
    default_metrics = ("accuracy",)

    def __init__(self, class_num: int, vocab: int = 20000,
                 embed_dim: int = 200, sequence_length: int = 500,
                 encoder: str = "cnn", encoder_output_dim: int = 256,
                 device=None, seed: int = 0):
        super().__init__(device=device, seed=seed, class_num=class_num,
                         vocab=vocab, embed_dim=embed_dim,
                         sequence_length=sequence_length, encoder=encoder,
                         encoder_output_dim=encoder_output_dim)

    def _build_module(self):
        c = self._config
        return TextClassifierNet(
            class_num=c["class_num"], vocab=c["vocab"],
            embed_dim=c["embed_dim"], encoder=c["encoder"],
            encoder_output_dim=c["encoder_output_dim"],
            sequence_length=c["sequence_length"])

    def _example_input(self):
        return np.ones((1, self._config["sequence_length"]), np.int32)
