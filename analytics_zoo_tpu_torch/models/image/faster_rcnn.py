"""Faster-RCNN-style two-stage detector with fixed shapes.

The counterpart of ``analytics_zoo_tpu/models/image/faster_rcnn.py``:
``rpn_anchors``, ``roi_align``, ``FasterRCNNModule`` and the registered
``FasterRCNN`` (load-and-predict: ``default_loss = None``, ``detect``).
Every stage keeps a fixed shape: the RPN scores one anchor set on a
single feature map and takes a fixed top-K of proposals (no objectness
threshold, no proposal NMS); ROI-align crops every proposal of the
batch at once by advanced indexing (``[B, K, P, P, C]``); the second
stage classifies all K proposals; per-class NMS runs on the host like
SSD's.

flax's names: ``_ConvBNRelu_0`` .. ``_ConvBNRelu_3`` (each a ``Conv_0``
and flax's plain ``BatchNorm_0``: epsilon 1e-5, never sampled, f32),
beside the named ``rpn_conv``, ``rpn_obj``, ``rpn_delta`` and
``head_fc1``/``head_cls``/``head_box``. The RPN's NHWC maps reshape to
``[B, H * W * 9]`` in ``(i, j, anchor)`` order, as ``rpn_anchors``
emits them.

``jax.lax.top_k`` returns the lower index first among equal scores;
``torch.topk`` promises no order among ties (on CUDA none at all), so
two runs may pick different anchors where objectness scores tie at the
k-th value. Compare proposals by anchor index.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.layers.convolutional import Conv
from analytics_zoo_tpu_torch.keras.layers.normalization import BatchNorm
from analytics_zoo_tpu_torch.keras.layers.transformer import Dense
from analytics_zoo_tpu_torch.models.common import (
    ZooModel, register_model, softmax_probs)
from analytics_zoo_tpu_torch.models.image.object_detection import (
    decode_detections)

# 3 scales x 3 ratios (rpn_anchors' defaults)
N_ANCHOR = 9
STRIDE = 8


def rpn_anchors(image_size: int, stride: int,
                scales: Sequence[float] = (0.15, 0.3, 0.55),
                ratios: Sequence[float] = (0.5, 1.0, 2.0)) -> np.ndarray:
    """Dense single-level anchor grid [H*W*A, 4] (x1y1x2y2 pixels)."""
    fsize = -(-image_size // stride)
    out: List[Tuple[float, float, float, float]] = []
    for i, j in itertools.product(range(fsize), repeat=2):
        cx, cy = (j + 0.5) * stride, (i + 0.5) * stride
        for s in scales:
            for r in ratios:
                w = s * image_size * float(np.sqrt(r))
                h = s * image_size / float(np.sqrt(r))
                out.append((cx - w / 2, cy - h / 2,
                            cx + w / 2, cy + h / 2))
    return np.asarray(out, np.float32)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: at a value equal to a bound the gradient is halved
    (``torch.maximum``/``minimum`` split ties as ``lax.max``/``min``
    do; ``torch.clamp`` would pass all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def roi_align(features: torch.Tensor, boxes: torch.Tensor, stride: int,
              pool: int = 7) -> torch.Tensor:
    """Gather-based bilinear ROI-align.

    features: [H, W, C] (one image) or [B, H, W, C]; boxes: [K, 4] or
    [B, K, 4] in image pixels. Returns [K, pool, pool, C] (or [B, K, pool,
    pool, C]): each box's ``pool`` x ``pool`` bin centres, one bilinear
    sample a bin, by four advanced-indexing gathers over the whole batch.
    """
    single = features.dim() == 3
    if single:
        features, boxes = features[None], boxes[None]
    b, fh, fw, _ = features.shape
    t = (torch.arange(pool, device=boxes.device, dtype=boxes.dtype)
         + 0.5) / pool
    x1, y1, x2, y2 = boxes.unbind(-1)                      # [B, K]
    # bin centres in feature-map coordinates, [B, K, P]
    xs = (x1[..., None] + (x2 - x1)[..., None] * t) / stride
    ys = (y1[..., None] + (y2 - y1)[..., None] * t) / stride
    xs = _clip(xs - 0.5, 0.0, fw - 1.0)
    ys = _clip(ys - 0.5, 0.0, fh - 1.0)
    x0 = torch.clamp(torch.floor(xs).long(), 0, fw - 2)
    y0 = torch.clamp(torch.floor(ys).long(), 0, fh - 2)
    wx = (xs - x0)[:, :, None, :, None]                    # [B, K, 1, P, 1]
    wy = (ys - y0)[:, :, :, None, None]                    # [B, K, P, 1, 1]
    bi = torch.arange(b, device=features.device)[:, None, None, None]
    yi, xi = y0[:, :, :, None], x0[:, :, None, :]          # rows, columns
    f00 = features[bi, yi, xi]                             # [B, K, P, P, C]
    f01 = features[bi, yi, xi + 1]
    f10 = features[bi, yi + 1, xi]
    f11 = features[bi, yi + 1, xi + 1]
    top = f00 * (1 - wx) + f01 * wx
    bot = f10 * (1 - wx) + f11 * wx
    out = top * (1 - wy) + bot * wy
    return out[0] if single else out


class _ConvBNRelu(nn.Module):
    """3x3 conv (no bias), flax's plain BatchNorm, relu."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, (3, 3), (stride, stride),
                           use_bias=False)
        self.BatchNorm_0 = BatchNorm(features, momentum=0.9, epsilon=1e-5)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Conv_0(x), train))


class FasterRCNNModule(nn.Module):
    """Backbone + RPN + top-K proposals + ROI-align + box head.

    Input [B, S, S, 3] -> (proposals [B, K, 4] pixels,
    class_logits [B, K, C+1], box_deltas [B, K, 4]); column 0 of the
    class axis is background. ``anchors`` ([N, 4], ``rpn_anchors`` at
    stride 8) is a buffer that moves with the module and is never
    saved.
    """

    def __init__(self, class_num: int, image_size: int = 128,
                 width: int = 64, top_k: int = 64, pool: int = 7,
                 anchors: Any = None):
        super().__init__()
        self.image_size = image_size
        self.top_k = top_k
        self.pool = pool
        c = 3  # RGB
        for i, (w, s) in enumerate(((width // 2, 1), (width // 2, 2),
                                    (width, 2), (width, 2))):
            self.add_module(f"_ConvBNRelu_{i}", _ConvBNRelu(c, w, s))
            c = w
        self.rpn_conv = Conv(width, width, (3, 3))
        self.rpn_obj = Conv(width, N_ANCHOR, (1, 1))
        self.rpn_delta = Conv(width, N_ANCHOR * 4, (1, 1))
        self.head_fc1 = Dense(pool * pool * width, 256)
        self.head_cls = Dense(256, class_num + 1)
        self.head_box = Dense(256, 4)  # class-agnostic
        if anchors is None:
            anchors = rpn_anchors(image_size, STRIDE)
        self.register_buffer("anchors", torch.as_tensor(
            np.asarray(anchors, np.float32)), persistent=False)

    def rpn(self, x: torch.Tensor, train: bool = False):
        """The first stage: the feature map ``[B, H, W, C]``, each
        anchor's objectness ``[B, N]`` and deltas ``[B, N, 4]``."""
        b = x.shape[0]
        h = x
        for i in range(4):
            h = getattr(self, f"_ConvBNRelu_{i}")(h, train)
        rpn = F.relu(self.rpn_conv(h))
        obj = self.rpn_obj(rpn).reshape(b, -1)              # [B, N]
        dlt = self.rpn_delta(rpn).reshape(b, -1, 4)         # [B, N, 4]
        return h, obj, dlt

    def second_stage(self, feat: torch.Tensor, dlt: torch.Tensor,
                     idx: torch.Tensor):
        """The proposals of the anchors ``idx`` ``[B, K]`` and the head's
        class logits and box deltas for them."""
        b, k = idx.shape
        sel_anchor = self.anchors[idx]                      # [B, K, 4]
        sel_delta = dlt.gather(1, idx[..., None].expand(-1, -1, 4))

        # decode the proposals on the device (detection.decode_boxes'
        # arithmetic, the size deltas clipped to [-4, 4])
        aw = sel_anchor[..., 2] - sel_anchor[..., 0]
        ah = sel_anchor[..., 3] - sel_anchor[..., 1]
        acx = sel_anchor[..., 0] + 0.5 * aw
        acy = sel_anchor[..., 1] + 0.5 * ah
        cx = acx + sel_delta[..., 0] * 0.1 * aw
        cy = acy + sel_delta[..., 1] * 0.1 * ah
        w = aw * torch.exp(_clip(sel_delta[..., 2] * 0.2, -4.0, 4.0))
        hh = ah * torch.exp(_clip(sel_delta[..., 3] * 0.2, -4.0, 4.0))
        proposals = torch.stack(
            [cx - w / 2, cy - hh / 2, cx + w / 2, cy + hh / 2], dim=-1)
        proposals = _clip(proposals, 0.0, float(self.image_size))

        pooled = roi_align(feat, proposals, STRIDE, self.pool)
        flat = pooled.reshape(b, k, -1)
        hdn = F.relu(self.head_fc1(flat))
        return proposals, self.head_cls(hdn), self.head_box(hdn)

    def forward(self, x: torch.Tensor, train: bool = False):
        feat, obj, dlt = self.rpn(x, train)
        _, idx = torch.topk(obj, self.top_k, dim=1)         # [B, K]
        return self.second_stage(feat, dlt, idx)


@register_model
class FasterRCNN(ZooModel):
    """Two-stage load-and-predict pipeline. ``detect`` refines the K
    proposals with the head's deltas and runs per-class NMS."""

    default_loss = None
    default_optimizer = "adam"

    def __init__(self, class_num: int, image_size: int = 128,
                 width: int = 64, top_k: int = 64, pool: int = 7,
                 label_map: Optional[Dict[Any, str]] = None,
                 device=None, seed: int = 0):
        self._label_map = {int(k): v
                           for k, v in (label_map or {}).items()}
        # before super().__init__: ZooModel builds the module eagerly
        self.anchors = rpn_anchors(image_size, stride=STRIDE)
        super().__init__(device=device, seed=seed, class_num=class_num,
                         image_size=image_size, width=width, top_k=top_k,
                         pool=pool, label_map={str(k): v for k, v in
                                               (label_map or {}).items()})

    def _build_module(self):
        c = self._config
        return FasterRCNNModule(
            class_num=c["class_num"], image_size=c["image_size"],
            width=c["width"], top_k=c["top_k"], pool=c["pool"],
            anchors=self.anchors)

    def _example_input(self):
        s = self._config["image_size"]
        return np.zeros((1, s, s, 3), np.float32)

    def detect(self, images: np.ndarray, batch_size: int = 8,
               score_threshold: float = 0.3, iou_threshold: float = 0.45,
               top_k: int = 100
               ) -> List[List[Tuple[int, float, np.ndarray]]]:
        proposals, cls_logits, box_deltas = self.estimator.predict(
            np.asarray(images, np.float32), batch_size=batch_size)
        return decode_detections(
            softmax_probs(cls_logits), proposals, box_deltas,
            self._config["image_size"], score_threshold, iou_threshold,
            top_k)

    def label_of(self, class_id: int) -> str:
        return self._label_map.get(class_id, str(class_id))
