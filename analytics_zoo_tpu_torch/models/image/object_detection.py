"""SSD-style object detection: model, anchors, predict pipeline.

The counterpart of ``analytics_zoo_tpu/models/image/object_detection.py``:
``generate_anchors``, ``multibox_loss``, ``SSDModule``, the registered
``ObjectDetector`` (``prepare_targets``, ``detect``, ``label_of``, its
``label_map`` kept in ``config.json``) and ``visualize``. One NHWC
forward gives every scale's class and box heads as fixed-shape tensors;
NMS and thresholds run on the host in numpy (``detection.py``).

flax names the unnamed submodules in creation order, so the port's are
``_ConvBlock_0`` .. ``_ConvBlock_5`` (each a ``Conv_0`` and a
``BatchNorm_0``: flax's plain ``nn.BatchNorm``, epsilon 1e-5, never
sampled, f32) and, at ``SSDModule``'s level, the heads ``Conv_0`` ..
``Conv_5``, class and box interleaved per level. The heads' NHWC maps
reshape to ``[B, H * W * anchors, ...]``: anchors in ``(i, j, anchor)``
order, as ``generate_anchors`` emits them.

``multibox_loss`` ranks the negatives with ``argsort(argsort(...))``
under ``stable=True``: jnp's sort is stable, so ties rank as in JAX.
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
from analytics_zoo_tpu_torch.models.common import (
    ZooModel, register_model, softmax_probs)
from analytics_zoo_tpu_torch.models.image.detection import (
    clip_boxes, decode_boxes, detect_per_class, match_anchors)


def generate_anchors(image_size: int, feature_sizes: Sequence[int],
                     scales: Sequence[float],
                     aspect_ratios: Sequence[Sequence[float]]
                     ) -> np.ndarray:
    """SSD prior boxes [N, 4] (x1, y1, x2, y2 in pixels): one anchor per
    (cell, scale x ratio) on every feature map, plus the geometric-mean
    scale's extra prior per cell."""
    anchors: List[Tuple[float, float, float, float]] = []
    for fsize, scale, ratios, next_scale in zip(
            feature_sizes, scales, aspect_ratios,
            list(scales[1:]) + [1.0]):
        step = image_size / fsize
        sizes = [(scale, scale),
                 (float(np.sqrt(scale * next_scale)),
                  float(np.sqrt(scale * next_scale)))]
        for r in ratios:
            sizes.append((scale * float(np.sqrt(r)),
                          scale / float(np.sqrt(r))))
        for i, j in itertools.product(range(fsize), repeat=2):
            cx = (j + 0.5) * step
            cy = (i + 0.5) * step
            for w, h in sizes:
                pw, ph = w * image_size, h * image_size
                anchors.append((cx - pw / 2, cy - ph / 2,
                                cx + pw / 2, cy + ph / 2))
    return np.asarray(anchors, np.float32)


def multibox_loss(preds, targets, neg_pos_ratio: float = 3.0):
    """SSD MultiBox loss: softmax cross-entropy over classes with
    hard-negative mining (``neg_pos_ratio`` negatives per positive) plus
    smooth-L1 on the positive anchors' box deltas, normalized by each
    image's positive count, averaged over the batch.

    preds: (class_logits [B, N, C+1], box_deltas [B, N, 4]);
    targets: (class_targets [B, N] int, box_targets [B, N, 4]) from
    ``detection.match_anchors``.
    """
    cls_logits, box_deltas = preds
    cls_t, box_t = targets[0].long(), targets[1].float()
    pos = cls_t > 0
    n_pos = pos.sum(dim=1).clamp(min=1)                      # [B]

    logp = F.log_softmax(cls_logits.float(), dim=-1)
    ce = -logp.gather(-1, cls_t[..., None])[..., 0]

    # hard negative mining: rank background anchors by loss and keep the
    # worst ratio * n_pos of them (a sort and a rank compare)
    neg_ce = torch.where(pos, float("-inf"), ce.detach())
    order = torch.argsort(-neg_ce, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    neg = rank < (neg_pos_ratio * n_pos)[:, None]
    cls_loss = torch.where(pos | neg, ce, 0.0).sum(dim=1)

    diff = (box_deltas.float() - box_t).abs()
    sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    box_loss = torch.where(pos[..., None], sl1, 0.0).sum(dim=(1, 2))
    return ((cls_loss + box_loss) / n_pos).mean()


class _ConvBlock(nn.Module):
    """3x3 conv (no bias), flax's plain BatchNorm, relu."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, (3, 3), (stride, stride),
                           use_bias=False)
        self.BatchNorm_0 = BatchNorm(features, momentum=0.9, epsilon=1e-5)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Conv_0(x), train))


class SSDModule(nn.Module):
    """Small SSD: conv backbone + multi-scale class/box heads.

    Input [B, S, S, 3] -> (class_logits [B, N, C+1], box_deltas [B, N, 4])
    where N = total anchors over the feature pyramid and column 0 of the
    class axis is background.
    """

    def __init__(self, class_num: int, image_size: int = 128,
                 widths: Sequence[int] = (32, 64, 128),
                 anchors_per_cell: int = 4):
        super().__init__()
        self.class_num = class_num
        self.n_levels = len(widths)
        # the stem halves twice; each pyramid level halves again
        c = 3  # RGB
        for i, (w, s) in enumerate([(widths[0], 1), (widths[0], 2),
                                    (widths[0], 2)]
                                   + [(w, 2) for w in widths]):
            self.add_module(f"_ConvBlock_{i}", _ConvBlock(c, w, s))
            c = w
        a = anchors_per_cell
        for i, w in enumerate(widths):
            self.add_module(f"Conv_{2 * i}",
                            Conv(w, a * (class_num + 1), (3, 3)))
            self.add_module(f"Conv_{2 * i + 1}", Conv(w, a * 4, (3, 3)))

    def forward(self, x: torch.Tensor, train: bool = False):
        b = x.shape[0]
        h = x
        for i in range(3):
            h = getattr(self, f"_ConvBlock_{i}")(h, train)
        cls_outs, box_outs = [], []
        for i in range(self.n_levels):
            h = getattr(self, f"_ConvBlock_{3 + i}")(h, train)
            cls = getattr(self, f"Conv_{2 * i}")(h)
            box = getattr(self, f"Conv_{2 * i + 1}")(h)
            cls_outs.append(cls.reshape(b, -1, self.class_num + 1))
            box_outs.append(box.reshape(b, -1, 4))
        return torch.cat(cls_outs, dim=1), torch.cat(box_outs, dim=1)


@register_model
class ObjectDetector(ZooModel):
    """SSD pipeline: ``detect(images)`` returns per-image lists of
    (class_id, score, [x1, y1, x2, y2]) after decode + per-class NMS;
    trainable end to end via ``fit((images, prepare_targets(gt)))``
    with the MultiBox loss."""

    default_loss = staticmethod(multibox_loss)
    default_optimizer = "adam"

    def __init__(self, class_num: int, image_size: int = 128,
                 widths: Sequence[int] = (32, 64, 128),
                 anchors_per_cell: int = 4,
                 label_map: Optional[Dict[Any, str]] = None,
                 device=None, seed: int = 0):
        # keys normalize to int; stored str-keyed in the json config so
        # the map survives save_model/load_model
        self._label_map = {int(k): v for k, v in (label_map or {}).items()}
        ratio_bank = [2.0, 0.5, 3.0, 1.0 / 3.0]
        if not 3 <= anchors_per_cell <= 2 + len(ratio_bank):
            raise ValueError(
                f"anchors_per_cell must be in [3, {2 + len(ratio_bank)}] "
                "(2 square priors + up to 4 aspect ratios)")
        super().__init__(device=device, seed=seed, class_num=class_num,
                         image_size=image_size, widths=tuple(widths),
                         anchors_per_cell=anchors_per_cell,
                         label_map={str(k): v for k, v in
                                    (label_map or {}).items()})
        # SAME-padded stride-2 convs produce ceil(s/2) grids; mirror
        # that exactly so the anchor count matches the head outputs
        s = -(-image_size // 2)   # stem block 1
        s = -(-s // 2)            # stem block 2
        feature_sizes = []
        for _ in widths:
            s = -(-s // 2)
            feature_sizes.append(s)
        n_scales = len(widths)
        scales = [0.15 + 0.55 * i / max(n_scales - 1, 1)
                  for i in range(n_scales)]
        # 2 square priors per cell; the remaining slots are aspect ratios
        ratios = [ratio_bank[:anchors_per_cell - 2]] * n_scales
        self.anchors = generate_anchors(image_size, feature_sizes,
                                        scales, ratios)

    def _build_module(self):
        c = self._config
        return SSDModule(class_num=c["class_num"],
                         image_size=c["image_size"],
                         widths=tuple(c["widths"]),
                         anchors_per_cell=c["anchors_per_cell"])

    def _example_input(self):
        s = self._config["image_size"]
        return np.zeros((1, s, s, 3), np.float32)

    def prepare_targets(self, ground_truth: Sequence[Tuple[np.ndarray,
                                                           np.ndarray]],
                        iou_threshold: float = 0.5
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-image (gt_boxes [G, 4], gt_labels [G] foreground ids
        >= 1) -> stacked (class_targets [B, N], box_targets [B, N, 4])
        ready for ``fit``; the anchor matcher runs on the host, so the
        training step keeps fixed shapes."""
        cls_list, box_list = [], []
        for boxes, labels in ground_truth:
            c, bx = match_anchors(self.anchors, boxes, labels,
                                  iou_threshold=iou_threshold)
            cls_list.append(c)
            box_list.append(bx)
        return np.stack(cls_list), np.stack(box_list)

    def detect(self, images: np.ndarray, batch_size: int = 8,
               score_threshold: float = 0.3, iou_threshold: float = 0.45,
               top_k: int = 100
               ) -> List[List[Tuple[int, float, np.ndarray]]]:
        """Full predict pipeline on [B, S, S, 3] images."""
        cls_logits, box_deltas = self.estimator.predict(
            np.asarray(images, np.float32), batch_size=batch_size)
        return decode_detections(
            softmax_probs(cls_logits), [self.anchors] * len(cls_logits),
            box_deltas, self._config["image_size"], score_threshold,
            iou_threshold, top_k)

    def label_of(self, class_id: int) -> str:
        return self._label_map.get(class_id, str(class_id))


def decode_detections(probs: np.ndarray, priors: Sequence[np.ndarray],
                      deltas: np.ndarray, size: int,
                      score_threshold: float, iou_threshold: float,
                      top_k: int) -> List[List[Tuple[int, float,
                                                     np.ndarray]]]:
    """Each image's boxes decoded from its priors (anchors or proposals)
    and deltas, clipped to the image, then thresholded and suppressed
    per class."""
    results = []
    for b in range(probs.shape[0]):
        boxes = clip_boxes(decode_boxes(priors[b], deltas[b]), size, size)
        results.append(detect_per_class(
            boxes, probs[b], score_threshold=score_threshold,
            iou_threshold=iou_threshold, top_k=top_k))
    return results


def visualize(image: np.ndarray,
              detections: Sequence[Tuple[int, float, np.ndarray]],
              label_map: Optional[Dict[int, str]] = None) -> np.ndarray:
    """Draw detection boxes + labels onto an image. Returns HWC uint8.
    Needs Pillow, imported here."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(np.clip(image, 0, 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    palette = [(255, 64, 64), (64, 200, 64), (64, 64, 255),
               (255, 200, 0), (200, 0, 200), (0, 200, 200)]
    for class_id, score, box in detections:
        color = palette[class_id % len(palette)]
        x1, y1, x2, y2 = [float(v) for v in box]
        draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
        name = (label_map or {}).get(class_id, str(class_id))
        draw.text((x1 + 2, max(y1 - 10, 0)), f"{name}:{score:.2f}",
                  fill=color)
    return np.asarray(img)
