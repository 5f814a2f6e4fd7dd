"""Object-detection post-processing utilities.

A copy of ``analytics_zoo_tpu/models/image/detection.py`` (host numpy, so
the port keeps its own rather than importing the JAX package): IoU,
greedy NMS, SSD box encoding and decoding, anchor matching, clipping and
per-class detection (the reference's ``BboxUtil`` and ``Nms``).

Boxes are [x1, y1, x2, y2] in pixel or normalized coordinates.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def bbox_iou(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Pairwise IoU: [N, 4] x [M, 4] -> [N, M]
    (ref: BboxUtil.scala getIoURate/jaccardOverlap)."""
    a = np.asarray(boxes_a, np.float32)[:, None]
    b = np.asarray(boxes_b, np.float32)[None]
    lt = np.maximum(a[..., :2], b[..., :2])
    rb = np.minimum(a[..., 2:], b[..., 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]))
    area_b = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]))
    union = area_a + area_b - inter
    return inter / np.maximum(union, 1e-9)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.45,
        top_k: int = 200) -> np.ndarray:
    """Greedy non-maximum suppression; returns kept indices sorted by
    descending score (ref: objectdetection/common/Nms.scala)."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    order = np.argsort(-scores)
    keep: List[int] = []
    while order.size and len(keep) < top_k:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        ious = bbox_iou(boxes[i:i + 1], boxes[order[1:]])[0]
        order = order[1:][ious <= iou_threshold]
    return np.asarray(keep, np.int64)


def decode_boxes(anchors: np.ndarray, deltas: np.ndarray,
                 variances=(0.1, 0.1, 0.2, 0.2)) -> np.ndarray:
    """SSD-style box regression decode: anchors [N,4] (x1y1x2y2) +
    deltas [N,4] (dx,dy,dw,dh) -> boxes [N,4]
    (ref: BboxUtil.scala decodeBoxes)."""
    anchors = np.asarray(anchors, np.float32)
    deltas = np.asarray(deltas, np.float32)
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = anchors[:, 0] + 0.5 * aw
    acy = anchors[:, 1] + 0.5 * ah
    cx = acx + deltas[:, 0] * variances[0] * aw
    cy = acy + deltas[:, 1] * variances[1] * ah
    w = aw * np.exp(deltas[:, 2] * variances[2])
    h = ah * np.exp(deltas[:, 3] * variances[3])
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                    axis=1)


def encode_boxes(anchors: np.ndarray, gt_boxes: np.ndarray,
                 variances=(0.1, 0.1, 0.2, 0.2)) -> np.ndarray:
    """Inverse of :func:`decode_boxes`: per-anchor regression targets
    for matched ground-truth boxes (ref: BboxUtil.scala encodeBoxes).
    anchors/gt_boxes: [N, 4] x1y1x2y2 -> deltas [N, 4]."""
    anchors = np.asarray(anchors, np.float32)
    gt = np.asarray(gt_boxes, np.float32)
    aw = np.maximum(anchors[:, 2] - anchors[:, 0], 1e-6)
    ah = np.maximum(anchors[:, 3] - anchors[:, 1], 1e-6)
    acx = anchors[:, 0] + 0.5 * aw
    acy = anchors[:, 1] + 0.5 * ah
    gw = np.maximum(gt[:, 2] - gt[:, 0], 1e-6)
    gh = np.maximum(gt[:, 3] - gt[:, 1], 1e-6)
    gcx = gt[:, 0] + 0.5 * gw
    gcy = gt[:, 1] + 0.5 * gh
    return np.stack([
        (gcx - acx) / aw / variances[0],
        (gcy - acy) / ah / variances[1],
        np.log(gw / aw) / variances[2],
        np.log(gh / ah) / variances[3],
    ], axis=1)


def match_anchors(anchors: np.ndarray, gt_boxes: np.ndarray,
                  gt_labels: np.ndarray, iou_threshold: float = 0.5,
                  variances=(0.1, 0.1, 0.2, 0.2)
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """SSD bipartite + per-prediction matching (ref: BboxUtil.scala
    matchBbox): every ground truth claims its best anchor; every other
    anchor joins its best-IoU ground truth when IoU >= threshold.

    gt_labels are FOREGROUND ids (>= 1); 0 marks background.
    Returns per-anchor (class_targets [N] int32, box_targets [N, 4]).
    Host-side numpy: runs in the input pipeline, so the device only ever sees
    the static [N]/[N, 4] targets.
    """
    n = anchors.shape[0]
    cls_t = np.zeros((n,), np.int32)
    box_t = np.zeros((n, 4), np.float32)
    gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
    if gt_boxes.shape[0] == 0:
        return cls_t, box_t
    gt_labels = np.asarray(gt_labels, np.int32).reshape(-1)
    iou = bbox_iou(anchors, gt_boxes)            # [N, G]
    best_gt = iou.argmax(axis=1)                 # per anchor
    best_iou = iou[np.arange(n), best_gt]
    matched = best_iou >= iou_threshold
    # bipartite pass: each gt forces its single best anchor positive
    forced = iou.argmax(axis=0)                  # per gt
    matched[forced] = True
    best_gt[forced] = np.arange(gt_boxes.shape[0])
    cls_t[matched] = gt_labels[best_gt[matched]]
    box_t[matched] = encode_boxes(anchors[matched],
                                  gt_boxes[best_gt[matched]], variances)
    return cls_t, box_t


def clip_boxes(boxes: np.ndarray, height: float, width: float) -> np.ndarray:
    """(ref: BboxUtil.scala clipBoxes)."""
    boxes = np.asarray(boxes, np.float32).copy()
    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, width)
    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, height)
    return boxes


def detect_per_class(boxes: np.ndarray, class_scores: np.ndarray,
                     score_threshold: float = 0.3,
                     iou_threshold: float = 0.45, top_k: int = 100
                     ) -> List[Tuple[int, float, np.ndarray]]:
    """Full detection post-processing: per-class threshold + NMS, merged
    and sorted (ref: objectdetection DetectionOutput* postprocessing).
    class_scores: [N, C] including background at column 0.
    Returns [(class_id, score, box)] sorted by score."""
    out: List[Tuple[int, float, np.ndarray]] = []
    n_classes = class_scores.shape[1]
    for c in range(1, n_classes):
        sc = class_scores[:, c]
        sel = sc >= score_threshold
        if not sel.any():
            continue
        keep = nms(boxes[sel], sc[sel], iou_threshold, top_k)
        idx = np.nonzero(sel)[0][keep]
        out.extend((c, float(class_scores[i, c]), boxes[i]) for i in idx)
    out.sort(key=lambda t: -t[1])
    return out[:top_k]
