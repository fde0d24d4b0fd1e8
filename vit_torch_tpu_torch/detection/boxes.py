"""Box operations, counterpart of ``vit_torch_tpu/detection/boxes.py``:
format conversion and the IoU / GIoU matrices of the DETR matcher and
losses, batch-vectorised over padded box sets (the reference's
``object_detr/util/box_ops.py`` semantics).  ``nms_padded`` comes with
Faster R-CNN (ROADMAP.md A10b)."""

from __future__ import annotations

import torch


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    """COCO result format (reference ``object/coco_eval.py:158-160``)."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([x0, y0, x1 - x0, y1 - y0], -1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return ((boxes[..., 2] - boxes[..., 0]).clamp_min(0)
            * (boxes[..., 3] - boxes[..., 1]).clamp_min(0))


def _inter_union(a: torch.Tensor, b: torch.Tensor):
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter, union


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a (..., N, 4) × b (..., M, 4) → (..., N, M), xyxy."""
    inter, union = _inter_union(a, b)
    return inter / union.clamp_min(1e-9)


def generalized_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GIoU matrix (the DETR loss and matcher cost, reference
    ``object_detr/models/matcher.py:70-76`` semantics)."""
    inter, union = _inter_union(a, b)
    iou = inter / union.clamp_min(1e-9)
    lt = torch.minimum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.maximum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / hull.clamp_min(1e-9)
