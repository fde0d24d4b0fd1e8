"""Box operations, counterpart of ``vit_torch_tpu/detection/boxes.py``:
format conversion, the IoU / GIoU matrices of the DETR matcher and
losses, batch-vectorised over padded box sets (the reference's
``object_detr/util/box_ops.py`` semantics), and the fixed-shape NMS of
Faster R-CNN's proposals and detections."""

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


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor,
               iou_threshold: float, max_outputs: int):
    """Fixed-shape greedy NMS over a batch: ``boxes`` (B, n, 4) xyxy and
    ``scores`` (B, n), or one image's (n, 4) and (n,).  Returns
    ``(indices, valid)`` of shape (B, max_outputs) (or (max_outputs,)):
    the kept boxes in score order, index 0 and ``valid`` False in the
    slots past the last live box.  A score of -inf is never kept.

    The JAX ``fori_loop`` body, one step a slot for the whole batch: the
    first of the largest live scores is kept (``max`` takes the first
    index of equal maxima, as ``jnp.argmax`` does), then every live box
    whose IoU with it exceeds the threshold is set to -inf, and so is the
    kept one.  Scores are compared in fp32, as the JAX loop casts them.
    Nothing in the loop reads the device from the host."""
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
    B, n = scores.shape
    dev = scores.device
    # a box suppresses itself even when it has no area (IoU 0)
    over = (box_iou(boxes, boxes) > iou_threshold) | torch.eye(
        n, dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)
    live = scores.float().clone()
    neg_inf = float("-inf")
    chosen, alive = [], []
    for _ in range(max_outputs):
        best_score, best = live.max(-1)
        best_valid = best_score > neg_inf
        chosen.append(best)
        alive.append(best_valid)
        live.masked_fill_(over[rows, best] & best_valid[:, None], neg_inf)
    index = torch.stack(chosen, -1)
    valid = torch.stack(alive, -1)
    index = torch.where(valid, index, torch.zeros_like(index))
    if single:
        return index[0], valid[0]
    return index, valid
