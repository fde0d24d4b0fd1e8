"""Hungarian matcher, counterpart of ``vit_torch_tpu/detection/matcher.py``
(the reference's ``HungarianMatcher``, ``object_detr/models/matcher.py:
55-82``): per image, the assignment of queries to ground-truth boxes that
minimises ``w_class·(−prob) + w_bbox·L1 + w_giou·(−GIoU)``.

The cost matrices are computed on the device (:func:`cost_matrices`);
only the small ``(L, B, Q, N)`` cost tensor crosses to the host, where
:func:`linear_sum_assignment` solves each image exactly.  The JAX package
calls scipy there and falls back to a greedy match without it; the port
imports no scipy and solves by shortest augmenting paths (the
Jonker-Volgenant / Crouse method scipy uses), vectorised over the larger
side, so that a step's L·B solves stay in milliseconds.  The device
auction matcher (``--matcher device``) comes with ROADMAP.md A10d.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vit_torch_tpu_torch.detection.boxes import (cxcywh_to_xyxy,
                                                 generalized_box_iou)


def cost_matrices(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                  gt_labels: torch.Tensor, gt_boxes_cxcywh: torch.Tensor,
                  box_mask: torch.Tensor, *, cost_class: float = 1.0,
                  cost_bbox: float = 5.0, cost_giou: float = 2.0
                  ) -> torch.Tensor:
    """Batched (B, Q, N_pad) fp32 matching cost, on the predictions'
    device; padded gt columns cost 1e9."""
    prob = torch.softmax(pred_logits.float(), dim=-1)
    boxes = pred_boxes.float()
    gt_boxes = gt_boxes_cxcywh.float()
    Q = prob.shape[1]
    labels = gt_labels.long()[:, None, :].expand(-1, Q, -1)
    cls_cost = -torch.gather(prob, 2, labels)                  # (B, Q, N)
    l1 = (boxes[:, :, None, :] - gt_boxes[:, None, :, :]).abs().sum(-1)
    giou = generalized_box_iou(cxcywh_to_xyxy(boxes),
                               cxcywh_to_xyxy(gt_boxes))
    cost = cost_class * cls_cost + cost_bbox * l1 - cost_giou * giou
    return torch.where(box_mask[:, None, :] > 0, cost,
                       torch.full_like(cost, 1e9))


def linear_sum_assignment(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Exact minimum-cost assignment of a rectangular ``(n, m)`` cost
    matrix: ``min(n, m)`` (row, column) pairs with the least total cost,
    as ``scipy.optimize.linear_sum_assignment`` returns them (rows
    ascending).  One shortest augmenting path a row of the smaller side,
    Dijkstra over the columns with the duals u, v keeping reduced costs
    non-negative; each step of a search is a numpy pass over the
    columns."""
    cost = np.asarray(cost, np.float64)
    if cost.ndim != 2:
        raise ValueError(f"cost must be 2-D, got shape {cost.shape}")
    if not np.isfinite(cost).all():
        raise ValueError("cost matrix holds inf or nan")
    transposed = cost.shape[0] > cost.shape[1]
    if transposed:
        cost = cost.T
    n, m = cost.shape
    u, v = np.zeros(n), np.zeros(m)
    col4row = np.full(n, -1, np.int64)
    row4col = np.full(m, -1, np.int64)
    for cur in range(n):
        shortest = np.full(m, np.inf)
        path = np.full(m, -1, np.int64)
        remaining = np.ones(m, bool)
        seen_rows = np.zeros(n, bool)
        min_val, i, sink = 0.0, cur, -1
        while sink < 0:
            seen_rows[i] = True
            r = min_val + cost[i] - u[i] - v
            better = remaining & (r < shortest)
            path[better] = i
            shortest[better] = r[better]
            cand = np.where(remaining, shortest, np.inf)
            lowest = cand.min()
            # among the cheapest, a free column ends the search at once
            ties = np.flatnonzero(cand == lowest)
            free = ties[row4col[ties] < 0]
            j = int(free[0] if free.size else ties[0])
            min_val = lowest
            remaining[j] = False
            if row4col[j] < 0:
                sink = j
            else:
                i = int(row4col[j])
        # dual update over the rows and columns the search reached
        u[cur] += min_val
        rows = np.flatnonzero(seen_rows)
        rows = rows[rows != cur]
        u[rows] += min_val - shortest[col4row[rows]]
        done = ~remaining
        v[done] -= min_val - shortest[done]
        # augment along the path back to the current row
        j = sink
        while True:
            i = int(path[j])
            row4col[j] = i
            col4row[i], j = j, col4row[i]
            if i == cur:
                break
    if transposed:
        order = np.argsort(col4row)
        return col4row[order], order
    return np.arange(n), col4row


def hungarian_match(cost: np.ndarray, box_mask: np.ndarray) -> np.ndarray:
    """Per-image assignment over a (B, Q, N_pad) host cost tensor: for
    every query, the matched gt slot or -1, ``(B, Q)`` int32.  Valid gt
    columns are picked by index, not by prefix: a zoom-crop can drop
    slots at any position."""
    cost = np.asarray(cost)
    box_mask = np.asarray(box_mask)
    B, Q, _ = cost.shape
    assign = np.full((B, Q), -1, np.int32)
    for b in range(B):
        valid = np.flatnonzero(box_mask[b] > 0)
        if valid.size == 0:
            continue
        rows, cols = linear_sum_assignment(cost[b][:, valid])
        assign[b, rows] = valid[cols].astype(np.int32)
    return assign
