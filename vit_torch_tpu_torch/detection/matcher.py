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
side, so that a step's L·B solves stay in milliseconds.

The device matcher (``--matcher device``) assigns on the card instead,
with no host read: :func:`auction_assign`, the JAX package's Bertsekas
auction (``matcher.py:51-120``), on CUDA one launch of
``csrc/auction.cu`` for all L·B problems (the source note gives its
arithmetic, bound and design), on the CPU its plain version
(:func:`auction_assign_reference`), a PyTorch loop over the JAX body whose
cond is read on the host.  ``auction_assign.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from vit_torch_tpu_torch.detection.boxes import (cxcywh_to_xyxy,
                                                 generalized_box_iou)
from vit_torch_tpu_torch.ops import _build
from vit_torch_tpu_torch.ops.gemm import check

NEG = -1e30                       # the JAX auction's "no bid"
# csrc/auction.cu: the dynamic shared memory a block may hold
_SMEM_MAX = 232448 - 256


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


def _auction_shapes(cost: torch.Tensor, box_mask: torch.Tensor):
    """The leading axes, Q and N of ``cost (..., Q, N)``, and the leading
    axes of ``box_mask (..., N)``, which must end the cost's (a mask of
    (B, N) serves every layer of an (L, B, Q, N) cost)."""
    if cost.dim() < 2 or box_mask.dim() < 1:
        raise ValueError(f"cost (..., Q, N) and box_mask (..., N), got "
                         f"{tuple(cost.shape)} and {tuple(box_mask.shape)}")
    lead, (Q, N) = tuple(cost.shape[:-2]), cost.shape[-2:]
    mlead = tuple(box_mask.shape[:-1])
    if (box_mask.shape[-1] != N or len(mlead) > len(lead)
            or lead[len(lead) - len(mlead):] != mlead):
        raise ValueError(f"box_mask {tuple(box_mask.shape)} does not fit "
                         f"cost {tuple(cost.shape)}")
    return lead, Q, N, mlead


def auction_assign_reference(cost: torch.Tensor, box_mask: torch.Tensor, *,
                             eps_frac: float = 1.0 / 500.0,
                             max_iters: int = 256,
                             return_iters: bool = False):
    """The plain version of :func:`auction_assign`: the JAX body on all
    problems at once in fp32, each problem updated while its own cond
    holds (the vmapped ``while_loop``'s semantics), the conds read on the
    host once an iteration."""
    lead, Q, N, _ = _auction_shapes(cost, box_mask)
    P = math.prod(lead)
    dev = cost.device
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    neg = f32(NEG)
    c = cost.float().reshape(P, Q, N)
    valid = (box_mask > 0).expand(*lead, N).reshape(P, N)
    benefit = torch.where(valid[:, :, None], -c.transpose(1, 2),
                          f32(0.0))                                # (P, N, Q)
    spread = torch.maximum(benefit.amax((1, 2)) - benefit.amin((1, 2)),
                           f32(1e-6))
    eps = spread * f32(eps_frac)
    target = torch.clamp_max(valid.sum(1), Q)
    prices = torch.zeros((P, Q), dtype=torch.float32, device=dev)
    owner = torch.full((P, Q), -1, dtype=torch.long, device=dev)
    item_of_gt = torch.full((P, N), -1, dtype=torch.long, device=dev)
    iters = torch.zeros(P, dtype=torch.long, device=dev)
    gt_ids = torch.arange(N, device=dev)
    q_ids = torch.arange(Q, device=dev)
    while True:
        n_assigned = ((item_of_gt >= 0) & valid).sum(1)
        active = (n_assigned < target) & (iters < max_iters)
        if not bool(active.any()):
            break
        unassigned = (item_of_gt < 0) & valid
        net = benefit - prices[:, None, :]
        v1 = net.amax(2)
        i1 = net.argmax(2)                       # the first on ties
        v2 = net.scatter(2, i1[..., None], NEG).amax(2)
        bid = prices.gather(1, i1) + (v1 - v2) + eps[:, None]
        bid = torch.where(unassigned, bid, neg)
        hit = (i1[..., None] == q_ids) & unassigned[..., None]
        scores = torch.where(hit, bid[..., None], neg)             # (P, N, Q)
        item_best = scores.amax(1)
        winner = scores.argmax(1)
        has_bid = (item_best > NEG / 2) & active[:, None]
        owner = torch.where(has_bid, winner, owner)
        prices = torch.where(has_bid, item_best, prices)
        own = owner[:, None, :] == gt_ids[None, :, None]           # (P, N, Q)
        item = torch.where(own.any(2), own.int().argmax(2), -1)
        item_of_gt = torch.where(active[:, None], item, item_of_gt)
        iters = iters + active.long()
    owner = owner.to(torch.int32).reshape(*lead, Q)
    if return_iters:
        return owner, iters.to(torch.int32).reshape(lead)
    return owner


@functools.lru_cache(maxsize=None)
def _lib():
    """auction.cu's entry point, built and loaded on first use."""
    lib = _build.load("auction")
    lib.auction_assign.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                   + [ctypes.c_float, ctypes.c_int,
                                      ctypes.c_void_p])
    lib.auction_assign.restype = ctypes.c_int
    return lib


def auction_smem_bytes(Q: int, N: int) -> int:
    """The shared memory a problem's block holds (auction.cu)."""
    return 4 * (N * Q + 2 * Q + 4 * N)


def auction_assign(cost: torch.Tensor, box_mask: torch.Tensor, *,
                   eps_frac: float = 1.0 / 500.0, max_iters: int = 256,
                   return_iters: bool = False):
    """Device-side assignment by the Bertsekas auction, the JAX package's
    ``auction_assign``: ``cost (..., Q, N)`` (cast to fp32) and
    ``box_mask (..., N)``, whose leading axes end the cost's; each valid
    gt bids for its best query under the current prices, all at once
    (Jacobi), with ε = ``spread · eps_frac`` (ε-CS: the total within
    ``n_valid · ε`` of the optimum).  Leading axes are independent
    problems.  Returns int32 ``(..., Q)``, each query's gt slot or -1
    (with ``return_iters``, also each problem's iteration count).

    CPU tensors run :func:`auction_assign_reference`; CUDA tensors are one
    launch of ``csrc/auction.cu``, with no host read, or raise."""
    lead, Q, N, mlead = _auction_shapes(cost, box_mask)
    if cost.device.type == "cpu" and box_mask.device.type == "cpu":
        return auction_assign_reference(cost, box_mask, eps_frac=eps_frac,
                                        max_iters=max_iters,
                                        return_iters=return_iters)
    if auction_smem_bytes(Q, N) > _SMEM_MAX:
        raise ValueError(f"an auction of {Q} queries and {N} gt slots holds "
                         f"{auction_smem_bytes(Q, N)} bytes of shared memory, "
                         f"more than a block's {_SMEM_MAX}")
    if cost.device != box_mask.device or cost.device.type != "cuda":
        raise ValueError(f"the auction takes cost and box_mask on one CUDA "
                         f"device, got {cost.device} and {box_mask.device}")
    c = cost.float().contiguous()
    m = box_mask.float().contiguous()
    owner = torch.empty(lead + (Q,), dtype=torch.int32, device=c.device)
    iters = torch.empty(lead, dtype=torch.int32, device=c.device)
    P = math.prod(lead)
    if P:
        stream = torch.cuda.current_stream(c.device).cuda_stream
        check(_lib().auction_assign(
            c.data_ptr(), m.data_ptr(), owner.data_ptr(), iters.data_ptr(),
            P, Q, N, math.prod(mlead), eps_frac, max_iters, stream),
            "auction")
        auction_assign.launches += 1
    return (owner, iters) if return_iters else owner


auction_assign.launches = 0
