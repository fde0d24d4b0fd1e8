"""Faster R-CNN, counterpart of ``vit_torch_tpu/detection/faster_rcnn.py``
(the reference's torchvision ``fasterrcnn_resnet50_fpn`` path,
``object/coco_pipeline.py:428-438``, and its Swin-FPN module surgery,
``object/module_surgery.py:92-126``): backbone stage maps, an FPN, an RPN
head shared by every level, fixed-count proposals by top-k and padded
NMS, multi-level RoIAlign, the two-layer box head, the RPN and RoI losses
with device-side matching and sampling, and the decode to scored boxes.
With ``num_keypoints`` the Keypoint R-CNN branch
(:mod:`~vit_torch_tpu_torch.detection.keypoint`) runs on the top-score
proposals in training and on the final detections in eval.

Fixed shapes end to end, as in the JAX package: static anchors per image
size and level, ``num_proposals`` proposals an image (unit boxes in the
slots NMS leaves empty), ``rpn_batch`` / ``roi_batch`` sampled anchors and
proposals with validity weights.  Every function takes a leading batch
axis; nothing reads the device from the host.

What differs in form from the JAX module:

- the randomness of the balanced sampling is an argument: the trainer
  draws the RPN noise ``(B, ΣA)`` and the RoI noise ``(B, R)`` from its
  generator and :func:`faster_rcnn_losses` takes them (``draws``), so
  that a test can feed the JAX key sequence's draws in;
- top-k is a stable descending sort, so that equal values keep index
  order, as ``jax.lax.top_k`` orders them (``torch.topk`` promises no
  order among ties);
- the RPN convs give (B, A[·4], H, W); they are permuted to (B, H, W,
  A[·4]) before the flatten, the position-major order of
  :func:`generate_anchors` (flax's NHWC reshape);
- the FPN's top-down upsampling is ``F.interpolate(mode="nearest-exact")``,
  which is ``jax.image.resize(..., "nearest")`` (``mode="nearest"`` is not
  at odd sizes);
- RoIAlign gathers rows of the ``(B·ΣHW, C)`` pyramid with one
  ``index_select`` per corner instead of a ``take_along_axis`` whose index
  is expanded over the channels.

``box_fc1`` and ``box_fc2`` are :class:`~vit_torch_tpu_torch.models.
layers.QLinear` (int8 in eval under ``VITX_W8A8=1``); ``cls_score`` and
``bbox_pred`` stay plain.  Parameters are fp32 and activations run in the
model's ``dtype``; box arithmetic runs in fp32 (or the activations' dtype
where that is wider).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vit_torch_tpu_torch.detection.boxes import box_iou, nms_padded
from vit_torch_tpu_torch.detection.keypoint import (KeypointHead,
                                                    heatmaps_to_keypoints,
                                                    keypoint_loss)
from vit_torch_tpu_torch.models.layers import (Conv2d, Linear, QLinear,
                                               init_weights)
from vit_torch_tpu_torch.parallel.collectives import global_sum

# --------------------------------------------------------------------------
# anchors, box coding, matching and sampling
# --------------------------------------------------------------------------


def generate_anchors(image_size: int, strides: Tuple[int, ...],
                     sizes: Tuple[float, ...],
                     ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
                     ) -> np.ndarray:
    """Static ``(ΣA, 4)`` fp32 xyxy anchors over every FPN level, one size
    a level and three ratios (torchvision ``AnchorGenerator``), laid out
    position-major: (y, x, ratio) with the ratio innermost, the order of
    :class:`RPNHead`'s flattened outputs."""
    all_anchors = []
    for stride, size in zip(strides, sizes):
        g = image_size // stride
        cy = (np.arange(g) + 0.5) * stride
        cx = (np.arange(g) + 0.5) * stride
        cyy, cxx = np.meshgrid(cy, cx, indexing="ij")
        centers = np.stack([cxx, cyy, cxx, cyy], axis=-1).reshape(-1, 1, 4)
        base = np.stack([
            np.array([-w / 2, -h / 2, w / 2, h / 2])
            for ratio in ratios
            for h, w in [(size * math.sqrt(ratio), size / math.sqrt(ratio))]
        ])
        all_anchors.append((centers + base[None]).reshape(-1, 4))
    return np.concatenate(all_anchors).astype(np.float32)


@functools.lru_cache(maxsize=32)
def anchors_on(image_size: int, strides: Tuple[int, ...],
               sizes: Tuple[float, ...], device: torch.device
               ) -> torch.Tensor:
    """:func:`generate_anchors` as a tensor on ``device``, made once."""
    return torch.from_numpy(generate_anchors(image_size, strides,
                                             sizes)).to(device)


@functools.lru_cache(maxsize=64)
def _constant(values: Tuple, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """A small constant tensor on ``device``, copied there once (a copy
    per step would wait for the device)."""
    return torch.tensor(values, dtype=dtype).to(device)


def _centers(boxes: torch.Tensor):
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(1e-3)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-3)
    return boxes[..., 0] + w / 2, boxes[..., 1] + h / 2, w, h


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """xyxy boxes → (dx, dy, dw, dh) against ``anchors`` (R-CNN coding);
    widths and heights clamped at 1e-3, so that the degenerate boxes of
    empty slots give finite (masked-out) terms."""
    ax, ay, aw, ah = _centers(anchors)
    bx, by, bw, bh = _centers(boxes)
    return torch.stack([(bx - ax) / aw, (by - ay) / ah,
                        torch.log(bw / aw), torch.log(bh / ah)], -1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 clip: Optional[float] = None) -> torch.Tensor:
    """The inverse of :func:`encode_boxes`, with dw and dh clipped to
    [-4, 4] and the boxes optionally clipped to ``[0, clip]``."""
    ax, ay, aw, ah = _centers(anchors)
    dx, dy, dw, dh = deltas.unbind(-1)
    dw = dw.clamp(-4.0, 4.0)
    dh = dh.clamp(-4.0, 4.0)
    cx = ax + dx * aw
    cy = ay + dy * ah
    w = aw * torch.exp(dw)
    h = ah * torch.exp(dh)
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if clip is not None:
        boxes = boxes.clamp(0.0, clip)
    return boxes


def smooth_l1(x: torch.Tensor, beta: float = 1.0 / 9) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax ** 2 / beta, ax - 0.5 * beta)


def optax_sigmoid_ce(logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy (optax's formula)."""
    return (logits.clamp_min(0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def match_to_gt(candidates: torch.Tensor, gt_boxes: torch.Tensor,
                gt_mask: torch.Tensor, hi: float, lo: float,
                allow_low_quality: bool = False):
    """torchvision ``Matcher`` over a batch: ``candidates`` (B, A, 4) (or
    (A, 4), shared by the batch), ``gt_boxes`` (B, G, 4), ``gt_mask`` (B,
    G).  Returns ``(matched_gt_idx, label)`` of shape (B, A): label 1
    positive (IoU >= hi), 0 negative (< lo), -1 ignored; the best gt is
    the first of equal IoUs.  ``allow_low_quality`` makes every
    candidate that is a gt's best match (within 1e-6, IoU > 0) positive."""
    iou = box_iou(candidates, gt_boxes)                       # (B, A, G)
    gt_on = gt_mask[..., None, :] > 0
    iou = torch.where(gt_on, iou, torch.full_like(iou, -1.0))
    best_iou, best_gt = iou.max(-1)
    label = torch.where(best_iou >= hi, 1,
                        torch.where(best_iou < lo, 0, -1))
    if allow_low_quality:
        gt_best = iou.amax(-2, keepdim=True)                  # (B, 1, G)
        is_best = (iou >= gt_best - 1e-6) & gt_on & (iou > 0)
        label = torch.where(is_best.any(-1), 1, label)
    return best_gt, label


def top_k(values: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values, equal
    values in index order."""
    order = torch.sort(values, dim=-1, descending=True, stable=True)
    return order.values[..., :k], order.indices[..., :k]


def sample_balanced(noise: torch.Tensor, label: torch.Tensor, num: int,
                    pos_fraction: float):
    """Fixed-size positive/negative sampling over a batch: ``noise`` (B, n)
    uniform in [0, 1) (the JAX function draws it inside), ``label`` (B, n)
    from :func:`match_to_gt`.  The ``int(num · pos_fraction)``
    positives and the other negatives are the top-k of the label-shifted
    noise.  Returns ``(idx, weight, is_pos)`` of shape (B, num): weight 1
    for a real sample, 0 for padding; both fp32."""
    n_pos = int(num * pos_fraction)
    pos_score = torch.where(label == 1, 1.0 + noise, noise - 2.0)
    _, pos_idx = top_k(pos_score, n_pos)
    pos_valid = label.gather(-1, pos_idx) == 1
    neg_score = torch.where(label == 0, 1.0 + noise, noise - 2.0)
    _, neg_idx = top_k(neg_score, num - n_pos)
    neg_valid = label.gather(-1, neg_idx) == 0
    idx = torch.cat([pos_idx, neg_idx], -1)
    weight = torch.cat([pos_valid, neg_valid], -1).float()
    is_pos = torch.cat([pos_valid, torch.zeros_like(neg_valid)], -1).float()
    return idx, weight, is_pos


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for ``x`` (B, n, ...) and ``idx`` (B, k)."""
    tail = x.shape[2:]
    index = idx.reshape(idx.shape + (1,) * len(tail)).expand(
        idx.shape + tail)
    return x.gather(1, index)


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class FPN(nn.Module):
    """Feature Pyramid Network over the backbone's stage maps: a lateral
    1x1 conv a level, the top-down nearest-neighbour upsample and sum,
    and a 3x3 conv a level (torchvision's layout).  NHWC in and out."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        self.lateral = nn.ModuleList(Conv2d(c, out_channels, 1)
                                     for c in in_channels)
        self.output = nn.ModuleList(
            Conv2d(out_channels, out_channels, 3, padding=1)
            for _ in in_channels)

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [conv(_nchw(f)) for conv, f in zip(self.lateral, feats)]
        outs = [laterals[-1]]
        for lat in laterals[-2::-1]:
            up = F.interpolate(outs[0], size=lat.shape[-2:],
                               mode="nearest-exact")
            outs.insert(0, lat + up)
        return [_nhwc(conv(o)) for conv, o in zip(self.output, outs)]


class RPNHead(nn.Module):
    """One 3x3 conv + ReLU shared by every level, then the objectness
    (A channels) and box-delta (4A channels, ordered (a, 4)) 1x1 convs.
    Returns logits (B, ΣA) and deltas (B, ΣA, 4) in anchor order."""

    def __init__(self, channels: int, num_anchors: int = 3):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)
        self.cls_logits = Conv2d(channels, num_anchors, 1)
        self.bbox_pred = Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats: List[torch.Tensor]):
        logits, deltas = [], []
        for f in feats:
            h = F.relu(self.conv(_nchw(f)))
            B = h.shape[0]
            logits.append(_nhwc(self.cls_logits(h)).reshape(B, -1))
            deltas.append(_nhwc(self.bbox_pred(h)).reshape(B, -1, 4))
        return torch.cat(logits, 1), torch.cat(deltas, 1)


def _roi_levels_and_grid(n_levels: int, boxes: torch.Tensor,
                         output_size: int):
    """Each RoI's FPN level (torchvision's ``floor(4 + log2(sqrt(wh) /
    224))``, clamped to the pyramid) and its S sample centres along y and
    x in image pixels."""
    S = output_size
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(1.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(1.0)
    k = torch.floor(4 + torch.log2(torch.sqrt(w * h) / 224.0 + 1e-8))
    k = k.clamp(2, 2 + n_levels - 1) - 2
    ys = (torch.arange(S, dtype=torch.float32, device=boxes.device)
          + 0.5) / S
    grid_y = boxes[..., 1:2] + ys * h[..., None]
    grid_x = boxes[..., 0:1] + ys * w[..., None]
    return k.long(), grid_y, grid_x


def _bilinear(gy: torch.Tensor, gx: torch.Tensor, fetch) -> torch.Tensor:
    """The four-corner bilinear blend of ``fetch(y, x)`` (B, R, S, S, C)
    at sample coordinates ``gy``, ``gx`` (B, R, S) in map pixels, weights
    in their dtype."""
    y0 = torch.floor(gy)
    x0 = torch.floor(gx)
    wy = (gy - y0)[..., :, None, None]
    wx = (gx - x0)[..., None, :, None]
    y0, x0 = y0.long(), x0.long()
    v00, v01 = fetch(y0, x0), fetch(y0, x0 + 1)
    v10, v11 = fetch(y0 + 1, x0), fetch(y0 + 1, x0 + 1)
    return ((1 - wy) * (1 - wx) * v00 + (1 - wy) * wx * v01
            + wy * (1 - wx) * v10 + wy * wx * v11)


def _roi_align_flat(feats: List[torch.Tensor], boxes: torch.Tensor,
                    strides: Tuple[int, ...],
                    output_size: int = 7) -> torch.Tensor:
    """Every RoI reads its one level of the concatenated ``(B·ΣHW, C)``
    pyramid through flat row indices ``b·ΣHW + offset[k] + y·W[k] + x``:
    one ``index_select`` a corner."""
    B, R, _ = boxes.shape
    S, C = output_size, feats[0].shape[-1]
    dev = boxes.device
    lvl, grid_y, grid_x = _roi_levels_and_grid(len(feats), boxes, S)
    hs = [f.shape[1] for f in feats]
    ws = [f.shape[2] for f in feats]
    offs = np.concatenate([[0], np.cumsum(np.asarray(hs) * ws)[:-1]])
    total = int(sum(h * w for h, w in zip(hs, ws)))
    flat = torch.cat([f.reshape(B, -1, C) for f in feats], 1).reshape(-1, C)
    stride_r = _constant(tuple(float(s) for s in strides), torch.float32,
                         dev)[lvl]                           # (B, R)
    Hl = _constant(tuple(hs), torch.long, dev)[lvl][..., None]
    Wl = _constant(tuple(ws), torch.long, dev)[lvl][..., None]
    base = (_constant(tuple(int(o) for o in offs), torch.long, dev)[lvl]
            + torch.arange(B, device=dev)[:, None] * total)[..., None, None]

    def fetch(yi, xi):
        yi = torch.minimum(yi.clamp_min(0), Hl - 1)          # (B, R, S)
        xi = torch.minimum(xi.clamp_min(0), Wl - 1)
        idx = base + (yi * Wl)[..., :, None] + xi[..., None, :]
        return flat.index_select(0, idx.reshape(-1)).reshape(B, R, S, S, C)

    gy = grid_y / stride_r[..., None] - 0.5
    gx = grid_x / stride_r[..., None] - 0.5
    return _bilinear(gy, gx, fetch)


def _roi_align_blend(feats: List[torch.Tensor], boxes: torch.Tensor,
                     strides: Tuple[int, ...],
                     output_size: int = 7) -> torch.Tensor:
    """Every RoI sampled at every level, the levels summed under the
    one-hot of its own: L times the gathers of :func:`_roi_align_flat`
    for the same values (``VITX_ROI_FLAT=0``, kept for A/B)."""
    B, R, _ = boxes.shape
    S = output_size
    dev = boxes.device
    lvl, grid_y, grid_x = _roi_levels_and_grid(len(feats), boxes, S)
    image = torch.arange(B, device=dev)[:, None, None, None]
    sampled = []
    for feat, stride in zip(feats, strides):
        Hl, Wl, C = feat.shape[1:]
        rows = feat.reshape(-1, C)

        def fetch(yi, xi, Hl=Hl, Wl=Wl, C=C, rows=rows):
            yi = yi.clamp(0, Hl - 1)
            xi = xi.clamp(0, Wl - 1)
            idx = image * (Hl * Wl) + (yi * Wl)[..., :, None] \
                + xi[..., None, :]
            return rows.index_select(0, idx.reshape(-1)).reshape(
                B, R, S, S, C)

        sampled.append(_bilinear(grid_y / stride - 0.5,
                                 grid_x / stride - 0.5, fetch))
    sampled = torch.stack(sampled)                         # (L, B, R, S, S, C)
    onehot = F.one_hot(lvl, len(feats)).permute(2, 0, 1).to(sampled.dtype)
    return (sampled * onehot[..., None, None, None]).sum(0)


def roi_align(feats: List[torch.Tensor], boxes: torch.Tensor,
              strides: Tuple[int, ...], output_size: int = 7) -> torch.Tensor:
    """Multi-level RoIAlign: ``feats`` the (B, Hl, Wl, C) levels,
    ``boxes`` (B, R, 4) xyxy in image pixels; (B, R, S, S, C) out, in the
    wider of the maps' dtype and fp32.  One sample a bin at its centre,
    coordinates clamped at the map's edge.  The flat gather is the
    default; ``VITX_ROI_FLAT=0`` (read per call) takes the all-levels
    blend, which computes the same values."""
    if os.environ.get("VITX_ROI_FLAT", "1") != "0":
        return _roi_align_flat(feats, boxes, strides, output_size)
    return _roi_align_blend(feats, boxes, strides, output_size)


@dataclasses.dataclass(frozen=True)
class FasterRCNNConfig:
    num_classes: int = 91            # foreground classes (labels 1..K)
    image_size: int = 512
    fpn_channels: int = 256
    strides: Tuple[int, ...] = (4, 8, 16, 32)
    anchor_sizes: Tuple[float, ...] = (32.0, 64.0, 128.0, 256.0)
    num_proposals: int = 256         # fixed post-NMS proposal count
    rpn_pre_nms_topk: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_batch: int = 256             # sampled anchors per image
    roi_batch: int = 128             # sampled proposals per image
    detections: int = 100
    # Keypoint R-CNN branch (torchvision keypointrcnn_resnet50_fpn
    # semantics); 0 = no keypoint head
    num_keypoints: int = 0
    kp_conv_channels: Tuple[int, ...] = (512,) * 8
    kp_roi_size: int = 14            # RoIAlign grid for the keypoint branch
    kp_rois: int = 128               # train-time proposals covered (top-score)

    @property
    def num_anchors(self) -> int:
        """ΣA: three anchors a position of every level."""
        return sum(3 * (self.image_size // s) ** 2 for s in self.strides)


class FasterRCNN(nn.Module):
    """Backbone stage maps → FPN → RPN → proposals → RoI heads.

    ``backbone`` maps NHWC images to a list of NHWC stage maps at
    ``config.strides`` with ``stage_channels`` channels.  ``forward``
    returns the raw pieces (``anchors``, ``rpn_logits``, ``rpn_deltas``,
    ``proposals``, ``proposal_scores``, ``proposal_index`` (each slot's
    anchor, -1 where NMS left it empty), ``cls_logits``, ``box_deltas``;
    with keypoints ``kp_logits`` and ``kp_boxes``, and in eval
    ``detections``); :func:`faster_rcnn_losses` trains on them and
    :func:`faster_rcnn_predict` decodes them."""

    def __init__(self, config: FasterRCNNConfig, backbone: nn.Module,
                 stage_channels: Sequence[int],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cfg = config
        if len(stage_channels) != len(cfg.strides):
            raise ValueError(f"{len(stage_channels)} backbone stages for "
                             f"{len(cfg.strides)} strides")
        self.config = cfg
        self.dtype = dtype
        self.backbone = backbone
        C = cfg.fpn_channels
        self.fpn = FPN(stage_channels, C)
        self.rpn = RPNHead(C)
        S = 7
        self.box_fc1 = QLinear(S * S * C, 1024)
        self.box_fc2 = QLinear(1024, 1024)
        self.cls_score = Linear(1024, cfg.num_classes + 1)
        self.bbox_pred = Linear(1024, 4 * (cfg.num_classes + 1))
        self.kp_head = None
        if cfg.num_keypoints > 0:
            self.kp_head = KeypointHead(C, cfg.num_keypoints,
                                        cfg.kp_conv_channels)

    @torch.no_grad()
    def proposals(self, logits: torch.Tensor, deltas: torch.Tensor,
                  anchors: torch.Tensor):
        """Fixed-count proposals (no gradient, as torchvision's): the
        decoded boxes of the top ``rpn_pre_nms_topk`` logits, NMS at
        ``rpn_nms_thresh`` to ``num_proposals``; the empty slots become
        unit boxes at the origin with score -inf.  Returns ``(boxes,
        scores, anchor_index)`` (index -1 in empty slots)."""
        cfg = self.config
        boxes = decode_boxes(deltas, anchors, clip=float(cfg.image_size))
        k = min(cfg.rpn_pre_nms_topk, logits.shape[-1])
        score, idx = top_k(logits, k)
        cand = _rows(boxes, idx)
        keep, valid = nms_padded(cand, score, cfg.rpn_nms_thresh,
                                 cfg.num_proposals)
        out_boxes = _rows(cand, keep)
        out_scores = torch.where(valid, score.gather(1, keep),
                                 torch.full_like(score[:, :1], -math.inf))
        unit = out_boxes.new_zeros(4)
        unit[2:] = 1.0
        out_boxes = torch.where(valid[..., None], out_boxes, unit)
        index = torch.where(valid, idx.gather(1, keep),
                            torch.full_like(keep, -1))
        return out_boxes, out_scores, index

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg = self.config
        feats = self.backbone(images)
        if len(feats) != len(cfg.strides):
            raise ValueError(f"backbone returned {len(feats)} maps for "
                             f"{len(cfg.strides)} strides")
        feats = self.fpn([f.to(self.dtype) for f in feats])
        rpn_logits, rpn_deltas = self.rpn(feats)
        anchors = anchors_on(cfg.image_size, tuple(cfg.strides),
                             tuple(float(s) for s in cfg.anchor_sizes),
                             images.device)
        prop_boxes, prop_scores, prop_index = self.proposals(
            rpn_logits.detach(), rpn_deltas.detach(), anchors)

        roi_feats = roi_align(feats, prop_boxes, cfg.strides)  # (B,R,7,7,C)
        B, R = roi_feats.shape[:2]
        x = roi_feats.reshape(B, R, -1).to(self.dtype)
        x = F.relu(self.box_fc1(x))
        x = F.relu(self.box_fc2(x))
        cls_logits = self.cls_score(x)
        box_deltas = self.bbox_pred(x).reshape(B, R, -1, 4)
        outputs = {"anchors": anchors, "rpn_logits": rpn_logits,
                   "rpn_deltas": rpn_deltas, "proposals": prop_boxes,
                   "proposal_scores": prop_scores,
                   "proposal_index": prop_index, "cls_logits": cls_logits,
                   "box_deltas": box_deltas}
        if self.kp_head is not None:
            if not self.training:
                # eval: keypoints on the final detections, as torchvision
                # infers them
                with torch.no_grad():
                    dets = decode_detections(outputs, cfg)
                kp_boxes = dets["boxes"]
                outputs["detections"] = dets
            else:
                # train: keypoints on the top-score proposals; the loss
                # keeps the positives among them
                kp_boxes = prop_boxes[:, :cfg.kp_rois]
            kp_feats = roi_align(feats, kp_boxes, cfg.strides,
                                 cfg.kp_roi_size)
            outputs["kp_logits"] = self.kp_head(kp_feats.to(self.dtype))
            outputs["kp_boxes"] = kp_boxes
        return outputs


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def draw_noise(generator: torch.Generator, cfg: FasterRCNNConfig,
               batch: int, device) -> Dict[str, torch.Tensor]:
    """The sampling noise of one step: ``rpn_noise`` (B, ΣA) and
    ``roi_noise`` (B, num_proposals), uniform in [0, 1)."""
    return {"rpn_noise": torch.rand((batch, cfg.num_anchors),
                                    generator=generator, device=device),
            "roi_noise": torch.rand((batch, cfg.num_proposals),
                                    generator=generator, device=device)}


def faster_rcnn_losses(outputs: Dict[str, torch.Tensor],
                       targets: Dict[str, torch.Tensor],
                       cfg: FasterRCNNConfig,
                       draws: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """The RPN and RoI-head losses (torchvision's: BCE and smooth L1 over
    ``rpn_batch`` sampled anchors matched at 0.7 / 0.3 IoU with the
    low-quality rescue; CE and class-specific smooth L1 over
    ``roi_batch`` sampled proposals matched at 0.5, a quarter positive),
    each the mean over the batch's real images; with keypoint outputs and
    ``targets["keypoints"]`` the keypoint loss.  ``draws`` holds the
    sampling noise (:func:`draw_noise`).  Targets: ``boxes`` (B, G, 4)
    xyxy pixels, ``labels`` (B, G), ``box_mask`` (B, G), ``mask`` (B,).
    ``loss`` is the sum of the terms."""
    anchors = outputs["anchors"]
    gt_boxes, gt_mask = targets["boxes"], targets["box_mask"]
    gt_labels = targets["labels"].long()
    sample_mask = targets["mask"]

    # ---- RPN ----
    gt_idx, a_label = match_to_gt(anchors, gt_boxes, gt_mask, hi=0.7,
                                  lo=0.3, allow_low_quality=True)
    idx, weight, is_pos = sample_balanced(draws["rpn_noise"], a_label,
                                          cfg.rpn_batch, 0.5)
    logit = outputs["rpn_logits"].gather(1, idx)
    bce = optax_sigmoid_ce(logit, is_pos)
    n_w = weight.sum(-1).clamp_min(1.0)
    rpn_cls = (bce * weight).sum(-1) / n_w
    matched = _rows(gt_boxes, gt_idx.gather(1, idx))
    reg_t = encode_boxes(matched, anchors[idx])
    reg = smooth_l1(_rows(outputs["rpn_deltas"], idx) - reg_t).sum(-1)
    rpn_reg = (reg * is_pos).sum(-1) / n_w

    # ---- RoI head ----
    proposals = outputs["proposals"]
    p_idx, p_label = match_to_gt(proposals, gt_boxes, gt_mask, hi=0.5,
                                 lo=0.5)
    sidx, sweight, spos = sample_balanced(draws["roi_noise"], p_label,
                                          cfg.roi_batch, 0.25)
    gt_of = p_idx.gather(1, sidx)
    cls_t = torch.where(spos > 0, gt_labels.gather(1, gt_of),
                        torch.zeros_like(gt_of))
    logp = torch.log_softmax(_rows(outputs["cls_logits"], sidx).float(), -1)
    ce = -logp.gather(-1, cls_t[..., None])[..., 0]
    roi_cls = (ce * sweight).sum(-1) / sweight.sum(-1).clamp_min(1.0)
    reg_t = encode_boxes(_rows(gt_boxes, gt_of), _rows(proposals, sidx))
    deltas = _rows(outputs["box_deltas"], sidx)              # (B, n, K+1, 4)
    d = deltas.gather(2, cls_t[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    reg = smooth_l1(d - reg_t).sum(-1)
    roi_reg = (reg * spos).sum(-1) / spos.sum(-1).clamp_min(1.0)

    n = global_sum(sample_mask.sum()).clamp_min(1.0)
    names = ("loss_rpn_cls", "loss_rpn_reg", "loss_cls", "loss_reg")
    out = {k: (v * sample_mask).sum() / n
           for k, v in zip(names, (rpn_cls, rpn_reg, roi_cls, roi_reg))}
    if "kp_logits" in outputs and "keypoints" in targets:
        kp = _keypoint_loss_batch(outputs, targets)
        out["loss_keypoint"] = kp.sum() / n
    out["loss"] = sum(out.values())
    return out


def _keypoint_loss_batch(outputs: Dict[str, torch.Tensor],
                         targets: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-image keypoint heatmap CE (B,) over the keypoint branch's RoIs
    that match a gt box at IoU >= 0.5, each held to its gt's keypoints
    (torchvision ``keypointrcnn_loss``), times the image mask."""
    kp_boxes = outputs["kp_boxes"]
    gt_idx, label = match_to_gt(kp_boxes, targets["boxes"],
                                targets["box_mask"], hi=0.5, lo=0.5)
    weights = (label == 1).float()
    matched = _rows(targets["keypoints"], gt_idx)            # (B, Rk, K, 3)
    return keypoint_loss(outputs["kp_logits"], kp_boxes, matched,
                         weights) * targets["mask"]


# --------------------------------------------------------------------------
# decoding
# --------------------------------------------------------------------------

def decode_detections(outputs: Dict[str, torch.Tensor],
                      cfg: FasterRCNNConfig,
                      score_thresh: float = 0.05) -> Dict[str, torch.Tensor]:
    """Class scores and class-specific boxes of every proposal, then a
    class-aware NMS at 0.5 (boxes offset by ``label · 2S``, so that
    classes never overlap) to ``detections`` a picture, in letterbox
    pixels: ``boxes`` (B, D, 4), ``scores`` (0 in empty slots) and
    ``labels`` (0 there)."""
    prob = torch.softmax(outputs["cls_logits"].float(), -1)
    scores, labels = prob[..., 1:].max(-1)
    labels = labels + 1
    d = outputs["box_deltas"].gather(
        2, labels[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    boxes = decode_boxes(d, outputs["proposals"], clip=float(cfg.image_size))
    score = torch.where(scores >= score_thresh, scores,
                        torch.full_like(scores, -math.inf))
    offset = labels.float()[..., None] * (cfg.image_size * 2.0)
    keep, valid = nms_padded(boxes + offset, score, 0.5, cfg.detections)
    return {"boxes": _rows(boxes, keep),
            "scores": torch.where(valid, score.gather(1, keep),
                                  torch.zeros_like(score[:, :1])),
            "labels": torch.where(valid, labels.gather(1, keep),
                                  torch.zeros_like(keep))}


def faster_rcnn_predict(outputs: Dict[str, torch.Tensor],
                        cfg: FasterRCNNConfig, scale: torch.Tensor,
                        pad: torch.Tensor,
                        score_thresh: float = 0.05
                        ) -> Dict[str, torch.Tensor]:
    """:func:`decode_detections` (or the eval forward's own), the
    letterbox undone (pad subtracted, divided by the scale); with the
    keypoint branch's eval outputs, ``keypoints`` (B, D, K, 3) decoded
    from the heatmaps and undone the same way."""
    dets = outputs.get("detections")
    if dets is None:
        dets = decode_detections(outputs, cfg, score_thresh)
    pad_xy = torch.cat([pad, pad], -1)[:, None, :]
    out = {"boxes": (dets["boxes"] - pad_xy) / scale[:, None, None],
           "scores": dets["scores"], "labels": dets["labels"]}
    if "kp_logits" in outputs and "detections" in outputs:
        kps = heatmaps_to_keypoints(outputs["kp_logits"],
                                    outputs["kp_boxes"])    # (B, D, K, 3)
        xy = (kps[..., :2] - pad[:, None, None, :]) \
            / scale[:, None, None, None]
        out["keypoints"] = torch.cat([xy, kps[..., 2:]], -1)
    return out


# --------------------------------------------------------------------------
# construction
# --------------------------------------------------------------------------

def make_backbone(name: str, image_size: int,
                  dtype: torch.dtype) -> Tuple[nn.Module, List[int]]:
    """The stage-map backbone of ``name`` and its stages' channels: a
    Swin config's ``SwinTransformer(multi_features=True)`` (the
    reference's module surgery), else a ResNet config's
    ``ResNet(features_only=True)``."""
    from vit_torch_tpu_torch.models.resnet import (EXPANSION,
                                                   RESNET_CONFIGS, ResNet)
    from vit_torch_tpu_torch.models.swin import SWIN_CONFIGS, SwinTransformer
    if name in SWIN_CONFIGS:
        cfg = SWIN_CONFIGS[name]
        trunk = SwinTransformer(cfg, image_size=image_size, dtype=dtype,
                                multi_features=True)
        return trunk, [cfg.embed_dim * 2 ** i for i in range(len(cfg.depths))]
    if name in RESNET_CONFIGS:
        cfg = RESNET_CONFIGS[name]
        trunk = ResNet(cfg, image_size=image_size, dtype=dtype,
                       features_only=True)
        return trunk, [64 * 2 ** i * EXPANSION for i in range(len(cfg.layers))]
    raise ValueError(f"unsupported Faster R-CNN backbone {name!r} (a swin or "
                     f"resnet config)")


@torch.no_grad()
def init_faster_rcnn(model: FasterRCNN, generator: torch.Generator) -> None:
    """Seeded init in flax's defaults for the heads: ``lecun_normal``
    (truncated normal of std ``1/sqrt(fan_in)``) on every conv, the
    keypoint deconv and linear weight, biases 0; the backbone as
    :func:`~vit_torch_tpu_torch.models.layers.init_weights` initialises
    it."""
    init_weights(model.backbone, generator)
    for name, mod in model.named_modules():
        if name.startswith("backbone") or not isinstance(
                mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            continue
        w = mod.weight
        fan_in = (w.shape[0] * w[0, 0].numel()
                  if isinstance(mod, nn.ConvTranspose2d) else w[0].numel())
        std = 1.0 / math.sqrt(fan_in) / .87962566103423978
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        if mod.bias is not None:
            mod.bias.zero_()


def build_faster_rcnn(config: FasterRCNNConfig,
                      backbone: str = "resnext50_32x4d",
                      dtype: torch.dtype = torch.bfloat16,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> FasterRCNN:
    """Faster R-CNN (Keypoint R-CNN with ``config.num_keypoints``) over
    the stage maps of ``backbone`` at ``config.image_size``, initialised
    on the CPU from ``generator`` (seed 0 when None) by
    :func:`init_faster_rcnn`, then moved to ``device``.  On the meta
    device the init is skipped, for a state-dict load next.
    ``model.backbone_arch`` keeps ``backbone``'s name."""
    from vit_torch_tpu_torch.models.zoo import reset_buffers
    meta = device is not None and torch.device(device).type == "meta"
    with torch.device("meta" if meta else "cpu"):
        trunk, channels = make_backbone(backbone, config.image_size, dtype)
        model = FasterRCNN(config, trunk, channels, dtype=dtype)
    model.backbone_arch = backbone
    if meta:
        return model
    init_faster_rcnn(model, generator or torch.Generator().manual_seed(0))
    reset_buffers(model)
    return model.to(device) if device is not None else model
