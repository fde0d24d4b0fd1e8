"""Keypoint R-CNN head, counterpart of
``vit_torch_tpu/detection/keypoint.py`` (the reference's keypoint path:
``object/coco_utils.py:222-251`` ``get_coco_kp``, the left/right flip swap
of ``object/transforms.py:7-14`` and the ``keypoints`` iou_type of its
``CocoEvaluator``; the model is torchvision's
``keypointrcnn_resnet50_fpn``):

- :class:`KeypointHead`: 3x3 convs + ReLU over (B, R, S, S, C) RoI
  features, a 4x4 stride-2 transposed conv to K maps and a bilinear x2
  upsample: (B, R, 4S, 4S, K) heatmap logits (torchvision
  ``KeypointRCNNHeads`` + ``KeypointRCNNPredictor``: eight 512-channel
  convs, 56 x 56 maps from 14 x 14 RoIs);
- :func:`keypoint_loss`: cross-entropy over the flattened heatmap of every
  visible keypoint of every positive RoI (``keypointrcnn_loss``);
- :func:`heatmaps_to_keypoints`: the argmax bin refined by a 3x3
  soft-argmax, mapped through the box, with its probability as score.

Fixed shapes: a static RoI count, masks for invisible and out-of-box
keypoints.  The JAX ``nn.ConvTranspose((4, 4), strides=2,
padding="SAME")`` is ``F.conv_transpose2d(stride=2, padding=1)`` with the
kernel flipped in space; :mod:`~vit_torch_tpu_torch.checkpoint.
jax_import` flips it on import, so the module holds torch's
``ConvTranspose2d`` weight ``(in, out, kh, kw)``.  ``jax.image.resize(...,
"bilinear")`` by two is ``F.interpolate(mode="bilinear",
align_corners=False)``.
"""

from __future__ import annotations

import re
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vit_torch_tpu_torch.models.layers import Conv2d

# COCO-17 horizontal-flip index swap (left_* <-> right_*), reference
# object/transforms.py:7-14
COCO_KP_FLIP_INDS = (0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13,
                     16, 15)


def kp_flip_inds_from_names(names) -> Tuple[int, ...]:
    """The horizontal-flip index swap from keypoint names: each name maps
    to its left/right mirror where the schema has one, else to itself.
    Mirrors are looked for on token boundaries first (``left``/``right``
    or a bare ``l``/``r`` token between ``_-. `` delimiters, so that
    ``ankle_l`` <-> ``ankle_r`` works and the ``l`` inside ``ankle`` stays),
    then by swapping a first or last ``l``/``r`` character (``tl``/``tr``,
    ``lshoulder``).  COCO-17's names give :data:`COCO_KP_FLIP_INDS`; a
    schema without mirror pairs gives the identity.  A pair that is not
    an involution falls back to the identity."""
    names = list(names)
    idx = {n: i for i, n in enumerate(names)}
    swap = {"left": "right", "right": "left", "l": "r", "r": "l"}

    def mirror(n):
        if not n:
            return n
        toks = re.split(r"([_\-. ])", n)
        for i, t in enumerate(toks):
            if t.lower() in swap:
                cand = "".join(toks[:i] + [swap[t.lower()]] + toks[i + 1:])
                if cand in idx:
                    return cand
        for pos in (-1, 0):
            c = n[pos].lower()
            if c in ("l", "r"):
                sub = swap[c]
                cand = n[:-1] + sub if pos == -1 else sub + n[1:]
                if cand != n and cand in idx:
                    return cand
        return n

    out = [idx[mirror(n)] for n in names]
    for i, j in enumerate(out):
        if out[j] != i:
            out[i] = i
    return tuple(out)


class KeypointHead(nn.Module):
    """(B, R, S, S, C) RoI features → (B, R, 4S, 4S, K) heatmap logits in
    fp32; the convs run in the input's dtype."""

    def __init__(self, in_channels: int, num_keypoints: int,
                 conv_channels: Sequence[int] = (512,) * 8):
        super().__init__()
        chans = [in_channels] + list(conv_channels)
        self.conv = nn.ModuleList(Conv2d(cin, cout, 3, padding=1)
                                  for cin, cout in zip(chans, chans[1:]))
        self.deconv = nn.ConvTranspose2d(chans[-1], num_keypoints, 4,
                                         stride=2, padding=1)
        self.num_keypoints = num_keypoints

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, R, S = x.shape[:3]
        x = x.reshape((B * R,) + x.shape[2:]).permute(0, 3, 1, 2)
        for conv in self.conv:
            x = F.relu(conv(x))
        x = F.conv_transpose2d(x, self.deconv.weight.to(x.dtype),
                               self.deconv.bias.to(x.dtype), stride=2,
                               padding=1)
        x = F.interpolate(x.float(), scale_factor=2, mode="bilinear",
                          align_corners=False)
        return x.permute(0, 2, 3, 1).reshape(B, R, 4 * S, 4 * S,
                                             self.num_keypoints)


def keypoints_to_heatmap_targets(keypoints: torch.Tensor,
                                 boxes: torch.Tensor, heatmap_size: int):
    """gt keypoints (..., K, 3) projected into their RoIs (..., 4): the
    flat heatmap bin (..., K) and a validity mask (..., K) fp32, valid
    where the keypoint is visible and its bin lies in the map.  A
    keypoint on the box's far edge takes the last bin (torchvision's
    boundary remap)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    w = (x2 - x1).clamp_min(1e-3)
    h = (y2 - y1).clamp_min(1e-3)
    kx, ky, kv = keypoints.unbind(-1)
    bx = torch.floor((kx - x1[..., None]) / w[..., None] * heatmap_size)
    by = torch.floor((ky - y1[..., None]) / h[..., None] * heatmap_size)
    last = torch.full_like(bx, heatmap_size - 1)
    bx = torch.where(kx == x2[..., None], last, bx)
    by = torch.where(ky == y2[..., None], last, by)
    inside = (bx >= 0) & (bx < heatmap_size) & (by >= 0) & (by < heatmap_size)
    valid = (inside & (kv > 0)).float()
    bx = bx.clamp(0, heatmap_size - 1).long()
    by = by.clamp(0, heatmap_size - 1).long()
    return by * heatmap_size + bx, valid


def keypoint_loss(kp_logits: torch.Tensor, boxes: torch.Tensor,
                  gt_keypoints: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Mean heatmap CE over the valid keypoints of the weighted RoIs, one
    value per leading index: ``kp_logits`` (..., R, HM, HM, K), ``boxes``
    (..., R, 4), ``gt_keypoints`` (..., R, K, 3) matched to each RoI,
    ``weights`` (..., R) 1 for a positive RoI."""
    HM, K = kp_logits.shape[-2], kp_logits.shape[-1]
    target, valid = keypoints_to_heatmap_targets(gt_keypoints, boxes, HM)
    valid = valid * weights[..., None]                       # (..., R, K)
    logits = kp_logits.reshape(kp_logits.shape[:-3] + (HM * HM, K))
    logp = torch.log_softmax(logits.float(), -2)
    ce = -logp.gather(-2, target[..., None, :])[..., 0, :]   # (..., R, K)
    return (ce * valid).sum((-2, -1)) / valid.sum((-2, -1)).clamp_min(1.0)


def heatmaps_to_keypoints(kp_logits: torch.Tensor,
                          boxes: torch.Tensor) -> torch.Tensor:
    """Heatmap logits (..., HM, HM, K) and their boxes (..., 4) → (..., K,
    3) image-pixel x, y and score: the argmax bin (the first of equal
    logits) refined by the probability-weighted mean offset of its 3x3
    neighbourhood (neighbours past the map's edge left out), mapped
    through the box; the score is the argmax's softmax probability."""
    HM, K = kp_logits.shape[-2], kp_logits.shape[-1]
    flat = kp_logits.reshape(kp_logits.shape[:-3] + (HM * HM, K))
    prob = torch.softmax(flat.float(), -2)
    idx = flat.argmax(-2)                                    # (..., K)
    score = prob.gather(-2, idx[..., None, :])[..., 0, :]
    iy = torch.div(idx, HM, rounding_mode="floor")
    ix = idx % HM
    num_x = torch.zeros_like(score)
    num_y = torch.zeros_like(score)
    den = torch.zeros_like(score)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ny = (iy + dy).clamp(0, HM - 1)
            nx = (ix + dx).clamp(0, HM - 1)
            w = prob.gather(-2, (ny * HM + nx)[..., None, :])[..., 0, :]
            w = w * ((ny == iy + dy) & (nx == ix + dx)).to(w.dtype)
            num_y = num_y + w * dy
            num_x = num_x + w * dx
            den = den + w
    off_y = num_y / den.clamp_min(1e-12)
    off_x = num_x / den.clamp_min(1e-12)
    by = iy.float() + 0.5 + off_y
    bx = ix.float() + 0.5 + off_x
    x1, y1, x2, y2 = boxes.unbind(-1)
    w = (x2 - x1).clamp_min(1e-3)[..., None]
    h = (y2 - y1).clamp_min(1e-3)[..., None]
    kx = x1[..., None] + bx / HM * w
    ky = y1[..., None] + by / HM * h
    return torch.stack([kx, ky, score], -1)
