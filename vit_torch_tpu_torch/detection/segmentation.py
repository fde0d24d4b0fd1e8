"""DETR instance masks, counterpart of
``vit_torch_tpu/detection/segmentation.py`` (the reference's
``DETRsegm``, ``object_detr/models/segmentation.py``): per-query
attention maps over the encoder memory (``MHAttentionMap:140``), the
small conv mask head with GroupNorm and the backbone's lateral adapters
(``MaskHeadSmallConv:69``), ``dice_loss:172`` and
``sigmoid_focal_loss:190`` on the Hungarian-matched queries, and the
post-process that upsamples and thresholds the masks, with the bit
packing of the evaluation's copy to the host.

:class:`DETRSegm` is the port's :class:`~vit_torch_tpu_torch.detection.
detr.DETR` with the mask branch: it runs the same transformer
(:meth:`DETR.detect`) and keeps DETR's parameter names, so that a DETR
state dict loads into it and leaves only ``bbox_attention.*`` and
``mask_head.*`` missing.  Its backbone is the port's Swin with
``multi_features=True``: the last stage feeds the transformer, the three
before it (two for a three-stage Swin) are the mask head's laterals.
W8A8 reaches ``input_proj`` and the transformer's QLinears, never the
mask branch.

What the JAX package computes with XLA, done the same way here:

- ``jax.image.resize(..., "nearest")`` samples at half-pixel centres,
  ``floor((j + 0.5) · in / out)`` in float32 (torch's ``nearest-exact``,
  not ``nearest``): :func:`resize_nearest`, used by the mask head's
  upsampling to each lateral and by the gt masks' resize in
  :func:`mask_losses`;
- flax's ``GroupNorm`` has epsilon 1e-6 (torch's default is 1e-5) and
  computes its statistics in fp32; the group count is 8, halved until it
  divides the channels;
- ``jnp.repeat(x, Q, axis=0)`` is ``repeat_interleave``, batch-major;
  the 1 x 1 adapters run on the B maps and broadcast over the queries;
- the attention map's softmax is joint over heads x Hf x Wf, and the
  mask head's input stacks the memory's channels, then the heads';
- the post-process's bilinear upsample is torch's ``bilinear,
  align_corners=False``.

Convolutions are NCHW (:class:`~vit_torch_tpu_torch.models.layers.
Conv2d`, cuDNN on the card); parameters are fp32, activations the
model's dtype.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vit_torch_tpu_torch.detection.detr import DETR, DETRConfig
from vit_torch_tpu_torch.models.layers import Conv2d, Linear
from vit_torch_tpu_torch.parallel.collectives import global_sum

GN_EPS = 1e-6


@functools.lru_cache(maxsize=64)
def _nearest_index(n_in: int, n_out: int, device: torch.device
                   ) -> torch.Tensor:
    """The source index of every output position of
    ``jax.image.resize(..., "nearest")``: ``floor((j + 0.5) · in / out)``
    in float32, in that order of operations."""
    j = torch.arange(n_out, dtype=torch.float32)
    idx = torch.floor((j + 0.5) * n_in / n_out).long().clamp_max(n_in - 1)
    return idx.to(device)


def gather_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (..., h, w), "nearest")`` of the last two
    axes at any size: a gather of rows, then of columns, by
    :func:`_nearest_index`.  Its backward is ``index_add_``'s atomics."""
    H, W = x.shape[-2:]
    x = x.index_select(-2, _nearest_index(H, h, x.device))
    return x.index_select(-1, _nearest_index(W, w, x.device))


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, (..., h, w), "nearest")`` of the last two
    axes.  A doubling of float maps (the mask head's upsampling at every
    512 px stage) takes ``F.interpolate(mode="nearest")``, whose indices
    ``j // 2`` are the same and whose backward sums without atomics
    (chip_smoke's ``segm_step`` times the mask branch both ways).  Any
    other size gathers."""
    H, W = x.shape[-2:]
    h, w = int(size[0]), int(size[1])
    if (h, w) == (H, W):
        return x
    if (h, w) == (2 * H, 2 * W) and x.dim() == 4 and x.is_floating_point():
        return F.interpolate(x, size=(h, w), mode="nearest")
    return gather_nearest(x, h, w)


def _groups(channels: int) -> int:
    g = 8
    while channels % g:
        g //= 2
    return g


class GroupNorm(nn.GroupNorm):
    """flax's ``GroupNorm``: epsilon 1e-6, statistics and affine in fp32
    (or wider), the result in the input's dtype; torch's parameter
    names."""

    def __init__(self, channels: int):
        super().__init__(_groups(channels), channels, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, torch.float32)
        return F.group_norm(x.to(dt), self.num_groups, self.weight.to(dt),
                            self.bias.to(dt), self.eps).to(x.dtype)


class MHAttentionMap(nn.Module):
    """Per-head query → memory attention maps with no value projection:
    (B, Q, C) x (B, Hf, Wf, C) → (B, Q, heads, Hf, Wf), the softmax over
    heads x Hf x Wf jointly (the reference's ``weights.flatten(2)``)."""

    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_linear = Linear(hidden_dim, hidden_dim)
        self.k_linear = Linear(hidden_dim, hidden_dim)

    def forward(self, q: torch.Tensor, memory_map: torch.Tensor
                ) -> torch.Tensor:
        B, Hf, Wf, C = memory_map.shape
        Q, H = q.shape[1], self.num_heads
        d = C // H
        qp = self.q_linear(q).reshape(B, Q, H, d)
        kp = self.k_linear(memory_map).reshape(B, Hf * Wf, H, d)
        # the products of the activation-dtype values, summed in fp32
        logits = torch.einsum("bqhd,bkhd->bqhk", qp.float(),
                              kp.float()) * d ** -0.5
        weights = torch.softmax(logits.reshape(B, Q, H * Hf * Wf), dim=-1)
        return weights.reshape(B, Q, H, Hf, Wf).to(q.dtype)


class MaskHeadSmallConv(nn.Module):
    """The conv mask head with GroupNorm and lateral adapters (reference
    ``MaskHeadSmallConv:69-135``) on (B·Q, C, h, w) stacks: ``lay1``
    keeps the stack's channels, ``lay2`` and each stage after a lateral
    halve them (``max(context_dim // 2**k, 8)``), ``out_lay`` gives one
    logit a pixel.  ``lateral_dims`` are the laterals' channels, in the
    order they are added (the coarsest first)."""

    def __init__(self, in_dim: int, lateral_dims: Sequence[int],
                 context_dim: int):
        super().__init__()
        cd = context_dim
        dims = [max(cd // 2, 8), max(cd // 4, 8), max(cd // 8, 8),
                max(cd // 16, 8)]
        self.lay1 = Conv2d(in_dim, in_dim, 3, padding=1)
        self.gn1 = GroupNorm(in_dim)
        self.lay2 = Conv2d(in_dim, dims[0], 3, padding=1)
        self.gn2 = GroupNorm(dims[0])
        ch = dims[0]
        for i, lat in enumerate(lateral_dims):
            nxt = dims[i + 1] if i + 1 < len(dims) else dims[-1]
            setattr(self, f"adapter{i + 1}", Conv2d(lat, dims[i], 1))
            setattr(self, f"lay{i + 3}", Conv2d(ch, nxt, 3, padding=1))
            setattr(self, f"gn{i + 3}", GroupNorm(nxt))
            ch = nxt
        self.out_lay = Conv2d(ch, 1, 3, padding=1)

    def forward(self, x: torch.Tensor, fpn_feats: List[torch.Tensor],
                num_queries: int) -> torch.Tensor:
        """``x`` (B·Q, C, h, w), batch-major; ``fpn_feats`` (B, C_i, H_i,
        W_i) NCHW.  Returns (B·Q, H_last, W_last) logits."""
        x = F.relu(self.gn1(self.lay1(x)))
        x = F.relu(self.gn2(self.lay2(x)))
        for i, feat in enumerate(fpn_feats):
            lateral = getattr(self, f"adapter{i + 1}")(feat)
            B, c, h, w = lateral.shape
            up = resize_nearest(x, (h, w))
            # the lateral broadcast over each image's queries: the same
            # sums as the JAX repeat, without B·Q copies
            x = (lateral[:, None] + up.reshape(B, num_queries, c, h, w)
                 ).reshape(B * num_queries, c, h, w)
            x = F.relu(getattr(self, f"gn{i + 3}")(
                getattr(self, f"lay{i + 3}")(x)))
        return self.out_lay(x)[:, 0]


class DETRSegm(DETR):
    """DETR with the instance-mask head.  ``backbone`` returns its stage
    maps (Swin ``multi_features=True``), at least three, and has
    ``stage_dims``."""

    def __init__(self, config: DETRConfig, backbone: nn.Module,
                 num_mask_heads: int = 8,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(config, backbone, dtype)
        C = config.hidden_dim
        dims = list(backbone.stage_dims)
        if len(dims) < 3:
            raise ValueError("DETRSegm needs a backbone of at least three "
                             "stages (multi_features=True)")
        self.num_mask_heads = num_mask_heads
        self.bbox_attention = MHAttentionMap(C, num_mask_heads)
        self.mask_head = MaskHeadSmallConv(C + num_mask_heads,
                                           dims[-2:-5:-1], C)

    def mask_logits(self, stages: List[torch.Tensor], memory: torch.Tensor,
                    hs: torch.Tensor) -> torch.Tensor:
        """The mask branch: (B, Q, h, w) logits from the backbone's stage
        maps (NHWC), the encoder memory (B, Hf·Wf, hidden) and the last
        decoder layer's normed output (B, Q, hidden)."""
        B, Hf, Wf, _ = stages[-1].shape
        Q = hs.shape[1]
        mem_map = memory.reshape(B, Hf, Wf, -1)
        attn = self.bbox_attention(hs, mem_map)           # (B, Q, H, Hf, Wf)
        stack = torch.cat([
            mem_map.permute(0, 3, 1, 2).repeat_interleave(Q, dim=0),
            attn.reshape(B * Q, self.num_mask_heads, Hf, Wf)], dim=1)
        fpn = [f.permute(0, 3, 1, 2) for f in stages[-2:-5:-1]]
        masks = self.mask_head(stack, fpn, Q)
        return masks.reshape(B, Q, *masks.shape[-2:])

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        stages = self.backbone(x)
        out, memory, hs = self.detect(stages[-1])
        out["pred_masks"] = self.mask_logits(stages, memory, hs)
        return out


# --------------------------------------------------------------------------
# losses (reference segmentation.py:172-208)
# --------------------------------------------------------------------------

def dice_loss(inputs: torch.Tensor, targets: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """inputs (M, h, w) logits; targets (M, h, w) {0, 1}; valid (M,).  The
    mean over the valid rows of ``1 - (2 Σ p t + 1) / (Σ p + Σ t + 1)``."""
    probs = torch.sigmoid(inputs.float()).flatten(1)
    targets = targets.flatten(1).float()
    num = 2 * (probs * targets).sum(1)
    den = probs.sum(1) + targets.sum(1)
    loss = 1 - (num + 1) / (den + 1)
    valid = valid.float()
    return (loss * valid).sum() / global_sum(valid.sum()).clamp_min(1.0)


def sigmoid_focal_loss(inputs: torch.Tensor, targets: torch.Tensor,
                       valid: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """The focal loss of each pixel's logit, its mean over each row's
    pixels, and the mean over the valid rows."""
    x = inputs.float()
    t = targets.float()
    p = torch.sigmoid(x)
    ce = x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))
    p_t = p * t + (1 - p) * (1 - t)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = loss * (alpha * t + (1 - alpha) * (1 - t))
    per = loss.flatten(1).mean(1)
    valid = valid.float()
    return (per * valid).sum() / global_sum(valid.sum()).clamp_min(1.0)


def mask_losses(pred_masks: torch.Tensor, gt_masks: torch.Tensor,
                assign: torch.Tensor, box_mask: torch.Tensor,
                sample_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The Hungarian-matched mask losses: pred_masks (B, Q, h, w) logits,
    gt_masks (B, N, H, W) binary, assign (B, Q) the gt slot of each query
    or -1, sample_mask (B,) the batch's padding.  The gt masks are
    resized to (h, w) as ``jax.image.resize(..., "nearest")`` does,
    before the gather (both are index selections, so the order does not
    change a value)."""
    B, Q, h, w = pred_masks.shape
    gt = resize_nearest(gt_masks, (h, w))
    safe = assign.long().clamp_min(0)
    gt = torch.gather(gt, 1, safe[:, :, None, None].expand(B, Q, h, w))
    matched = (assign >= 0).float() * sample_mask.float()[:, None]
    pm = pred_masks.reshape(B * Q, h, w)
    gm = gt.reshape(B * Q, h, w)
    valid = matched.reshape(B * Q)
    return {"loss_mask": sigmoid_focal_loss(pm, gm, valid),
            "loss_dice": dice_loss(pm, gm, valid)}


# --------------------------------------------------------------------------
# post-process and the copy to the host
# --------------------------------------------------------------------------

def postprocess_segm(pred_masks: torch.Tensor, image_size: int,
                     threshold: float = 0.5) -> torch.Tensor:
    """(B, Q, h, w) logits → (B, Q, S, S) bool at the letterboxed image's
    resolution: a bilinear upsample in fp32, then ``sigmoid > threshold``
    (reference ``PostProcessSegm:79-103``; the letterbox is undone on the
    host with the batch's scale and pad)."""
    up = F.interpolate(pred_masks.float(), size=(image_size, image_size),
                       mode="bilinear", align_corners=False)
    return torch.sigmoid(up) > threshold


def pack_mask_bits(masks: torch.Tensor) -> torch.Tensor:
    """(..., W) binary masks → (..., ceil(W/8)) uint8, 8 pixels a byte,
    MSB first (``np.unpackbits``'s layout): an eighth of the bytes to
    copy to the host.  A W not a multiple of 8 is zero-padded; the
    unpacker slices ``[..., :W]``."""
    m = masks.to(torch.uint8)
    W = m.shape[-1]
    if W % 8:
        m = F.pad(m, (0, 8 - W % 8))
    m8 = m.reshape(*m.shape[:-1], -1, 8)
    acc = m8[..., 0] << 7
    for i in range(1, 8):
        acc |= m8[..., i] << (7 - i)
    return acc
