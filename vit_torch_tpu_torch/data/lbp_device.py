"""Local Binary Patterns on torch tensors, counterpart of
``vit_torch_tpu/data/lbp_device.py``.

The reference's tire pipeline applies random AutoAugment to the RGB image
*before* ``lbp_merge`` every step (``utils_dataset_tire.py:81-90``), so
with ``--aug_auto`` LBP has to run per step on the batch's device, after
the augmentation; the host path (``lbp.py``) runs once at build time.

Every ring sample's offset is the same for all pixels, so bilinear
interpolation is a weighted sum of four edge-clamped shifted copies of
the image: slices of one replicate-padded batch, no gather.  The
semantics are ``lbp.py``'s: scikit-image's ring, the ``>= center - 1e-4``
tie rule, the reference's normalisation ranges and PIL's fixed-point
gray conversion.  The four-tap sum and the normalisation run in float64,
the host's precision, in the host's order (weights first, then the
taps left to right, each product and sum a separate op, so no FMA joins
them), so a ring value within rounding of the tie band compares as it
does on the host and the codes are the host's bit for bit.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from vit_torch_tpu_torch.data.lbp import LBP_METHODS, method_range


def rgb_to_gray_uint8(images: torch.Tensor) -> torch.Tensor:
    """PIL ``convert('L')`` bit-exact: ``(19595 R + 38470 G + 7471 B +
    0x8000) >> 16`` of (..., 3) integer values, as int64."""
    v = images.long()
    return (19595 * v[..., 0] + 38470 * v[..., 1] + 7471 * v[..., 2]
            + 0x8000) >> 16


def lbp_bits(gray: torch.Tensor, n_points: int,
             radius: float) -> torch.Tensor:
    """Neighbour-comparison bits (P, B, H, W) bool of a float64 (B, H, W)
    gray batch; the ring follows scikit-image (p=0 due east,
    counter-clockwise)."""
    B, H, W = gray.shape
    pad = int(math.ceil(radius)) + 1
    padded = F.pad(gray[:, None], (pad, pad, pad, pad),
                   mode="replicate")[:, 0]

    def shifted(dy: int, dx: int) -> torch.Tensor:
        return padded[:, pad + dy:pad + dy + H, pad + dx:pad + dx + W]

    threshold = gray - 1e-4
    bits = []
    for p in range(n_points):
        angle = 2 * math.pi * p / n_points
        sy, sx = -radius * math.sin(angle), radius * math.cos(angle)
        y0, x0 = math.floor(sy), math.floor(sx)
        fy, fx = sy - y0, sx - x0
        v = (((1 - fy) * (1 - fx)) * shifted(y0, x0)
             + ((1 - fy) * fx) * shifted(y0, x0 + 1)
             + (fy * (1 - fx)) * shifted(y0 + 1, x0)
             + (fy * fx) * shifted(y0 + 1, x0 + 1))
        bits.append(v >= threshold)
    return torch.stack(bits)


def lbp_map(bits: torch.Tensor, method: str) -> torch.Tensor:
    """The code map (B, H, W) int64 of ``method`` from :func:`lbp_bits`'
    bits (``lbp._lbp_numpy``'s semantics)."""
    P = bits.shape[0]
    b = bits.long()
    if method in ("default", "ror"):
        weights = (1 << torch.arange(P, device=bits.device)).view(P, 1, 1, 1)
        codes = (b * weights).sum(0)
        if method == "default":
            return codes
        mask = (1 << P) - 1
        best = codes
        for s in range(1, P):
            best = torch.minimum(best,
                                 ((codes >> s) | (codes << (P - s))) & mask)
        return best
    transitions = (b != torch.roll(b, -1, dims=0)).sum(0)
    ones = b.sum(0)
    if method == "uniform":
        return torch.where(transitions <= 2, ones, torch.full_like(ones,
                                                                   P + 1))
    if method == "nri_uniform":
        rise = (b == 1) & (torch.roll(b, 1, dims=0) == 0)
        first_rise = rise.to(torch.uint8).argmax(0)
        label = 1 + (ones - 1) * P + first_rise
        label = torch.where(ones == 0, torch.zeros_like(label), label)
        label = torch.where(ones == P, torch.full_like(label,
                                                       P * (P - 1) + 1), label)
        return torch.where(transitions > 2,
                           torch.full_like(label, P * (P - 1) + 2), label)
    raise ValueError(method)


def lbp_merge_device(images: torch.Tensor, radius: int = 1,
                     point_mult: int = 8,
                     methods: Sequence[str] = ("l", "default", "uniform"),
                     ) -> torch.Tensor:
    """``lbp.get_lbp_merge`` for a batch on its device: (B, H, W, 3) uint8
    RGB → (B, H, W, len(methods)) uint8."""
    n_points = min(point_mult * radius, 24)
    gray = rgb_to_gray_uint8(images)
    lbp_methods = [m for m in methods if m in LBP_METHODS]
    bits = (lbp_bits(gray.double(), n_points, float(radius))
            if lbp_methods else None)
    channels = []
    for m in methods:
        if m == "l":
            channels.append(gray.to(torch.uint8))
        elif m in ("r", "g", "b"):
            channels.append(images[..., "rgb".index(m)].to(torch.uint8))
        elif m in LBP_METHODS:
            lo, hi = method_range(m, n_points)
            code = lbp_map(bits, m).double()
            # a same-device divisor: true division, as numpy's (a host
            # scalar becomes a reciprocal multiply on CUDA)
            span = torch.tensor(float(hi - lo), dtype=torch.float64,
                                device=images.device)
            scaled = (code - lo) / span * 255
            channels.append(scaled.clamp(0, 255).to(torch.uint8))
        else:
            raise ValueError(m)
    return torch.stack(channels, dim=-1)
