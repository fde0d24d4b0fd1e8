"""AutoAugment on torch tensors, counterpart of
``vit_torch_tpu/data/autoaugment.py`` (the reference's PIL policy
classes, ``utils_datasets.py:62-338``): the ImageNet / CIFAR10 / STL10 /
SVHN sub-policy tables verbatim (op, probability, magnitude-index
triples; the reference's STL10 table equals its ImageNet table), with
PIL's semantics: nearest-neighbour affine warps with fill 128 (shears
bicubic), signed enhancement factors, PIL's equalize LUT and unsigned
rotation.

The ops work on a batch of float32 images in [0, 255], (n, H, W, C),
each sample with its own magnitude and sign, given as (n,) tensors: a
test feeds both packages the same draws.  Each sample draws (policy
index, two uniforms, two signs) from the trainer's generator on the
batch's device (:func:`draw`).  The JAX package computes all 14 ops for
every sample (``vmap`` of ``lax.switch``); here the batch is grouped by
the drawn op instead: each op runs once, batched, on the samples that
drew it, and the results are scattered back (:func:`apply_policy`).
Grouping reads the (2, B) drawn op ids to the host once a call, the one
synchronisation of the augmentation.  As in PIL, the image is rounded to
uint8 levels after each of the two ops.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vit_torch_tpu_torch.data.augment import DrawnAugment

FILL = 128.0

OP_NAMES = ["shearX", "shearY", "translateX", "translateY", "rotate",
            "color", "posterize", "solarize", "contrast", "sharpness",
            "brightness", "autocontrast", "equalize", "invert"]
_OP_ID = {n: i for i, n in enumerate(OP_NAMES)}

# magnitude ranges, verbatim (utils_datasets.py:277-292)
_RANGES = {
    "shearX": np.linspace(0, 0.3, 10),
    "shearY": np.linspace(0, 0.3, 10),
    "translateX": np.linspace(0, 150 / 331, 10),
    "translateY": np.linspace(0, 150 / 331, 10),
    "rotate": np.linspace(0, 30, 10),
    "color": np.linspace(0.0, 0.9, 10),
    "posterize": np.round(np.linspace(8, 4, 10), 0).astype(int),
    "solarize": np.linspace(256, 0, 10),
    "contrast": np.linspace(0.0, 0.9, 10),
    "sharpness": np.linspace(0.0, 0.9, 10),
    "brightness": np.linspace(0.0, 0.9, 10),
    "autocontrast": [0] * 10,
    "equalize": [0] * 10,
    "invert": [0] * 10,
}

# ops whose factor gets a random ± sign in the reference
_SIGNED = {"shearX", "shearY", "translateX", "translateY", "color",
           "contrast", "sharpness", "brightness"}


def _P(*rows) -> List[Tuple]:
    return list(rows)


# (p1, op1, mag_idx1, p2, op2, mag_idx2) — verbatim tables
IMAGENET_POLICY = _P(
    (0.4, "posterize", 8, 0.6, "rotate", 9),
    (0.6, "solarize", 5, 0.6, "autocontrast", 5),
    (0.8, "equalize", 8, 0.6, "equalize", 3),
    (0.6, "posterize", 7, 0.6, "posterize", 6),
    (0.4, "equalize", 7, 0.2, "solarize", 4),
    (0.4, "equalize", 4, 0.8, "rotate", 8),
    (0.6, "solarize", 3, 0.6, "equalize", 7),
    (0.8, "posterize", 5, 1.0, "equalize", 2),
    (0.2, "rotate", 3, 0.6, "solarize", 8),
    (0.6, "equalize", 8, 0.4, "posterize", 6),
    (0.8, "rotate", 8, 0.4, "color", 0),
    (0.4, "rotate", 9, 0.6, "equalize", 2),
    (0.0, "equalize", 7, 0.8, "equalize", 8),
    (0.6, "invert", 4, 1.0, "equalize", 8),
    (0.6, "color", 4, 1.0, "contrast", 8),
    (0.8, "rotate", 8, 1.0, "color", 2),
    (0.8, "color", 8, 0.8, "solarize", 7),
    (0.4, "sharpness", 7, 0.6, "invert", 8),
    (0.6, "shearX", 5, 1.0, "equalize", 9),
    (0.4, "color", 0, 0.6, "equalize", 3),
    (0.4, "equalize", 7, 0.2, "solarize", 4),
    (0.6, "solarize", 5, 0.6, "autocontrast", 5),
    (0.6, "invert", 4, 1.0, "equalize", 8),
    (0.6, "color", 4, 1.0, "contrast", 8),
    (0.8, "equalize", 8, 0.6, "equalize", 3),
)
STL10_POLICY = IMAGENET_POLICY  # identical in the reference (:170-219)

CIFAR10_POLICY = _P(
    (0.1, "invert", 7, 0.2, "contrast", 6),
    (0.7, "rotate", 2, 0.3, "translateX", 9),
    (0.8, "sharpness", 1, 0.9, "sharpness", 3),
    (0.5, "shearY", 8, 0.7, "translateY", 9),
    (0.5, "autocontrast", 8, 0.9, "equalize", 2),
    (0.2, "shearY", 7, 0.3, "posterize", 7),
    (0.4, "color", 3, 0.6, "brightness", 7),
    (0.3, "sharpness", 9, 0.7, "brightness", 9),
    (0.6, "equalize", 5, 0.5, "equalize", 1),
    (0.6, "contrast", 7, 0.6, "sharpness", 5),
    (0.7, "color", 7, 0.5, "translateX", 8),
    (0.3, "equalize", 7, 0.4, "autocontrast", 8),
    (0.4, "translateY", 3, 0.2, "sharpness", 6),
    (0.9, "brightness", 6, 0.2, "color", 8),
    (0.5, "solarize", 2, 0.0, "invert", 3),
    (0.2, "equalize", 0, 0.6, "autocontrast", 0),
    (0.2, "equalize", 8, 0.6, "equalize", 4),
    (0.9, "color", 9, 0.6, "equalize", 6),
    (0.8, "autocontrast", 4, 0.2, "solarize", 8),
    (0.1, "brightness", 3, 0.7, "color", 0),
    (0.4, "solarize", 5, 0.9, "autocontrast", 3),
    (0.9, "translateY", 9, 0.7, "translateY", 9),
    (0.9, "autocontrast", 2, 0.8, "solarize", 3),
    (0.8, "equalize", 8, 0.1, "invert", 3),
    (0.7, "translateY", 9, 0.9, "autocontrast", 1),
)

SVHN_POLICY = _P(
    (0.9, "shearX", 4, 0.2, "invert", 3),
    (0.9, "shearY", 8, 0.7, "invert", 5),
    (0.6, "equalize", 5, 0.6, "solarize", 6),
    (0.9, "invert", 3, 0.6, "equalize", 3),
    (0.6, "equalize", 1, 0.9, "rotate", 3),
    (0.9, "shearX", 4, 0.8, "autocontrast", 3),
    (0.9, "shearY", 8, 0.4, "invert", 5),
    (0.9, "shearY", 5, 0.2, "solarize", 6),
    (0.9, "invert", 6, 0.8, "autocontrast", 1),
    (0.6, "equalize", 3, 0.9, "rotate", 3),
    (0.9, "shearX", 4, 0.3, "solarize", 3),
    (0.8, "shearY", 8, 0.7, "invert", 4),
    (0.9, "equalize", 5, 0.6, "translateY", 6),
    (0.9, "invert", 4, 0.6, "equalize", 7),
    (0.3, "contrast", 3, 0.8, "rotate", 4),
    (0.8, "invert", 5, 0.0, "translateY", 2),
    (0.7, "shearY", 6, 0.4, "solarize", 8),
    (0.6, "invert", 4, 0.8, "rotate", 4),
    (0.3, "shearY", 7, 0.9, "translateX", 3),
    (0.1, "shearX", 6, 0.6, "invert", 5),
    (0.7, "solarize", 2, 0.6, "translateY", 7),
    (0.8, "shearY", 4, 0.8, "invert", 8),
    (0.7, "shearX", 9, 0.8, "translateY", 3),
    (0.8, "shearY", 5, 0.7, "autocontrast", 3),
    (0.7, "shearX", 2, 0.1, "invert", 5),
)

POLICIES = {"imagenet": IMAGENET_POLICY, "stl10": STL10_POLICY,
            "cifar10": CIFAR10_POLICY, "svhn": SVHN_POLICY}


# --------------------------------------------------------------------------
# batched ops: img (n, H, W, C) float32 in [0, 255]; mag, sign (n,) float32

def _col(t: torch.Tensor) -> torch.Tensor:
    return t.view(-1, 1, 1)


def _cubic_weights(t: torch.Tensor) -> List[torch.Tensor]:
    """PIL ``Image.transform`` bicubic weights for offsets (-1, 0, 1, 2)
    around the floor of the sample position: cubic convolution with
    a = -1.0 (PIL's transform filter, not the a = -0.5 of its resize)."""
    a = -1.0
    ws = []
    for x in (t + 1.0, t, 1.0 - t, 2.0 - t):
        ax = x.abs()
        inner = ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
        outer = (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a
        ws.append(torch.where(ax <= 1.0, inner,
                              torch.where(ax < 2.0, outer, 0.0)))
    return ws


def _affine(img, a, b, c, d, e, f, bicubic: bool = False) -> torch.Tensor:
    """PIL ``Image.transform(AFFINE)``: output pixel (x, y) samples the
    input at (a (x+.5) + b (y+.5) + c, d (x+.5) + e (y+.5) + f), pixel
    centres mapped, then floored (nearest) or sampled by 4x4 bicubic taps
    (edge-clamped); fill 128 out of bounds.  Coefficients are (n,)."""
    n, H, W, C = img.shape
    dev = img.device
    ys = torch.arange(H, dtype=torch.float32, device=dev).view(1, H, 1) + 0.5
    xs = torch.arange(W, dtype=torch.float32, device=dev).view(1, 1, W) + 0.5
    xin = _col(a) * xs + _col(b) * ys + _col(c)
    yin = _col(d) * xs + _col(e) * ys + _col(f)
    bi = torch.arange(n, device=dev).view(n, 1, 1)
    if not bicubic:
        xi = torch.floor(xin).long()
        yi = torch.floor(yin).long()
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        out = img[bi, yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        return torch.where(inb[..., None], out, FILL)
    px, py = xin - 0.5, yin - 0.5
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = _cubic_weights(px - x0)
    wy = _cubic_weights(py - y0)
    x0, y0 = x0.long(), y0.long()
    acc = torch.zeros_like(img)
    for j, wyj in zip((-1, 0, 1, 2), wy):
        rowy = (y0 + j).clamp(0, H - 1)
        for i, wxi in zip((-1, 0, 1, 2), wx):
            colx = (x0 + i).clamp(0, W - 1)
            acc = acc + (wyj * wxi)[..., None] * img[bi, rowy, colx]
    inb = (px >= -0.5) & (px <= W - 0.5) & (py >= -0.5) & (py <= H - 0.5)
    return torch.where(inb[..., None], acc.clamp(0.0, 255.0), FILL)


def _shear_x(img, mag, sign):
    one, zero = torch.ones_like(mag), torch.zeros_like(mag)
    return _affine(img, one, mag * sign, zero, zero, one, zero, bicubic=True)


def _shear_y(img, mag, sign):
    one, zero = torch.ones_like(mag), torch.zeros_like(mag)
    return _affine(img, one, zero, zero, mag * sign, one, zero, bicubic=True)


def _translate_x(img, mag, sign):
    one, zero = torch.ones_like(mag), torch.zeros_like(mag)
    return _affine(img, one, zero, mag * img.shape[2] * sign, zero, one, zero)


def _translate_y(img, mag, sign):
    one, zero = torch.ones_like(mag), torch.zeros_like(mag)
    return _affine(img, one, zero, zero, zero, one, mag * img.shape[1] * sign)


def _rotate(img, mag, sign):
    """PIL ``rotate(angle)``: counter-clockwise about (W/2, H/2), PIL's
    centre, fill 128; the reference never signs the rotation."""
    H, W = img.shape[1:3]
    theta = mag * np.pi / 180.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    cx, cy = W / 2.0, H / 2.0
    return _affine(img, cos, -sin, cx - cos * cx + sin * cy,
                   sin, cos, cy - sin * cx - cos * cy)


def _gray(img):
    if img.shape[-1] == 3:
        w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype,
                         device=img.device)
        return (img * w).sum(-1, keepdim=True)
    return img.mean(-1, keepdim=True)


def _blend(a, b, factor):
    return (a + factor.view(-1, 1, 1, 1) * (b - a)).clamp(0.0, 255.0)


def _color(img, mag, sign):
    return _blend(_gray(img).expand_as(img), img, 1.0 + mag * sign)


def _contrast(img, mag, sign):
    # PIL: blend with the mean of the L image, rounded like PIL's int mean
    mean = torch.round(_gray(img).mean(dim=(1, 2, 3), keepdim=True))
    return _blend(mean.expand_as(img), img, 1.0 + mag * sign)


def _brightness(img, mag, sign):
    return _blend(torch.zeros_like(img), img, 1.0 + mag * sign)


def _sharpness(img, mag, sign):
    """PIL's SMOOTH kernel; border pixels keep their values."""
    n, H, W, C = img.shape
    kernel = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]],
                          dtype=torch.float32, device=img.device) / 13.0
    planes = img.permute(0, 3, 1, 2).reshape(n * C, 1, H, W)
    smoothed = F.conv2d(planes, kernel.view(1, 1, 3, 3), padding=1)
    smoothed = smoothed.view(n, C, H, W).permute(0, 2, 3, 1).clone()
    smoothed[:, 0], smoothed[:, -1] = img[:, 0], img[:, -1]
    smoothed[:, :, 0], smoothed[:, :, -1] = img[:, :, 0], img[:, :, -1]
    return _blend(smoothed, img, 1.0 + mag * sign)


def _posterize(img, mag, sign):
    bits = mag.int().view(-1, 1, 1, 1)
    mask = (0xFF << (8 - bits)) & 0xFF
    return (img.int() & mask).to(img.dtype)


def _solarize(img, mag, sign):
    return torch.where(img < mag.view(-1, 1, 1, 1), img, 255.0 - img)


def _autocontrast(img, mag, sign):
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    scale = 255.0 / (hi - lo).clamp_min(1e-6)
    return torch.where(hi > lo, ((img - lo) * scale).clamp(0, 255), img)


def _equalize(img, mag, sign):
    """PIL ``ImageOps.equalize``'s LUT, per sample and channel."""
    n, H, W, C = img.shape
    planes = img.permute(0, 3, 1, 2).reshape(n * C, H * W)
    v = planes.clamp(0, 255).long()
    hist = torch.zeros(n * C, 256, dtype=torch.long, device=img.device)
    hist.scatter_add_(1, v, torch.ones_like(v))
    levels = torch.arange(256, device=img.device)
    last = torch.where(hist > 0, levels, -1).argmax(1, keepdim=True)
    step = (hist.sum(1, keepdim=True) - hist.gather(1, last)) // 255
    cum = torch.cumsum(hist, 1) - hist
    lut = ((step // 2 + cum) // step.clamp_min(1)).clamp(0, 255)
    out = torch.where(step > 0, lut.gather(1, v).to(img.dtype), planes)
    return out.view(n, C, H, W).permute(0, 2, 3, 1)


def _invert(img, mag, sign):
    return 255.0 - img


OP_FNS = [_shear_x, _shear_y, _translate_x, _translate_y, _rotate, _color,
          _posterize, _solarize, _contrast, _sharpness, _brightness,
          _autocontrast, _equalize, _invert]


# --------------------------------------------------------------------------
# policies

def policy_tables(policy: str) -> Dict[str, torch.Tensor]:
    """The table of ``policy`` as (2, n_subpolicies) tensors: op id,
    probability, magnitude and whether the op takes a random sign."""
    table = POLICIES[policy]
    return {
        "op": torch.tensor([[_OP_ID[r[1]] for r in table],
                            [_OP_ID[r[4]] for r in table]]),
        "p": torch.tensor([[r[0] for r in table], [r[3] for r in table]],
                          dtype=torch.float32),
        "mag": torch.tensor([[float(_RANGES[r[1]][r[2]]) for r in table],
                             [float(_RANGES[r[4]][r[5]]) for r in table]],
                            dtype=torch.float32),
        "signed": torch.tensor([[r[1] in _SIGNED for r in table],
                                [r[4] in _SIGNED for r in table]]),
    }


def draw(gen: torch.Generator, batch: int, n_subpolicies: int,
         device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One sample's draws, for a batch: the sub-policy index (B,), two
    uniforms (2, B) and two signs (2, B) in {-1, 1}."""
    idx = torch.randint(0, n_subpolicies, (batch,), generator=gen,
                        device=device)
    u = torch.rand((2, batch), generator=gen, device=device)
    s = torch.randint(0, 2, (2, batch), generator=gen, device=device)
    return idx, u, s.float() * 2.0 - 1.0


def apply_policy(images: torch.Tensor, tables: Dict[str, torch.Tensor],
                 idx: torch.Tensor, u: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
    """Apply each sample's sub-policy ``idx`` to (B, H, W, C) uint8
    ``images`` given its draws: op k of a sample runs when ``u[k] <
    p[k]``, with sign ``s[k]`` where the op is signed.  Returns uint8."""
    ops = tables["op"][:, idx]
    mags = tables["mag"][:, idx]
    signs = torch.where(tables["signed"][:, idx], s, 1.0)
    drawn = torch.where(u < tables["p"][:, idx], ops, -1).cpu().numpy()
    x = images.float()
    for k in range(2):
        for op in np.unique(drawn[k][drawn[k] >= 0]):
            rows = torch.from_numpy(np.flatnonzero(drawn[k] == op)).to(
                images.device)
            x.index_copy_(0, rows, OP_FNS[op](x[rows], mags[k][rows],
                                              signs[k][rows]))
        x = x.round().clamp(0, 255)
    return x.to(torch.uint8)


def make_autoaugment(policy: str = "imagenet") -> DrawnAugment:
    """Batched AutoAugment, a :class:`~vit_torch_tpu_torch.data.augment.
    DrawnAugment`: ``fn(generator, uint8 images) -> uint8``, its draws
    (:func:`draw`) kept batch-major."""
    cpu_tables = policy_tables(policy)
    on_device: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def tables_on(dev) -> Dict[str, torch.Tensor]:
        if dev not in on_device:
            on_device[dev] = {k: v.to(dev) for k, v in cpu_tables.items()}
        return on_device[dev]

    def draw_batch(gen: torch.Generator, batch: int, hw, dev) -> dict:
        idx, u, s = draw(gen, batch, cpu_tables["op"].shape[1], dev)
        return {"idx": idx, "u": u.t(), "s": s.t()}

    def apply(images: torch.Tensor, d: dict) -> torch.Tensor:
        return apply_policy(images, tables_on(images.device), d["idx"],
                            d["u"].t(), d["s"].t())

    return DrawnAugment(draw_batch, apply)
