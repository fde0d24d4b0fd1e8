"""Train-time detection augmentation on device tensors, counterpart of
``vit_torch_tpu/detection/transforms.py``: the per-sample horizontal flip
(reference ``object/transforms.py:7-31``), DETR's RandomSelect zoom-crop
(``object_detr/datasets/transforms.py:242-260``) and RandomErasing, on a
letterboxed ``(B, S, S, C)`` batch and its ``(B, N, 4)`` xyxy boxes.

Each transform is a draw from the trainer's ``torch.Generator``
(``draw_*``) and an apply that takes the drawn values (``apply_*``), so
that a test can feed the JAX package's draws into the port's arithmetic;
``random_*`` does both.  The zoom-crop resamples as
``jax.image.scale_and_translate(..., method="linear")`` does: half-pixel
centres, a triangle kernel (the zoom is at least 1, so the kernel is not
widened), weights renormalised where the canvas edge cuts the kernel, and
samples outside the canvas zero; the separable weight matrices are
applied with two ``einsum``.  The flip also mirrors DETR's ``(B, N, S, S)``
instance masks and Keypoint R-CNN's ``(B, N, K, 3)`` keypoints, with the
schema's left/right swap; the zoom-crop resamples each mask plane with
the images' weights and thresholds it at 0.5.  Masks move with their
images: one draw applies to both.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch


def _uniform(generator, shape, device, lo=0.0, hi=1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return lo + u * (hi - lo)


# -- horizontal flip --------------------------------------------------------

def draw_hflip(generator: torch.Generator, batch: int,
               device: torch.device, prob: float = 0.5) -> torch.Tensor:
    """(B,) bool: which samples flip."""
    return torch.rand((batch,), generator=generator, device=device) < prob


def apply_hflip(flip: torch.Tensor, images: torch.Tensor,
                boxes: torch.Tensor, image_size: int,
                keypoints: Optional[torch.Tensor] = None,
                kp_flip_inds: Optional[Sequence[int]] = None,
                masks: Optional[torch.Tensor] = None):
    """Flip the chosen samples' images along W and mirror their boxes'
    x coordinates about S (the centred letterbox is symmetric).  With
    ``masks`` (B, N, S, S), flip them along W too and return them third.
    With ``keypoints`` (B, N, K, 3), mirror their x about S too and
    reorder the K axis by ``kp_flip_inds`` (the left/right swap; none
    keeps the order; a sequence or a tensor), and return them last."""
    images = torch.where(flip[:, None, None, None], images.flip(2), images)
    flipped = torch.stack([image_size - boxes[..., 2], boxes[..., 1],
                           image_size - boxes[..., 0], boxes[..., 3]], -1)
    boxes = torch.where(flip[:, None, None], flipped, boxes)
    out = (images, boxes)
    if masks is not None:
        out += (torch.where(flip[:, None, None, None], masks.flip(-1),
                            masks),)
    if keypoints is None:
        return out
    kf = torch.stack([image_size - keypoints[..., 0], keypoints[..., 1],
                      keypoints[..., 2]], -1)
    if kp_flip_inds is not None:
        # a tensor on the keypoints' device saves a copy a call
        kf = kf.index_select(2, torch.as_tensor(kp_flip_inds,
                                                device=kf.device))
    keypoints = torch.where(flip[:, None, None, None], kf, keypoints)
    return out + (keypoints,)


def random_hflip(generator: torch.Generator, images: torch.Tensor,
                 boxes: torch.Tensor, image_size: int,
                 masks: Optional[torch.Tensor] = None, prob: float = 0.5,
                 keypoints: Optional[torch.Tensor] = None,
                 kp_flip_inds: Optional[Sequence[int]] = None):
    """Per-sample random horizontal flip; returns ``(images, boxes)``,
    then the masks and the keypoints where given."""
    flip = draw_hflip(generator, images.shape[0], images.device, prob)
    return apply_hflip(flip, images, boxes, image_size, keypoints,
                       kp_flip_inds, masks)


# -- zoom-crop --------------------------------------------------------------

def draw_zoom_crop(generator: torch.Generator, batch: int, image_size: int,
                   device: torch.device,
                   scale_range: Tuple[float, float] = (0.6, 1.0),
                   prob: float = 0.5) -> Dict[str, torch.Tensor]:
    """``apply`` (B,) bool, ``zoom`` (B,) = S / window side and ``off``
    (B, 2) the window's (y, x) origin in pixels: a window of side
    ``s·S``, s ~ U[scale_range], at a uniform offset inside the canvas."""
    S = float(image_size)
    apply = torch.rand((batch,), generator=generator, device=device) < prob
    s = _uniform(generator, (batch,), device, *scale_range)
    w = s * S
    off = _uniform(generator, (batch, 2), device) * (S - w[:, None])
    return {"apply": apply, "zoom": S / w, "off": off}


def linear_weights(in_size: int, out_size: int, scale: torch.Tensor,
                   translation: torch.Tensor) -> torch.Tensor:
    """(B, in_size, out_size) resampling weights of
    ``jax.image.scale_and_translate``'s ``linear`` method with antialias,
    for per-sample ``scale`` and ``translation`` (B,): output pixel j
    samples input coordinate ``(j + 0.5 - t) / scale - 0.5`` with a
    triangle kernel widened by ``max(1 / scale, 1)``; each column is
    normalised to sum 1, and a sample outside the input is zero."""
    scale = scale.float()[:, None, None]
    translation = translation.float()[:, None, None]
    dev = scale.device
    inv = 1.0 / scale
    kernel_scale = torch.clamp(inv, min=1.0)
    out = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample = (out[None, None, :] + 0.5) * inv - translation * inv - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = (sample - src[None, :, None]).abs() / kernel_scale
    w = torch.clamp(1 - x.abs(), min=0)
    total = w.sum(dim=1, keepdim=True)
    tiny = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > tiny,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside, w, torch.zeros_like(w))


def resample_linear(images: torch.Tensor, zoom: torch.Tensor,
                    off: torch.Tensor) -> torch.Tensor:
    """Per-sample zoom of ``(B, S, S, C)`` images by ``zoom`` about the
    window origin ``off`` (y, x), fp32 out: the JAX zoom-crop's
    ``scale_and_translate(img, (S, S, C), (0, 1), [z, z], [-oy z, -ox z],
    "linear")``."""
    S = images.shape[1]
    wy = linear_weights(S, S, zoom, -off[:, 0] * zoom)
    wx = linear_weights(images.shape[2], images.shape[2], zoom,
                        -off[:, 1] * zoom)
    x = images.float()
    x = torch.einsum("bijc,biy->byjc", x, wy)
    return torch.einsum("byjc,bjx->byxc", x, wx)


def apply_zoom_crop(draw: Dict[str, torch.Tensor], images: torch.Tensor,
                    boxes: torch.Tensor, box_mask: torch.Tensor,
                    image_size: int, masks: Optional[torch.Tensor] = None):
    """Resample the chosen samples' windows to the full canvas (cast back
    to the images' dtype), shift, scale and clip their boxes, and drop
    the boxes the crop left no more than a pixel wide or high from
    ``box_mask``.  Returns ``(images, boxes, box_mask)``, and with
    ``masks`` (B, N, S, S) fourth the masks, each plane resampled as the
    images are and thresholded at > 0.5 (in the masks' dtype)."""
    apply, zoom, off = draw["apply"], draw["zoom"], draw["off"]
    S = float(image_size)
    zoomed = resample_linear(images, zoom, off).to(images.dtype)
    images = torch.where(apply[:, None, None, None], zoomed, images)
    oxy = off.flip(-1)[:, None, :]                  # (B, 1, [ox, oy])
    new_boxes = ((boxes - torch.cat([oxy, oxy], -1))
                 * zoom[:, None, None]).clamp(0.0, S)
    bw = new_boxes[..., 2] - new_boxes[..., 0]
    bh = new_boxes[..., 3] - new_boxes[..., 1]
    survives = (bw > 1.0) & (bh > 1.0)
    boxes = torch.where(apply[:, None, None], new_boxes, boxes)
    box_mask = torch.where(apply[:, None],
                           box_mask * survives.to(box_mask.dtype), box_mask)
    if masks is None:
        return images, boxes, box_mask
    # the planes as channels: (B, S, S, N), each resampled on its own
    planes = resample_linear(masks.permute(0, 2, 3, 1), zoom, off)
    zm = (planes > 0.5).to(masks.dtype).permute(0, 3, 1, 2)
    masks = torch.where(apply[:, None, None, None], zm, masks)
    return images, boxes, box_mask, masks


def random_zoom_crop(generator: torch.Generator, images: torch.Tensor,
                     boxes: torch.Tensor, box_mask: torch.Tensor,
                     image_size: int, masks: Optional[torch.Tensor] = None,
                     scale_range: Tuple[float, float] = (0.6, 1.0),
                     prob: float = 0.5):
    """Per-sample RandomSelect of identity and a random crop + resize;
    returns ``(images, boxes, box_mask)``, and the masks fourth where
    given."""
    draw = draw_zoom_crop(generator, images.shape[0], image_size,
                          images.device, scale_range, prob)
    return apply_zoom_crop(draw, images, boxes, box_mask, image_size, masks)


# -- erasing ----------------------------------------------------------------

def draw_erasing(generator: torch.Generator, batch: int,
                 device: torch.device, prob: float = 0.5,
                 scale: Tuple[float, float] = (0.02, 0.33),
                 ratio: Tuple[float, float] = (0.3, 3.3)
                 ) -> Dict[str, torch.Tensor]:
    """``apply`` (B,) bool, ``area`` (B,) as a share of the canvas,
    ``log_ratio`` (B,) and ``pos`` (B, 2) in [0, 1) (y, x)."""
    return {
        "apply": torch.rand((batch,), generator=generator,
                            device=device) < prob,
        "area": _uniform(generator, (batch,), device, *scale),
        "log_ratio": _uniform(generator, (batch,), device,
                              math.log(ratio[0]), math.log(ratio[1])),
        "pos": _uniform(generator, (batch, 2), device)}


def apply_erasing(draw: Dict[str, torch.Tensor], images: torch.Tensor,
                  value=0.0) -> torch.Tensor:
    """Erase a rectangle of area ``area·H·W`` and aspect
    ``exp(log_ratio)`` at ``pos·(H - h, W - w)`` with ``value`` (a scalar
    or one value a channel, cast to the images' dtype) in the chosen
    samples (torchvision's RandomErasing); boxes are left untouched, as in
    the reference."""
    B, H, W = images.shape[:3]
    area = draw["area"] * (H * W)
    aspect = torch.exp(draw["log_ratio"])
    eh = torch.sqrt(area * aspect).clamp(1.0, H)
    ew = torch.sqrt(area / aspect).clamp(1.0, W)
    y0 = draw["pos"][:, 0] * (H - eh)
    x0 = draw["pos"][:, 1] * (W - ew)
    yy = torch.arange(H, dtype=torch.float32, device=images.device)
    xx = torch.arange(W, dtype=torch.float32, device=images.device)
    yy, xx = yy[None, :, None], xx[None, None, :]
    inside = ((yy >= y0[:, None, None]) & (yy < (y0 + eh)[:, None, None])
              & (xx >= x0[:, None, None]) & (xx < (x0 + ew)[:, None, None]))
    erase = inside & draw["apply"][:, None, None]
    fill = torch.as_tensor(value, dtype=torch.float32,
                           device=images.device).to(images.dtype)
    return torch.where(erase[..., None], fill, images)


def random_erasing(generator: torch.Generator, images: torch.Tensor, *,
                   prob: float = 0.5,
                   scale: Tuple[float, float] = (0.02, 0.33),
                   ratio: Tuple[float, float] = (0.3, 3.3),
                   value: Sequence[float] = 0.0) -> torch.Tensor:
    """Per-sample RandomErasing of a ``(B, S, S, C)`` batch."""
    draw = draw_erasing(generator, images.shape[0], images.device, prob,
                        scale, ratio)
    return apply_erasing(draw, images, value)
