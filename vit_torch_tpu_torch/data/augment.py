"""Device-side image augmentation, counterpart of
``vit_torch_tpu/data/augment.py``.

The reference's train transform (Resize(bicubic) → RandomCrop with
pad ≈ size/12, fill 128 → RandomHorizontalFlip → ToTensor → Normalize,
``utils_datasets.py:554-582``) runs here on the batch's device, batched
over the whole batch, on uint8 NHWC images: the resize happened once at
load time on the host.

Each op is a deterministic function of explicit offsets, flags or
centres (:func:`crop`, :func:`hflip`, :func:`vflip`, :func:`cutout_at`),
with a thin random wrapper on top that draws them from a
``torch.Generator`` on the batch's device.  JAX and torch draw different
numbers from one seed, so the tests pin the deterministic ops against the
JAX ops on the same offsets and flags.  A whole train transform is a
:class:`DrawnAugment`: its draws for a batch, then their application, so
that the ranks of a data mesh draw for the global batch and each applies
its rows (``train/steps.py``).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=16)
def _norm_constants(mean: tuple, std: tuple, device: torch.device):
    """255·mean and 1 / (255·std) on ``device``, copied there once: a
    copy a call would make every step wait for the device."""
    mean_t = torch.tensor(mean, dtype=torch.float32) * 255.0
    inv_std = 1.0 / (torch.tensor(std, dtype=torch.float32) * 255.0)
    return mean_t.to(device), inv_std.to(device)


def normalize(images: torch.Tensor, mean: Sequence[float],
              std: Sequence[float], dtype=torch.float32) -> torch.Tensor:
    """uint8 [0, 255] → normalised float, channels last:
    ``(x - 255 mean) / (255 std)``, in fp32, then cast to ``dtype``."""
    mean, inv_std = _norm_constants(tuple(float(m) for m in mean),
                                    tuple(float(s) for s in std),
                                    images.device)
    return ((images.float() - mean) * inv_std).to(dtype)


def crop_to(images: torch.Tensor, offs_y: torch.Tensor,
            offs_x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Per-sample crop of ``(B, H, W, C)`` images at offsets ``(B,)``."""
    dev = images.device
    rows = offs_y[:, None] + torch.arange(out_h, device=dev)[None, :]
    cols = offs_x[:, None] + torch.arange(out_w, device=dev)[None, :]
    b = torch.arange(images.shape[0], device=dev)[:, None, None]
    return images[b, rows[:, :, None], cols[:, None, :]]


def crop(images: torch.Tensor, offs_y: torch.Tensor, offs_x: torch.Tensor,
         pad: int, fill: int = 128) -> torch.Tensor:
    """Pad every side by ``pad`` with ``fill``, then crop back to the input
    size at per-sample offsets in ``[0, 2 pad]`` (RandomCrop's semantics)."""
    B, H, W, C = images.shape
    padded = F.pad(images, (0, 0, pad, pad, pad, pad), value=fill)
    return crop_to(padded, offs_y, offs_x, H, W)


def hflip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Mirror the samples whose ``flip`` flag ``(B,)`` is set."""
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def vflip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(flip[:, None, None, None], images.flip(1), images)


def cutout_at(images: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor,
              size: int, fill_value: float = 0.0) -> torch.Tensor:
    """One square per sample centred at ``(cy, cx)``, half-open bounds
    ``[c - size//2, c + size//2)`` clipped at the border, filled with
    ``fill_value`` (the reference's tensor-space Cutout)."""
    B, H, W, C = images.shape
    dev = images.device
    ys = torch.arange(H, device=dev)[None, :, None]
    xs = torch.arange(W, device=dev)[None, None, :]
    cy, cx = cy[:, None, None], cx[:, None, None]
    half = size // 2
    mask = ((ys >= cy - half) & (ys < cy + half)
            & (xs >= cx - half) & (xs < cx + half))
    return torch.where(mask[..., None],
                       torch.tensor(fill_value, dtype=images.dtype,
                                    device=dev), images)


def draw_int(gen: torch.Generator, high: int, n: int,
             device) -> torch.Tensor:
    """``n`` integers in ``[0, high)``: offsets and centres."""
    return torch.randint(0, high, (n,), generator=gen, device=device)


def random_crop(gen: torch.Generator, images: torch.Tensor, pad: int,
                fill: int = 128) -> torch.Tensor:
    B, dev = images.shape[0], images.device
    offs_y = draw_int(gen, 2 * pad + 1, B, dev)
    offs_x = draw_int(gen, 2 * pad + 1, B, dev)
    return crop(images, offs_y, offs_x, pad, fill)


def draw_flip(gen: torch.Generator, batch: int, device,
              p: float = 0.5) -> torch.Tensor:
    """:func:`random_hflip`'s (and :func:`random_vflip`'s) flags."""
    return torch.rand(batch, generator=gen, device=device) < p


def random_hflip(gen: torch.Generator, images: torch.Tensor,
                 p: float = 0.5) -> torch.Tensor:
    return hflip(images, draw_flip(gen, images.shape[0], images.device, p))


def random_vflip(gen: torch.Generator, images: torch.Tensor,
                 p: float = 0.5) -> torch.Tensor:
    return vflip(images, draw_flip(gen, images.shape[0], images.device, p))


def random_crop_to(gen: torch.Generator, images: torch.Tensor,
                   size: int) -> torch.Tensor:
    """Random crop of a larger image down to ``size``, no padding."""
    B, H, W, C = images.shape
    offs_y = draw_int(gen, H - size + 1, B, images.device)
    offs_x = draw_int(gen, W - size + 1, B, images.device)
    return crop_to(images, offs_y, offs_x, size, size)


def cutout(gen: torch.Generator, images: torch.Tensor, size: int,
           fill_value: float = 0.0) -> torch.Tensor:
    B, H, W, C = images.shape
    cy = draw_int(gen, H, B, images.device)
    cx = draw_int(gen, W, B, images.device)
    return cutout_at(images, cy, cx, size, fill_value)


class DrawnAugment:
    """A random transform as ``draw(generator, batch, (H, W), device)``,
    a dict of tensors whose leading dim is ``batch``, and ``apply(images,
    draws)``; ``augment(generator, images)`` does both.  The draws come
    from the generator in the order the random wrappers above take them,
    so the whole transform draws the same numbers as the wrappers
    chained."""

    def __init__(self, draw: Callable, apply: Callable) -> None:
        self.draw = draw
        self.apply = apply

    def __call__(self, gen: torch.Generator,
                 images: torch.Tensor) -> torch.Tensor:
        return self.apply(images, self.draw(gen, images.shape[0],
                                            images.shape[1:3], images.device))


def make_train_augment(
    mean: Sequence[float], std: Sequence[float], *,
    crop_pad: Optional[int] = None, hflip: bool = True,
    cutout_size: int = 0, auto_policy: Optional[str] = None,
    dtype=torch.float32,
) -> DrawnAugment:
    """The reference's train transform stack as one device function,
    ``augment(generator, uint8 images) -> float images``, in the JAX
    package's order: crop → flip → AutoAugment → normalize → cutout.

    ``crop_pad=None`` derives the reference default ``max(2, size // 12)``.
    ``auto_policy`` ∈ {imagenet, cifar10, stl10, svhn} enables AutoAugment
    (``autoaugment.py``) on the batch's device.
    """
    auto_fn = None
    if auto_policy:
        from vit_torch_tpu_torch.data.autoaugment import make_autoaugment
        auto_fn = make_autoaugment(auto_policy)
    return _train_augment(mean, std, crop_pad, hflip, cutout_size, auto_fn,
                          dtype)


def _train_augment(mean, std, crop_pad: Optional[int], do_flip: bool,
                   cutout_size: int, auto_fn: Optional[DrawnAugment],
                   dtype) -> DrawnAugment:
    def pad_of(H: int) -> int:
        return crop_pad if crop_pad is not None else max(2, H // 12)

    def draw(gen: torch.Generator, B: int, hw, dev) -> dict:
        H, W = hw
        span = 2 * pad_of(H) + 1
        out = {"crop_y": draw_int(gen, span, B, dev),
               "crop_x": draw_int(gen, span, B, dev)}
        if do_flip:
            out["flip"] = draw_flip(gen, B, dev)
        if auto_fn is not None:
            out["auto"] = auto_fn.draw(gen, B, hw, dev)
        if cutout_size > 0:
            out["cut_y"] = draw_int(gen, H, B, dev)
            out["cut_x"] = draw_int(gen, W, B, dev)
        return out

    def apply(images: torch.Tensor, d: dict) -> torch.Tensor:
        x = crop(images, d["crop_y"], d["crop_x"], pad_of(images.shape[1]),
                 fill=128)
        if do_flip:
            x = hflip(x, d["flip"])
        if auto_fn is not None:
            x = auto_fn.apply(x, d["auto"])
        x = normalize(x, mean, std, dtype=dtype)
        if cutout_size > 0:
            x = cutout_at(x, d["cut_y"], d["cut_x"], cutout_size)
        return x

    return DrawnAugment(draw, apply)


def make_eval_transform(mean: Sequence[float], std: Sequence[float],
                        dtype=torch.float32
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    return functools.partial(normalize, mean=mean, std=std, dtype=dtype)
