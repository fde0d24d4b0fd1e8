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
JAX ops on the same offsets and flags.
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


def _randint(gen: torch.Generator, high: int, n: int,
             device) -> torch.Tensor:
    return torch.randint(0, high, (n,), generator=gen, device=device)


def random_crop(gen: torch.Generator, images: torch.Tensor, pad: int,
                fill: int = 128) -> torch.Tensor:
    B, dev = images.shape[0], images.device
    offs_y = _randint(gen, 2 * pad + 1, B, dev)
    offs_x = _randint(gen, 2 * pad + 1, B, dev)
    return crop(images, offs_y, offs_x, pad, fill)


def random_hflip(gen: torch.Generator, images: torch.Tensor,
                 p: float = 0.5) -> torch.Tensor:
    flip = torch.rand(images.shape[0], generator=gen,
                      device=images.device) < p
    return hflip(images, flip)


def random_vflip(gen: torch.Generator, images: torch.Tensor,
                 p: float = 0.5) -> torch.Tensor:
    flip = torch.rand(images.shape[0], generator=gen,
                      device=images.device) < p
    return vflip(images, flip)


def random_crop_to(gen: torch.Generator, images: torch.Tensor,
                   size: int) -> torch.Tensor:
    """Random crop of a larger image down to ``size``, no padding."""
    B, H, W, C = images.shape
    offs_y = _randint(gen, H - size + 1, B, images.device)
    offs_x = _randint(gen, W - size + 1, B, images.device)
    return crop_to(images, offs_y, offs_x, size, size)


def cutout(gen: torch.Generator, images: torch.Tensor, size: int,
           fill_value: float = 0.0) -> torch.Tensor:
    B, H, W, C = images.shape
    cy = _randint(gen, H, B, images.device)
    cx = _randint(gen, W, B, images.device)
    return cutout_at(images, cy, cx, size, fill_value)


def make_train_augment(
    mean: Sequence[float], std: Sequence[float], *,
    crop_pad: Optional[int] = None, hflip: bool = True,
    cutout_size: int = 0, auto_policy: Optional[str] = None,
    dtype=torch.float32,
) -> Callable[[torch.Generator, torch.Tensor], torch.Tensor]:
    """The reference's train transform stack as one device function,
    ``augment(generator, uint8 images) -> float images``, in the JAX
    package's order: crop → flip → AutoAugment → normalize → cutout.

    ``crop_pad=None`` derives the reference default ``max(2, size // 12)``.
    ``auto_policy`` ∈ {imagenet, cifar10, stl10, svhn} enables AutoAugment
    (``autoaugment.py``) on the batch's device.
    """
    do_flip = hflip
    auto_fn = None
    if auto_policy:
        from vit_torch_tpu_torch.data.autoaugment import make_autoaugment
        auto_fn = make_autoaugment(auto_policy)

    def augment(gen: torch.Generator, images: torch.Tensor) -> torch.Tensor:
        H = images.shape[1]
        pad = crop_pad if crop_pad is not None else max(2, H // 12)
        x = random_crop(gen, images, pad, fill=128)
        if do_flip:
            x = random_hflip(gen, x)
        if auto_fn is not None:
            x = auto_fn(gen, x)
        x = normalize(x, mean, std, dtype=dtype)
        if cutout_size > 0:
            x = cutout(gen, x, cutout_size)
        return x

    return augment


def make_eval_transform(mean: Sequence[float], std: Sequence[float],
                        dtype=torch.float32
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    return functools.partial(normalize, mean=mean, std=std, dtype=dtype)
