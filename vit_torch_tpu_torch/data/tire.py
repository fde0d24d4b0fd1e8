"""The tire dataset (an ImageFolder turned into LBP channel stacks),
counterpart of ``vit_torch_tpu/data/tire.py``: the reference's
``get_tire_dataset`` (``utils_dataset_tire.py:30-132``) with the CLI's
per-setting presets (``main.py:135-152``):

| setting | channels                                      | zoom | crop |
|---------|-----------------------------------------------|------|------|
| 0       | r,g,b,default,uniform,ror,nri_uniform (7 ch)  | 2.0  | 1.2  |
| 1       | l,default,uniform (3 ch)                      | 2.0  | 1.2  |
| 2       | l,default,uniform                             | 2.4  | 1.2  |
| 3       | l,default,uniform                             | 2.4  | 1.6  |

with LBP radius 2 and point_mult 8 in every setting, in the reference's
order (``utils_dataset_tire.py:59-90``): ``fit_to(zoom_shape, fill=128)``
→ ``CenterCrop(pre_crop_shape)`` → ``RandomCrop(image_size)`` → HFlip →
VFlip → [AutoAugment] → ``lbp_merge`` → ``Normalize(0.5, 0.25)``, where
``zoom_shape = image_size · max(1, crop, zoom)`` and ``pre_crop_shape =
image_size · max(1, crop)``, both rounded down to even.

Two modes, as in the JAX package:

- the default: the letterbox, the centre crop and the LBP stack run once
  at build time on the host (``lbp.py``); the random crop and the flips
  run on the batch's device, on the channel stack (cropping commutes
  with LBP; a flipped LBP map differs from the LBP of a flipped image
  only in orientation-sensitive codes, which the JAX package accepts so
  that no step needs host LBP).  The reference's AutoAugment stage is
  not applied in this mode (it must precede LBP);
- ``aug_auto`` (imagenet, cifar10, stl10, svhn): the train split stays
  RGB and every step runs crop → flips → AutoAugment → LBP
  (``lbp_device.py``) → normalise on the batch's device.

Colour jitter is left out in both: LBP is invariant to monotone
intensity changes, so it only touched the raw r/g/b channels.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from vit_torch_tpu_torch.data.datasets import _imagefolder_arrays
from vit_torch_tpu_torch.data.lbp import get_lbp_merge
from vit_torch_tpu_torch.data.loader import ArrayDataLoader, PrefetchLoader

# reference preset table (main.py:135-152): (methods, zoom, random_crop)
TIRE_SETTINGS = {
    0: dict(methods=("r", "g", "b", "default", "uniform", "ror",
                     "nri_uniform"), zoom=2.0, crop=1.2),
    1: dict(methods=("l", "default", "uniform"), zoom=2.0, crop=1.2),
    2: dict(methods=("l", "default", "uniform"), zoom=2.4, crop=1.2),
    3: dict(methods=("l", "default", "uniform"), zoom=2.4, crop=1.6),
}
TIRE_LBP_RADIUS = 2       # reference _lbp_dict (main.py:152)
TIRE_LBP_POINT_MULT = 8


def _center_crop(imgs: np.ndarray, size: int) -> np.ndarray:
    H, W = imgs.shape[1:3]
    oy, ox = (H - size) // 2, (W - size) // 2
    return imgs[:, oy:oy + size, ox:ox + size]


class TireDatasets:
    """``.sets`` (uint8 NHWC train/test arrays), ``.loaders``, ``.info``,
    ``.num_labels``, ``.image_channels`` and ``.norm_values``, as
    ``datasets.Datasets``, plus :meth:`make_augment_fn`."""

    def __init__(self, data_path: str, image_size: int = 224, bs: int = 32,
                 settings: int = 0, test_ratio: float = 0.2, seed: int = 0,
                 limit_train: int = 0, limit_test: int = 0,
                 prefetch: bool = True, aug_auto: str = "") -> None:
        assert settings in TIRE_SETTINGS, f"settings must be 0-3, got {settings}"
        recipe = TIRE_SETTINGS[settings]
        zoom, crop = recipe["zoom"], recipe["crop"]
        # reference shape arithmetic (utils_dataset_tire.py:57-58)
        zoom_shape = int(image_size * max(1.0, crop, zoom)) // 2 * 2
        pre_crop_shape = int(image_size * max(1.0, crop)) // 2 * 2
        folder_splits, classes = _imagefolder_arrays(
            data_path, zoom_shape, test_ratio=test_ratio, seed=seed,
            letterbox=True, fill=128)
        self.classes = classes
        self.num_labels = len(classes)
        self.methods = recipe["methods"]
        self.image_channels = len(self.methods)
        lbp = functools.partial(get_lbp_merge, radius=TIRE_LBP_RADIUS,
                                point_mult=TIRE_LBP_POINT_MULT,
                                methods=self.methods)
        self.aug_auto = aug_auto
        splits: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for split, (imgs, labels) in folder_splits.items():
            # train keeps the margin of the random crop (taken per step on
            # the device); test is centre-cropped to the final size
            crop_size = pre_crop_shape if split == "train" else image_size
            imgs = _center_crop(imgs, crop_size)
            if split == "train" and aug_auto:
                splits[split] = (np.ascontiguousarray(imgs), labels)
            else:
                splits[split] = (np.stack([lbp(img) for img in imgs]), labels)
        self.sets = splits
        self.image_size = image_size
        self.settings = settings
        # every channel normalised with (0.5, 0.25), as the reference
        # (utils_dataset_tire.py:91)
        self.norm_values = {"mean": [0.5] * self.image_channels,
                            "std": [0.25] * self.image_channels}
        self.info = {
            "dataset": "tire",
            "num_labels": self.num_labels,
            "image_size": image_size,
            "image_channels": self.image_channels,
            "settings": settings,
            "zoom_shape": zoom_shape,
            "pre_crop_shape": pre_crop_shape,
            "sample_count_train": len(splits["train"][1]),
            "sample_count_val": len(splits["test"][1]),
        }
        train_loader = ArrayDataLoader(*splits["train"], batch_size=bs,
                                       shuffle=True, seed=seed,
                                       limit=limit_train)
        val_loader = ArrayDataLoader(*splits["test"], batch_size=bs,
                                     limit=limit_test)
        if prefetch:
            train_loader = PrefetchLoader(train_loader)
            val_loader = PrefetchLoader(val_loader)
        self.loaders = {"train": train_loader, "val": val_loader}

    def make_augment_fn(self, dtype=torch.float32):
        """The train augmentation on the batch's device, a
        :class:`~vit_torch_tpu_torch.data.augment.DrawnAugment`
        ``fn(generator, uint8 images) -> images``: random crop to
        ``image_size``, flips and normalisation of the LBP stack; with
        ``aug_auto``, AutoAugment and LBP of the RGB crop between the flips
        and the normalisation."""
        from vit_torch_tpu_torch.data.augment import (DrawnAugment, crop_to,
                                                      draw_flip, draw_int,
                                                      hflip, normalize, vflip)
        size = self.image_size
        mean, std = self.norm_values["mean"], self.norm_values["std"]
        auto_fn = lbp_fn = None
        if self.aug_auto:
            from vit_torch_tpu_torch.data.autoaugment import make_autoaugment
            from vit_torch_tpu_torch.data.lbp_device import lbp_merge_device
            auto_fn = make_autoaugment(self.aug_auto)
            lbp_fn = functools.partial(lbp_merge_device,
                                       radius=TIRE_LBP_RADIUS,
                                       point_mult=TIRE_LBP_POINT_MULT,
                                       methods=self.methods)

        def draw(gen: torch.Generator, B: int, hw, dev) -> dict:
            H, W = hw
            out = {}
            if H > size:
                out["crop_y"] = draw_int(gen, H - size + 1, B, dev)
                out["crop_x"] = draw_int(gen, W - size + 1, B, dev)
            out["hflip"] = draw_flip(gen, B, dev)
            out["vflip"] = draw_flip(gen, B, dev)
            if auto_fn is not None:
                out["auto"] = auto_fn.draw(gen, B, (size, size), dev)
            return out

        def apply(images: torch.Tensor, d: dict) -> torch.Tensor:
            x = images
            if "crop_y" in d:
                x = crop_to(x, d["crop_y"], d["crop_x"], size, size)
            x = vflip(hflip(x, d["hflip"]), d["vflip"])
            if auto_fn is not None:
                x = lbp_fn(auto_fn.apply(x, d["auto"]))
            return normalize(x, mean, std, dtype=dtype)

        return DrawnAugment(draw, apply)
