"""Dataset registry, copied from ``vit_torch_tpu/data/datasets.py`` (the
port imports nothing of the JAX package; everything here is numpy and
PIL, so the arrays are bit-for-bit the JAX package's).

STL-10 / CIFAR-10 / CIFAR-100 parsed from their standard on-disk files,
an ImageFolder directory with a per-class stratified split, and the
deterministic ``synthetic`` dataset.  Datasets materialise as in-memory
uint8 NHWC arrays; the deterministic resize happens once here and random
augmentation runs on the device (``augment.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from vit_torch_tpu_torch.data.loader import ArrayDataLoader, PrefetchLoader

# per-dataset normalization constants, verbatim from the reference
# (utils_datasets.py:586-589,644-647,701-704)
NORM_VALUES = {
    "stl10": {
        "mean": [0.44671062065972217, 0.43980983983523964, 0.40664644709967324],
        "std": [0.2603409782662331, 0.25657727311344447, 0.27126738145225493],
    },
    "cifar10": {"mean": [0.4914, 0.4822, 0.4465], "std": [0.247, 0.243, 0.261]},
    "cifar100": {
        "mean": [0.50707516, 0.48654887, 0.44091784],
        "std": [0.26733429, 0.25643846, 0.27615047],
    },
    "imagenet": {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]},
    "synthetic": {"mean": [0.5, 0.5, 0.5], "std": [0.25, 0.25, 0.25]},
}


DATASET_INFO = {
    "stl10": dict(num_labels=10, image_size=96),
    "cifar10": dict(num_labels=10, image_size=32),
    "cifar100": dict(num_labels=100, image_size=32),
    "synthetic": dict(num_labels=10, image_size=32),
}


def resize_images(images: np.ndarray, size: int) -> np.ndarray:
    """Deterministic bicubic resize of uint8 NHWC images (PIL, matching the
    reference's ``transforms.Resize(size, BICUBIC)``)."""
    if images.shape[1] == size and images.shape[2] == size:
        return images
    from PIL import Image
    out = np.empty((len(images), size, size, images.shape[3]), np.uint8)
    for i, img in enumerate(images):
        out[i] = np.asarray(
            Image.fromarray(img).resize((size, size), Image.BICUBIC))
    return out


def _synthetic_arrays(split: str, n: int = 512, image_size: int = 32,
                      num_labels: int = 10, seed: int = 0):
    """Deterministic learnable synthetic data: class-dependent low-frequency
    pattern + noise, so smoke runs show real learning curves."""
    rng = np.random.default_rng(seed + (0 if split == "train" else 1))
    labels = rng.integers(0, num_labels, n).astype(np.int32)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32) / image_size
    base = np.stack([
        np.sin(2 * np.pi * (yy * (1 + c % 3) + xx * (1 + c // 3)))
        for c in range(num_labels)
    ])  # (num_labels, H, W)
    imgs = base[labels][..., None].repeat(3, axis=-1) * 60 + 128
    imgs = imgs + rng.normal(0, 25, imgs.shape)
    return np.clip(imgs, 0, 255).astype(np.uint8), labels


def _load_cifar_batches(paths, label_key: bytes):
    import pickle
    imgs, labels = [], []
    for p in paths:
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(np.asarray(d[b"data"], np.uint8))
        labels.append(np.asarray(d[label_key], np.int32))
    images = np.concatenate(imgs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(images), np.concatenate(labels)


def _standard_arrays(dataset: str, split: str, root_path: str):
    """Parse the standard on-disk formats (the same files torchvision
    downloads) directly with numpy — no torchvision dependency.

    Layouts: CIFAR pickles under ``cifar-10-batches-py/`` /
    ``cifar-100-python/``; STL-10 binaries under ``stl10_binary/``
    (3×96×96 column-major per image, labels 1-based).
    """
    train = split == "train"
    try:
        if dataset == "stl10":
            d = os.path.join(root_path, "stl10_binary")
            stem = "train" if train else "test"
            x = np.fromfile(os.path.join(d, f"{stem}_X.bin"), np.uint8)
            images = x.reshape(-1, 3, 96, 96).transpose(0, 3, 2, 1)
            y = np.fromfile(os.path.join(d, f"{stem}_y.bin"), np.uint8)
            labels = y.astype(np.int32) - 1
        elif dataset == "cifar10":
            d = os.path.join(root_path, "cifar-10-batches-py")
            paths = ([os.path.join(d, f"data_batch_{i}") for i in range(1, 6)]
                     if train else [os.path.join(d, "test_batch")])
            return _load_cifar_batches(paths, b"labels")
        elif dataset == "cifar100":
            # fixed reference bug: CIFAR-100 actually loads CIFAR-100
            # (reference utils_datasets.py:741 constructed CIFAR10)
            d = os.path.join(root_path, "cifar-100-python")
            return _load_cifar_batches(
                [os.path.join(d, "train" if train else "test")],
                b"fine_labels")
        else:
            raise ValueError(dataset)
    except (FileNotFoundError, OSError) as e:
        raise RuntimeError(
            f"{dataset} not found under {root_path!r} and this environment "
            f"has no network egress; place the standard files there or use "
            f"--dataset synthetic. ({e})") from e
    return np.ascontiguousarray(images), labels


def _imagefolder_arrays(data_path: str, image_size: int, test_ratio: float = 0.2,
                        seed: int = 0, letterbox: bool = False,
                        fill: int = 128):
    """ImageFolder with per-class stratified train/test split (the
    reference's ``LocalDatasets`` + ``SubsetRandomSampler`` scheme,
    ``utils_datasets.py:911-1068``).  ``letterbox=True`` preserves aspect
    ratio and pads with ``fill`` (the reference's ``TRANS.fit_to``,
    ``utils_datasets.py:1203-1267``) instead of a plain square resize."""
    from PIL import Image
    classes = sorted(d for d in os.listdir(data_path)
                     if os.path.isdir(os.path.join(data_path, d)))
    assert classes, f"no class subdirectories in {data_path!r}"
    rng = np.random.default_rng(seed)
    out = {"train": ([], []), "test": ([], [])}
    for ci, cls in enumerate(classes):
        cdir = os.path.join(data_path, cls)
        files = sorted(f for f in os.listdir(cdir)
                       if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
        order = rng.permutation(len(files))
        n_test = max(1, int(len(files) * test_ratio))
        for j, fi in enumerate(order):
            split = "test" if j < n_test else "train"
            img = Image.open(os.path.join(cdir, files[fi])).convert("RGB")
            if letterbox:
                w, h = img.size
                scale = image_size / max(w, h)
                nw, nh = int(round(w * scale)), int(round(h * scale))
                resized = img.resize((nw, nh), Image.BICUBIC)
                canvas = Image.new("RGB", (image_size, image_size),
                                   (fill, fill, fill))
                canvas.paste(resized, ((image_size - nw) // 2,
                                       (image_size - nh) // 2))
                img = canvas
            else:
                img = img.resize((image_size, image_size), Image.BICUBIC)
            out[split][0].append(np.asarray(img, np.uint8))
            out[split][1].append(ci)
    result = {}
    for split, (imgs, labels) in out.items():
        if not imgs:
            counts = {c: len([f for f in os.listdir(os.path.join(data_path, c))
                              if f.lower().endswith((".png", ".jpg", ".jpeg",
                                                     ".bmp"))])
                      for c in classes}
            raise ValueError(
                f"ImageFolder split {split!r} is empty with test_ratio="
                f"{test_ratio} (per-class file counts: {counts}); every "
                f"class needs at least 2 images so both splits are "
                f"non-empty")
        result[split] = (np.stack(imgs), np.asarray(labels, np.int32))
    return result, classes


class Datasets:
    """Facade: ``Datasets(name, ...)`` → ``.loaders/.info/.num_labels/.norm_values``."""

    available_datasets = ("stl10", "cifar10", "cifar100", "synthetic")

    def __init__(self, dataset: str, image_size: int = 0, bs: int = 128,
                 root_path: str = "./data", data_path: str = "",
                 limit_train: int = 0, limit_test: int = 0, seed: int = 0,
                 synthetic_size: int = 512, prefetch: bool = True) -> None:
        self.dataset = dataset
        splits: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        if dataset == "synthetic":
            info = DATASET_INFO["synthetic"]
            size = image_size or info["image_size"]
            for split in ("train", "test"):
                imgs, labels = _synthetic_arrays(split, n=synthetic_size,
                                                 image_size=size, seed=seed)
                splits[split] = (imgs, labels)
            self.num_labels = info["num_labels"]
            self.norm_values = NORM_VALUES["synthetic"]
        elif dataset in ("stl10", "cifar10", "cifar100"):
            info = DATASET_INFO[dataset]
            size = image_size or info["image_size"]
            for split in ("train", "test"):
                imgs, labels = _standard_arrays(dataset, split, root_path)
                splits[split] = (resize_images(imgs, size), labels)
            self.num_labels = info["num_labels"]
            self.norm_values = NORM_VALUES[dataset]
        else:  # ImageFolder path (the reference's LocalDatasets / tire data)
            assert data_path, f"unknown dataset {dataset!r} and no --data_path given"
            size = image_size or 224
            folder_splits, classes = _imagefolder_arrays(data_path, size, seed=seed)
            splits = folder_splits
            self.num_labels = len(classes)
            self.classes = classes
            self.norm_values = NORM_VALUES["imagenet"]

        self.image_size = splits["train"][0].shape[1]
        self.info = {
            "dataset": dataset,
            "num_labels": self.num_labels,
            "image_size": self.image_size,
            "sample_count_train": len(splits["train"][1]),
            "sample_count_val": len(splits["test"][1]),
        }
        train_loader = ArrayDataLoader(*splits["train"], batch_size=bs,
                                       shuffle=True, seed=seed,
                                       limit=limit_train)
        val_loader = ArrayDataLoader(*splits["test"], batch_size=bs,
                                     shuffle=False, limit=limit_test)
        if prefetch:
            train_loader = PrefetchLoader(train_loader)
            val_loader = PrefetchLoader(val_loader)
        # reference split naming: train/val (val == the torchvision test split)
        self.loaders = {"train": train_loader, "val": val_loader}
        self.sets = splits
