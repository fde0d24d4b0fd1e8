"""Dataset constants and the deterministic eval resize, copied from
``vit_torch_tpu/data/datasets.py`` (the port imports nothing of the JAX
package)."""

from __future__ import annotations

import numpy as np

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
