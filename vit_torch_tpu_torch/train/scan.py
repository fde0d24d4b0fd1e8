"""Epoch loops over device-resident splits, counterpart of
``vit_torch_tpu/train/scan.py``.

The whole split lives on the device as uint8 (STL-10 train is 138 MB,
CIFAR-10 184 MB), and every step gathers its batch there from a shuffled
index array, so no image crosses the host link during an epoch.  The JAX
package fuses an epoch into one ``lax.scan`` dispatch; here it is a
Python loop over the same steps, with the metric sums kept on the device
and read once per epoch (CUDA graphs are later work).  On a pure data
mesh the steps take the mesh's layout (``parallel/api.py``): the whole
split stays replicated on every device as in the JAX package, and each
rank gathers its rows of every global batch (the trainer hands the loops
those columns of the index arrays).

Also here: cached-feature linear eval, which runs the frozen backbone once
over each split and then trains only the head on the cached features
(the reference's frozen-representation datasets,
``utils_datasets.py:342-527``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vit_torch_tpu_torch.train.steps import (accumulate_metrics,
                                             init_metric_accumulator)


def epoch_indices(n: int, batch_size: int, rng: np.random.Generator,
                  shuffle: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(steps, B) index + mask arrays covering the split (last batch
    padded).  The same numpy calls as the JAX package, so the same order
    from the same ``rng``."""
    order = np.arange(n)
    if shuffle:
        rng.shuffle(order)
    n_steps = (n + batch_size - 1) // batch_size
    padded = np.zeros(n_steps * batch_size, np.int64)
    padded[:n] = order
    msk = np.zeros(n_steps * batch_size, np.float32)
    msk[:n] = 1.0
    return (padded.reshape(n_steps, batch_size).astype(np.int32),
            msk.reshape(n_steps, batch_size))


def _run_steps(step: Callable, images: torch.Tensor, labels: torch.Tensor,
               idx: np.ndarray, msk: np.ndarray, with_preds: bool = False):
    dev = images.device
    idx_d = torch.from_numpy(np.asarray(idx, np.int64)).to(dev)
    msk_d = torch.from_numpy(np.asarray(msk, np.float32)).to(dev)
    acc = init_metric_accumulator(dev)
    preds = []
    for i in range(idx_d.shape[0]):
        batch_idx = idx_d[i]
        out = step(images[batch_idx], labels[batch_idx], msk_d[i])
        if with_preds:
            preds.append(out.pop("pred"))
        acc = accumulate_metrics(acc, out)
    if with_preds:
        return acc, torch.stack(preds)
    return acc


def make_scan_train_fn(train_step: Callable) -> Callable:
    """``run(images, labels, idx, msk) -> metric sums``: ``images`` and
    ``labels`` are the whole split on the device, ``idx`` / ``msk`` the
    (steps, B) arrays of :func:`epoch_indices`."""

    def run(images, labels, idx, msk):
        return _run_steps(train_step, images, labels, idx, msk)

    return run


def make_scan_eval_fn(eval_step: Callable, with_preds: bool = False
                      ) -> Callable:
    """As :func:`make_scan_train_fn` for evaluation; ``with_preds`` (an
    eval step built with ``with_preds``) also returns the (steps, B) argmax
    predictions (the debug-eval dump)."""

    def run(images, labels, idx, msk):
        return _run_steps(eval_step, images, labels, idx, msk,
                          with_preds=with_preds)

    return run


@torch.no_grad()
def cache_backbone_features(backbone: nn.Module, images: torch.Tensor,
                            batch_size: int,
                            eval_transform: Optional[Callable] = None
                            ) -> torch.Tensor:
    """Run the frozen backbone once over a device-resident uint8 split and
    return its ``(N, feature_dim)`` features (in the backbone's dtype)."""
    was_training = backbone.training
    backbone.eval()
    feats = []
    try:
        for start in range(0, len(images), batch_size):
            x = images[start:start + batch_size]
            n = len(x)
            if n < batch_size:       # keep the static batch shape
                pad = x[:1].expand(batch_size - n, *x.shape[1:])
                x = torch.cat([x, pad])
            if eval_transform is not None:
                x = eval_transform(x)
            feats.append(backbone(x)[:n])
    finally:
        backbone.train(was_training)
    return torch.cat(feats)


def device_split(images: np.ndarray, labels: np.ndarray,
                 device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (uint8 images, int64 labels) split moved to ``device`` once."""
    return (torch.from_numpy(np.ascontiguousarray(images)).to(device),
            torch.from_numpy(np.asarray(labels, np.int64)).to(device))

