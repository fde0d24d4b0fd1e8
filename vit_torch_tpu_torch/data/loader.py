"""Fixed-shape batching loader, counterpart of
``vit_torch_tpu/data/loader.py``.

Every batch, the final partial one included, has the configured batch
size, with a per-sample validity ``mask`` so padded rows contribute
nothing to loss or metrics.  The static shape keeps the step's kernels at
one set of shapes and makes the port's batches the JAX package's.

Data lives in memory as one uint8 NHWC array (the reference's datasets are
small: STL-10/CIFAR fit trivially); batch assembly is a fancy-index, so no
worker processes are needed — random augmentation runs on device (see
``augment.py``).  A background-thread prefetcher overlaps host batch
assembly + H2D transfer with device compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class ArrayDataLoader:
    """Yields ``{'image': uint8 (B,H,W,C), 'label': int32 (B,), 'mask': f32 (B,)}``."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch_size: int,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = False,
                 limit: int = 0, process_shard: bool = False) -> None:
        assert len(images) == len(labels)
        if limit and limit > 0:
            images, labels = images[:limit], labels[:limit]
        if process_shard:
            # multi-process data sharding: each rank loads its slice (the
            # reference's DistributedSampler branch,
            # utils_datasets.py:866-891)
            import torch.distributed as dist
            if dist.is_initialized() and dist.get_world_size() > 1:
                rank, world = dist.get_rank(), dist.get_world_size()
                images, labels = images[rank::world], labels[rank::world]
        self.images = np.ascontiguousarray(images)
        self.labels = np.asarray(labels, np.int32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    @property
    def num_samples(self) -> int:
        return len(self.labels)

    def __len__(self) -> int:
        n = self.num_samples
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = self.num_samples
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        n_batches = len(self)
        for b in range(n_batches):
            idx = order[b * bs:(b + 1) * bs]
            valid = len(idx)
            if valid < bs:  # pad to static shape
                idx = np.concatenate([idx, np.zeros(bs - valid, np.int64)])
            batch = {
                "image": self.images[idx],
                "label": self.labels[idx],
                "mask": (np.arange(bs) < valid).astype(np.float32),
            }
            yield batch


class PrefetchLoader:
    """Wrap a loader with a background thread + bounded queue so batch
    assembly overlaps device compute (the reference's num_workers=4
    equivalent, without processes — assembly here is a single fancy-index)."""

    def __init__(self, loader, prefetch: int = 2) -> None:
        self.loader = loader
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.loader)

    @property
    def num_samples(self) -> int:
        return self.loader.num_samples

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        err: list = []

        def _put(item) -> bool:
            # bounded-wait put so the worker can exit when the consumer
            # abandons iteration mid-epoch (otherwise it blocks forever on
            # the full queue, leaking the thread + the batches it holds)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self.loader:
                    if not _put(item):
                        return
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                _put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # runs on normal exhaustion AND on generator close/GC: release
            # the worker (it may be blocked on a full queue) and reap it
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=1.0)
