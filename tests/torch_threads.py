"""PyTorch's intra-op thread count for the port's CPU tests.

pytest-xdist sets ``PYTEST_XDIST_WORKER_COUNT`` in each of its workers;
every worker's PyTorch would otherwise start one thread a core, so that
six workers oversubscribe the cores sixfold.  Each ``test_torch_port_*``
module calls :func:`fit_threads_to_workers` at import, so the cores are
shared out among the workers, and a run in one process keeps them all.
"""

import os

import torch


def fit_threads_to_workers() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(threads)
    return threads
