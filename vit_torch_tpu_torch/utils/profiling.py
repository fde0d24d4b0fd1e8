"""Profiling and device telemetry, counterpart of
``vit_torch_tpu/utils/profiling.py`` (the reference's observability gaps,
SURVEY.md §5: wall-clock timers only, NVML polling commented out, no
profiler).

- :class:`DeviceMemory`: the reference's ``NVIDIA_SMI`` surface over the
  CUDA caching allocator (``torch.cuda.memory_stats``) and
  ``torch.cuda.mem_get_info``: GB in use, total, free and the allocator's
  peak; all zeros where there is no card.
- :func:`trace`: ``torch.profiler`` around the enclosed region (CPU, and
  CUDA where there is a card), a Chrome trace written into ``log_dir``.
- :func:`fence`: the device's work feeding a tensor finished
  (``torch.cuda.synchronize`` on its device; nothing on the CPU).
- :class:`StepTimer`: rolling per-step wall time with that fence.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch


class DeviceMemory:
    """Memory telemetry of one CUDA device (GB: total, used, free, peak);
    zeros without a card."""

    def __init__(self, device_id: int = 0) -> None:
        self.device_id = device_id

    def stats(self) -> Dict[str, float]:
        gb = 1024 ** 3
        if not torch.cuda.is_available():
            return {"total_gb": 0.0, "used_gb": 0.0, "free_gb": 0.0,
                    "peak_gb": 0.0}
        free, total = torch.cuda.mem_get_info(self.device_id)
        stats = torch.cuda.memory_stats(self.device_id)
        return {
            "total_gb": total / gb,
            "used_gb": stats.get("allocated_bytes.all.current", 0) / gb,
            "free_gb": free / gb,
            "peak_gb": stats.get("allocated_bytes.all.peak", 0) / gb,
        }

    def get_str(self) -> str:
        s = self.stats()
        return (f"hbm[{s['used_gb']:.2f}/{s['total_gb']:.2f}GB "
                f"peak {s['peak_gb']:.2f}GB]")


@contextlib.contextmanager
def trace(log_dir: str = "./logs/trace") -> Iterator[
        torch.profiler.profile]:
    """Profile the enclosed region with ``torch.profiler`` (the CUDA
    activity too where there is a card) and write its Chrome trace to
    ``log_dir/trace.json`` (view in ``chrome://tracing`` or Perfetto)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        fence()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def fence(x: Optional[torch.Tensor] = None) -> None:
    """Wait for the device's work feeding ``x`` (every device's when
    None): ``torch.cuda.synchronize`` on its device; nothing on the
    CPU, whose operations have finished when they return."""
    if x is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    elif x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class StepTimer:
    """Rolling step timer with a device fence; reports ms/step."""

    def __init__(self, window: int = 50) -> None:
        self.window = window
        self.times: list = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, fence_on: Optional[torch.Tensor] = None) -> float:
        if fence_on is not None:
            fence(fence_on)
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def ms_per_step(self) -> float:
        return 1e3 * float(np.median(self.times)) if self.times else 0.0

    def get_str(self) -> str:
        return f"step[{self.ms_per_step:.1f}ms]"
