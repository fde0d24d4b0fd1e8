"""Run-telemetry subsystem, the port's own copy of
``vit_torch_tpu/utils/stats.py`` (the port imports nothing of the JAX
package).  ``default_hardware`` reports the torch device; the detection
meters are ``SmoothedValue`` and ``MetricLogger``.

Capability parity with the reference's ``utils_stats.py`` (``TimerLog``,
``CounterLog``, ``Metrics``, ``StatMetrics``, ``Stats``): per-split,
per-epoch metric rounds streamed to a JSON stats file whose schema matches
the reference's checked-in run logs (``{info, telem, results, <split>: [rows]}``
with rows ``{epoch, sample, lr, loss, acc, time, time_start, time_finish,
time_cost}`` — see reference ``utils_stats.py:493-507,639-719``).

Redesigned, not copied: metrics are plain weighted accumulators (the train
step returns device-resident sums once per epoch or per logging window, not
per-batch host syncs), the known reference quirks are fixed (the dead
``(best)`` marker from falsy ``prev_best=0.0`` at ``utils_stats.py:234-235``
and the 10-day "day" constant at ``utils_stats.py:92``), and best-value
results are computed correctly for both higher- and lower-is-better metrics.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence


BAR_CHARS = " ▏▎▍▌▋▊▉█"


def format_time(seconds: float) -> str:
    """Compact ``1h23m45s``-style rendering (reference ``utils_stats.py:82-99``,
    with the day constant fixed to 86400)."""
    if seconds is None or seconds != seconds or seconds < 0 or seconds == float("inf"):
        return "--"
    seconds = float(seconds)
    units = [("d", 86400.0), ("h", 3600.0), ("m", 60.0), ("s", 1.0)]
    parts: List[str] = []
    for name, width in units:
        if seconds >= width or (name == "s" and not parts):
            count = int(seconds // width)
            seconds -= count * width
            parts.append(f"{count}{name}")
        if len(parts) == 2:
            break
    return "".join(parts)


def progress_bar(fraction: float, width: int = 10) -> str:
    """Unicode block progress bar (reference ``CounterLog`` ``utils_stats.py:102-168``)."""
    fraction = min(max(float(fraction), 0.0), 1.0)
    cells = fraction * width
    full = int(cells)
    frac = cells - full
    partial = BAR_CHARS[int(frac * (len(BAR_CHARS) - 1))] if full < width else ""
    return (BAR_CHARS[-1] * full + partial).ljust(width)


class TimerLog:
    """Elapsed / total / remaining wall time derived from a progress fraction."""

    def __init__(self) -> None:
        self.time_start = time.time()
        self.time_now = self.time_start

    def restart(self) -> None:
        self.time_start = time.time()
        self.time_now = self.time_start

    def update(self, progress: float) -> Dict[str, float]:
        self.time_now = time.time()
        elapsed = self.time_now - self.time_start
        total = elapsed / progress if progress > 0 else float("inf")
        return {
            "elapsed": elapsed,
            "total": total,
            "remain": max(total - elapsed, 0.0),
            "progress": progress,
        }

    def get_str(self, progress: float) -> str:
        d = self.update(progress)
        return f"{format_time(d['elapsed'])}/{format_time(d['total'])}"


class CounterLog:
    """Named counter with an optional total, rendering ``name[k/M][▇▇  ]``."""

    def __init__(self, name: str, total: Optional[int] = None) -> None:
        self.name = name
        self.total = total
        self.count = 0

    def reset(self, total: Optional[int] = None) -> None:
        self.count = 0
        if total is not None:
            self.total = total

    def update(self, increment: int = 1) -> int:
        self.count += increment
        return self.count

    @property
    def progress(self) -> float:
        if not self.total:
            return 0.0
        return min(self.count / self.total, 1.0)

    def get_str(self, bar: bool = True) -> str:
        if self.total:
            s = f"{self.name}[{self.count}/{self.total}]"
            if bar:
                s += f"[{progress_bar(self.progress)}]"
            return s
        return f"{self.name}[{self.count}]"


class Metrics:
    """One scalar metric: weighted running average per round + best across rounds."""

    def __init__(self, name: str, higher_is_better: bool = True,
                 fmt: str = "{:.4f}") -> None:
        self.name = name
        self.higher_is_better = higher_is_better
        self.fmt = fmt
        self.round_values: List[float] = []  # per-round (epoch) averages
        self._sum = 0.0
        self._weight = 0.0

    def reset_round(self) -> None:
        self._sum = 0.0
        self._weight = 0.0

    def update(self, value: float, weight: float = 1.0) -> None:
        self._sum += float(value) * weight
        self._weight += weight

    @property
    def avg(self) -> float:
        return self._sum / self._weight if self._weight > 0 else 0.0

    def finish_round(self) -> float:
        avg = self.avg
        self.round_values.append(avg)
        self.reset_round()
        return avg

    @property
    def best(self) -> Optional[float]:
        if not self.round_values:
            return None
        return (max if self.higher_is_better else min)(self.round_values)

    @property
    def best_index(self) -> Optional[int]:
        if not self.round_values:
            return None
        return self.round_values.index(self.best)

    def is_best_round(self) -> bool:
        """True if the latest finished round is the best so far."""
        return bool(self.round_values) and self.best_index == len(self.round_values) - 1

    def get_str(self) -> str:
        return f"{self.name}[{self.fmt.format(self.avg)}]"


DEFAULT_METRICS = {
    "acc": dict(higher_is_better=True, fmt="{:7.2%}"),
    "loss": dict(higher_is_better=False, fmt="{:.4f}"),
}


class StatMetrics:
    """Per-split round (epoch) manager holding a set of :class:`Metrics`.

    Each finished round appends a row ``{epoch, sample, lr, <metrics...>,
    time, time_start, time_finish, time_cost}`` matching the reference's
    per-epoch log rows.
    """

    def __init__(self, split: str, metrics: Optional[Dict[str, dict]] = None,
                 sample_total: Optional[int] = None, epoch_total: Optional[int] = None) -> None:
        self.split = split
        self.metrics: Dict[str, Metrics] = {
            name: Metrics(name, **spec)
            for name, spec in (metrics or DEFAULT_METRICS).items()
        }
        self.rows: List[Dict[str, Any]] = []
        self.epoch_counter = CounterLog("epoch", epoch_total)
        self.sample_counter = CounterLog("sample", sample_total)
        self.timer = TimerLog()
        self.lr: float = 0.0
        self._round_start: Optional[float] = None
        self._round_samples = 0

    def new_round(self, epoch: Optional[int] = None) -> None:
        for m in self.metrics.values():
            m.reset_round()
        self.sample_counter.reset()
        self.timer.restart()
        self._round_start = time.time()
        self._round_samples = 0
        if epoch is not None:
            self.epoch_counter.count = epoch

    def update(self, sample_count: int = 0, lr: Optional[float] = None,
               **metric_values: float) -> None:
        weight = max(sample_count, 1)
        for name, value in metric_values.items():
            if name in self.metrics and value is not None:
                self.metrics[name].update(value, weight=weight)
        if sample_count:
            self.sample_counter.update(sample_count)
            self._round_samples += sample_count
        if lr is not None:
            self.lr = float(lr)

    def finish_round(self) -> Dict[str, Any]:
        now = time.time()
        start = self._round_start if self._round_start is not None else now
        row: Dict[str, Any] = {
            "epoch": self.epoch_counter.count,
            "sample": self.sample_counter.count,
            "lr": self.lr,
        }
        for name, m in self.metrics.items():
            row[name] = m.finish_round()
        row.update({
            "time": now - start,
            "time_start": start,
            "time_finish": now,
            "time_cost": now - start,
        })
        self.rows.append(row)
        self.epoch_counter.update()
        self._round_start = None
        return row

    @property
    def sample_time(self) -> float:
        """Best (minimum) seconds/sample across rounds — the reference's
        throughput figure (``results."<split>.sample_time"``)."""
        times = [r["time_cost"] / r["sample"] for r in self.rows if r.get("sample")]
        return min(times) if times else 0.0

    @property
    def epoch_time(self) -> float:
        times = [r["time_cost"] for r in self.rows]
        return sum(times) / len(times) if times else 0.0

    def get_str(self) -> str:
        parts = [
            self.split,
            self.epoch_counter.get_str(bar=False),
            self.sample_counter.get_str(bar=True),
        ]
        for m in self.metrics.values():
            s = m.get_str()
            if m.is_best_round() and len(m.round_values) > 1:
                s += "(best)"
            parts.append(s)
        parts.append(f"lr[{self.lr:.2e}]")
        parts.append(f"time[{self.timer.get_str(self.sample_counter.progress)}]")
        return " ".join(parts)


class Stats:
    """Top-level run record: ``info`` (args), ``telem``, per-split rounds,
    aggregated ``results`` — persisted as one JSON file per run."""

    def __init__(self, splits: Sequence[str] = ("train", "val"),
                 stats_fp: Optional[str] = None,
                 info: Optional[Dict[str, Any]] = None,
                 telem: Optional[Dict[str, Any]] = None,
                 metrics: Optional[Dict[str, dict]] = None,
                 epoch_total: Optional[int] = None,
                 sample_totals: Optional[Dict[str, int]] = None,
                 print_fps: float = 10.0) -> None:
        self.stats_fp = stats_fp
        self.info = dict(info or {})
        self.telem: Dict[str, Any] = {
            "hardware": default_hardware(),
            "completed": False,
            "time_stamp": time.strftime("%y%m%d_%H%M%S"),
            "time_start": time.time(),
            "time_finish": None,
            "time_elapsed": None,
            "time_updated": time.time(),
            **(telem or {}),
        }
        sample_totals = sample_totals or {}
        self.splits: Dict[str, StatMetrics] = {
            s: StatMetrics(s, metrics=metrics, epoch_total=epoch_total,
                           sample_total=sample_totals.get(s))
            for s in splits
        }
        self.current_split = list(splits)[0] if splits else None
        self._last_print = 0.0
        self._print_interval = 1.0 / print_fps if print_fps > 0 else 0.0

    # -- split management -------------------------------------------------
    def set_split(self, split: str) -> StatMetrics:
        if split not in self.splits:
            self.splits[split] = StatMetrics(split)
        self.current_split = split
        return self.splits[split]

    @property
    def S(self) -> StatMetrics:
        return self.splits[self.current_split]

    def new_round(self, epoch: Optional[int] = None) -> None:
        self.S.new_round(epoch)

    def update(self, sample_count: int = 0, lr: Optional[float] = None,
               **metric_values: float) -> None:
        self.S.update(sample_count, lr=lr, **metric_values)

    def finish_round(self, save: bool = True) -> Dict[str, Any]:
        row = self.S.finish_round()
        if save:
            self.save()
        return row

    # -- results aggregation ----------------------------------------------
    def update_results(self) -> Dict[str, Any]:
        results: Dict[str, Any] = {}
        epochs = max((len(s.rows) for s in self.splits.values()), default=0)
        results["epochs"] = max(epochs - 1, 0)
        results["epoch.time"] = sum(s.epoch_time for s in self.splits.values())
        results["epoch.sample_time"] = 0.0
        for name, s in self.splits.items():
            results[f"{name}.time"] = s.epoch_time
            results[f"{name}.sample_time"] = s.sample_time
            for mname, m in s.metrics.items():
                if m.round_values:
                    results[f"{name}.{mname}"] = m.best
        self.results = results
        return results

    # -- persistence ------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        self.telem["time_updated"] = time.time()
        self.telem["time_elapsed"] = self.telem["time_updated"] - self.telem["time_start"]
        return {
            "info": self.info,
            "telem": self.telem,
            "results": self.update_results(),
            **{name: s.rows for name, s in self.splits.items()},
        }

    def save(self, fp: Optional[str] = None) -> Optional[str]:
        fp = fp or self.stats_fp
        if not fp:
            return None
        os.makedirs(os.path.dirname(os.path.abspath(fp)), exist_ok=True)
        tmp = fp + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=4, default=_json_default)
        os.replace(tmp, fp)
        return fp

    def finish(self, save: bool = True) -> None:
        self.telem["completed"] = True
        self.telem["time_finish"] = time.time()
        if save:
            self.save()

    # -- terminal rendering -----------------------------------------------
    def get_str(self) -> str:
        return self.S.get_str()

    def print(self, force: bool = False, end: str = "") -> None:
        now = time.time()
        if not force and now - self._last_print < self._print_interval:
            return
        self._last_print = now
        print("\r" + self.get_str() + " " * 4, end=end, flush=True)


def _json_default(o: Any) -> Any:
    try:
        import numpy as np
        if isinstance(o, np.generic):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
    except ImportError:
        pass
    return str(o)


def default_hardware(device=None) -> str:
    """Device-count × device-name tag, e.g. ``1xNVIDIAH10080GBHBM3`` or
    ``1xcpu`` (the reference hardcodes ``'1x3090'`` at ``main.py:214``).
    ``device=None`` means CUDA when a GPU is present."""
    import torch
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev).replace(" ", "")
        return f"{torch.cuda.device_count()}x{name}"
    return f"1x{dev.type}"


class SmoothedValue:
    """Windowed meter with a global average (the reference's
    detection-side ``SmoothedValue``, ``object/torch_utils.py:15-74``)."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.window: List[float] = []
        self.window_size = window_size
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.window.append(float(value))
        if len(self.window) > self.window_size:
            self.window.pop(0)
        self.total += float(value) * n
        self.count += n

    @property
    def median(self) -> float:
        import statistics
        return statistics.median(self.window) if self.window else 0.0

    @property
    def avg(self) -> float:
        return sum(self.window) / len(self.window) if self.window else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def value(self) -> float:
        return self.window[-1] if self.window else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, value=self.value)


def _device_memory() -> str:
    """The CUDA caching allocator's peak, where there is a GPU."""
    import torch
    if not torch.cuda.is_available():
        return ""
    return f"max mem: {torch.cuda.max_memory_allocated() / 2 ** 20:.0f}MB"


class MetricLogger:
    """Iteration logger with ETA and meters (the reference's
    ``MetricLogger.log_every``, ``object/torch_utils.py:147-218``, its
    memory read from the CUDA allocator)."""

    def __init__(self, delimiter: str = "  ") -> None:
        self.meters: Dict[str, SmoothedValue] = {}
        self.delimiter = delimiter

    def update(self, **kwargs: float) -> None:
        for k, v in kwargs.items():
            self.meters.setdefault(k, SmoothedValue()).update(float(v))

    def __getattr__(self, name: str):
        meters = object.__getattribute__(self, "__dict__").get("meters", {})
        if name in meters:
            return meters[name]
        raise AttributeError(name)

    def __str__(self) -> str:
        return self.delimiter.join(f"{k}: {m}"
                                   for k, m in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        n = len(iterable) if hasattr(iterable, "__len__") else None
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        start = time.time()
        end = start
        for i, obj in enumerate(iterable):
            yield obj
            iter_time.update(time.time() - end)
            end = time.time()
            if i % print_freq == 0 or (n and i == n - 1):
                eta = format_time(iter_time.avg * (n - i - 1)) if n else "--"
                total = f"{i}/{n}" if n else str(i)
                print(f"\r{header} [{total}] eta: {eta} {self} "
                      f"time: {iter_time} {_device_memory()}", end="",
                      flush=True)
        print(f"\r{header} done in {format_time(time.time() - start)}")
