"""Training checkpoints on ``torch.save``, counterpart of
``vit_torch_tpu/checkpoint/orbax_io.py``, with its functions and layout:

    ckpt_dir/<step>/state.pt     one directory a saved step (the trainer
                                 saves the epoch as the step; 0 is valid)
    ckpt_dir/metrics.json        {step: metrics} of every save, also of the
                                 steps that retention has deleted
    ckpt_dir/best/...            the trainer's mirror of its best epoch
                                 (``max_to_keep=1``), the same layout

A state is a dict of tensors, numbers, strings, lists and dicts only (the
trainer's: the model's and the optimizer's ``state_dict()``, the step, the
epoch and its generator's state), so :func:`restore_checkpoint` loads it
with ``weights_only=True`` and runs no pickled code.

Each step is written into a temporary directory beside it and then
renamed into place with ``os.replace``, as orbax does: a crash mid-save
leaves a ``.tmp-*`` directory, which :func:`latest_step` never picks.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch

#: subdirectory holding an eviction-proof copy of the best-val checkpoint
BEST_SUBDIR = "best"
_STATE = "state.pt"
_METRICS = "metrics.json"


def _steps(ckpt_dir: str) -> List[int]:
    """The complete saved steps, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(name) for name in os.listdir(ckpt_dir)
                  if name.isdigit()
                  and os.path.isfile(os.path.join(ckpt_dir, name, _STATE)))


def _replace_dir(src: str, dst: str) -> None:
    """Move directory ``src`` to ``dst``, replacing an existing ``dst``."""
    trash = None
    if os.path.exists(dst):
        trash = f"{dst}.old-{os.getpid()}"
        os.replace(dst, trash)
    os.replace(src, dst)
    if trash is not None:
        shutil.rmtree(trash)


def saved_metrics(ckpt_dir: str) -> Dict[int, dict]:
    """Per-step metrics recorded by :func:`save_checkpoint`."""
    path = os.path.join(ckpt_dir, _METRICS)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {int(k): v for k, v in json.load(f).items()}


def best_saved_metric(ckpt_dir: str, key: str = "val_acc") -> Optional[float]:
    """Best recorded value of ``key`` across all saves (including steps that
    retention has since deleted): the trainer's best-val seed on resume."""
    vals = [m[key] for m in saved_metrics(ckpt_dir).values() if key in m]
    return max(vals) if vals else None


def save_checkpoint(ckpt_dir: str, state: Dict[str, Any], step: int,
                    metrics: Optional[dict] = None,
                    max_to_keep: int = 3) -> None:
    """Write ``state`` as step ``step`` atomically, then delete the oldest
    steps beyond ``max_to_keep`` and record ``metrics``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, _STATE))
    _replace_dir(tmp, os.path.join(ckpt_dir, str(step)))
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))
    if metrics:
        record = {str(k): v for k, v in saved_metrics(ckpt_dir).items()}
        record[str(step)] = metrics
        path = os.path.join(ckpt_dir, _METRICS)
        with open(path + ".tmp", "w") as f:
            json.dump(record, f)
        os.replace(path + ".tmp", path)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       map_location=None) -> Dict[str, Any]:
    """Load step ``step`` (the latest when None) onto ``map_location``."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir!r}")
    return torch.load(os.path.join(ckpt_dir, str(step), _STATE),
                      map_location=map_location, weights_only=True)
