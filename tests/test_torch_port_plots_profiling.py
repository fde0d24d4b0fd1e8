"""The port's plotting and profiling utilities (``utils/plots.py``,
``utils/profiling.py``), as ``tests/test_plots_and_profiling.py`` holds
the JAX package's: each plot writes a PNG (and the class colours are
those of the JAX module); ``DeviceMemory`` has the JAX keys (zeros
without a card); ``StepTimer`` with its fence; ``trace`` writes a Chrome
trace."""

import json
import os

import numpy as np
import pytest
import torch

from vit_torch_tpu.utils import plots as jax_plots
from vit_torch_tpu_torch.detection.coco_data import (CocoDetectionDataset,
                                                     make_synthetic_coco)
from vit_torch_tpu_torch.utils import plots
from vit_torch_tpu_torch.utils.profiling import (DeviceMemory, StepTimer,
                                                 fence, trace)
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()


def test_class_colors_match_jax():
    colors = [plots.class_color(i) for i in range(10)]
    assert len(set(colors)) == 10
    assert colors == [jax_plots.class_color(i) for i in range(10)]


def test_annotate_saves(tmp_path):
    fp = str(tmp_path / "out.png")
    plots.annotate(np.zeros((32, 32, 3), np.uint8),
                   np.asarray([[4, 4, 20, 20]]), labels=[1], scores=[0.9],
                   class_names={1: "box"}, save_to=fp)
    assert os.path.getsize(fp) > 0


def test_plot_training_curves(tmp_path):
    d = {"info": {"arch": "x"},
         "train": [{"epoch": 0, "acc": 0.5, "loss": 1.0},
                   {"epoch": 1, "acc": 0.6, "loss": 0.8}],
         "val": [{"epoch": 0, "acc": 0.4, "loss": 1.1},
                 {"epoch": 1, "acc": 0.5, "loss": 0.9}]}
    src = tmp_path / "stats.json"
    src.write_text(json.dumps(d))
    fp = str(tmp_path / "curves.png")
    plots.plot_training_curves(str(src), save_to=fp)
    assert os.path.getsize(fp) > 0


def test_plot_detection_logs(tmp_path):
    d = {"logs": [{"epoch": 0, "val": {"bbox": {"ap": 0.1}}},
                  {"epoch": 1, "val": {"bbox": {"ap": 0.2}}}]}
    src = tmp_path / "det.json"
    src.write_text(json.dumps(d))
    fp = str(tmp_path / "ap.png")
    plots.plot_detection_logs(str(src), save_to=fp)
    assert os.path.getsize(fp) > 0


def test_coco_browser_saves(tmp_path):
    img_dir, ann = make_synthetic_coco(str(tmp_path / "coco"), n_images=2,
                                       size=32)
    ds = CocoDetectionDataset(img_dir, ann, image_size=32)
    fp = str(tmp_path / "gt.png")
    plots.CocoBrowser(ds).show(0, save_to=fp)
    assert os.path.getsize(fp) > 0


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mem = DeviceMemory()
    s = mem.stats()
    assert s == {"total_gb": 0.0, "used_gb": 0.0, "free_gb": 0.0,
                 "peak_gb": 0.0}
    assert mem.get_str().startswith("hbm[")


def test_step_timer_with_fence():
    t = StepTimer(window=2)
    for _ in range(3):
        t.start()
        x = torch.ones(64, 64) @ torch.ones(64, 64)
        assert t.stop(fence_on=x) > 0
    assert len(t.times) == 2 and t.ms_per_step > 0
    assert t.get_str().startswith("step[")
    fence()                      # no card: nothing to wait for


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as prof:
        (torch.ones(8, 8) * 2).sum()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert prof.key_averages()


@pytest.mark.parametrize("name", ["annotate", "plot_training_curves",
                                  "plot_detection_logs", "CocoBrowser"])
def test_plot_api_matches_jax(name):
    """The same public names and, for functions, the same parameters."""
    import inspect
    ours, theirs = getattr(plots, name), getattr(jax_plots, name)
    assert (list(inspect.signature(ours).parameters)
            == list(inspect.signature(theirs).parameters))
