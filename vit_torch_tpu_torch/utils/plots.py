"""Visualisation tools, counterpart of ``vit_torch_tpu/utils/plots.py``
(the reference's ``object/od_plot.py`` / ``object_detr/plot_od.py`` box
overlays with a hue per class, ``object_detr/util/plot_utils.py:13-75``
training curves from the stats logs, and the ``CocoManager`` ground-truth
browser).

Backend: matplotlib, headless (Agg); each function returns the figure and
optionally saves it.  matplotlib is imported inside the functions, never
when the module is imported: the card's machine has none, and nothing on
the training or serving paths plots.
"""

from __future__ import annotations

import colorsys
import json
from typing import Dict, Optional, Sequence

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend, and its patches."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import patches
    return plt, patches


def _save(fig, save_to: Optional[str]):
    if save_to:
        plt, _ = _pyplot()
        fig.savefig(save_to, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return fig


def class_color(label: int, n_classes: int = 20):
    """A stable hue per class (the reference's hue-per-class scheme,
    ``object/od_plot.py:44-170``)."""
    hue = (label * 0.61803398875) % 1.0
    return colorsys.hsv_to_rgb(hue, 0.85, 0.95)


def annotate(image: np.ndarray, boxes: np.ndarray,
             labels: Optional[Sequence[int]] = None,
             scores: Optional[Sequence[float]] = None,
             class_names: Optional[Dict[int, str]] = None,
             save_to: Optional[str] = None, ax=None):
    """Draw xyxy boxes with per-class colours and score labels over an
    image."""
    plt, patches = _pyplot()
    if ax is None:
        fig, ax = plt.subplots(figsize=(8, 8))
    else:
        fig = ax.figure
    ax.imshow(image)
    ax.axis("off")
    boxes = np.asarray(boxes).reshape(-1, 4)
    for i, box in enumerate(boxes):
        label = int(labels[i]) if labels is not None else 0
        color = class_color(label)
        x0, y0, x1, y1 = box
        ax.add_patch(patches.Rectangle((x0, y0), x1 - x0, y1 - y0,
                                       fill=False, edgecolor=color,
                                       linewidth=2))
        text = class_names.get(label, str(label)) if class_names else str(label)
        if scores is not None:
            text += f" {scores[i]:.2f}"
        ax.text(x0, y0 - 2, text, color="white", fontsize=8,
                bbox=dict(facecolor=color, alpha=0.8, pad=1))
    return _save(fig, save_to)


def plot_training_curves(stats_fp: str, keys: Sequence[str] = ("acc", "loss"),
                         save_to: Optional[str] = None):
    """Train/val metric curves from a classification stats JSON (the
    reference's ``plot_utils.py:13-75`` over this package's logs)."""
    plt, _ = _pyplot()
    with open(stats_fp) as f:
        d = json.load(f)
    splits = [s for s in ("train", "val") if isinstance(d.get(s), list)]
    fig, axes = plt.subplots(1, len(keys), figsize=(6 * len(keys), 4))
    if len(keys) == 1:
        axes = [axes]
    for ax, key in zip(axes, keys):
        for split in splits:
            rows = d[split]
            ax.plot([r["epoch"] for r in rows], [r.get(key) for r in rows],
                    marker="o", markersize=3, label=split)
        ax.set_xlabel("epoch")
        ax.set_ylabel(key)
        ax.legend()
        ax.grid(alpha=0.3)
    fig.suptitle(d.get("info", {}).get("arch", stats_fp))
    return _save(fig, save_to)


def plot_detection_logs(stats_fp: str, metric: str = "ap",
                        save_to: Optional[str] = None):
    """bbox ``metric`` against the epoch from a detection stats JSON
    (``cli/coco.py``'s)."""
    plt, _ = _pyplot()
    with open(stats_fp) as f:
        d = json.load(f)
    rows = d.get("logs", [])
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot([r["epoch"] for r in rows],
            [r["val"]["bbox"].get(metric, 0) for r in rows], marker="o")
    ax.set_xlabel("epoch")
    ax.set_ylabel(f"bbox {metric}")
    ax.grid(alpha=0.3)
    return _save(fig, save_to)


class CocoBrowser:
    """Ground-truth browsing (the reference's ``CocoManager``,
    ``object_detr/plot_od.py:87+``): render a picture's boxes."""

    def __init__(self, dataset) -> None:
        self.dataset = dataset  # detection.coco_data.CocoDetectionDataset

    def show(self, index: int, save_to: Optional[str] = None):
        sample = self.dataset[index]
        valid = sample["box_mask"] > 0
        names = {v: self.dataset.coco.cats.get(k, {}).get("name", str(k))
                 for k, v in self.dataset.cat_to_label.items()}
        return annotate(sample["image"], sample["boxes"][valid],
                        sample["labels"][valid], class_names=names,
                        save_to=save_to)
