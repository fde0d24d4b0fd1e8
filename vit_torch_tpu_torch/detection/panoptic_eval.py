"""Panoptic Quality (PQ), counterpart of
``vit_torch_tpu/detection/panoptic_eval.py`` (the reference's
``object_detr/datasets/panoptic_eval.py``, a wrapper over panopticapi's
``pq_compute``): PQ = SQ x RQ over categories (Kirillov et al.), a
segment pair matching where their IoU exceeds 0.5 and their categories
agree, per-category TP/FP/FN with panopticapi's void and crowd handling,
on per-image segment maps (integer id maps and ``{id: category_id}``
dicts, panopticapi's data model without its PNG layer).  numpy only.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence, Tuple

import numpy as np

VOID = 0


class PQStat:
    def __init__(self) -> None:
        self.iou = defaultdict(float)
        self.tp = defaultdict(int)
        self.fp = defaultdict(int)
        self.fn = defaultdict(int)

    def merge(self, other: "PQStat") -> None:
        """Add another rank's counts (a data-parallel evaluation)."""
        for mine, theirs in ((self.iou, other.iou), (self.tp, other.tp),
                             (self.fp, other.fp), (self.fn, other.fn)):
            for k, v in theirs.items():
                mine[k] += v

    def update(self, gt_map: np.ndarray, gt_segments: Dict[int, int],
               pred_map: np.ndarray, pred_segments: Dict[int, int],
               crowd_ids: Sequence[int] = ()) -> None:
        """Accumulate one image.  ``*_segments`` map segment id →
        category id; id 0 / missing ids are void."""
        crowd_ids = set(crowd_ids)
        # panopticapi remaps unlabeled pixels to VOID when rasterizing;
        # here gt_map may carry ids missing from gt_segments (e.g. a
        # category-filtered gt dict) — fold them into VOID so unions and
        # the FP void-fraction rule see them as void, per the docstring
        if gt_segments:
            known = np.asarray(list(gt_segments) + [VOID])
            gt_map = np.where(np.isin(gt_map, known), gt_map, VOID)
        else:
            gt_map = np.full_like(gt_map, VOID)
        gt_area = {sid: int(a) for sid, a in
                   zip(*np.unique(gt_map, return_counts=True))}
        pred_area = {sid: int(a) for sid, a in
                     zip(*np.unique(pred_map, return_counts=True))}
        # intersections via combined labels
        combo = gt_map.astype(np.int64) * (2 ** 32) + pred_map.astype(np.int64)
        inter: Dict[Tuple[int, int], int] = {}
        for c, a in zip(*np.unique(combo, return_counts=True)):
            inter[(int(c // 2 ** 32), int(c % 2 ** 32))] = int(a)

        matched_gt, matched_pred = set(), set()
        for (g, p), i in inter.items():
            if g == VOID or p == VOID or g not in gt_segments or \
                    p not in pred_segments or g in crowd_ids:
                continue
            if gt_segments[g] != pred_segments[p]:
                continue
            union = gt_area[g] + pred_area[p] - i \
                - inter.get((VOID, p), 0)       # void inside pred excluded
            iou = i / union if union > 0 else 0.0
            if iou > 0.5:
                cat = gt_segments[g]
                self.tp[cat] += 1
                self.iou[cat] += iou
                matched_gt.add(g)
                matched_pred.add(p)
        for g, cat in gt_segments.items():
            if g in matched_gt or g in crowd_ids:
                continue
            self.fn[cat] += 1
        for p, cat in pred_segments.items():
            if p in matched_pred:
                continue
            # panopticapi rule: preds mostly covered by void/crowd don't count
            void_i = inter.get((VOID, p), 0)
            crowd_i = sum(inter.get((g, p), 0) for g in crowd_ids
                          if gt_segments.get(g) == cat)
            if pred_area.get(p, 0) > 0 and \
                    (void_i + crowd_i) / pred_area[p] > 0.5:
                continue
            self.fp[cat] += 1

    def summarize(self) -> Dict[str, float]:
        cats = set(self.tp) | set(self.fp) | set(self.fn)
        per_cat = {}
        for c in cats:
            tp, fp, fn = self.tp[c], self.fp[c], self.fn[c]
            if tp + fp + fn == 0:
                continue
            sq = self.iou[c] / tp if tp else 0.0
            rq = tp / (tp + 0.5 * fp + 0.5 * fn)
            per_cat[c] = {"pq": sq * rq, "sq": sq, "rq": rq}
        n = max(len(per_cat), 1)
        return {
            "pq": sum(v["pq"] for v in per_cat.values()) / n,
            "sq": sum(v["sq"] for v in per_cat.values()) / n,
            "rq": sum(v["rq"] for v in per_cat.values()) / n,
            "n": len(per_cat),
            "per_class": per_cat,
        }


def masks_to_segment_map(masks: np.ndarray, labels: Sequence[int],
                         scores: Sequence[float], shape: Tuple[int, int],
                         ) -> Tuple[np.ndarray, Dict[int, int]]:
    """Paint instance masks into one id map (higher score wins overlaps) —
    the panoptic-postprocess step for converting DETRSegm outputs."""
    seg = np.zeros(shape, np.int32)
    segments: Dict[int, int] = {}
    order = np.argsort(scores)          # low→high; later paints win
    sid = 1
    for i in order:
        m = masks[i].astype(bool)
        if not m.any():
            continue
        seg[m] = sid
        segments[sid] = int(labels[i])
        sid += 1
    # drop segments fully overpainted
    remaining = set(np.unique(seg).tolist())
    segments = {k: v for k, v in segments.items() if k in remaining}
    return seg, segments
