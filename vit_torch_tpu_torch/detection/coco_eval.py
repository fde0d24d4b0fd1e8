"""COCO bbox, segm and keypoint evaluation, counterpart of
``vit_torch_tpu/detection/coco_eval.py`` (its ``COCO``, ``COCOeval`` and
``CocoEvaluator`` for ``iou_type`` ``"bbox"``, ``"segm"`` and
``"keypoints"``).

The published COCO protocol: greedy score-descending matching per IoU
threshold with iscrowd and area-range ignore handling, 101-point
interpolated precision, and the 12-number summary (AP, AP50, AP75,
APs/m/l, AR1/10/100, ARs/m/l) that the reference flattens into its stats
JSON (``object/coco_pipeline.py:495-515``).  The keypoint protocol
(pycocotools' ``computeOks``): the OKS with the published per-keypoint
sigmas (0.05 each where a schema has other than 17 keypoints), 20
detections an image, no "small" bucket, gts without a labelled keypoint
ignored, and the 10-number summary (AP, AP50, AP75, APm, APl, AR, AR50,
AR75, ARm, ARl).  The IoUs are :mod:`~vit_torch_tpu_torch.detection.
_mask`'s: boxes, and RLE masks (polygons rasterised at the image's size)
with crowd regions; a segm result's area is its mask's (``area_segm``),
so that segm buckets by mask area.  Under a data mesh every rank's
results are merged before the summary
(:meth:`CocoEvaluator.synchronize_between_processes`).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from vit_torch_tpu_torch.detection import _mask
from vit_torch_tpu_torch.detection._mask import bbox_iou

IOU_TYPES = ("bbox", "segm", "keypoints")


def _check_iou_type(iou_type: str) -> None:
    if iou_type not in IOU_TYPES:
        raise ValueError(f"unknown iou_type {iou_type!r}")


class COCO:
    """Minimal COCO-format container (pycocotools.COCO equivalent)."""

    def __init__(self, annotation_file: Optional[str] = None,
                 dataset: Optional[dict] = None) -> None:
        if annotation_file is not None:
            with open(annotation_file) as f:
                dataset = json.load(f)
        self.dataset = dataset or {"images": [], "annotations": [],
                                   "categories": []}
        self.create_index()

    def create_index(self) -> None:
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)

    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs)

    def get_cat_ids(self) -> List[int]:
        return sorted(self.cats)

    def load_res(self, results: Sequence[dict]) -> "COCO":
        """Build a results COCO from detection dicts ``{image_id,
        category_id, bbox (xywh), score[, segmentation][, keypoints]}``;
        a result with a segmentation keeps its mask's area in
        ``area_segm`` (and in ``area`` where it has none); one with
        keypoints and no bbox takes its bbox and area from the keypoints'
        extent (pycocotools ``loadRes``)."""
        res = COCO(dataset={
            "images": list(self.dataset.get("images", [])),
            "categories": list(self.dataset.get("categories", [])),
            "annotations": []})
        anns = []
        for i, det in enumerate(results):
            ann = dict(det)
            ann["id"] = i + 1
            if "bbox" in ann and "area" not in ann:
                x, y, w, h = ann["bbox"]
                ann["area"] = w * h
            if "segmentation" in ann:
                # one result dict serves every iou type, so the mask's
                # area rides in a key of its own
                ann["area_segm"] = _mask.area(ann["segmentation"])
                ann.setdefault("area", ann["area_segm"])
            if "keypoints" in ann and "bbox" not in ann:
                kp = np.asarray(ann["keypoints"], np.float64).reshape(-1, 3)
                x0, x1 = float(kp[:, 0].min()), float(kp[:, 0].max())
                y0, y1 = float(kp[:, 1].min()), float(kp[:, 1].max())
                ann["bbox"] = [x0, y0, x1 - x0, y1 - y0]
                ann["area"] = (x1 - x0) * (y1 - y0)
            ann.setdefault("iscrowd", 0)
            anns.append(ann)
        res.dataset["annotations"] = anns
        res.create_index()
        return res


# COCO-17 per-keypoint OKS sigmas (the published constants)
KPT_OKS_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
    1.07, 1.07, .87, .87, .89, .89]) / 10.0


class COCOeval:
    """The COCO evaluation protocol, bbox, segm or keypoints."""

    def __init__(self, coco_gt: COCO, coco_dt: COCO,
                 iou_type: str = "bbox") -> None:
        _check_iou_type(iou_type)
        self.coco_gt = coco_gt
        self.coco_dt = coco_dt
        self.iou_type = iou_type
        self.img_ids = coco_gt.get_img_ids()
        self.cat_ids = coco_gt.get_cat_ids() or [-1]
        self.iou_thrs = np.linspace(0.5, 0.95, 10)
        self.rec_thrs = np.linspace(0.0, 1.0, 101)
        if iou_type == "keypoints":
            self.max_dets = [20]
            self.area_rng = [[0.0, 1e10], [32 ** 2, 96 ** 2],
                             [96 ** 2, 1e10]]
            self.area_lbl = ["all", "medium", "large"]
        else:
            self.max_dets = [1, 10, 100]
            self.area_rng = [[0.0, 1e10], [0.0, 32 ** 2],
                             [32 ** 2, 96 ** 2], [96 ** 2, 1e10]]
            self.area_lbl = ["all", "small", "medium", "large"]
        self.stats: np.ndarray = np.zeros(12)
        self.eval: dict = {}

    # -- per-image matching -----------------------------------------------

    def _gt_dt(self, img_id, cat_id):
        gts = [a for a in self.coco_gt.img_to_anns.get(img_id, [])
               if a["category_id"] == cat_id]
        dts = [a for a in self.coco_dt.img_to_anns.get(img_id, [])
               if a["category_id"] == cat_id]
        return gts, dts

    def _compute_iou(self, img_id, cat_id):
        gts, dts = self._gt_dt(img_id, cat_id)
        if not gts or not dts:
            return np.zeros((len(dts), len(gts)))
        dts = sorted(dts, key=lambda d: -d.get("score", 0))[:self.max_dets[-1]]
        if self.iou_type == "keypoints":
            return self._compute_oks(dts, gts)
        iscrowd = [int(g.get("iscrowd", 0)) for g in gts]
        if self.iou_type == "bbox":
            return bbox_iou([d["bbox"] for d in dts],
                            [g["bbox"] for g in gts], iscrowd)
        img = self.coco_gt.imgs[img_id]
        h, w = img["height"], img["width"]
        return _mask.rle_iou([self._to_rle(d["segmentation"], h, w)
                              for d in dts],
                             [self._to_rle(g["segmentation"], h, w)
                              for g in gts], iscrowd)

    @staticmethod
    def _to_rle(segm, h, w) -> dict:
        return segm if isinstance(segm, dict) else _mask.poly_to_rle(segm,
                                                                     h, w)

    @staticmethod
    def _compute_oks(dts, gts) -> np.ndarray:
        """The (D, G) Object Keypoint Similarity (pycocotools
        ``computeOks``): a Gaussian fall-off of each keypoint's distance,
        scaled by the gt's area and the keypoint's sigma, averaged over
        the gt's labelled keypoints; against a gt with none labelled, the
        distance outside the gt box grown by its size on every side."""
        ious = np.zeros((len(dts), len(gts)))
        for j, gt in enumerate(gts):
            g = np.asarray(gt["keypoints"], np.float64).reshape(-1, 3)
            xg, yg, vg = g[:, 0], g[:, 1], g[:, 2]
            k = len(g)
            sigmas = (KPT_OKS_SIGMAS if k == len(KPT_OKS_SIGMAS)
                      else np.full(k, 0.05))
            variances = (2 * sigmas) ** 2
            x0, y0, bw, bh = gt["bbox"]
            x1, y1 = x0 + bw, y0 + bh
            area = gt.get("area", bw * bh)
            for i, dt in enumerate(dts):
                d = np.asarray(dt["keypoints"], np.float64).reshape(-1, 3)
                xd, yd = d[:, 0], d[:, 1]
                if vg.sum() > 0:
                    dx, dy = xd - xg, yd - yg
                else:
                    z = np.zeros(k)
                    dx = (np.maximum(z, (x0 - bw) - xd)
                          + np.maximum(z, xd - (x1 + bw)))
                    dy = (np.maximum(z, (y0 - bh) - yd)
                          + np.maximum(z, yd - (y1 + bh)))
                e = (dx ** 2 + dy ** 2) / variances / (area + np.spacing(1)) / 2
                if vg.sum() > 0:
                    e = e[vg > 0]
                ious[i, j] = np.mean(np.exp(-e)) if e.size else 0.0
        return ious

    def _gt_ignored(self, g, area_rng) -> int:
        ig = int(g.get("iscrowd", 0)) or not (
            area_rng[0] <= g.get("area", 0) <= area_rng[1])
        if self.iou_type == "keypoints" and not ig:
            # a gt with no labelled keypoint is ignored, not missed
            nk = g.get("num_keypoints")
            if nk is None and "keypoints" in g:
                kp = np.asarray(g["keypoints"], np.float64).reshape(-1, 3)
                nk = int((kp[:, 2] > 0).sum())
            ig = nk == 0 if nk is not None else ig
        return int(bool(ig))

    def _evaluate_img(self, img_id, cat_id, area_rng, ious):
        gts, dts = self._gt_dt(img_id, cat_id)
        if not gts and not dts:
            return None
        # ignore flags are local: the caller's annotations stay untouched
        ig = np.asarray([self._gt_ignored(g, area_rng) for g in gts])
        # gts sorted: non-ignored first (stable)
        gt_order = np.argsort(ig, kind="stable")
        gts = [gts[i] for i in gt_order]
        dts = sorted(dts, key=lambda d: -d.get("score", 0))[:self.max_dets[-1]]
        iou = ious[:, gt_order] if len(ious) else ious

        T = len(self.iou_thrs)
        G, D = len(gts), len(dts)
        gt_match = np.zeros((T, G), np.int64)
        dt_match = np.zeros((T, D), np.int64)
        gt_ignore = ig[gt_order] if G else ig
        dt_ignore = np.zeros((T, D))
        for ti, thr in enumerate(self.iou_thrs):
            for di in range(D):
                best, best_iou = -1, min(thr, 1 - 1e-10)
                for gi in range(G):
                    if gt_match[ti, gi] > 0 and not gts[gi].get("iscrowd", 0):
                        continue
                    # stop at ignored gts once a real match was found
                    if best > -1 and not gt_ignore[best] and gt_ignore[gi]:
                        break
                    if iou[di, gi] < best_iou:
                        continue
                    best_iou = iou[di, gi]
                    best = gi
                if best == -1:
                    continue
                dt_ignore[ti, di] = gt_ignore[best]
                dt_match[ti, di] = gts[best]["id"]
                gt_match[ti, best] = dts[di]["id"]
        # unmatched dts outside the area range are ignored; segm buckets
        # by the mask's area
        def dt_area(d):
            if self.iou_type == "segm" and "area_segm" in d:
                return d["area_segm"]
            return d.get("area", d["bbox"][2] * d["bbox"][3]
                         if "bbox" in d else 0)

        dt_out = np.asarray([
            not (area_rng[0] <= dt_area(d) <= area_rng[1])
            for d in dts]) if D else np.zeros(0, bool)
        if D:
            dt_ignore = np.logical_or(dt_ignore, np.logical_and(
                dt_match == 0, dt_out[None, :].repeat(T, 0)))
        return {
            "dt_scores": np.asarray([d.get("score", 0) for d in dts]),
            "dt_match": dt_match,
            "dt_ignore": dt_ignore,
            "gt_ignore": gt_ignore,
            "num_gt": int((~gt_ignore.astype(bool)).sum()),
        }

    # -- protocol -----------------------------------------------------------

    def evaluate(self) -> None:
        ious = {(img, cat): self._compute_iou(img, cat)
                for img in self.img_ids for cat in self.cat_ids}
        self._results = {}
        for cat in self.cat_ids:
            for ai, area in enumerate(self.area_rng):
                for img in self.img_ids:
                    self._results[(img, cat, ai)] = self._evaluate_img(
                        img, cat, area, ious[(img, cat)])

    def accumulate(self) -> None:
        T, R = len(self.iou_thrs), len(self.rec_thrs)
        K, A, M = len(self.cat_ids), len(self.area_rng), len(self.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        for ki, cat in enumerate(self.cat_ids):
            for ai in range(A):
                results = [self._results.get((img, cat, ai))
                           for img in self.img_ids]
                results = [r for r in results if r is not None]
                if not results:
                    continue
                num_gt = sum(r["num_gt"] for r in results)
                if num_gt == 0:
                    continue
                for mi, max_det in enumerate(self.max_dets):
                    dtm = np.concatenate(
                        [r["dt_match"][:, :max_det] for r in results], axis=1)
                    dti = np.concatenate(
                        [r["dt_ignore"][:, :max_det] for r in results], axis=1)
                    sc = np.concatenate(
                        [r["dt_scores"][:max_det] for r in results])
                    o = np.argsort(-sc, kind="mergesort")
                    dtm, dti = dtm[:, o], dti[:, o]
                    tps = np.logical_and(dtm > 0, ~dti.astype(bool))
                    fps = np.logical_and(dtm == 0, ~dti.astype(bool))
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / num_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        # precision envelope (monotone non-increasing)
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, self.rec_thrs, side="left")
                        q = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q
        self.eval = {"precision": precision, "recall": recall}

    def _summarize(self, ap: bool, iou_thr=None, area="all", max_det=100):
        ai = self.area_lbl.index(area)
        mi = self.max_dets.index(max_det)
        s = self.eval["precision" if ap else "recall"]
        if iou_thr is not None:
            s = s[np.isclose(self.iou_thrs, iou_thr)]
        s = s[:, :, :, ai, mi] if ap else s[:, :, ai, mi]
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self) -> np.ndarray:
        s = self._summarize
        if self.iou_type == "keypoints":
            self.stats = np.array([
                s(True, max_det=20), s(True, 0.5, max_det=20),
                s(True, 0.75, max_det=20),
                s(True, area="medium", max_det=20),
                s(True, area="large", max_det=20),
                s(False, max_det=20), s(False, 0.5, max_det=20),
                s(False, 0.75, max_det=20),
                s(False, area="medium", max_det=20),
                s(False, area="large", max_det=20)])
            return self.stats
        self.stats = np.array([
            s(True), s(True, 0.5), s(True, 0.75),
            s(True, area="small"), s(True, area="medium"),
            s(True, area="large"),
            s(False, max_det=1), s(False, max_det=10), s(False, max_det=100),
            s(False, area="small"), s(False, area="medium"),
            s(False, area="large"),
        ])
        return self.stats


class CocoEvaluator:
    """Accumulating evaluator (the reference's ``CocoEvaluator``,
    ``object/coco_eval.py:19-155``): feed per-batch predictions keyed by
    image id, then accumulate and summarize."""

    METRIC_KEYS = ["ap", "ap50", "ap75", "aps", "apm", "apl",
                   "ar1", "ar10", "ar100", "ars", "arm", "arl"]
    KP_METRIC_KEYS = ["ap", "ap50", "ap75", "apm", "apl",
                      "ar", "ar50", "ar75", "arm", "arl"]

    def __init__(self, coco_gt: COCO, iou_types: Sequence[str] = ("bbox",)):
        for iou_type in iou_types:
            _check_iou_type(iou_type)
        self.coco_gt = coco_gt
        self.iou_types = list(iou_types)
        self.results: List[dict] = []
        self.coco_eval: Dict[str, COCOeval] = {}

    def update(self, predictions: Dict[int, dict]) -> None:
        """predictions: ``{image_id: {'boxes' xyxy, 'scores', 'labels'
        [, 'masks' (N, H, W) binary at the original resolution]
        [, 'keypoints' (N, K, 3)]}}`` (numpy or anything numpy
        converts)."""
        for img_id, pred in predictions.items():
            masks = pred.get("masks")
            boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
            scores = np.asarray(pred["scores"], np.float64).reshape(-1)
            labels = np.asarray(pred["labels"], np.int64).reshape(-1)
            keypoints = pred.get("keypoints")
            # xyxy -> xywh (reference object/coco_eval.py:158-160)
            xywh = boxes.copy()
            xywh[:, 2:] -= xywh[:, :2]
            for i, (box, score, label) in enumerate(zip(xywh, scores,
                                                        labels)):
                result = {
                    "image_id": int(img_id), "category_id": int(label),
                    "bbox": [float(v) for v in box], "score": float(score)}
                if masks is not None:
                    result["segmentation"] = _mask.encode(
                        np.asarray(masks[i], np.uint8))
                if keypoints is not None:
                    result["keypoints"] = [float(v) for v in np.asarray(
                        keypoints[i], np.float64).reshape(-1)]
                self.results.append(result)

    def synchronize_between_processes(self) -> None:
        """Multi-process merge: every rank's result list gathered on every
        rank (the reference's pickle all_gather,
        ``object/coco_eval.py:163-182``); nothing to do in one process."""
        from vit_torch_tpu_torch.parallel.multihost import all_gather_objects
        merged = []
        for part in all_gather_objects(self.results):
            merged.extend(part)
        self.results = merged

    def accumulate(self) -> None:
        coco_dt = self.coco_gt.load_res(self.results)
        for iou_type in self.iou_types:
            ev = COCOeval(self.coco_gt, coco_dt, iou_type)
            ev.evaluate()
            ev.accumulate()
            ev.summarize()
            self.coco_eval[iou_type] = ev

    def summarize(self) -> Dict[str, Dict[str, float]]:
        return {iou_type: dict(zip(self.KP_METRIC_KEYS
                                   if iou_type == "keypoints"
                                   else self.METRIC_KEYS, ev.stats.tolist()))
                for iou_type, ev in self.coco_eval.items()}
