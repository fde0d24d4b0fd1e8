"""Mask RLE and IoU, counterpart of ``vit_torch_tpu/detection/_mask.py``
(the reference's ``pycocotools._mask``: RLE encode, decode, area, merge,
polygon rasterisation, bbox and RLE IoU with the iscrowd rule, used by
``object/coco_eval.py:10-12`` and ``object/coco_utils.py:9``).

numpy only: no shared library is loaded.  Every function is vectorised
over pixels and runs; none walks the pixels or the runs in Python.  RLE
is COCO's: a column-major scan, counts alternating 0-runs and 1-runs,
starting with zeros.  The results equal the JAX package's functions' bit
for bit (counts lists, areas; IoU to rounding of one float64 division).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


# --------------------------------------------------------------------------
# RLE encode / decode / area
# --------------------------------------------------------------------------

def _runs(flat: np.ndarray) -> List[int]:
    """Run lengths of a 0/1 vector, the first run a 0-run (of length 0
    when the vector starts with a 1)."""
    edges = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], edges, [len(flat)]])).tolist()
    return [0] + runs if len(flat) and flat[0] else runs


def encode(mask: np.ndarray) -> dict:
    """Binary (H, W) mask → COCO-style uncompressed RLE dict."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).ravel(order="F")
    return {"size": [h, w], "counts": _runs(flat)}


def decode(rle: dict) -> np.ndarray:
    """RLE → (H, W) uint8 mask; pixels past the counts' sum are 0."""
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], np.int64)
    vals = np.repeat(np.arange(len(counts), dtype=np.uint8) % 2, counts)
    flat = np.zeros(h * w, np.uint8)
    n = min(len(vals), h * w)
    flat[:n] = vals[:n]
    return flat.reshape(w, h).T


def area(rle: dict) -> int:
    return int(np.asarray(rle["counts"], np.int64)[1::2].sum())


def merge(rles: Sequence[dict]) -> dict:
    """Union-merge RLEs (for multi-polygon objects)."""
    if len(rles) == 1:
        return rles[0]
    m = decode(rles[0])
    for r in rles[1:]:
        m = m | decode(r)
    return encode(m)


# --------------------------------------------------------------------------
# IoU (pycocotools semantics: iscrowd gt → intersection / dt area)
# --------------------------------------------------------------------------

def iou(dt, gt, iscrowd: Sequence[int]) -> np.ndarray:
    """IoU matrix (n_dt, n_gt).  dt/gt are either xywh box arrays or lists
    of RLE dicts — mirrors ``pycocotools.mask.iou``."""
    iscrowd = np.asarray(iscrowd, np.uint8)
    if isinstance(dt, np.ndarray) or (len(dt) and not isinstance(dt[0],
                                                                 dict)):
        return bbox_iou(np.asarray(dt, np.float64),
                        np.asarray(gt, np.float64), iscrowd)
    return rle_iou(list(dt), list(gt), iscrowd)


def bbox_iou(dt: np.ndarray, gt: np.ndarray,
             iscrowd: Sequence[int]) -> np.ndarray:
    """(D, G) IoU of xywh boxes; against a crowd gt the denominator is the
    detection's own area (pycocotools ``bbIou``)."""
    dt = np.asarray(dt, np.float64).reshape(-1, 4)
    gt = np.asarray(gt, np.float64).reshape(-1, 4)
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx0, dy0 = dt[:, 0:1], dt[:, 1:2]
    dx1, dy1 = dx0 + dt[:, 2:3], dy0 + dt[:, 3:4]
    gx0, gy0 = gt[None, :, 0], gt[None, :, 1]
    gx1, gy1 = gx0 + gt[None, :, 2], gy0 + gt[None, :, 3]
    iw = np.maximum(np.minimum(dx1, gx1) - np.maximum(dx0, gx0), 0)
    ih = np.maximum(np.minimum(dy1, gy1) - np.maximum(dy0, gy0), 0)
    inter = iw * ih
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None, :]
    crowd = (np.asarray(iscrowd, bool)[None, :] if len(iscrowd)
             else np.zeros((1, len(gt)), bool))
    denom = np.where(crowd, da, da + ga - inter)
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def rle_iou(dt: List[dict], gt: List[dict],
            iscrowd: Sequence[int]) -> np.ndarray:
    """(D, G) IoU of RLE masks of one image: each mask decoded once, every
    intersection from one product of the flattened 0/1 masks (exact in
    float32 while an image has at most 2^24 pixels, float64 beyond)."""
    n_dt, n_gt = len(dt), len(gt)
    if n_dt == 0 or n_gt == 0:
        return np.zeros((n_dt, n_gt))
    h, w = dt[0]["size"]
    ftype = np.float32 if h * w <= 2 ** 24 else np.float64
    d = np.stack([decode(r).ravel() for r in dt]).astype(ftype)
    g = np.stack([decode(r).ravel() for r in gt]).astype(ftype)
    inter = (d @ g.T).astype(np.int64)
    ad = d.sum(1, dtype=np.float64).astype(np.int64)[:, None]
    ag = g.sum(1, dtype=np.float64).astype(np.int64)[None, :]
    crowd = np.asarray(iscrowd, bool) if len(iscrowd) else np.zeros(n_gt,
                                                                    bool)
    denom = np.where(crowd[None, :], ad, ad + ag - inter)
    return np.where(denom > 0, inter / np.maximum(denom, 1), 0.0)


# --------------------------------------------------------------------------
# polygon -> RLE (frPoly equivalent, PIL rasterisation)
# --------------------------------------------------------------------------

def poly_to_rle(polygons: Sequence[Sequence[float]], h: int, w: int) -> dict:
    """Rasterise a COCO polygon segmentation to an RLE mask."""
    from PIL import Image, ImageDraw
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return encode(np.asarray(img, np.uint8))
