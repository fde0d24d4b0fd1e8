"""Local Binary Pattern texture transforms on the host, the port's own
copy of ``vit_torch_tpu/data/lbp.py`` (the reference's ``TRANS`` LBP
stack, ``utils_datasets.py:1073-1267``): per-method LBP maps normalised
to uint8 (default / ror / uniform / nri_uniform with the reference's
value ranges) and their channel stack, where a channel may also be the
gray image ('l') or a raw colour channel ('r'/'g'/'b').  The letterbox
(the reference's ``fit_to``) is ``datasets.py:_imagefolder_arrays``.

The code map is numpy only (``_lbp_numpy``, scikit-image's ring
convention; a stack samples the ring once for all its methods).  The JAX
package calls its C++ ``local_binary_pattern`` (``csrc/maskops.cpp``) by
ctypes where that library is built; the port does not load the JAX
package's library, and a native path of its own belongs to the detection
slice.  The tire dataset runs this once, at build time (``tire.py``);
the per-step path is ``lbp_device.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

LBP_METHODS = ["default", "ror", "uniform", "nri_uniform"]


def rgb_to_gray_uint8(img: np.ndarray) -> np.ndarray:
    """PIL ``convert('L')`` bit-exact: integer luma with PIL's fixed-point
    coefficients and rounding (``(19595 R + 38470 G + 7471 B + 0x8000) >>
    16``).  The reference quantises to a uint8 'L' image before LBP
    (``utils_datasets.py:1105-1111``), so LBP parity needs the same ties."""
    if img.ndim == 2:
        return np.clip(np.round(img), 0, 255).astype(np.uint8)
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    return ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16).astype(np.uint8)


def _lbp_numpy(img: np.ndarray, P: int, R: float, method: str) -> np.ndarray:
    """LBP map (H, W) float64 of a float64 gray image."""
    return _lbp_map(_lbp_codes(img, P, R), P, method)


def _lbp_codes(img: np.ndarray, P: int, R: float) -> np.ndarray:
    """The ring codes (H, W) uint64 of a float64 gray image."""
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    codes = np.zeros((h, w), np.uint64)
    for p in range(P):
        # skimage ring convention: sample p at (row - R sin θ, col + R cos θ),
        # i.e. p=0 due east, traversing counter-clockwise in image coords
        angle = 2 * np.pi * p / P
        sy, sx = -R * np.sin(angle), R * np.cos(angle)
        yy, xx = ys + sy, xs + sx
        y0, x0 = np.floor(yy).astype(int), np.floor(xx).astype(int)
        fy, fx = yy - y0, xx - x0
        c = lambda a, lo, hi: np.clip(a, lo, hi)
        at = lambda yi, xi: img[c(yi, 0, h - 1), c(xi, 0, w - 1)]
        v = ((1 - fy) * (1 - fx) * at(y0, x0) + (1 - fy) * fx * at(y0, x0 + 1)
             + fy * (1 - fx) * at(y0 + 1, x0) + fy * fx * at(y0 + 1, x0 + 1))
        # tie tolerance: flat regions read >= center
        codes |= ((v >= img - 1e-4).astype(np.uint64) << np.uint64(p))
    return codes


def _lbp_map(codes: np.ndarray, P: int, method: str) -> np.ndarray:
    """The map of ``method`` from :func:`_lbp_codes`, float64."""
    bits = ((codes[None] >> np.arange(P, dtype=np.uint64)[:, None, None])
            & np.uint64(1)).astype(np.int64)
    transitions = (bits != np.roll(bits, -1, axis=0)).sum(0)
    ones = bits.sum(0)
    if method == "default":
        return codes.astype(np.float64)
    if method == "ror":
        best = codes.copy()
        mask = np.uint64((1 << P) - 1)
        for s in range(1, P):
            rot = ((codes >> np.uint64(s)) | (codes << np.uint64(P - s))) & mask
            best = np.minimum(best, rot)
        return best.astype(np.float64)
    if method == "uniform":
        return np.where(transitions <= 2, ones, P + 1).astype(np.float64)
    if method == "nri_uniform":
        prev = np.roll(bits, 1, axis=0)
        first_rise = np.argmax((bits == 1) & (prev == 0), axis=0)
        label = 1 + (ones - 1) * P + first_rise
        label = np.where(ones == 0, 0, label)
        label = np.where(ones == P, P * (P - 1) + 1, label)
        label = np.where(transitions > 2, P * (P - 1) + 2, label)
        return label.astype(np.float64)
    raise ValueError(method)


def method_range(method: str, n_points: int) -> List[float]:
    """Reference normalisation ranges (``utils_datasets.py:1120-1133``)."""
    if method in ("default", "ror"):
        return [0, 2 ** n_points - 1]
    if method == "uniform":
        return [0, n_points + 1]
    if method == "nri_uniform":
        return [0, (n_points + 1) * n_points]
    return [0, 255]


def get_lbp_full(img: np.ndarray, radius: int = 1, point_mult: int = 8,
                 methods: Optional[Sequence[str]] = None,
                 ) -> Dict[str, np.ndarray]:
    """Per-method LBP maps normalised to uint8 (reference ``get_lbp_full``,
    ``utils_datasets.py:1112-1146``).  RGB input is quantised to a PIL-exact
    uint8 'L' image first, matching the reference's ``convert('L')`` ties."""
    gray = rgb_to_gray_uint8(np.asarray(img)).astype(np.float64)
    if methods is None:
        methods = list(LBP_METHODS)
    if isinstance(methods, str):
        methods = [methods]
    n_points = min(point_mult * radius, 24)
    methods = [m for m in methods if m in LBP_METHODS]
    codes = _lbp_codes(gray, n_points, radius) if methods else None
    out = {}
    for method in methods:
        lo, hi = method_range(method, n_points)
        m = _lbp_map(codes, n_points, method)
        m = (m - lo) / (hi - lo) * 255
        out[method] = np.clip(m, 0, 255).astype(np.uint8)
    return out


def get_lbp_merge(img: np.ndarray, radius: int = 1, point_mult: int = 8,
                  methods: Sequence[str] = ("l", "default", "uniform"),
                  ) -> np.ndarray:
    """Channel-stack of LBP maps / gray / raw colour channels (reference
    ``get_lbp_merge``, ``utils_datasets.py:1148-1180``): N-channel uint8
    image whose channel count equals ``len(methods)``."""
    img = np.asarray(img)
    valid = set(LBP_METHODS) | {"l", "r", "g", "b"}
    assert all(m in valid for m in methods), methods
    lbp_maps = get_lbp_full(img, radius, point_mult,
                            [m for m in methods if m in LBP_METHODS])
    channels = []
    for m in methods:
        if m == "l":
            channels.append(rgb_to_gray_uint8(img))
        elif m in ("r", "g", "b"):
            channels.append(img[..., "rgb".index(m)])
        else:
            channels.append(lbp_maps[m])
    return np.stack(channels, axis=-1)
