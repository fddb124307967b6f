"""Geometry helpers for the ported transforms (counterpart of
`dpcr_agb_tpu/transforms/geometry.py`)."""
from __future__ import annotations

import numpy as np


def points_in_polygon(points: np.ndarray, polygon: np.ndarray) -> np.ndarray:
    """Vectorized even-odd-rule point-in-polygon test: points [N,2],
    polygon [V,2] (closed implicitly)."""
    points = np.asarray(points, dtype=np.float64)
    poly = np.asarray(polygon, dtype=np.float64)
    x, y = points[:, 0], points[:, 1]
    x0, y0 = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    inside = np.zeros(len(points), dtype=bool)
    for i in range(len(poly)):
        crosses = (y0[i] > y) != (y1[i] > y)
        if not crosses.any():
            continue
        xint = (x1[i] - x0[i]) * (y - y0[i]) / (y1[i] - y0[i]) + x0[i]
        inside ^= crosses & (x < xint)
    return inside


def dbscan1d_labels(z: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """1D DBSCAN labels (noise = -1) via sorting + searchsorted: a point is
    core if >= min_samples points lie within [z-eps, z+eps] (itself
    included); clusters are chains of core points closer than eps plus the
    border points within eps of a core point."""
    z = np.asarray(z, dtype=np.float64).ravel()
    n = len(z)
    order = np.argsort(z, kind="stable")
    zs = z[order]
    lo = np.searchsorted(zs, zs - eps, side="left")
    hi = np.searchsorted(zs, zs + eps, side="right")
    core = (hi - lo) >= min_samples

    labels_sorted = np.full(n, -1, dtype=np.int64)
    core_idx = np.flatnonzero(core)
    if len(core_idx):
        zc = zs[core_idx]
        new_cluster = np.concatenate([[True], np.diff(zc) > eps])
        core_labels = np.cumsum(new_cluster) - 1
        labels_sorted[core_idx] = core_labels
        pos = np.searchsorted(zc, zs)
        left = np.clip(pos - 1, 0, len(zc) - 1)
        right = np.clip(pos, 0, len(zc) - 1)
        d_left = np.abs(zs - zc[left])
        d_right = np.abs(zs - zc[right])
        nearest = np.where(d_right < d_left, right, left)
        d_near = np.minimum(d_left, d_right)
        border = (~core) & (d_near <= eps)
        labels_sorted[border] = core_labels[nearest[border]]
    labels = np.empty(n, dtype=np.int64)
    labels[order] = labels_sorted
    return labels
