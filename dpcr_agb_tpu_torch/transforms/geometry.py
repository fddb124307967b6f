"""Geometry helpers for the ported transforms (counterpart of
`dpcr_agb_tpu/transforms/geometry.py`)."""
from __future__ import annotations

import numpy as np


def euler_angles_to_rotation_matrix(theta: np.ndarray,
                                    order=(0, 1, 2)) -> np.ndarray:
    """Rotation matrix from per-axis Euler angles, the axis matrices
    composed in the given order."""
    cx, sx = np.cos(theta[0]), np.sin(theta[0])
    cy, sy = np.cos(theta[1]), np.sin(theta[1])
    cz, sz = np.cos(theta[2]), np.sin(theta[2])
    r_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    r_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    r_z = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    ms = [[r_x, r_y, r_z][i] for i in order]
    return (ms[2] @ ms[1] @ ms[0]).astype(np.float32)


def affine2d(scale: float = 1.0, translate=(0.0, 0.0),
             rotate_deg: float = 0.0, rotate_about=(0.5, 0.5)) -> np.ndarray:
    """3x3 homogeneous 2D affine: scale, then translate, then rotate about
    a point."""
    s_m = np.diag([scale, scale, 1.0])
    t_m = np.array([[1, 0, translate[0]], [0, 1, translate[1]], [0, 0, 1.0]])
    th = np.deg2rad(rotate_deg)
    c, s = np.cos(th), np.sin(th)
    cx, cy = rotate_about
    to_c = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
    r_m = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    back = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1.0]])
    return back @ r_m @ to_c @ t_m @ s_m


def transform_points2d(a: np.ndarray, pts: np.ndarray) -> np.ndarray:
    pts_h = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    return (pts_h @ a.T)[:, :2]


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
