"""Point-cloud transforms of the NFI pre_transform, the deterministic
sparse_xy test chain and the random augmentations of the sparse_xy train
chain (counterparts in `dpcr_agb_tpu/transforms/transforms.py`). Each
random transform draws from the explicit `rng` in the same order as its
JAX counterpart, so both give the same sample from one seed."""
from __future__ import annotations

import math

import numpy as np

from .core import Transform, apply_index, apply_mask, num_points, register
from .geometry import (affine2d, dbscan1d_labels,
                       euler_angles_to_rotation_matrix, points_in_polygon,
                       transform_points2d)


@register
class ScalePos(Transform):
    """mul/div pos by a per-axis scale."""

    def __init__(self, scale_x=1.0, scale_y=1.0, scale_z=1.0, op="mul"):
        self.scale = np.array([[scale_x, scale_y, scale_z]], dtype=np.float32)
        self.op = op

    def __call__(self, rng, sample):
        pos = sample["pos"]
        sample = dict(sample)
        sample["pos"] = (pos * self.scale if self.op == "mul"
                         else pos / self.scale)
        return sample


@register
class MoveCenterPosPerSample(Transform):
    """Constant shift of pos by (center_x, center_y, center_z)."""

    def __init__(self, center_x=0.5, center_y=0.5, center_z=0.5):
        self.center = np.array([[center_x, center_y, center_z]],
                               dtype=np.float32)

    def __call__(self, rng, sample):
        sample = dict(sample)
        sample["pos"] = sample["pos"] + self.center
        return sample


@register
class StartZFromZero(Transform):
    """z -= z.min()."""

    def __call__(self, rng, sample):
        pos = sample["pos"].copy()
        pos[:, 2] -= pos[:, 2].min()
        sample = dict(sample)
        sample["pos"] = pos
        return sample


class FixedPointsOwn(Transform):
    """Sample exactly `num` points without replacement (minimal duplication
    when fewer and `allow_duplicates`)."""

    def __init__(self, num, allow_duplicates=True, skip_list=None):
        self.num = num
        self.allow_duplicates = allow_duplicates
        self.skip_list = list(skip_list or [])

    def __call__(self, rng, sample):
        n = num_points(sample)
        if self.allow_duplicates:
            reps = math.ceil(self.num / n)
            idx = np.concatenate([rng.permutation(n)
                                  for _ in range(reps)])[:self.num]
        else:
            idx = rng.permutation(n)[:self.num]
        return apply_index(sample, idx, self.skip_list)


@register
class MaxPoints(Transform):
    """Subsample (no duplicates) when there are more than `num` points."""

    def __init__(self, num, skip_list=None):
        self.num = num
        self.inner = FixedPointsOwn(num, allow_duplicates=False,
                                    skip_list=skip_list)

    def __call__(self, rng, sample):
        if num_points(sample) > self.num:
            return self.inner(rng, sample)
        return sample


@register
class MinPoints(Transform):
    """Upsample (duplicate) to `num` when fewer are present, from a fixed
    default_rng(42) stream for determinism."""

    def __init__(self, num, skip_list=None):
        self.num = num
        self.inner = FixedPointsOwn(num, allow_duplicates=True,
                                    skip_list=skip_list)

    def __call__(self, rng, sample):
        if num_points(sample) < self.num:
            return self.inner(np.random.default_rng(42), sample)
        return sample


@register
class ZFilter(Transform):
    """Keep points with z_min < z < z_max."""

    def __init__(self, z_min, z_max, skip_keys=()):
        self.z_min, self.z_max = float(z_min), float(z_max)
        self.skip_keys = list(skip_keys or [])

    def __call__(self, rng, sample):
        z = sample["pos"][:, 2]
        return apply_mask(sample, (z > self.z_min) & (z < self.z_max),
                          self.skip_keys)


@register
class Polygon2dExtend(Transform):
    """Keep points inside a fixed 2D polygon (the NFI hexagon plot mask)."""

    def __init__(self, polygon, skip_list=None):
        self.polygon = np.asarray(polygon, dtype=np.float64)
        self.skip_list = list(skip_list or [])

    def __call__(self, rng, sample):
        mask = points_in_polygon(sample["pos"][:, :2], self.polygon)
        return apply_mask(sample, mask, self.skip_list)


@register
class DBSCANZOutlierRemoval(Transform):
    """1D DBSCAN on z; keep the z range covered by non-noise points."""

    def __init__(self, eps=1.0, min_samples=10, skip_list=None):
        self.eps, self.min_samples = eps, min_samples
        self.skip_list = list(skip_list or [])

    def __call__(self, rng, sample):
        z = sample["pos"][:, 2]
        keep = dbscan1d_labels(z, self.eps, self.min_samples) != -1
        if not keep.any():
            return sample
        mask = (z <= z[keep].max()) & (z >= z[keep].min())
        return apply_mask(sample, mask, self.skip_list)


@register
class RandomNoise(Transform):
    """Clipped isotropic gaussian jitter (f32 draws) with prob p."""

    def __init__(self, sigma=0.01, clip=0.05, p=None):
        self.sigma, self.clip = sigma, clip
        self.p = 1.0 if p is None else p

    def __call__(self, rng, sample):
        if rng.random() < self.p:
            noise = np.clip(self.sigma * rng.standard_normal(
                sample["pos"].shape, dtype=np.float32),
                -self.clip, self.clip)
            sample = dict(sample)
            sample["pos"] = (sample["pos"] + noise).astype(np.float32)
        return sample


@register
class Random3AxisRotation(Transform):
    """Random Euler rotation: each axis's angle is drawn with prob p within
    +-rot degrees, the axis matrices composed in a random order."""

    def __init__(self, apply_rotation=True, rot_x=None, rot_y=None,
                 rot_z=None, p=None):
        self.apply_rotation = apply_rotation
        if apply_rotation and rot_x is None and rot_y is None \
                and rot_z is None:
            raise ValueError("At least one rot_ should be defined")
        self.degrees = [abs(min(r, 180)) if r else 0
                        for r in (rot_x, rot_y, rot_z)]
        self.p = 1.0 if p is None else p

    def __call__(self, rng, sample):
        if not self.apply_rotation:
            return sample
        thetas = np.zeros(3)
        for ax, deg in enumerate(self.degrees):
            if deg > 0 and rng.random() < self.p:
                thetas[ax] = np.deg2rad(rng.random() * 2 * deg - deg)
        order = rng.permutation(3)
        m = euler_angles_to_rotation_matrix(thetas, order=tuple(order))
        sample = dict(sample)
        sample["pos"] = (sample["pos"] @ m.T).astype(np.float32)
        if sample.get("norm") is not None:
            sample["norm"] = (sample["norm"] @ m.T).astype(np.float32)
        return sample


@register
class RandomShiftPos(Transform):
    """With prob p, shift all points by one uniform offset in +-max."""

    def __init__(self, max_x=0.01, max_y=0.01, max_z=0.01, p=0.5):
        self.max = np.array([[max_x, max_y, max_z]], dtype=np.float32)
        self.p = p

    def __call__(self, rng, sample):
        if rng.random() < self.p:
            shift = (rng.random((1, 3)).astype(np.float32) * 2 * self.max
                     - self.max)
            sample = dict(sample)
            sample["pos"] = sample["pos"] + shift
        return sample


@register
class RandomDropout(Transform):
    """With prob dropout_application_ratio, keep a (1 - dropout_ratio)
    fraction of the points (only above min_points)."""

    def __init__(self, dropout_ratio=0.2, dropout_application_ratio=0.5,
                 min_points=0, skip_list=None):
        self.dropout_ratio = dropout_ratio
        self.dropout_application_ratio = dropout_application_ratio
        self.min_points = min_points
        self.skip_list = list(skip_list or [])

    def __call__(self, rng, sample):
        n = num_points(sample)
        if n > self.min_points \
                and rng.random() < self.dropout_application_ratio:
            keep = int(n * (1 - self.dropout_ratio))
            return FixedPointsOwn(keep, skip_list=self.skip_list)(rng, sample)
        return sample


@register
class RandomGroundRemoval(Transform):
    """With prob p, drop the points below a uniform threshold in [min_v,
    max_v] and lower z by it; skipped if fewer than min_points survive."""

    def __init__(self, min_v, max_v, p=0.5, min_points=500, skip_list=None):
        self.min_v, self.max_v, self.p = min_v, max_v, p
        self.min_points = min_points
        self.skip_list = list(skip_list or [])

    def __call__(self, rng, sample):
        if rng.random() >= self.p:
            return sample
        remove_v = rng.random() * (self.max_v - self.min_v) + self.min_v
        cond = sample["pos"][:, 2] > remove_v
        if cond.sum() < self.min_points:
            return sample
        pos = sample["pos"].copy()
        pos[:, 2] -= remove_v
        sample = dict(sample)
        sample["pos"] = pos
        return apply_mask(sample, cond, self.skip_list)


def _n_added(rng, n, n_max_points, ratio_min, ratio_max) -> int:
    ratio = rng.random() * (ratio_max - ratio_min) + ratio_min
    n_add = int(ratio * n)
    return n_add + min(0, n_max_points - (n + n_add))


@register
class AddRandomPoints(Transform):
    """With prob p, add ratio*N uniform points inside the cloud's bounding
    box (at most n_max_points in all)."""

    def __init__(self, n_max_points, add_ratio_min, add_ratio_max, p=0.5):
        self.n_max_points = n_max_points
        self.add_ratio_min, self.add_ratio_max = add_ratio_min, add_ratio_max
        self.p = p

    def __call__(self, rng, sample):
        n = num_points(sample)
        if n >= self.n_max_points or rng.random() >= self.p:
            return sample
        n_add = _n_added(rng, n, self.n_max_points, self.add_ratio_min,
                         self.add_ratio_max)
        if n_add <= 0:
            return sample
        pos = sample["pos"]
        lo, hi = pos.min(axis=0), pos.max(axis=0)
        new_pts = (rng.random((n_add, pos.shape[1])).astype(np.float32)
                   * (hi - lo) + lo)
        sample = dict(sample)
        sample["pos"] = np.concatenate([pos, new_pts], axis=0)
        return sample


@register
class CopyJitterRandomPoints(Transform):
    """With prob p, duplicate random points with clipped gaussian jitter,
    copying their `x`/`y` rows unchanged."""

    def __init__(self, n_max_points, add_ratio_min, add_ratio_max, sigma,
                 clip, p=0.5):
        self.n_max_points = n_max_points
        self.add_ratio_min, self.add_ratio_max = add_ratio_min, add_ratio_max
        self.sigma, self.clip, self.p = sigma, clip, p

    def __call__(self, rng, sample):
        n = num_points(sample)
        if n >= self.n_max_points or rng.random() >= self.p:
            return sample
        n_add = _n_added(rng, n, self.n_max_points, self.add_ratio_min,
                         self.add_ratio_max)
        if n_add <= 0:
            return sample
        idx = rng.integers(0, n, size=n_add)
        noise = np.clip(self.sigma * rng.standard_normal((n_add, 3)),
                        -self.clip, self.clip).astype(np.float32)
        out = dict(sample)
        out["pos"] = np.concatenate([sample["pos"],
                                     sample["pos"][idx] + noise], 0)
        for key in ("x", "y"):
            v = sample.get(key)
            if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n:
                out[key] = np.concatenate([v, v[idx]], axis=0)
        return out


@register
class RandomPolygon2dExtend(Transform):
    """Pick one of the polygons, scale and rotate it at random about
    (0.5, 0.5), keep the points inside (when any are)."""

    def __init__(self, polygons, skip_list=None, size_min=1.0, size_max=1.0,
                 rotate=180.0):
        self.polygons = [np.asarray(p, dtype=np.float64) if p != "None"
                         else None for p in polygons]
        self.size_min, self.size_max, self.rotate = size_min, size_max, rotate
        self.skip_list = list(skip_list or [])

    def __call__(self, rng, sample):
        poly = self.polygons[rng.integers(0, len(self.polygons))]
        if poly is None:
            return sample
        scale = rng.random() * (self.size_max - self.size_min) + self.size_min
        trans = (1 - scale) / 2.0
        deg = rng.random() * self.rotate * np.sign(rng.random() - 0.5)
        verts = transform_points2d(
            affine2d(scale=scale, translate=(trans, trans), rotate_deg=deg),
            poly)
        mask = points_in_polygon(sample["pos"][:, :2], verts)
        if mask.sum() > 0:
            sample = apply_mask(sample, mask, self.skip_list)
        return sample
