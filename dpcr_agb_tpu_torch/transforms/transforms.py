"""Point-cloud transforms of the NFI pre_transform and the deterministic
sparse_xy test chain (counterparts in `dpcr_agb_tpu/transforms/
transforms.py`)."""
from __future__ import annotations

import math

import numpy as np

from .core import Transform, apply_index, apply_mask, num_points, register
from .geometry import dbscan1d_labels, points_in_polygon


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
