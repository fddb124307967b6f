"""Point-cloud transforms (counterparts in
`dpcr_agb_tpu/transforms/transforms.py`): the NFI pre_transform, the
sparse_xy chains, centering, scaling and mirroring, crops and samplers,
and the z-outlier and density filters. Each random transform draws from
the explicit `rng` in the same order and with the same numpy calls as its
JAX counterpart, so both give the same sample from one seed. The three
that the JAX package hands to scikit-learn (OPTICS, KernelDensity,
KDTree) run on numpy copies in `geometry.py`."""
from __future__ import annotations

import math

import numpy as np

from .core import Transform, apply_index, apply_mask, num_points, register
from .geometry import (affine2d, dbscan1d_labels,
                       euler_angles_to_rotation_matrix,
                       gaussian_kde_log_density, optics_dbscan_noise,
                       points_in_polygon, radius_counts, transform_points2d)


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


@register
class FixedPointsOwn(Transform):
    """Sample exactly `num` points: with `replace`, `num` uniform draws;
    else without replacement (minimal duplication when fewer and
    `allow_duplicates`)."""

    def __init__(self, num, replace=False, allow_duplicates=True,
                 skip_list=None):
        self.num = num
        self.replace = replace
        self.allow_duplicates = allow_duplicates
        self.skip_list = list(skip_list or [])

    def __call__(self, rng, sample):
        n = num_points(sample)
        if self.replace:
            idx = rng.integers(0, n, size=self.num)
        elif self.allow_duplicates:
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


def _no_skeleton(add_skeleton_pts) -> None:
    """The polygon transforms take the skeleton keywords, and raise as the
    JAX classes do when skeleton points are asked for."""
    if add_skeleton_pts:
        raise NotImplementedError("skeleton points unused by NFI presets")


@register
class Polygon2dExtend(Transform):
    """Keep points inside a fixed 2D polygon (the NFI hexagon plot mask).
    The skeleton keywords are accepted; add_skeleton_pts=True raises."""

    def __init__(self, polygon, skip_list=None, add_skeleton_pts=False,
                 num_skeleton_pts=100, height_skeleton_pts=1.0,
                 cage_skeleton=False):
        _no_skeleton(add_skeleton_pts)
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
                 rotate=180.0, add_skeleton_pts=False, num_skeleton_pts=100,
                 height_skeleton_pts=1.0, cage_skeleton=False):
        _no_skeleton(add_skeleton_pts)
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


def _mean_center(pos):
    return pos.mean(axis=0, keepdims=True)


def _quantile_center(pos):
    return (np.quantile(pos, 0.99, axis=0, keepdims=True)
            + np.quantile(pos, 0.01, axis=0, keepdims=True)) / 2.0


def _maxmin_center(pos):
    return (pos.max(axis=0, keepdims=True)
            + pos.min(axis=0, keepdims=True)) / 2.0


@register
class CenterPosPerSample(Transform):
    """Subtract a center (mean, quantile or maxmin) on the selected axes."""

    _AGGS = {"mean": _mean_center, "quantile": _quantile_center,
             "maxmin": _maxmin_center}

    def __init__(self, center_x=True, center_y=True, center_z=False,
                 center="mean"):
        self.mask = np.array([[center_x, center_y, center_z]],
                             dtype=np.float32)
        if center not in self._AGGS:
            raise ValueError(f"Unknown center function: {center}")
        self.agg = self._AGGS[center]

    def __call__(self, rng, sample):
        if not self.mask.any():
            return sample
        sample = dict(sample)
        sample["pos"] = sample["pos"] - (
            self.agg(sample["pos"]) * self.mask).astype(np.float32)
        return sample


@register
class FixedCenterPosPerSample(Transform):
    """Move the maxmin center to (center_x, center_y, center_z)."""

    def __init__(self, center_x=0.5, center_y=0.5, center_z=0.5):
        self.center = np.array([[center_x, center_y, center_z]],
                               dtype=np.float32)

    def __call__(self, rng, sample):
        pos = sample["pos"]
        pos = pos - _maxmin_center(pos) + self.center
        sample = dict(sample)
        sample["pos"] = pos.astype(np.float32)
        return sample


@register
class CenterXYbyZ(Transform):
    """Center xy on the maxmin midpoint of the points whose z lies in
    (z_thresh_min, z_thresh_max); records that band's xy extent
    (`pos_deviation`) and point count (`pos_center_points`), which
    `RadiusObjectAdder` reads."""

    def __init__(self, center_x=0.0, center_y=0.0, z_thresh_min=0.0,
                 z_thresh_max=1.0):
        self.z_min, self.z_max = z_thresh_min, z_thresh_max
        self.center = np.array([[center_x, center_y]], dtype=np.float32)

    def __call__(self, rng, sample):
        pos = sample["pos"].copy()
        zsel = (self.z_min < pos[:, 2]) & (pos[:, 2] < self.z_max)
        xy = pos[:, :2]
        amax = xy[zsel].max(axis=0, keepdims=True)
        amin = xy[zsel].min(axis=0, keepdims=True)
        pos[:, :2] = xy - (amax + amin) / 2.0 + self.center
        sample = dict(sample)
        sample["pos"] = pos
        sample["pos_deviation"] = (amax - amin).astype(np.float32)
        sample["pos_center_points"] = np.int64(zsel.sum())
        return sample


@register
class RandomScaling(Transform):
    """Scale each axis by a uniform factor in [scales[0], scales[1]]
    (normals, when present, follow and are renormalised)."""

    def __init__(self, scales=None):
        if scales is None or len(scales) != 2 or scales[0] > scales[1]:
            raise ValueError(f"scales must be [a, b] with a <= b: {scales}")
        self.scales = scales

    def __call__(self, rng, sample):
        scale = (self.scales[0] + rng.random(3).astype(np.float32)
                 * (self.scales[1] - self.scales[0]))
        sample = dict(sample)
        sample["pos"] = sample["pos"] * scale
        if sample.get("norm") is not None:
            norm = sample["norm"] / scale
            sample["norm"] = norm / np.linalg.norm(norm, axis=1,
                                                   keepdims=True)
        return sample


@register
class RandomSymmetry(Transform):
    """Mirror each enabled axis about its max with probability 0.5."""

    def __init__(self, axis=(False, False, False)):
        self.axis = list(axis)

    def __call__(self, rng, sample):
        pos = sample["pos"]
        for i, ax in enumerate(self.axis):
            if ax and rng.random() < 0.5:
                pos = pos.copy()
                pos[:, i] = pos[:, i].max() - pos[:, i]
        sample = dict(sample)
        sample["pos"] = pos
        return sample


@register
class RandomTranslation(Transform):
    """One uniform translation in [delta_min, delta_max] per axis."""

    def __init__(self, delta_max=(1.0, 1.0, 1.0),
                 delta_min=(-1.0, -1.0, -1.0)):
        self.delta_max = np.asarray(delta_max, dtype=np.float32)
        self.delta_min = np.asarray(delta_min, dtype=np.float32)

    def __call__(self, rng, sample):
        trans = rng.random(3).astype(np.float32) * (
            self.delta_max - self.delta_min) + self.delta_min
        sample = dict(sample)
        sample["pos"] = sample["pos"] + trans
        return sample


@register
class AddGround(Transform):
    """When the cloud has fewer than max_points, REPLACE it by n_points
    ground points (z 0, xy uniform in [xy_min, xy_min + (xy_max -
    xy_min) / 2))."""

    def __init__(self, max_points, n_points, xy_min=0.0, xy_max=1.0):
        self.max_points, self.n_points = max_points, n_points
        self.xy_min, self.xy_range = xy_min, (xy_max - xy_min) / 2.0

    def __call__(self, rng, sample):
        if num_points(sample) < self.max_points:
            pos = rng.random((self.n_points, 3)).astype(np.float32) \
                * self.xy_range + self.xy_min
            pos[:, 2] = 0.0
            sample = dict(sample)
            sample["pos"] = pos
        return sample


@register
class CylinderExtend(Transform):
    """Keep the points within an xy radius of the origin."""

    def __init__(self, radius, skip_list=None):
        self.radius = radius
        self.skip_list = list(skip_list or [])

    def __call__(self, rng, sample):
        xy = sample["pos"][:, :2]
        mask = (xy ** 2).sum(axis=1) <= self.radius ** 2
        return apply_mask(sample, mask, self.skip_list)


@register
class RectangleExtend(Transform):
    """Keep the points inside the centered box |x| < e_x, |y| < e_y,
    |z| < e_z (the y bound on y: the reference tests x twice)."""

    def __init__(self, e_x=1.0, e_y=1.0, e_z=1.0):
        self.e = np.array([e_x, e_y, e_z], dtype=np.float32)

    def __call__(self, rng, sample):
        pos = sample["pos"]
        mask = np.all((pos < self.e) & (pos > -self.e), axis=1)
        return apply_mask(sample, mask)


@register
class EllipsoidCrop(Transform):
    """Keep an ellipsoid (semi-axes a, b, c) around a random point of the
    randomly rotated cloud."""

    def __init__(self, a=1.0, b=1.0, c=1.0, rot_x=180, rot_y=180, rot_z=180):
        self.abc2 = np.array([a, b, c], dtype=np.float64) ** 2
        self.rotation = Random3AxisRotation(rot_x=rot_x, rot_y=rot_y,
                                            rot_z=rot_z)

    def __call__(self, rng, sample):
        i = rng.integers(0, num_points(sample))
        rotated = self.rotation(rng, dict(sample))
        centered = rotated["pos"] - rotated["pos"][i]
        mask = ((centered ** 2) / self.abc2).sum(axis=1) < 1
        return apply_mask(sample, mask)


@register
class CubeCrop(Transform):
    """Keep the points inside a randomly rotated cube of half-size c
    centered on a random voxel (of side grid_size_center) of the cloud."""

    def __init__(self, c=1.0, rot_x=180, rot_y=180, rot_z=180,
                 grid_size_center=0.01):
        self.c = c
        self.rotation = Random3AxisRotation(rot_x=rot_x, rot_y=rot_y,
                                            rot_z=rot_z)
        self.grid_size_center = grid_size_center

    def __call__(self, rng, sample):
        coords = np.round(sample["pos"] / self.grid_size_center)
        uniq = np.unique(coords, axis=0)
        center = uniq[rng.integers(0, len(uniq))] * self.grid_size_center
        moved = dict(sample)
        moved["pos"] = sample["pos"] - center
        moved = self.rotation(rng, moved)
        pos = moved["pos"] + center
        mask = np.all((pos - (center - self.c) > 0)
                      & ((center + self.c) - pos > 0), axis=1)
        return apply_mask(sample, mask)


@register
class IrregularSampling(Transform):
    """Soft crop around the first point of a random occupied cell (side
    grid_size_center): a point is kept with probability
    exp(-|p - center|_p^p / (2 sigma^2)), sigma^2 = d_half^p / (2 ln 2)."""

    def __init__(self, d_half=2.5, p=2, grid_size_center=0.1, skip_keys=()):
        self.d_half, self.p = d_half, p
        self.grid_size = grid_size_center
        self.skip_keys = list(skip_keys or [])

    def __call__(self, rng, sample):
        pos = sample["pos"]
        cells = np.floor(pos / self.grid_size).astype(np.int64)
        _, first = np.unique(cells, axis=0, return_index=True)
        center = pos[first[rng.integers(0, len(first))]]
        d_p = (np.abs(pos - center) ** self.p).sum(1)
        sigma_2 = (self.d_half ** self.p) / (2 * np.log(2))
        thresh = np.exp(-d_p / (2 * sigma_2))
        mask = rng.random(len(pos)) < thresh
        return apply_mask(sample, mask, self.skip_keys)


@register
class PeriodicSampling(Transform):
    """Keep the points whose distance to a random center falls in the
    `prop` share of each `period`."""

    def __init__(self, period=0.1, prop=0.1, box_multiplier=1, skip_keys=()):
        self.pulse = 2 * np.pi / period
        self.thresh = np.cos(self.pulse * prop * period * 0.5)
        self.box_multiplier = box_multiplier
        self.skip_keys = list(skip_keys or [])

    def __call__(self, rng, sample):
        pos = sample["pos"]
        max_p, min_p = pos.max(0), pos.min(0)
        center = self.box_multiplier * rng.random(3).astype(np.float32) \
            * (max_p - min_p) + min_p
        d_p = np.linalg.norm(pos - center, axis=1)
        mask = np.cos(self.pulse * d_p) > self.thresh
        return apply_mask(sample, mask, self.skip_keys)


@register
class StatZOutlierRemoval(Transform):
    """Drop the points whose z-score reaches the threshold."""

    def __init__(self, threshold=4.0, skip_list=None):
        self.threshold = threshold
        self.skip_list = list(skip_list or [])

    def __call__(self, rng, sample):
        z = sample["pos"][:, 2]
        out = np.abs((z - z.mean()) / z.std())
        return apply_mask(sample, out < self.threshold, self.skip_list)


def _keep_z_range(sample, z, keep, skip_list):
    """Keep the points whose z lies in the range of the kept ones (all of
    them when none is kept)."""
    if not keep.any():
        return sample
    mask = (z <= z[keep].max()) & (z >= z[keep].min())
    return apply_mask(sample, mask, skip_list)


@register
class OPTICSZOutlierRemoval(Transform):
    """OPTICS (its DBSCAN extraction at eps) on z: keep the z range of the
    points it does not call noise. scikit-learn's labels, computed by
    `geometry.optics_dbscan_noise`."""

    def __init__(self, eps=1.0, min_samples=10, skip_list=None):
        self.eps, self.min_samples = eps, min_samples
        self.skip_list = list(skip_list or [])

    def __call__(self, rng, sample):
        z = sample["pos"][:, 2]
        keep = ~optics_dbscan_noise(z, self.eps, self.min_samples)
        return _keep_z_range(sample, z, keep, self.skip_list)


@register
class KernelDensityZOutlierRemoval(Transform):
    """Gaussian KDE on z: keep the z range of the points whose log
    density exceeds log(p). Only the lowest and the highest such point
    matter, so the scores are computed from each end inwards, 512 points
    at a time, until one passes (`geometry.gaussian_kde_log_density`,
    scikit-learn's score)."""

    _CHUNK = 512

    def __init__(self, bandwidth=1.0, p=0.05, skip_list=None):
        self.bandwidth, self.p = bandwidth, p
        self.skip_list = list(skip_list or [])

    def _first_kept(self, zs, idx):
        for s in range(0, len(idx), self._CHUNK):
            ii = idx[s:s + self._CHUNK]
            score = gaussian_kde_log_density(zs, zs[ii], self.bandwidth)
            hit = np.flatnonzero(score > np.log(self.p))
            if len(hit):
                return ii[hit[0]]
        return None

    def __call__(self, rng, sample):
        zf = sample["pos"][:, 2].astype(np.float64)
        zs = np.sort(zf)
        n = len(zs)
        lo = self._first_kept(zs, np.arange(n))
        if lo is None:
            return sample
        hi = self._first_kept(zs, np.arange(n - 1, -1, -1))
        mask = (zf <= zs[hi]) & (zf >= zs[lo])
        return apply_mask(sample, mask, self.skip_list)


@register
class DensityFilter(Transform):
    """Keep the points with more than min_num other points within
    radius_nn (`geometry.radius_counts`: scikit-learn's KDTree count,
    inclusive, in float64)."""

    def __init__(self, radius_nn: float = 0.04, min_num: int = 6,
                 skip_keys=()):
        self.radius_nn, self.min_num = radius_nn, min_num
        self.skip_keys = list(skip_keys or [])

    def __call__(self, rng, sample):
        counts = radius_counts(sample["pos"], self.radius_nn)
        return apply_mask(sample, (counts - 1) > self.min_num,
                          self.skip_keys)
