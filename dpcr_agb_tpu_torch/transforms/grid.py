"""Voxel-grid sampling, the voxel augmentations of the sparse_xy train
chain, `SaveOriginalPosId` and `ElasticDistortion` (counterparts in
`dpcr_agb_tpu/transforms/grid.py`). GridSampling3D runs in the sparse_xy
chain's mode "last":
  * coords = round(pos / size)
  * shuffle all per-point arrays, then keep the last point of each voxel (a
    uniform random representative)
  * quantize_coords stores int32 voxel coords in sample['coords']
The reference's mode "mean" is not used by the ported chains."""
from __future__ import annotations

import numpy as np

from .core import Transform, num_points, register, shuffle_sample, \
    unique_int_rows


@register
class GridSampling3D(Transform):
    def __init__(self, size, quantize_coords=False, mode="mean"):
        if mode != "last":
            raise NotImplementedError(
                f"GridSampling3D mode {mode!r} is not ported (ported: last)")
        self.size = size
        self.quantize_coords = quantize_coords

    def __call__(self, rng, sample):
        sample = shuffle_sample(rng, sample)
        n = num_points(sample)
        coords = np.round(sample["pos"] / self.size)
        uniq, inverse = unique_int_rows(coords)
        last_indices = np.zeros(len(uniq), dtype=np.int64)
        last_indices[inverse] = np.arange(len(inverse))
        out = {k: (v[last_indices] if isinstance(v, np.ndarray)
                   and v.ndim >= 1 and v.shape[0] == n else v)
               for k, v in sample.items()}
        if self.quantize_coords:
            out["coords"] = coords[last_indices].astype(np.int32)
        out["grid_size"] = np.array([self.size], dtype=np.float32)
        return out


@register
class RandomCoordsFlip(Transform):
    """Flip the voxel coords about their max on each non-ignored axis with
    prob p."""

    def __init__(self, ignored_axis, is_temporal=False, p=0.95):
        if not 0 <= p <= 1:
            raise ValueError(f"p={p} is not a probability")
        ignored = [{"x": 0, "y": 1, "z": 2}[a] for a in ignored_axis]
        self.flip_axes = sorted(set(range(4 if is_temporal else 3))
                                - set(ignored))
        self.p = p

    def __call__(self, rng, sample):
        coords = sample["coords"]
        for ax in self.flip_axes:
            if rng.random() < self.p:
                coords = coords.copy()
                coords[:, ax] = coords[:, ax].max() - coords[:, ax]
        sample = dict(sample)
        sample["coords"] = coords
        return sample


@register
class ShiftVoxels(Transform):
    """With prob p, add one random integer offset in [0, 100) to the voxel
    coords."""

    def __init__(self, apply_shift=True, p=0.5):
        self.apply_shift = apply_shift
        self.p = p

    def __call__(self, rng, sample):
        if self.apply_shift and rng.random() < self.p:
            if "coords" not in sample:
                raise ValueError("should quantize first using GridSampling3D")
            coords = sample["coords"]
            if not np.issubdtype(coords.dtype, np.integer):
                raise TypeError("coords are expected to be integer voxel "
                                "coords")
            shift = (rng.random(3) * 100).astype(coords.dtype)
            sample = dict(sample)
            sample["coords"] = coords.copy()
            sample["coords"][:, :3] += shift
        return sample


@register
class SaveOriginalPosId(Transform):
    """origin_id = arange(N), once (a sample that has it keeps it)."""

    KEY = "origin_id"

    def __call__(self, rng, sample):
        if self.KEY in sample:
            return sample
        sample = dict(sample)
        sample[self.KEY] = np.arange(num_points(sample), dtype=np.int64)
        return sample


def _blur3(a: np.ndarray, axis: int) -> np.ndarray:
    """scipy.ndimage.convolve(a, ones(3) / 3 along `axis`, mode="constant")
    for float32 a: each output ((0 + w a[i-1]) + w a[i]) + w a[i+1] in
    float64 (w = 1/3, 0 outside), rounded to float32."""
    w = 1.0 / 3.0
    pad = [(0, 0)] * a.ndim
    pad[axis] = (1, 1)
    p = np.pad(a.astype(np.float64), pad)
    n = a.shape[axis]
    take = [slice(None)] * a.ndim
    out = None
    for k in range(3):
        take[axis] = slice(k, k + n)
        term = w * p[tuple(take)]
        out = term if out is None else out + term
    return out.astype(np.float32)


def _map_coordinates_linear(grid: np.ndarray, coords: np.ndarray
                            ) -> np.ndarray:
    """scipy.ndimage.map_coordinates(grid, coords, order=1) for a float32
    3-D grid and coordinates [3, N] inside it: the 8 corners in C order,
    each value times its three weights (axis 0 first) in float64, summed
    in that order, rounded to float32. A corner past the last cell has
    weight 0 (read at the last cell)."""
    c = coords.astype(np.float64)
    base = np.floor(c)
    frac = c - base
    base = base.astype(np.int64)
    wts = (1.0 - frac, frac)
    t = np.zeros(c.shape[1])
    for a in (0, 1):
        for b in (0, 1):
            for d in (0, 1):
                ix = np.minimum(base[0] + a, grid.shape[0] - 1)
                iy = np.minimum(base[1] + b, grid.shape[1] - 1)
                iz = np.minimum(base[2] + d, grid.shape[2] - 1)
                v = grid[ix, iy, iz].astype(np.float64)
                t = t + v * wts[a][0] * wts[b][1] * wts[d][2]
    return t.astype(np.float32)


@register
class ElasticDistortion(Transform):
    """With probability p, for each (granularity, magnitude): a gaussian
    noise grid of cells of that size, blurred twice along each axis by a
    3-tap box, sampled trilinearly at the points and added to pos times
    the magnitude."""

    def __init__(self, apply_distorsion=True, granularity=(0.2, 0.8),
                 magnitude=(0.4, 1.6), p=0.5):
        self.apply_distorsion = apply_distorsion
        self.granularity = list(granularity)
        self.magnitude = list(magnitude)
        self.p = p

    @staticmethod
    def _distort(rng, pos, granularity, magnitude):
        coords_min = pos.min(axis=0)
        dims = ((pos.max(axis=0) - coords_min) // granularity).astype(int) + 3
        noise = rng.standard_normal((*dims, 3)).astype(np.float32)
        for _ in range(2):
            for axis in range(3):
                noise = np.stack([_blur3(noise[..., c], axis)
                                  for c in range(3)], axis=-1)
        sample_coords = (pos - coords_min) / granularity + 1
        disp = np.stack([
            _map_coordinates_linear(noise[..., c], sample_coords.T)
            for c in range(3)], axis=-1)
        return (pos + disp * magnitude).astype(np.float32)

    def __call__(self, rng, sample):
        if self.apply_distorsion and rng.random() < self.p:
            pos = sample["pos"]
            for g, m in zip(self.granularity, self.magnitude):
                pos = self._distort(rng, pos, g, m)
            sample = dict(sample)
            sample["pos"] = pos
        return sample
