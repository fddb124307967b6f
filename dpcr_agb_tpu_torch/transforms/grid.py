"""Voxel-grid sampling and the voxel augmentations of the sparse_xy train
chain (counterparts in `dpcr_agb_tpu/transforms/grid.py`). GridSampling3D
runs in the sparse_xy chain's mode "last":
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
