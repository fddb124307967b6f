"""Voxel-grid sampling (counterpart of `GridSampling3D` in
`dpcr_agb_tpu/transforms/grid.py`), in the sparse_xy chain's mode "last":
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
