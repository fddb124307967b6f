"""Fixed-shape batch assembly (counterpart of `dpcr_agb_tpu/data/batch.py`).

A `Batch` holds statically shaped padded numpy arrays after `collate`;
`Batch.to(device)` turns them into torch tensors on one device:
  * sparse voxel clouds: coords [B,V,3] int32 (PAD_COORD at padding),
    x [B,V,C] f32, mask [B,V] bool
  * per-sample: y_reg [B,T] (NaN = missing), y_reg_mask, area_idx, ...
Voxel counts are padded to a bucket ladder so shapes repeat across batches.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

PAD_COORD = np.int32(-(2 ** 20))  # impossible voxel coordinate


@dataclasses.dataclass
class Batch:
    pos: Any                      # [B, N, 3] f32
    x: Any                        # [B, N, C] f32
    mask: Any                     # [B, N] bool
    y_reg: Any                    # [B, T] f32 (NaN = missing)
    y_reg_mask: Any               # [B, T] bool
    area_idx: Any                 # [B] i32
    label_idx: Any                # [B] i64
    is_double: Any                # [B] bool
    valid: Any = None             # [B] bool (False = batch-padding sample)
    coords: Any = None            # [B, N, 3] i32 (sparse models only)
    stats: Any = None             # [B, S] f32
    aux: Any = None               # model arrays (z tag, KPConv pyramid)
    ready: Any = None             # CUDA event: the copy to the card is done

    @property
    def batch_size(self) -> int:
        return self.pos.shape[0]

    @property
    def num_points(self) -> int:
        return self.pos.shape[1]

    def to(self, device) -> "Batch":
        """Every array field as a torch tensor on `device` (aux included)."""
        def conv(v):
            if v is None:
                return None
            if isinstance(v, dict):
                return {k: conv(a) for k, a in v.items()}
            if isinstance(v, torch.Tensor):
                return v.to(device)
            return torch.from_numpy(np.ascontiguousarray(v)).to(device)
        return Batch(**{f.name: getattr(self, f.name) if f.name == "ready"
                        else conv(getattr(self, f.name))
                        for f in dataclasses.fields(self)})


def device_put(batch: Batch, device: torch.device,
               stream: "torch.cuda.Stream") -> Batch:
    """The batch's arrays as tensors on `device`. On a CUDA device they are
    copied from pinned host memory on `stream` (a stream of the caller's,
    e.g. a loader's), and `ready` holds an event recorded after the
    copies: `wait_ready` makes the consuming stream wait on it before the
    batch is read. On the CPU this is `batch.to(device)`."""
    if device.type != "cuda":
        return batch.to(device)

    def conv(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: conv(a) for k, a in v.items()}
        host = v if isinstance(v, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(v))
        return host.pin_memory().to(device, non_blocking=True)

    with torch.cuda.stream(stream):
        moved = {f.name: conv(getattr(batch, f.name))
                 for f in dataclasses.fields(batch) if f.name != "ready"}
        ready = torch.cuda.Event()
        ready.record(stream)
    return Batch(**moved, ready=ready)


def wait_ready(batch: Batch) -> Batch:
    """Make the current CUDA stream wait for a `device_put` batch's copies,
    and mark its tensors as used on that stream (so the caching allocator
    does not hand their memory to the copy stream while the step still
    reads them). A batch without an event is returned as it is."""
    if batch.ready is None:
        return batch
    current = torch.cuda.current_stream(batch.mask.device)
    current.wait_event(batch.ready)

    def mark(v):
        if isinstance(v, dict):
            for a in v.values():
                mark(a)
        elif isinstance(v, torch.Tensor):
            v.record_stream(current)
    for f in dataclasses.fields(batch):
        if f.name != "ready":
            mark(getattr(batch, f.name))
    return dataclasses.replace(batch, ready=None)


def bucket_size(n: int, buckets: Optional[Sequence[int]] = None,
                minimum: int = 256) -> int:
    """Smallest bucket >= n; default buckets are powers of two."""
    if buckets:
        for b in sorted(buckets):
            if n <= b:
                return int(b)
        return int(max(buckets))
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class CollateSpec:
    """Policy for batch assembly, derived from the model's conv_type."""
    conv_type: str = "dense"              # dense | sparse
    num_points: Optional[int] = None      # fixed N (dense presets) or None
    buckets: Optional[Sequence[int]] = None
    min_bucket: int = 512
    use_coords: bool = False


def collate(samples: List[dict], spec: CollateSpec,
            pad_to_batch: Optional[int] = None,
            n_valid: Optional[int] = None) -> Batch:
    """Pad a list of transformed sample dicts into one fixed-shape Batch.
    pad_to_batch > len(samples) repeats the first sample into padding rows
    marked valid=False with all-False y_reg_mask."""
    n_real = len(samples) if n_valid is None else n_valid
    if pad_to_batch is not None and pad_to_batch > len(samples):
        samples = list(samples) + [samples[0]] * (pad_to_batch - len(samples))
    bs = len(samples)
    counts = [s["pos"].shape[0] for s in samples]
    if spec.num_points is not None:
        n_pad = spec.num_points
        if max(counts) > n_pad:
            raise ValueError(f"sample with {max(counts)} points exceeds fixed "
                             f"num_points={n_pad}")
    else:
        n_pad = bucket_size(max(counts), spec.buckets, spec.min_bucket)

    c_dim = next((int(s["x"].shape[-1]) for s in samples
                  if s.get("x") is not None), 0)
    t_dim = next((int(np.atleast_1d(s["y_reg"]).shape[-1]) for s in samples
                  if s.get("y_reg") is not None), 0)

    pos = np.zeros((bs, n_pad, 3), dtype=np.float32)
    x = np.zeros((bs, n_pad, c_dim), dtype=np.float32)
    mask = np.zeros((bs, n_pad), dtype=bool)
    y_reg = np.full((bs, t_dim), np.nan, dtype=np.float32)
    y_reg_mask = np.zeros((bs, t_dim), dtype=bool)
    area_idx = np.zeros(bs, dtype=np.int32)
    label_idx = np.zeros(bs, dtype=np.int64)
    is_double = np.zeros(bs, dtype=bool)
    coords = None
    if spec.use_coords:
        coords = np.full((bs, n_pad, 3), PAD_COORD, dtype=np.int32)
    stats = None
    if samples[0].get("stats") is not None:
        stats = np.zeros((bs, len(np.atleast_1d(samples[0]["stats"]))),
                         dtype=np.float32)

    for i, s in enumerate(samples):
        n = counts[i]
        pos[i, :n] = s["pos"]
        mask[i, :n] = True
        if c_dim and s.get("x") is not None:
            x[i, :n] = s["x"]
        if t_dim and s.get("y_reg") is not None:
            y_reg[i] = np.atleast_1d(s["y_reg"])
            if s.get("y_reg_mask") is not None:
                y_reg_mask[i] = np.atleast_1d(s["y_reg_mask"])
            else:
                y_reg_mask[i] = ~np.isnan(y_reg[i])
        area_idx[i] = int(s.get("area_idx", 0))
        label_idx[i] = int(s.get("label_idx", i))
        is_double[i] = bool(s.get("is_double", False))
        if coords is not None:
            if "coords" not in s:
                raise ValueError("sparse collate requires quantized 'coords' "
                                 "(add GridSampling3D(quantize_coords=True))")
            coords[i, :n] = s["coords"]
        if stats is not None and s.get("stats") is not None:
            stats[i] = np.atleast_1d(s["stats"])

    valid = np.zeros(bs, dtype=bool)
    valid[:n_real] = True
    y_reg_mask[n_real:] = False  # padding samples never contribute to loss
    return Batch(pos=pos, x=x, mask=mask, y_reg=y_reg, y_reg_mask=y_reg_mask,
                 area_idx=area_idx, label_idx=label_idx, is_double=is_double,
                 valid=valid, coords=coords, stats=stats)


def normalize_sparse_rows(batch: Batch, dims: Sequence[int]) -> Batch:
    """Drop out-of-volume voxels, then sort each sample's valid rows by flat
    grid key (x-major, z-minor) with all padding compacted to the tail.
    Duplicate voxels within a sample are an upstream error and raise."""
    pos = np.asarray(batch.pos)
    x = np.asarray(batch.x)
    mask = np.asarray(batch.mask)
    coords = np.asarray(batch.coords)
    d, h, w = (int(v) for v in dims)
    c = coords.astype(np.int64)
    in_b = ((c >= 0) & (c < np.array([d, h, w], np.int64))).all(-1)
    ok = mask & in_b
    key = (c[..., 0] * h + c[..., 1]) * w + c[..., 2]
    key = np.where(ok, key, np.iinfo(np.int64).max)
    order = np.argsort(key, axis=1, kind="stable")
    skey = np.take_along_axis(key, order, axis=1)
    mask2 = np.take_along_axis(ok, order, axis=1)
    if bool(((skey[:, 1:] == skey[:, :-1]) & mask2[:, 1:]).any()):
        raise ValueError(
            "duplicate voxel coords within a sample — upstream voxelization "
            "must produce unique rows (GridSampling3D quantize_coords)")
    coords2 = np.take_along_axis(coords, order[..., None], axis=1)
    coords2[~mask2] = PAD_COORD
    return dataclasses.replace(
        batch,
        pos=np.take_along_axis(pos, order[..., None], axis=1),
        x=np.take_along_axis(x, order[..., None], axis=1),
        mask=mask2, coords=coords2)
