"""Sort-based voxel grids for the KPConv pyramid (counterpart of
`pack_keys`, `build_grid` and `downsample(mode="mean")` in
`dpcr_agb_tpu/ops/voxel.py`), batched over a leading axis.

Coordinates are packed into one sortable int32 key; a coarser level is the
set of unique keys of a stable sort, and a level's features are pooled into
it by segment (here: the mean, which makes the voxel barycentres of
`neighbors.grid_subsample`; taken without atomics, so that a cloud always
gives the same barycentres). The kernel maps, lookups and the max/sum
pooling of the sparse-voxel nets' map mode are not ported yet."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

COORD_BITS = 10
COORD_OFFSET = 1 << (COORD_BITS - 1)          # 512
SENTINEL_KEY = 1 << (3 * COORD_BITS)          # sorts after all valid keys


def pack_keys(coords: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """coords [...,3] int32 (clipped to |c| < 512) + valid [...] ->
    sortable int32 keys, the sentinel where not valid."""
    c = torch.clamp(coords, -COORD_OFFSET, COORD_OFFSET - 1) + COORD_OFFSET
    key = (c[..., 0] << (2 * COORD_BITS)) | (c[..., 1] << COORD_BITS) \
        | c[..., 2]
    return torch.where(valid, key, torch.full_like(key, SENTINEL_KEY))


class VoxelGrid(NamedTuple):
    """One resolution level of a batch."""
    coords: torch.Tensor       # [B, V, 3] int32 (unit coords at this level)
    mask: torch.Tensor         # [B, V] bool
    keys_sorted: torch.Tensor  # [B, V] int32 ascending (sentinels last)
    order: torch.Tensor        # [B, V]: keys_sorted[i] = key(coords[order[i]])


def build_grid(coords: torch.Tensor, mask: torch.Tensor) -> VoxelGrid:
    keys = pack_keys(coords, mask)
    keys_sorted, order = torch.sort(keys, dim=-1, stable=True)
    return VoxelGrid(coords=coords, mask=mask, keys_sorted=keys_sorted,
                     order=order)


def downsample(grid: VoxelGrid, feats: Optional[torch.Tensor], stride: int,
               v_out: int, mode: str = "unique"
               ) -> Tuple[VoxelGrid, Optional[torch.Tensor]]:
    """Coarsen to the stride lattice: out coords = unique(floor(in/stride))
    in key order; mode 'mean' also pools feats [B,V,C] by output voxel. If
    the unique count exceeds v_out, the largest keys are dropped."""
    if mode not in ("unique", "mean"):
        raise NotImplementedError(f"downsample mode {mode!r} is left for a "
                                  "later slice of the port (ported: unique, "
                                  "mean)")
    b = grid.coords.shape[0]
    dev = grid.coords.device
    down = torch.div(grid.coords, stride, rounding_mode="floor")
    keys = pack_keys(down, grid.mask)
    skeys, order = torch.sort(keys, dim=-1, stable=True)
    sdown = torch.gather(down, 1, order[..., None].expand(-1, -1, 3))
    valid_sorted = skeys != SENTINEL_KEY
    prev = torch.cat([torch.full_like(skeys[:, :1], -1), skeys[:, :-1]], 1)
    is_first = (skeys != prev) & valid_sorted
    seg = torch.cumsum(is_first.to(torch.int64), dim=1) - 1      # [B,V]
    n_unique = is_first.sum(1)

    # slot v_out takes what is dropped
    out_coords = torch.zeros((b, v_out + 1, 3), dtype=torch.int32, device=dev)
    scatter_idx = torch.where(is_first & (seg < v_out), seg,
                              torch.full_like(seg, v_out))
    out_coords.scatter_(1, scatter_idx[..., None].expand(-1, -1, 3), sdown)
    out_coords = out_coords[:, :v_out]
    out_mask = torch.arange(v_out, device=dev)[None, :] \
        < torch.clamp(n_unique, max=v_out)[:, None]

    out_feats = None
    if feats is not None and mode == "mean":
        # Segment means without atomics, so that the same cloud always gives
        # the same barycentres (a float scatter_add_ on CUDA adds in a
        # varying order, and a barycentre that moves by one rounding can
        # move a neighbour across a search radius). The members of a voxel
        # are consecutive after the sort, so its sum is a difference of two
        # prefix sums, taken in f64, where it is exact to f32 rounding.
        c = feats.shape[-1]
        sfeats = torch.gather(feats, 1, order[..., None].expand(-1, -1, c))
        prefix = torch.cumsum(torch.where(
            valid_sorted[..., None], sfeats, 0.0).double(), dim=1)
        prefix = torch.cat([prefix.new_zeros((b, 1, c)), prefix], dim=1)
        pos = torch.arange(skeys.shape[1], device=dev).expand(b, -1)
        # where the kept voxels end: at the first dropped one, else at the
        # last valid row; empty output slots start and end there
        end = torch.where(is_first & (seg == v_out), pos,
                          valid_sorted.sum(1, keepdim=True)
                          ).amin(1, keepdim=True)
        # start[s]: the first sorted row of output voxel s (each written
        # once; everything else writes `end` into slot v_out)
        start = end.repeat(1, v_out + 1)
        start.scatter_(1, scatter_idx,
                       torch.where(scatter_idx < v_out, pos, end))
        gather_c = start[..., None].expand(-1, -1, c)
        total = torch.gather(prefix, 1, gather_c[:, 1:]) \
            - torch.gather(prefix, 1, gather_c[:, :-1])
        cnt = (start[:, 1:] - start[:, :-1])[..., None]
        out_feats = (total / torch.clamp(cnt, min=1)).to(feats.dtype)
    return build_grid(out_coords, out_mask), out_feats
