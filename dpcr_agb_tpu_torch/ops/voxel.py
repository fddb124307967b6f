"""Sort-based voxel grids (counterpart of `dpcr_agb_tpu/ops/voxel.py`),
batched over a leading axis: the KPConv pyramid's subsampling and the
sparse-voxel nets' map mode.

Coordinates are packed into one sortable int32 key; a coarser level is the
set of unique keys of a stable sort, and a level's features are pooled into
it by segment (here: the mean, which makes the voxel barycentres of
`neighbors.grid_subsample`; taken without atomics, so that a cloud always
gives the same barycentres).

Map mode works as MinkowskiEngine does: a kernel map [K, V_out] names, for
each kernel offset and output voxel, the input row that the offset reaches
(binary search of the probe key in the sorted keys), or the shadow row
V_in where there is none; a convolution gathers the rows of each offset
and accumulates their products with the offset's [Cin, Cout] weights in
f32. A batch keeps one shadow row per sample: the rows of sample b sit at
b·(V_in + 1) of the flattened input, so one gather serves the batch."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel.rounding import cast_widened, sums_rounded_once

COORD_BITS = 10
COORD_OFFSET = 1 << (COORD_BITS - 1)          # 512
SENTINEL_KEY = 1 << (3 * COORD_BITS)          # sorts after all valid keys


def hypercube_offsets(kernel_size: int, dimension: int = 3) -> np.ndarray:
    """[K, 3] int32 offsets in MinkowskiEngine's region order, z fastest;
    for an odd kernel size the cube is centred ([-(k//2), k//2] a side).
    This order fixes the [K, Cin, Cout] layout of every conv kernel."""
    if kernel_size % 2 == 1:
        r = np.arange(-(kernel_size // 2), kernel_size // 2 + 1)
    else:
        r = np.arange(0, kernel_size)
    grids = np.meshgrid(*([r] * dimension), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=1).astype(np.int32)


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
    in key order; modes 'mean', 'sum' and 'max' also pool feats [B,V,C] by
    output voxel ('max' zeroes the unoccupied outputs). If the unique
    count exceeds v_out, the largest keys are dropped, and so are their
    contributions."""
    if mode not in ("unique", "mean", "sum", "max"):
        raise ValueError(f"downsample mode {mode!r}: unique, mean, sum or "
                         "max")
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
    if feats is not None and mode == "max":
        # the maximum is the same in any order: a scatter-max into a
        # -inf fill, slot v_out taking the dropped rows
        c = feats.shape[-1]
        sfeats = torch.gather(feats, 1, order[..., None].expand(-1, -1, c))
        contrib = torch.where(valid_sorted & (seg < v_out), seg,
                              torch.full_like(seg, v_out))
        vals = torch.where(valid_sorted[..., None], sfeats,
                           torch.full_like(sfeats, float("-inf")))
        out = torch.full((b, v_out + 1, c), float("-inf"), dtype=feats.dtype,
                         device=dev)
        out.scatter_reduce_(1, contrib[..., None].expand(-1, -1, c), vals,
                            reduce="amax", include_self=True)
        out_feats = torch.where(out_mask[..., None], out[:, :v_out],
                                torch.zeros_like(out[:, :v_out]))
    elif feats is not None and mode in ("mean", "sum"):
        # Segment sums without atomics, so that the same cloud always gives
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
        out_feats = (total / torch.clamp(cnt, min=1) if mode == "mean"
                     else total).to(feats.dtype)
    return build_grid(out_coords, out_mask), out_feats


def lookup(grid: VoxelGrid, probe_coords: torch.Tensor,
           probe_valid: torch.Tensor) -> torch.Tensor:
    """Rows of grid.coords at the probe coords [B, ..., 3] (int32), V (the
    shadow) where there is none or the probe is not valid. Probes are
    clipped to the key range as the keys are."""
    b, v = grid.keys_sorted.shape
    pk = pack_keys(probe_coords, probe_valid)
    flat = pk.reshape(b, -1)
    pos = torch.searchsorted(grid.keys_sorted.contiguous(), flat.contiguous())
    pos_c = torch.clamp(pos, max=v - 1)
    found = (torch.gather(grid.keys_sorted, 1, pos_c) == flat) \
        & (flat != SENTINEL_KEY)
    rows = torch.gather(grid.order, 1, pos_c).to(torch.int32)
    return torch.where(found, rows, torch.full_like(rows, v)) \
        .reshape(pk.shape)


def kernel_map(in_grid: VoxelGrid, out_grid: VoxelGrid,
               offsets: np.ndarray, stride: int) -> torch.Tensor:
    """[B, K, V_out] int32 rows of the input level (V_in = shadow): output
    voxel u covers the input voxels at stride·u + offset."""
    offs = torch.as_tensor(offsets, dtype=torch.int32,
                           device=out_grid.coords.device)
    base = out_grid.coords * stride                          # [B, V_out, 3]
    probe = base[:, None, :, :] + offs[None, :, None, :]     # [B,K,V_out,3]
    return lookup(in_grid, probe, out_grid.mask[:, None, :].expand(
        -1, offs.shape[0], -1))


def _flat_rows(feats: torch.Tensor, fill: float) -> torch.Tensor:
    """feats [B, V, C] -> [B·(V+1), C]: each sample's rows, then its
    shadow row of `fill`."""
    b, v, c = feats.shape
    shadow = feats.new_full((b, 1, c), fill)
    return torch.cat([feats, shadow], dim=1).reshape(b * (v + 1), c)


def _flat_index(nbr_idx: torch.Tensor, v_in: int) -> torch.Tensor:
    """Kernel maps [B, K, V_out] -> rows of `_flat_rows` (int32)."""
    b = nbr_idx.shape[0]
    base = torch.arange(b, device=nbr_idx.device, dtype=torch.int32) \
        * (v_in + 1)
    return nbr_idx.to(torch.int32) + base[:, None, None]


def sparse_conv_apply(feats: torch.Tensor, nbr_idx: torch.Tensor,
                      weights: torch.Tensor,
                      offset_chunk: Optional[int] = None,
                      target_cols: int = 256) -> torch.Tensor:
    """Gather, matmul, accumulate: feats [B, V_in, Cin], nbr_idx
    [B, K, V_out] (V_in = shadow, a zero row), weights [K, Cin, Cout] ->
    [B, V_out, Cout] f32.

    The offsets go in chunks of ~target_cols gathered columns, so the
    gathered rows never exceed [B·V_out, chunk·Cin]; each chunk's product
    is taken and summed in f32 (bf16 rows and weights are widened first,
    exactly), as the JAX function's preferred_element_type=f32 does."""
    b, v_in, cin = feats.shape
    k, v_out = nbr_idx.shape[1], nbr_idx.shape[2]
    cout = weights.shape[-1]
    if offset_chunk is None:
        offset_chunk = max(1, target_cols // max(cin, 1))
    chunk = max(1, min(offset_chunk, k))
    widened = sums_rounded_once(feats.dtype)
    if widened:
        # under a process group the weights' gradient stays the f32
        # partial, rounded once after the SUM
        weights = cast_widened(weights, feats.dtype)
    rows = _flat_rows(feats, 0.0)
    # [B·V_out, K]: each output row's K input rows, side by side
    idx = _flat_index(nbr_idx, v_in).permute(0, 2, 1).reshape(b * v_out, k)
    acc = None
    for k0 in range(0, k, chunk):
        k1 = min(k0 + chunk, k)
        g = rows[idx[:, k0:k1]].reshape(b * v_out, (k1 - k0) * cin)
        w = weights[k0:k1].reshape((k1 - k0) * cin, cout)
        part = g.float() @ (w if widened else w.to(feats.dtype).float())
        acc = part if acc is None else acc + part
    return acc.reshape(b, v_out, cout)


def max_pool_apply(feats: torch.Tensor, nbr_idx: torch.Tensor,
                   out_mask: torch.Tensor) -> torch.Tensor:
    """Masked max pool over the kernel map's rows: feats [B, V_in, C],
    nbr_idx [B, K, V_out] -> [B, V_out, C]. The shadow gives -inf; an
    output voxel with no input row, or masked out, is 0. The gradient of
    a tie is split evenly over its rows (amax), as jnp.max's is."""
    b, v_in, c = feats.shape
    g = _flat_rows(feats, float("-inf"))[_flat_index(nbr_idx, v_in)]
    out = torch.amax(g, dim=1)                           # [B, V_out, C]
    keep = (nbr_idx < v_in).any(dim=1) & out_mask
    return torch.where(keep[..., None], out, torch.zeros_like(out))
