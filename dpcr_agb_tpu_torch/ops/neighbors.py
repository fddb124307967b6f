"""Neighbourhood ops of the KPConv pyramid on the batch's device (counterpart
of `radius_neighbors` and `grid_subsample` in `dpcr_agb_tpu/ops/
neighbors.py`), batched over a leading axis. Farthest point sampling waits
for PointNeXt.

  * `radius_neighbors`: brute-force squared distances as a matrix product
    (|q|^2 + |s|^2 - 2 q.s), over query tiles of 1024 so that the [Nq, Ns]
    matrix is never whole; the k nearest within the radius, ascending by
    distance, padded with the shadow index Ns. The distance formula is the
    JAX package's, so that the same neighbours are cropped near the radius
    (`torch.cdist` rounds differently); on CUDA it needs TF32 off for
    matmul, which is PyTorch's default and is checked here.
  * `grid_subsample`: voxel-barycentre downsampling (mean position per
    cell) on the sort and segment machinery of `voxel.py`.

`torch.topk` and `jax.lax.top_k` may order exact distance ties differently;
clouds without exact ties give the same lists."""
from __future__ import annotations

from typing import Tuple

import torch

from .voxel import build_grid, downsample

_FAR = 1e8


def radius_neighbors(q_pts: torch.Tensor, q_mask: torch.Tensor,
                     s_pts: torch.Tensor, s_mask: torch.Tensor,
                     radius: float, k: int, tile: int = 1024) -> torch.Tensor:
    """q_pts [B,Nq,3], q_mask [B,Nq], s_pts [B,Ns,3], s_mask [B,Ns] ->
    [B,Nq,k] int32 indices of the k nearest supports within `radius` of
    each query, ascending by distance; Ns (the shadow) where fewer are in
    range and at masked-out queries."""
    if q_pts.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("radius_neighbors needs full-f32 matmul: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    nq, ns = q_pts.shape[1], s_pts.shape[1]
    kk = min(k, ns)
    # |s|^2 with the penalty of a masked-out support folded in (adding 0 to
    # a valid one changes nothing; a masked-out one lands ~1e8 away either
    # way and is never in range)
    s_key = torch.sum(torch.square(s_pts), dim=-1) \
        + torch.where(s_mask, 0.0, _FAR).to(s_pts.dtype)         # [B,Ns]
    s_t = s_pts.transpose(1, 2)                                   # [B,3,Ns]
    r2 = radius * radius
    out = torch.empty((q_pts.shape[0], nq, k), dtype=torch.int32,
                      device=q_pts.device)
    for start in range(0, nq, tile):
        q_tile = q_pts[:, start:start + tile]
        # (|q|^2 + |s|^2) - 2 q.s in two passes over the tile: the doubling
        # is exact, so `sub(alpha=2)` rounds as the three-pass form does
        d2 = torch.sum(torch.square(q_tile), -1, keepdim=True) \
            + s_key[:, None, :]
        d2 = torch.sub(d2, torch.matmul(q_tile, s_t), alpha=2.0, out=d2)
        dist, idx = torch.topk(d2, kk, dim=-1, largest=False, sorted=True)
        out[:, start:start + tile, :kk] = torch.where(dist < r2, idx, ns)
    if k > ns:
        out[:, :, kk:] = ns
    return torch.where(q_mask[..., None], out, ns)


def grid_subsample(pos: torch.Tensor, mask: torch.Tensor, dl: float,
                   n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxel-barycentre subsample: cell = floor(pos/dl), output = mean of the
    member positions, in cell-key order. pos [B,N,3], mask [B,N] ->
    (pos_out [B,n_out,3] f32, mask_out [B,n_out]); invalid rows are parked
    far away so that later radius searches never hit them."""
    coords = torch.floor(pos / dl).to(torch.int32)
    out_grid, bary = downsample(build_grid(coords, mask), pos, 1, n_out,
                                mode="mean")
    bary = torch.where(out_grid.mask[..., None], bary, _FAR)
    return bary, out_grid.mask
