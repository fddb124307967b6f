"""Neighbourhood ops on the batch's device (counterpart of
`radius_neighbors`, `grid_subsample` and `fps` in `dpcr_agb_tpu/ops/
neighbors.py`), batched over a leading axis: the KPConv pyramid's search
and subsampling, PointNeXt's ball query and farthest point sampling.

  * `radius_neighbors`: brute-force squared distances as a matrix product
    (|q|^2 + |s|^2 - 2 q.s), over query tiles of 1024 so that the [Nq, Ns]
    matrix is never whole; the k nearest within the radius, ascending by
    distance, padded with the shadow index Ns. The distance formula is the
    JAX package's, so that the same neighbours are cropped near the radius
    (`torch.cdist` rounds differently); on CUDA it needs TF32 off for
    matmul, which is PyTorch's default and is checked here.
  * `grid_subsample`: voxel-barycentre downsampling (mean position per
    cell) on the sort and segment machinery of `voxel.py`.

  * `fps`: farthest point sampling, the `fps` kernel on CUDA tensors
    (`kernels/csrc/fps.cu`) and `fps_plain` on CPU ones.

`torch.topk` and `jax.lax.top_k` may order exact distance ties differently;
clouds without exact ties give the same lists."""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import ops as kernel_ops
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


def fps_plain(pos: torch.Tensor, mask: torch.Tensor, n_samples: int,
              start: int = 0) -> torch.Tensor:
    """Farthest point sampling, the JAX package's loop batched: pos
    [B,N,3] f32, mask [B,N] bool -> [B,n_samples] int64 indices. The
    running distance starts at +inf on valid rows and -inf on masked ones;
    idx[0] = start; each step takes d = (dx*dx + dy*dy) + dz*dz to the last
    pick (separate elementwise ops: no fused multiply-add, no reduction
    kernel's order), -inf on masked rows, the running minimum, and picks
    its argmax (the first maximal index). A sample with fewer valid rows
    than n_samples repeats valid indices once every valid distance is 0;
    an all-masked one gives index 0 throughout."""
    b = pos.shape[0]
    ninf = torch.full((), float("-inf"), dtype=pos.dtype, device=pos.device)
    dists = torch.where(mask, float("inf"), ninf)
    idx = torch.zeros((b, n_samples), dtype=torch.int64, device=pos.device)
    idx[:, 0] = start
    px, py, pz = (pos[..., a].contiguous() for a in range(3))
    rows = torch.arange(b, device=pos.device)
    last = idx[:, 0]
    for i in range(1, n_samples):
        lp = pos[rows, last]                                      # [B,3]
        dx = px - lp[:, 0:1]
        dy = py - lp[:, 1:2]
        dz = pz - lp[:, 2:3]
        d = (dx * dx + dy * dy) + dz * dz
        dists = torch.minimum(dists, torch.where(mask, d, ninf))
        last = torch.argmax(dists, dim=1)
        idx[:, i] = last
    return idx


def fps(pos: torch.Tensor, mask: torch.Tensor, n_samples: int,
        start: int = 0) -> torch.Tensor:
    """`fps_plain`'s function, the op `dpcr_port::fps`: the `fps` kernel on
    CUDA tensors (it raises for a shape it cannot take), the plain version
    on CPU ones."""
    return kernel_ops.fps(pos.contiguous(), mask.contiguous(), n_samples,
                          start)
