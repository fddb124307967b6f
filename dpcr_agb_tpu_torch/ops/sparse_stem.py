"""Sparse level 0: the k=7 stem conv evaluated only at occupied voxels
(counterpart of `stem_conv_sparse_batch` in `dpcr_agb_tpu/ops/
sparse_stem.py`).

The rows' features are scattered into a Cin-wide dense volume, which serves
only as gather storage; every site then reads its 7^3 neighbours (empty
cells read zeros, the conv semantics) and multiplies them by the weights.
On CUDA tensors `stem_conv_sites` launches the hand-written `stem_sites`
kernel and its weight gradient the `stem_sites_dw` kernel; on CPU tensors
they run `stem_conv_sites_plain` and `stem_conv_sites_dw_plain`.

Also the level-0 pools that work on the rows without the hand-written
kernels (the reference's DPCR_SPARSE_POOL modes "scattermax" and "rows"):
`scatter_max_pool_batch`, and `pool_neighbor_map_batch` with
`max_pool_sparse`."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops as kernel_ops
from ..parallel import round_after_sum
from ..parallel.rounding import sums_rounded_once
from .dense_grid import scatter_to_dense
from .pool import _pool_parents

K = 7


def _hypercube_offsets(k: int) -> np.ndarray:
    """[k^3, 3] offsets in [0, k), z fastest (the weights' row order)."""
    r = np.arange(k)
    return np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)


def _site_patches(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Each site's 343 neighbours [B*V, 343*Cin], gathered by index
    arithmetic on the zero-padded volume; out-of-volume coords read at the
    clipped site."""
    b, d, h, w, cin = vol.shape
    v = coords.shape[1]
    p = K // 2
    vp = F.pad(vol, (0, 0, p, p, p, p, p, p))
    dp, hp, wp = d + 2 * p, h + 2 * p, w + 2 * p
    lim = torch.tensor([d - 1, h - 1, w - 1], device=coords.device)
    cc = torch.minimum(coords.long().clamp(min=0), lim)
    # padded index of neighbour c + o - p is c + o: the window's corner is c
    base = ((torch.arange(b, device=cc.device)[:, None] * dp + cc[..., 0])
            * hp + cc[..., 1]) * wp + cc[..., 2]
    o = torch.from_numpy(_hypercube_offsets(K)).to(cc.device)
    off = (o[:, 0] * hp + o[:, 1]) * wp + o[:, 2]
    return vp.reshape(-1, cin)[base[..., None] + off].reshape(b * v, -1)


def stem_conv_sites_plain(vol: torch.Tensor, coords: torch.Tensor,
                          mask: torch.Tensor, weights: torch.Tensor,
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of the `stem_sites` kernel: the [B*V, 343*Cin]
    site patches, then one f32 matmul with the reshaped weights. Masked
    rows are 0; the result is cast to vol's dtype before the bias is
    added."""
    b, v = mask.shape
    cout = weights.shape[-1]
    patches = _site_patches(vol, coords)
    y = patches.float() @ weights.reshape(-1, cout).float()
    y = y.reshape(b, v, cout).to(vol.dtype)
    m = mask[..., None]
    y = torch.where(m, y, torch.zeros_like(y))
    if bias is not None:
        y = (y + bias.to(y.dtype)) * m.to(y.dtype)
    return y


def stem_conv_sites(vol: torch.Tensor, coords: torch.Tensor,
                    mask: torch.Tensor, weights: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """vol [B,D,H,W,Cin], coords [B,V,3] int32, mask [B,V] bool, weights
    [343,Cin,Cout], optional bias [Cout] -> [B,V,Cout] in vol's dtype:
    y[b,v] = sum_o vol[b, c_v + o - 3] @ W[o] (+ bias), zero at masked rows.
    The op `dpcr_port::stem_sites`: the `stem_sites` kernel on CUDA
    tensors, the plain version on CPU ones."""
    return kernel_ops.stem_sites(vol, coords, mask, weights, bias)


def stem_conv_sites_dw_plain(vol: torch.Tensor, coords: torch.Tensor,
                             mask: torch.Tensor, ct: torch.Tensor
                             ) -> torch.Tensor:
    """Plain PyTorch version of the `stem_sites_dw` kernel: the site
    patches of `stem_conv_sites_plain`, transposed and multiplied by the
    masked cotangent rows, in f32 -> dW [343, Cin, Cout] float32."""
    cin, cout = vol.shape[-1], ct.shape[-1]
    ctm = torch.where(mask[..., None], ct, torch.zeros_like(ct))
    dw = _site_patches(vol, coords).float().t() @ ctm.reshape(-1, cout).float()
    return dw.reshape(K ** 3, cin, cout)


def stem_conv_sites_dw(vol: torch.Tensor, coords: torch.Tensor,
                       mask: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """dW [343,Cin,Cout] float32 of `stem_conv_sites` for the cotangent rows
    ct [B,V,Cout]: sum over the masked-in sites of patch x ct. The
    `stem_sites_dw` kernel on CUDA tensors, the plain version on CPU
    ones."""
    if vol.is_cuda:
        from .. import kernels
        return kernels.stem_sites_dw(vol, coords, mask, ct)
    return stem_conv_sites_dw_plain(vol, coords, mask, ct)


class _StemConvSites(torch.autograd.Function):
    """`stem_conv_sites` with its weight and bias gradients, each returned
    in the dtype the weights and bias came in: given in vol's dtype, dW
    (f32 from the kernel) and db are rounded to it here; given in f32 (cast
    to vol's dtype inside), they stay the f32 partials. The volume is
    data, so it gets no gradient; only vol, coords and mask are saved."""

    @staticmethod
    def forward(ctx, vol, coords, mask, weights, bias):
        ctx.save_for_backward(vol, coords, mask)
        ctx.weights_dtype = weights.dtype
        ctx.bias_dtype = None if bias is None else bias.dtype
        return stem_conv_sites(
            vol, coords, mask, weights.to(vol.dtype).contiguous(),
            None if bias is None else bias.to(vol.dtype))

    @staticmethod
    def backward(ctx, ct):
        vol, coords, mask = ctx.saved_tensors
        ct = ct.contiguous()
        dw = db = None
        if ctx.needs_input_grad[3]:
            dw = stem_conv_sites_dw(vol, coords, mask, ct).to(
                ctx.weights_dtype)
        if ctx.bias_dtype is not None and ctx.needs_input_grad[4]:
            db = torch.where(mask[..., None], ct.float(), 0.0).sum((0, 1))
            db = db.to(ctx.bias_dtype)
        return None, None, None, dw, db


def stem_conv_rows(coords: torch.Tensor, mask: torch.Tensor,
                   feats: torch.Tensor, dims: Sequence[int],
                   weights: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   compute_dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """Rows [B,V,Cin] -> stem rows [B,V,Cout] in compute_dtype: the scatter
    into the Cin-wide volume, then `stem_conv_sites` (the sites mode of
    SparseConv, minkowski.py), differentiable in weights and bias. Under a
    process group in bf16 their gradients are the f32 partials, rounded
    once after the SUM."""
    vol, _ = scatter_to_dense(coords, mask, feats.to(compute_dtype), dims)
    if sums_rounded_once(compute_dtype):
        round_after_sum(compute_dtype, weights, bias)
        dt = weights.dtype
    else:
        dt = compute_dtype
    return _StemConvSites.apply(
        vol, coords.to(torch.int32).contiguous(), mask.contiguous(),
        weights.to(dt).contiguous(), None if bias is None else bias.to(dt))


def scatter_max_pool_batch(coords: torch.Tensor, mask: torch.Tensor,
                           h_rows: torch.Tensor, dims: Sequence[int]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minkowski MaxPool (kernel 3, stride 2) as one scatter-max of the
    level-0 rows [B,V,C] into the level-1 volume: each row goes to its 1..8
    parent cells (`pool._pool_parents`), and an indicator scattered only to
    the all-lower parent (x // 2) marks the occupied outputs. Returns
    (pooled [B,d1,h1,w1,C], zero at unoccupied outputs, occupancy
    [B,d1,h1,w1,1]). Autograd splits a window's cotangent evenly among its
    maximizers (`scatter_reduce`'s amax rule, as JAX's scatter-max)."""
    d, h, w = (int(n) for n in dims)
    d1, h1, w1 = -(-d // 2), -(-h // 2), -(-w // 2)
    b, v = mask.shape
    c = h_rows.shape[-1]
    s1 = d1 * h1 * w1
    flat, valid = _pool_parents(coords, mask, dims)
    flat = torch.where(valid, flat, torch.full_like(flat, b * s1))  # dump row
    stride_one = torch.zeros((b, v, 8, 1), dtype=h_rows.dtype,
                             device=h_rows.device)
    stride_one[:, :, 0, 0] = valid[..., 0].to(h_rows.dtype)
    payload = torch.cat([h_rows[:, :, None, :].expand(b, v, 8, c),
                         stride_one], -1)
    neg = torch.full((), float("-inf"), dtype=h_rows.dtype,
                     device=h_rows.device)
    payload = torch.where(valid[..., None], payload, neg)
    table = torch.full((b * s1 + 1, c + 1), float("-inf"),
                       dtype=h_rows.dtype, device=h_rows.device)
    table = table.scatter_reduce(
        0, flat.reshape(-1, 1).expand(-1, c + 1),
        payload.reshape(b * v * 8, c + 1), "amax", include_self=True)
    dense = table[: b * s1].reshape(b, d1, h1, w1, c + 1)
    occ = (dense[..., -1:] > 0).to(h_rows.dtype).detach()
    pooled = torch.where(occ > 0, dense[..., :c],
                         torch.zeros_like(dense[..., :c]))
    return pooled, occ


def pool_neighbor_map_batch(coords0: torch.Tensor, mask0: torch.Tensor,
                            coords1: torch.Tensor, mask1: torch.Tensor,
                            dims: Sequence[int]) -> torch.Tensor:
    """[B,V1,27] local row indices into each sample's level-0 rows for the
    MaxPool window {2u-1, 2u, 2u+1}^3 of every level-1 site u (z-fastest
    offsets); V0 marks a missing neighbour. Built from a dense volume of
    row indices padded by one cell; out-of-volume level-0 rows enter no
    window, and masked level-1 sites get the shadow only."""
    d, h, w = (int(n) for n in dims)
    b, v0 = mask0.shape
    lim = torch.tensor([d, h, w], device=coords0.device)
    c0 = coords0.long()
    m0 = mask0 & ((c0 >= 0) & (c0 < lim)).all(-1)
    cc = torch.minimum(c0.clamp(min=0), lim - 1) + 1          # padded index
    dp, hp, wp = d + 2, h + 2, w + 2
    sp = dp * hp * wp
    gidx = (cc[..., 0] * hp + cc[..., 1]) * wp + cc[..., 2] \
        + (torch.arange(b, device=cc.device) * sp)[:, None]
    gidx = torch.where(m0, gidx, torch.full_like(gidx, b * sp))
    row_of = torch.full((b * sp + 1,), v0, dtype=torch.long,
                        device=cc.device)
    row_of[gidx.reshape(-1)] = torch.arange(v0, device=cc.device).repeat(b)
    row_of[b * sp] = v0
    c1 = torch.minimum((coords1.long() * 2).clamp(min=0), lim - 1)
    base = (c1[..., 0] * hp + c1[..., 1]) * wp + c1[..., 2] \
        + (torch.arange(b, device=cc.device) * sp)[:, None]  # window corner
    o = torch.from_numpy(_hypercube_offsets(3)).to(cc.device)
    off = (o[:, 0] * hp + o[:, 1]) * wp + o[:, 2]
    nbr = row_of[base[..., None] + off]
    return torch.where(mask1[..., None], nbr, torch.full_like(nbr, v0))


def max_pool_sparse(h_rows: torch.Tensor, nbr: torch.Tensor,
                    mask1: torch.Tensor) -> torch.Tensor:
    """Masked max over gathered level-0 rows: h_rows [B,V,C], nbr
    [B,V1,27] local indices (V = shadow) -> [B,V1,C]; the shadow counts as
    -inf, and sites with no real neighbour or masked out give 0. Autograd
    splits a tie evenly (`amax`, as jnp.max)."""
    b, v, c = h_rows.shape
    padded = torch.cat([h_rows, h_rows.new_full((b, 1, c), float("-inf"))], 1)
    idx = nbr + (torch.arange(b, device=nbr.device) * (v + 1))[:, None, None]
    g = padded.reshape(b * (v + 1), c)[idx]                 # [B,V1,27,C]
    out = g.amax(2)
    ok = ((nbr < v).any(-1) & mask1)[..., None]
    return torch.where(ok, out, torch.zeros_like(out))
