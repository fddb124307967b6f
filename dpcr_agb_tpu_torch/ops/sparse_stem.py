"""Sparse level 0: the k=7 stem conv evaluated only at occupied voxels
(counterpart of `stem_conv_sparse_batch` in `dpcr_agb_tpu/ops/
sparse_stem.py`).

The rows' features are scattered into a Cin-wide dense volume, which serves
only as gather storage; every site then reads its 7^3 neighbours (empty
cells read zeros, the conv semantics) and multiplies them by the weights.
On CUDA tensors `stem_conv_sites` launches the hand-written `stem_sites`
kernel and its weight gradient the `stem_sites_dw` kernel; on CPU tensors
they run `stem_conv_sites_plain` and `stem_conv_sites_dw_plain`."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .dense_grid import scatter_to_dense

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
    The `stem_sites` kernel on CUDA tensors, the plain version on CPU ones."""
    if vol.is_cuda:
        from .. import kernels
        return kernels.stem_sites(vol, coords, mask, weights, bias)
    return stem_conv_sites_plain(vol, coords, mask, weights, bias)


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
    """`stem_conv_sites` with its weight and bias gradients. The volume is
    data, so it gets no gradient; only vol, coords and mask are saved."""

    @staticmethod
    def forward(ctx, vol, coords, mask, weights, bias):
        ctx.save_for_backward(vol, coords, mask)
        ctx.weights_dtype = weights.dtype
        ctx.bias_dtype = None if bias is None else bias.dtype
        return stem_conv_sites(vol, coords, mask, weights, bias)

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
    SparseConv, minkowski.py), differentiable in weights and bias."""
    vol, _ = scatter_to_dense(coords, mask, feats.to(compute_dtype), dims)
    return _StemConvSites.apply(
        vol, coords.to(torch.int32).contiguous(), mask.contiguous(),
        weights.to(compute_dtype).contiguous(),
        None if bias is None else bias.to(compute_dtype))
