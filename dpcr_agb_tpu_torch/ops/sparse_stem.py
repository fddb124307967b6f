"""Sparse level 0: the k=7 stem conv evaluated only at occupied voxels
(counterpart of `stem_conv_sparse_batch` in `dpcr_agb_tpu/ops/
sparse_stem.py`).

The rows' features are scattered into a Cin-wide dense volume, which serves
only as gather storage; every site then reads its 7^3 neighbours (empty
cells read zeros, the conv semantics) and multiplies them by the weights.
On CUDA tensors `stem_conv_sites` launches the hand-written `stem_sites`
kernel; on CPU tensors it runs `stem_conv_sites_plain`."""
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


def stem_conv_sites_plain(vol: torch.Tensor, coords: torch.Tensor,
                          mask: torch.Tensor, weights: torch.Tensor,
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of the `stem_sites` kernel: gather each site's
    343 neighbours into [B*V, 343*Cin] patches by index arithmetic on the
    zero-padded volume, then one f32 matmul with the reshaped weights.
    Out-of-volume coords read at the clipped site; masked rows are 0; the
    result is cast to vol's dtype before the bias is added."""
    b, d, h, w, cin = vol.shape
    v = coords.shape[1]
    cout = weights.shape[-1]
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
    patches = vp.reshape(-1, cin)[base[..., None] + off]     # [B,V,343,Cin]
    y = patches.reshape(b * v, -1).float() @ weights.reshape(-1, cout).float()
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


def stem_conv_rows(coords: torch.Tensor, mask: torch.Tensor,
                   feats: torch.Tensor, dims: Sequence[int],
                   weights: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   compute_dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """Rows [B,V,Cin] -> stem rows [B,V,Cout] in compute_dtype: the scatter
    into the Cin-wide volume, then `stem_conv_sites` (the sites mode of
    SparseConv, minkowski.py)."""
    vol, _ = scatter_to_dense(coords, mask, feats.to(compute_dtype), dims)
    return stem_conv_sites(vol, coords.to(torch.int32).contiguous(),
                           mask.contiguous(), weights.to(compute_dtype)
                           .contiguous(),
                           None if bias is None else bias.to(compute_dtype))
