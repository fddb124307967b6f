"""Dense-grid execution of sparse-voxel convolutions (counterpart of
`dpcr_agb_tpu/ops/dense_grid.py`).

Voxel features are scattered into a bounded [B,D,H,W,C] volume with an
occupancy volume [B,D,H,W,1]; a conv is `F.conv3d` followed by a multiply
with the output occupancy, which is exactly Minkowski convolution semantics:
  * stride 1: out[u] = sum_o W[o] x[u+o] at occupied sites, zeros elsewhere
  * stride 2: output sites are cells with >= 1 occupied child, values from
    the k^3 window around 2u (pad k//2)

Public functions keep the JAX layout (channels last, (D,H,W) = (x,y,z),
kernels [K^3,Cin,Cout] with z-fastest offsets) and permute to NCDHW only
around `conv3d`: a contiguous NDHWC tensor viewed as NCDHW has
channels_last_3d strides, so the permutes copy nothing on the card."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def scatter_to_dense(coords: torch.Tensor, mask: torch.Tensor,
                     feats: torch.Tensor, dims: Sequence[int],
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B,V,3] + [B,V] + [B,V,C] -> dense [B,D,H,W,C] + occupancy
    [B,D,H,W,1], both in feats' dtype. Masked and out-of-volume rows are
    dropped; duplicate valid coords sum."""
    d, h, w = (int(v) for v in dims)
    b, v = mask.shape
    s = d * h * w
    lim = torch.tensor([d, h, w], dtype=coords.dtype, device=coords.device)
    valid = mask & ((coords >= 0) & (coords < lim)).all(-1)
    c = torch.minimum(coords.clamp(min=0), lim - 1).long()
    flat = (c[..., 0] * h + c[..., 1]) * w + c[..., 2]
    flat = flat + (torch.arange(b, device=flat.device) * s)[:, None]
    flat = torch.where(valid, flat, torch.full_like(flat, b * s)).reshape(-1)
    payload = torch.where(valid[..., None], feats, torch.zeros_like(feats))
    table = torch.zeros((b * s + 1, feats.shape[-1]), dtype=feats.dtype,
                        device=feats.device)
    table.index_add_(0, flat, payload.reshape(b * v, -1))
    otab = torch.zeros((b * s + 1,), dtype=feats.dtype, device=feats.device)
    otab.index_add_(0, flat, valid.reshape(-1).to(feats.dtype))
    return (table[: b * s].reshape(b, d, h, w, -1),
            otab[: b * s].reshape(b, d, h, w, 1))


def occupancy_pool(occ: torch.Tensor) -> torch.Tensor:
    """Next-level occupancy [B,ceil(D/2),ceil(H/2),ceil(W/2),1]: a cell is
    occupied iff any of its 2^3 children is. Occupancy is >= 0, so padding
    odd extents with 0 equals the reference's -inf padding + max(., 0)."""
    b, d, h, w, c = occ.shape
    d1, h1, w1 = -(-d // 2), -(-h // 2), -(-w // 2)
    p = F.pad(occ, (0, 0, 0, 2 * w1 - w, 0, 2 * h1 - h, 0, 2 * d1 - d))
    p = p.reshape(b, d1, 2, h1, 2, w1, 2, c)
    return torch.amax(p, dim=(2, 4, 6)).clamp(min=0)


def conv_weight(weights: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[K^3,Cin,Cout] (z-fastest offsets) -> conv3d's [Cout,Cin,k,k,k]."""
    kvol, cin, cout = weights.shape
    k = round(kvol ** (1.0 / 3.0))
    return weights.reshape(k, k, k, cin, cout).permute(4, 3, 0, 1, 2).to(
        dtype)


def dense_conv(x: torch.Tensor, occ_out: torch.Tensor, weights: torch.Tensor,
               kernel_size: int, stride: int = 1,
               compute_dtype: torch.dtype = torch.float32,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B,D,H,W,Cin]; weights [K^3,Cin,Cout]; pad k//2 (so a stride-2 k3
    conv gives ceil(n/2) and a k1 conv pads nothing). Returns
    [B,D',H',W',Cout] in compute_dtype, (conv + bias) * occ_out."""
    w5 = conv_weight(weights, compute_dtype)
    b5 = None if bias is None else bias.to(compute_dtype)
    y = F.conv3d(x.to(compute_dtype).permute(0, 4, 1, 2, 3), w5, b5,
                 stride=stride, padding=kernel_size // 2)
    y = y.permute(0, 2, 3, 4, 1)
    return y * occ_out.to(y.dtype)


def level_dims(dims: Sequence[int], level: int) -> Tuple[int, int, int]:
    """Grid dims shrink by ceil-halving per level (stride 2, pad 1)."""
    d, h, w = dims
    for _ in range(level):
        d, h, w = -(-d // 2), -(-h // 2), -(-w // 2)
    return d, h, w
