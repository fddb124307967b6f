"""The masked Minkowski MaxPool (kernel 3, stride 2) of the stem rows, forward
and backward (counterpart of `pallas_max_pool` in `dpcr_agb_tpu/ops/
pallas_pool.py` and of `pooled_rows_fused` in `dpcr_agb_tpu/ops/
sparse_stem.py`).

Output cell u is the max over the inputs {2u-1, 2u, 2u+1}^3 with empty or
out-of-range inputs excluded (-inf), zeroed where the pooled occupancy is 0
(no occupied child in {2u, 2u+1}^3). The backward routes the cotangent of
each occupied output cell to every input that equals its max (ties get
the full cotangent each), in row space: each row gathers its 1..8 parent
cells. On CUDA tensors `masked_max_pool` and `masked_max_pool_bwd_rows`
launch the hand-written `max_pool_k3s2` and `max_pool_k3s2_bwd` kernels;
on CPU tensors they run their plain versions."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .dense_grid import occupancy_pool, scatter_to_dense


def masked_max_pool_plain(x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the `max_pool_k3s2` kernel: fill empty cells
    with -inf, pad by one cell (and to an even extent) with -inf, take the
    max of the 27 stride-2 slices, then zero where occupancy_pool(occ) is
    0, as pallas_max_pool does."""
    b, d, h, w, c = x.shape
    d1, h1, w1 = -(-d // 2), -(-h // 2), -(-w // 2)
    neg = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
    filled = torch.where(occ > 0, x, neg)
    fp = F.pad(filled, (0, 0, 1, 2 * w1 - w, 1, 2 * h1 - h, 1, 2 * d1 - d),
               value=float("-inf"))
    y = None
    for a in range(3):
        for e in range(3):
            for f in range(3):
                s = fp[:, a:a + 2 * d1 - 1:2, e:e + 2 * h1 - 1:2,
                       f:f + 2 * w1 - 1:2]
                y = s if y is None else torch.maximum(y, s)
    return torch.where(occupancy_pool(occ) > 0, y, torch.zeros_like(y))


def masked_max_pool(x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """x [B,D,H,W,C], occupancy occ [B,D,H,W,1] of x's dtype ->
    [B,ceil(D/2),ceil(H/2),ceil(W/2),C]. The `max_pool_k3s2` kernel on CUDA
    tensors, the plain version on CPU ones."""
    if x.is_cuda:
        from .. import kernels
        return kernels.max_pool_k3s2(x, occ)
    return masked_max_pool_plain(x, occ)


def _pool_parents(coords: torch.Tensor, mask: torch.Tensor,
                  dims: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each level-0 row's level-1 parents: u_d in {x_d//2, (x_d+1)//2} per
    axis, 8 slots (bit a of the slot picks the upper parent on axis a),
    duplicates and out-of-range parents invalid. Returns (flat [B,V,8]
    indices into the batch-flattened level-1 grid, valid [B,V,8]); masked
    and out-of-volume rows have no valid slot."""
    d, h, w = (int(n) for n in dims)
    ext1 = torch.tensor([-(-d // 2), -(-h // 2), -(-w // 2)],
                        device=coords.device)
    lim = torch.tensor([d, h, w], device=coords.device)
    c = coords.long()
    mask = mask & ((c >= 0) & (c < lim)).all(-1)
    cc = torch.minimum(c.clamp(min=0), lim - 1)
    lo, hi = cc // 2, (cc + 1) // 2
    flats, valids = [], []
    for bits in range(8):
        up = torch.tensor([(bits >> a) & 1 for a in range(3)],
                          dtype=torch.bool, device=coords.device)
        u = torch.where(up, hi, lo)
        dup = (up & (hi == lo)).any(-1)
        valids.append(mask & (u < ext1).all(-1) & ~dup)
        flats.append((u[..., 0] * ext1[1] + u[..., 1]) * ext1[2] + u[..., 2])
    b = mask.shape[0]
    s1 = int(ext1.prod())
    flat = torch.stack(flats, -1) + (torch.arange(b, device=c.device)
                                     * s1)[:, None, None]
    valid = torch.stack(valids, -1)
    return torch.where(valid, flat, torch.zeros_like(flat)), valid


def masked_max_pool_bwd_rows_plain(coords: torch.Tensor, mask: torch.Tensor,
                                   h_rows: torch.Tensor, y: torch.Tensor,
                                   occ_l: torch.Tensor, ct: torch.Tensor,
                                   dims: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of the `max_pool_k3s2_bwd` kernel, written out
    (not autograd of `masked_max_pool_plain`, whose `torch.maximum` splits
    ties): for each row and channel, the f32 sum, in slot order, of the
    occ_l-masked cotangent of every valid parent whose y equals the row's
    value; cast to h_rows' dtype, zero at masked rows."""
    c = h_rows.shape[-1]
    flat, valid = _pool_parents(coords, mask, dims)
    ctm = torch.where(occ_l > 0, ct, torch.zeros_like(ct)).reshape(-1, c)
    yt = y.reshape(-1, c)
    dx = torch.zeros(h_rows.shape, dtype=torch.float32, device=h_rows.device)
    for s in range(8):
        eq = (yt[flat[..., s]] == h_rows) & valid[..., s, None]
        dx = dx + torch.where(eq, ctm[flat[..., s]].float(), 0.0)
    return torch.where(mask[..., None], dx, 0.0).to(h_rows.dtype)


def masked_max_pool_bwd_rows(coords: torch.Tensor, mask: torch.Tensor,
                             h_rows: torch.Tensor, y: torch.Tensor,
                             occ_l: torch.Tensor, ct: torch.Tensor,
                             dims: Sequence[int]) -> torch.Tensor:
    """Rows' gradient [B,V,C] of the pooled volume y = pool(rows) for its
    cotangent ct [B,d1,h1,w1,C]. The `max_pool_k3s2_bwd` kernel on CUDA
    tensors, the plain version on CPU ones."""
    if h_rows.is_cuda:
        from .. import kernels
        return kernels.max_pool_k3s2_bwd(coords, mask, h_rows, y, occ_l, ct,
                                         dims)
    return masked_max_pool_bwd_rows_plain(coords, mask, h_rows, y, occ_l, ct,
                                          dims)


class _PooledRows(torch.autograd.Function):
    """Forward: scatter, occupancy_pool, masked_max_pool. Saves only
    (coords, mask, h_rows, y, occ_l), as the JAX residuals are: the
    full-resolution volume is freed after the forward."""

    @staticmethod
    def forward(ctx, coords, mask, h_rows, dims):
        hv, occ_v = scatter_to_dense(coords, mask, h_rows, dims)
        y = masked_max_pool(hv, occ_v)
        occ_l = occupancy_pool(occ_v)
        ctx.save_for_backward(coords, mask, h_rows, y, occ_l)
        ctx.dims = tuple(dims)
        ctx.mark_non_differentiable(occ_l)
        return y, occ_l

    @staticmethod
    def backward(ctx, ct_y, _ct_occ):
        coords, mask, h_rows, y, occ_l = ctx.saved_tensors
        dx = masked_max_pool_bwd_rows(coords, mask, h_rows, y, occ_l,
                                      ct_y.contiguous(), ctx.dims)
        return None, None, dx, None


def pooled_rows(coords: torch.Tensor, mask: torch.Tensor,
                h_rows: torch.Tensor, dims: Sequence[int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stem rows [B,V,C] -> (pooled level-1 volume [B,d1,h1,w1,C], its
    occupancy [B,d1,h1,w1,1]), differentiable in h_rows."""
    return _PooledRows.apply(coords.to(torch.int32).contiguous(),
                             mask.contiguous(), h_rows.contiguous(),
                             tuple(int(n) for n in dims))
