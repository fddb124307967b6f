"""The masked Minkowski MaxPool (kernel 3, stride 2), forward and backward,
of the stem rows and of a whole volume (counterpart of `pallas_max_pool` in
`dpcr_agb_tpu/ops/pallas_pool.py`, of `pooled_rows_fused` in
`dpcr_agb_tpu/ops/sparse_stem.py` and of `manual_max_pool` in
`dpcr_agb_tpu/ops/dense_stem.py`).

Output cell u is the max over the inputs {2u-1, 2u, 2u+1}^3 with empty or
out-of-range inputs excluded (-inf), zeroed where the pooled occupancy is 0
(no occupied child in {2u, 2u+1}^3). The backward routes the cotangent of
each occupied output cell to every input that equals its max (ties get
the full cotangent each), in row space: each row gathers its 1..8 parent
cells. The volume form (`pallas_max_pool`, the dense level 0) routes alike
for every input cell of the volume. The rows' forward (`pooled_rows`,
flavour "dense") reads the rows themselves: `masked_max_pool_rows` equals
scattering them into the full-resolution volume, `occupancy_pool` and
`masked_max_pool`, without that volume on the card. On CUDA tensors `masked_max_pool`,
`masked_max_pool_rows`, `masked_max_pool_bwd_rows` and
`masked_max_pool_bwd_vol` launch the hand-written `max_pool_k3s2`,
`max_pool_k3s2_rows`, `max_pool_k3s2_bwd` and `max_pool_k3s2_bwd_vol`
kernels; on CPU tensors they run their plain versions."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kernel_ops
from .dense_grid import (NEG_INF, dense_max_pool_xla, occupancy_pool,
                         scatter_to_dense, windowed_max)

POOL_FWD_FLAVOURS = ("dense", "separable", "scattermax")


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
    [B,ceil(D/2),ceil(H/2),ceil(W/2),C]. The op `dpcr_port::max_pool_k3s2`:
    the `max_pool_k3s2` kernel on CUDA tensors, the plain version on CPU
    ones."""
    return kernel_ops.max_pool_k3s2(x, occ)


def masked_max_pool_rows_plain(coords: torch.Tensor, mask: torch.Tensor,
                               h_rows: torch.Tensor, dims: Sequence[int]
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the `max_pool_k3s2_rows` kernel: the rows
    scattered into the volume of `dims` (`scatter_to_dense`: masked and
    out-of-volume rows dropped, duplicate cells summed), then
    (masked_max_pool_plain, occupancy_pool) of that volume."""
    hv, occ_v = scatter_to_dense(coords, mask, h_rows, dims)
    return masked_max_pool_plain(hv, occ_v), occupancy_pool(occ_v)


def masked_max_pool_rows(coords: torch.Tensor, mask: torch.Tensor,
                         h_rows: torch.Tensor, dims: Sequence[int]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows [B,V,C] (coords int32 [B,V,3], mask bool [B,V]) -> (pooled
    level-1 volume [B,d1,h1,w1,C], its occupancy [B,d1,h1,w1,1]). The op
    `dpcr_port::max_pool_k3s2_rows`: the `max_pool_k3s2_rows` kernel on
    CUDA tensors (no C-wide full-resolution volume), the plain version on
    CPU ones."""
    return kernel_ops.max_pool_k3s2_rows(coords, mask, h_rows,
                                         [int(n) for n in dims])


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
    """Forward: the pooled level-1 volume of the rows, in one of three
    flavours that give identical values: "dense" (`masked_max_pool_rows`:
    on the card the rows read straight into the window max, no
    full-resolution volume), "separable" (scatter, three 1-D library
    window maxes) or "scattermax" (the rows straight into the level-1
    volume). Saves only (coords, mask, h_rows, y, occ_l), as the JAX
    residuals are: no full-resolution volume outlives the forward."""

    @staticmethod
    def forward(ctx, coords, mask, h_rows, dims, flavour):
        if flavour == "scattermax":
            from .sparse_stem import scatter_max_pool_batch
            y, occ_l = scatter_max_pool_batch(coords, mask, h_rows, dims)
        elif flavour == "dense":
            y, occ_l = masked_max_pool_rows(coords, mask, h_rows, dims)
        else:
            hv, occ_v = scatter_to_dense(coords, mask, h_rows, dims)
            occ_l = occupancy_pool(occ_v)
            y = dense_max_pool_xla(hv, occ_v, occ_l, separable=True)
        ctx.save_for_backward(coords, mask, h_rows, y, occ_l)
        ctx.dims = tuple(dims)
        ctx.mark_non_differentiable(occ_l)
        return y, occ_l

    @staticmethod
    def backward(ctx, ct_y, _ct_occ):
        coords, mask, h_rows, y, occ_l = ctx.saved_tensors
        dx = masked_max_pool_bwd_rows(coords, mask, h_rows, y, occ_l,
                                      ct_y.contiguous(), ctx.dims)
        return None, None, dx, None, None


def pooled_rows(coords: torch.Tensor, mask: torch.Tensor,
                h_rows: torch.Tensor, dims: Sequence[int],
                flavour: str = "dense") -> Tuple[torch.Tensor, torch.Tensor]:
    """Stem rows [B,V,C] -> (pooled level-1 volume [B,d1,h1,w1,C], its
    occupancy [B,d1,h1,w1,1]), differentiable in h_rows through the
    row-form equality routing whatever the forward `flavour`."""
    if flavour not in POOL_FWD_FLAVOURS:
        raise ValueError(f"pool forward flavour {flavour!r}: one of "
                         f"{POOL_FWD_FLAVOURS}")
    return _PooledRows.apply(coords.to(torch.int32).contiguous(),
                             mask.contiguous(), h_rows.contiguous(),
                             tuple(int(n) for n in dims), flavour)


def _cover_slots(n: int, n1: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Along one axis of extent n (level-1 extent n1): each cell's two
    covering outputs [n,2] = (i//2, (i+1)//2), and whether each slot counts
    [n,2]: the lower always, the upper only for an odd i inside n1."""
    i = torch.arange(n, device=device)
    u = torch.stack([i // 2, (i + 1) // 2], -1)
    ok = torch.stack([torch.ones_like(i, dtype=torch.bool),
                      (i % 2 == 1) & ((i + 1) // 2 < n1)], -1)
    return u.clamp(max=n1 - 1), ok


def masked_max_pool_bwd_vol_plain(x: torch.Tensor, occ_in: torch.Tensor,
                                  y: torch.Tensor, ct: torch.Tensor
                                  ) -> torch.Tensor:
    """Plain PyTorch version of the `max_pool_k3s2_bwd_vol` kernel, written
    out (not autograd of a max, which splits or picks among ties): for
    each input cell and channel the f32 sum, over the up to 8 covering
    outputs, of the cotangent of every output whose y equals the cell's
    value, in the TPU kernel's order (the up to four terms of each
    first-axis parent summed alone, lower parents first, then the two
    partial sums added); cast to x's dtype and zero at unoccupied cells."""
    b, d, h, w, c = x.shape
    d1, h1, w1 = y.shape[1:4]
    (ud, okd), (uh, okh), (uw, okw) = (
        _cover_slots(n, n1, x.device) for n, n1 in ((d, d1), (h, h1),
                                                    (w, w1)))
    dx = 0.0
    for td in range(2):
        part = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for th in range(2):
            for tw in range(2):
                pick = (slice(None), ud[:, td, None, None],
                        uh[None, :, th, None], uw[None, None, :, tw])
                ok = (okd[:, td, None, None] & okh[None, :, th, None]
                      & okw[None, None, :, tw])[None, ..., None]
                part = part + torch.where((y[pick] == x) & ok,
                                          ct[pick].float(), 0.0)
        dx = dx + part
    return torch.where(occ_in > 0, dx, 0.0).to(x.dtype)


def masked_max_pool_bwd_vol(x: torch.Tensor, occ_in: torch.Tensor,
                            y: torch.Tensor, ct: torch.Tensor
                            ) -> torch.Tensor:
    """dx [B,D,H,W,C] of the pooled volume y = pool(x under occ_in) for its
    cotangent ct [B,d1,h1,w1,C], which is zero at unoccupied outputs
    already. The `max_pool_k3s2_bwd_vol` kernel on CUDA tensors, the plain
    version on CPU ones."""
    if x.is_cuda:
        from .. import kernels
        return kernels.max_pool_k3s2_bwd_vol(x, occ_in, y, ct)
    return masked_max_pool_bwd_vol_plain(x, occ_in, y, ct)


class _VolumePool(torch.autograd.Function):
    """`pallas_max_pool`: forward `masked_max_pool` then the occ_out mask;
    backward the volume-form equality routing of the occ_out-masked
    cotangent. Saves (x, occ_in, occ_out, y) as the reference does."""

    @staticmethod
    def forward(ctx, x, occ_in, occ_out):
        y = masked_max_pool(x, occ_in)
        y = torch.where(occ_out > 0, y, torch.zeros_like(y))
        ctx.save_for_backward(x, occ_in, occ_out, y)
        return y

    @staticmethod
    def backward(ctx, ct):
        x, occ_in, occ_out, y = ctx.saved_tensors
        ctm = torch.where(occ_out > 0, ct, torch.zeros_like(ct)).to(x.dtype)
        return masked_max_pool_bwd_vol(x, occ_in, y, ctm.contiguous()), \
            None, None


def pallas_max_pool(x: torch.Tensor, occ_in: torch.Tensor,
                    occ_out: torch.Tensor) -> torch.Tensor:
    """The volume-form pool with the hand-written kernels both ways
    (`dense_max_pool`'s mode "pallas"): x [B,D,H,W,C], occupancies
    [B,D,H,W,1] and [B,ceil(D/2),ceil(H/2),ceil(W/2),1] of x's dtype ->
    the pooled volume, zero at unoccupied outputs; every maximizer of a
    window gets the window's full cotangent."""
    return _VolumePool.apply(x.contiguous(), occ_in.contiguous(),
                             occ_out.contiguous())


def manual_max_pool_bwd_plain(x: torch.Tensor, occ_in: torch.Tensor,
                              occ_out: torch.Tensor, y: torch.Tensor,
                              ct: torch.Tensor) -> torch.Tensor:
    """The reference's 27-tap equality routing: y (with -1e30 at unoccupied
    outputs) and the masked ct dilated back onto the stride-2 grid, padded
    by one cell and cropped to the input extent + 2; each of the 27 shifts
    adds the cotangent where x equals the shifted y, in f32; times
    (occ_in > 0), in x's dtype."""
    b, d, h, w, c = x.shape
    d2, h2, w2 = y.shape[1:4]
    ctm = torch.where(occ_out > 0, ct, torch.zeros_like(ct))
    yd = torch.zeros((b, 2 * d2, 2 * h2, 2 * w2, c), dtype=y.dtype,
                     device=y.device)
    yd[:, ::2, ::2, ::2] = torch.where(
        occ_out > 0, y, torch.full((), NEG_INF, dtype=y.dtype,
                                   device=y.device))
    cd = torch.zeros_like(yd, dtype=ctm.dtype)
    cd[:, ::2, ::2, ::2] = ctm
    pad = (0, 0, 1, 1, 1, 1, 1, 1)
    ydp = F.pad(yd, pad, value=NEG_INF)[:, :d + 2, :h + 2, :w + 2]
    cdp = F.pad(cd, pad)[:, :d + 2, :h + 2, :w + 2]
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for dd in range(3):
        for hh in range(3):
            for ww in range(3):
                ys = ydp[:, dd:dd + d, hh:hh + h, ww:ww + w]
                cs = cdp[:, dd:dd + d, hh:hh + h, ww:ww + w]
                acc = acc + torch.where(x == ys, cs.float(), 0.0)
    return (acc * (occ_in > 0)).to(x.dtype)


class _ManualPool(torch.autograd.Function):
    """`manual_max_pool`: the library window max forward, the equality
    routing backward. The 27-tap form and the volume-form kernel route the
    same set of cotangents (they differ in where the f32 sum of the up to
    8 terms is split, so by a rounding of that sum at most), so CUDA
    tensors share the `max_pool_k3s2_bwd_vol` kernel and CPU tensors take
    the 27-tap form."""

    @staticmethod
    def forward(ctx, x, occ_in, occ_out, separable):
        neg = torch.full((), NEG_INF, dtype=x.dtype, device=x.device)
        y = windowed_max(torch.where(occ_in > 0, x, neg), separable)
        y = torch.where(occ_out > 0, y, torch.zeros_like(y))
        ctx.save_for_backward(x, occ_in, occ_out, y)
        return y

    @staticmethod
    def backward(ctx, ct):
        x, occ_in, occ_out, y = ctx.saved_tensors
        if x.is_cuda:
            ctm = torch.where(occ_out > 0, ct, torch.zeros_like(ct))
            dx = masked_max_pool_bwd_vol(x, occ_in, y.contiguous(),
                                         ctm.to(x.dtype).contiguous())
        else:
            dx = manual_max_pool_bwd_plain(x, occ_in, occ_out, y, ct)
        return dx, None, None, None


def manual_max_pool(x: torch.Tensor, occ_in: torch.Tensor,
                    occ_out: torch.Tensor,
                    separable: bool = True) -> torch.Tensor:
    """`dense_max_pool`'s mode "manual": `windowed_max` of the
    -1e30-filled volume forward (three 1-D passes, or one 3-D window when
    `separable` is False), equality routing backward."""
    return _ManualPool.apply(x.contiguous(), occ_in.contiguous(),
                             occ_out.contiguous(), separable)
