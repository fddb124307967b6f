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
channels_last_3d strides, so the permutes copy nothing on the card.

How the stem conv and the level-0 pool run is chosen by mode arguments with
the values of the JAX package's DPCR_STEM_MODE and DPCR_POOL_BWD; the model
(`models/minkowski.py`) reads those variables when it is built.

Under a process group a bf16 conv's weight and bias gradients are the f32
partials, rounded once after the SUM (`parallel.rounding.conv`); the
forward is the one-process conv's."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..parallel import round_after_sum
from ..parallel import rounding

NEG_INF = -1e30
STEM_MODES = ("xla3d", "zfold_firewall", "zfold2d_firewall")
POOL_BWD_MODES = ("xla", "manual", "separable", "pallas")
# The first-axis fold of tiny-Cin convs in the backward only
# (`_tiny_cin_conv`): off, as in the reference, whose tests keep it alive.
USE_DFOLD_TINY_CIN = False


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
               bias: Optional[torch.Tensor] = None,
               stem_mode: str = "xla3d") -> torch.Tensor:
    """x [B,D,H,W,Cin]; weights [K^3,Cin,Cout]; pad k//2 (so a stride-2 k3
    conv gives ceil(n/2) and a k1 conv pads nothing). Returns
    [B,D',H',W',Cout] in compute_dtype, (conv + bias) * occ_out. A tiny-Cin
    conv (Cin*k <= 32, k > 1: the stem) under a `zfold*_firewall` stem_mode
    runs folded between layout firewalls (`dense_stem.stem_conv_folded`)."""
    if stem_mode not in STEM_MODES:
        raise ValueError(f"stem_mode {stem_mode!r}: one of {STEM_MODES}")
    k = kernel_size
    cin, cout = weights.shape[-2:]
    folded = stem_mode in ("zfold_firewall", "zfold2d_firewall") \
        and cin * k <= 32 and k > 1
    if folded or (USE_DFOLD_TINY_CIN and cin * k <= 32):
        if folded:
            from .dense_stem import stem_conv_folded
            y = stem_conv_folded(x, occ_out, weights, k, stride,
                                 compute_dtype,
                                 two_d=stem_mode == "zfold2d_firewall")
        else:
            y = _tiny_cin_conv(
                x.to(compute_dtype),
                weights.reshape(k, k, k, cin, cout).to(compute_dtype), k,
                stride) * occ_out.to(compute_dtype)
        if bias is not None:
            y = rounding.add_bias(y, bias) \
                if rounding.sums_rounded_once(y.dtype) \
                else y + bias.to(y.dtype)
            y = y * occ_out.to(y.dtype)
        return y
    if rounding.sums_rounded_once(compute_dtype):
        round_after_sum(compute_dtype, weights, bias)
        xc = x.to(compute_dtype).permute(0, 4, 1, 2, 3)
        y = rounding.conv(xc, conv_weight(weights, torch.float32), bias,
                          stride, [k // 2] * 3,
                          widen=xc.device.type == "cpu").permute(
                              0, 2, 3, 4, 1)
        return y * occ_out.to(y.dtype)
    w5 = conv_weight(weights, compute_dtype)
    b5 = None if bias is None else bias.to(compute_dtype)
    xc = x.to(compute_dtype).permute(0, 4, 1, 2, 3)
    if xc.device.type == "cpu" and compute_dtype != torch.float32:
        # the CPU's bf16 conv3d gives a weight gradient read from
        # uninitialized memory at some shapes (a k3 stride-2 conv of a
        # [2,2,1] volume, batch 4): on the CPU the conv runs in f32 on the
        # exactly widened operands and rounds its output, as a bf16 conv
        # accumulating in f32 does
        y = F.conv3d(xc.float(), w5.float(),
                     None if b5 is None else b5.float(), stride=stride,
                     padding=k // 2).to(compute_dtype)
    else:
        y = F.conv3d(xc, w5, b5, stride=stride, padding=k // 2)
    y = y.permute(0, 2, 3, 4, 1)
    return y * occ_out.to(y.dtype)


def _conv3d_plain(x: torch.Tensor, w5: torch.Tensor, k: int,
                  stride: int) -> torch.Tensor:
    """NDHWC conv of x with w5 [k,k,k,Cin,Cout], pad k//2."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w5.permute(4, 3, 0, 1, 2),
                 stride=stride, padding=k // 2)
    return y.permute(0, 2, 3, 4, 1)


def _dense_conv_dfold_core(x: torch.Tensor, w_dense: torch.Tensor, k: int,
                           stride: int) -> torch.Tensor:
    """The same conv with the first-axis taps folded into channels and a
    depth-1 3D conv over the other two (5-D NDHWC throughout)."""
    from .dense_stem import zfold_conv
    return zfold_conv(x, w_dense, k, stride)


class _TinyCinConv(torch.autograd.Function):
    """Plain 3D conv forward; the backward differentiates the folded
    formulation instead (the same function, so the same gradients up to
    the order of the sums)."""

    @staticmethod
    def forward(ctx, x, w5, k, stride):
        ctx.save_for_backward(x, w5)
        ctx.k, ctx.stride = k, stride
        return _conv3d_plain(x, w5, k, stride)

    @staticmethod
    def backward(ctx, ct):
        x, w5 = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip((x, w5), need)]
            y = _dense_conv_dfold_core(*ins, ctx.k, ctx.stride)
            grads = iter(torch.autograd.grad(
                y, [t for t, n in zip(ins, need) if n], ct))
        return (*(next(grads) if n else None for n in need), None, None)


def _tiny_cin_conv(x: torch.Tensor, w5: torch.Tensor, k: int,
                   stride: int) -> torch.Tensor:
    """Tiny-Cin (stem) conv of x [B,D,H,W,Cin] with w5 [k,k,k,Cin,Cout]:
    plain 3D conv forward, folded backward."""
    return _TinyCinConv.apply(x, w5, k, stride)


def windowed_max(filled: torch.Tensor, separable: bool) -> torch.Tensor:
    """The k3/s2 window max, padded by one cell with -inf, of a filled
    volume [B,D,H,W,C] -> [B,ceil(D/2),ceil(H/2),ceil(W/2),C]. `separable`
    chains three 1-D k3/s2 passes (the max over a 3^3 window factorizes per
    axis). Autograd routes a window's cotangent to its first maximizer in
    row-major order (per pass when separable), as select-and-scatter does
    in the reference."""
    y = filled.permute(0, 4, 1, 2, 3)
    if separable:
        for axis in range(3):
            kk, ss, pp = [1, 1, 1], [1, 1, 1], [0, 0, 0]
            kk[axis], ss[axis], pp[axis] = 3, 2, 1
            y = F.max_pool3d(y, kk, ss, pp)
    else:
        y = F.max_pool3d(y, 3, 2, 1)
    return y.permute(0, 2, 3, 4, 1)


def dense_max_pool_xla(x: torch.Tensor, occ_in: torch.Tensor,
                       occ_out: torch.Tensor,
                       separable: bool = False) -> torch.Tensor:
    """The library k3/s2 masked window max: empty inputs filled with -1e30,
    `windowed_max`, zero at unoccupied outputs; differentiated by
    autograd."""
    neg = torch.full((), NEG_INF, dtype=x.dtype, device=x.device)
    y = windowed_max(torch.where(occ_in > 0, x, neg), separable)
    return torch.where(occ_out > 0, y, torch.zeros_like(y))


def dense_max_pool(x: torch.Tensor, occ_in: torch.Tensor,
                   occ_out: torch.Tensor, pool_bwd: str = "xla",
                   pool_fwd_separable: bool = True) -> torch.Tensor:
    """Minkowski MaxPool (kernel 3, stride 2) of the volume x [B,D,H,W,C]
    under its occupancy occ_in, output only at the cells of occ_out:
    the same values in every mode. pool_bwd picks the backward: "xla" and
    "separable" (autograd of the library window max, one maximizer per
    window and per pass), "manual" and "pallas" (equality routing: every
    maximizer gets the full cotangent; `pool.manual_max_pool`, whose
    forward is separable unless pool_fwd_separable is False, and
    `pool.pallas_max_pool`, the hand-written kernels)."""
    if pool_bwd not in POOL_BWD_MODES:
        raise ValueError(f"pool_bwd {pool_bwd!r}: one of {POOL_BWD_MODES}")
    if pool_bwd == "manual":
        from .pool import manual_max_pool
        return manual_max_pool(x, occ_in, occ_out, pool_fwd_separable)
    if pool_bwd == "pallas":
        from .pool import pallas_max_pool
        return pallas_max_pool(x, occ_in, occ_out)
    return dense_max_pool_xla(x, occ_in, occ_out,
                              separable=pool_bwd == "separable")


def level_dims(dims: Sequence[int], level: int) -> Tuple[int, int, int]:
    """Grid dims shrink by ceil-halving per level (stride 2, pad 1)."""
    d, h, w = dims
    for _ in range(level):
        d, h, w = -(-d // 2), -(-h // 2), -(-w // 2)
    return d, h, w
