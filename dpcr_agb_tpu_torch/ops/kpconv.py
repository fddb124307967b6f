"""Fused rigid KPConv (counterpart of `kpconv_fused` in `dpcr_agb_tpu/ops/
pallas_kpconv.py` and of the gather in front of it, `KPConvOp.__call__` in
`dpcr_agb_tpu/models/kpconv.py`).

Per query row q with neighbours nbr[q, :K] (index Ns = shadow, no point):

    w[k, p]  = influence(|rel[q, k] - kernel_points[p]|^2)
    part[p]  = sum_k w[k, p] * x[nbr[q, k]]            # [Kp, C]
    out[q]   = sum_p part[p] @ weights[p]              # [Cout], f32

`rel [B,Nq,K,3]` is the neighbour position minus the query position, shared
by every KPConv of one pyramid level (a shadow neighbour sits ~1e6 away, so
`linear` and `gaussian` give it no weight; `constant` gives 1 and relies on
the shadow's feature row being zero). Gradients flow to x and weights only.

On CUDA tensors forward and backward launch the hand-written `kpconv_fused`
and `kpconv_fused_bwd` kernels, which gather the rows of x themselves: the
gathered features [B,Nq,K,C], the influences [B,Nq,K,Kp] and the weighted
features [B,Nq,Kp,C] never reach device memory. On CPU tensors they run the
plain versions below (the gather, the influences and the two einsums of
`kpconv_apply_batched`).

compute_dtype bf16 (mixed precision): the features and the per-edge product
w*x are rounded to bf16, the sums over K and the products with the weights
(rounded to bf16) accumulate in f32, and the output is f32. The backward
rounds the cotangent and the weights to bf16 for `g @ W[p]^T` and
`part[p]^T g` and keeps the influences in f32 for dx."""
from __future__ import annotations

import torch

INFLUENCES = ("linear", "gaussian", "constant")
AGGREGATIONS = ("sum", "closest")


def _check_modes(influence: str, aggregation: str) -> None:
    if influence not in INFLUENCES:
        raise ValueError(f"Unknown KP_influence: {influence}")
    if aggregation not in AGGREGATIONS:
        raise ValueError(f"Unknown aggregation_mode: {aggregation}")


def influence_weights(rel: torch.Tensor, kernel_points: torch.Tensor,
                      extent: float, influence: str = "linear",
                      aggregation: str = "sum") -> torch.Tensor:
    """rel [B,Nq,K,3], kernel_points [Kp,3] -> w [B,Nq,K,Kp] f32. With
    'closest' only the first kernel point at the least distance keeps its
    weight (`torch.argmin` returns the first minimum)."""
    _check_modes(influence, aggregation)
    diff = rel.unsqueeze(-2) - kernel_points
    dx, dy, dz = diff.unbind(-1)
    sq_d = dx * dx + dy * dy + dz * dz
    if influence == "constant":
        w = torch.ones_like(sq_d)
    elif influence == "linear":
        w = torch.clamp(1.0 - torch.sqrt(torch.clamp(sq_d, min=0.0)) / extent,
                        min=0.0)
    else:
        sigma = extent * 0.3
        w = torch.exp(-sq_d / (2 * sigma * sigma + 1e-9))
    if aggregation == "closest":
        first = torch.argmin(sq_d, dim=-1, keepdim=True)
        w = w * torch.zeros_like(w).scatter_(-1, first, 1.0)
    return w


def gather_rows(x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """x [B,Ns,C], nbr [B,Nq,K] (Ns = shadow) -> [B,Nq,K,C]; the shadow
    reads a zero row. One flat `index_select`: its backward is an
    `index_add_` (atomics on CUDA), where the backward of `table[idx]`
    sorts the indices first and takes many times longer."""
    b, ns, c = x.shape
    x_pad = torch.cat([x, x.new_zeros((b, 1, c))], dim=1)
    idx = nbr.long() + (torch.arange(b, device=x.device) * (ns + 1)
                        )[:, None, None]
    return x_pad.reshape(b * (ns + 1), c).index_select(
        0, idx.reshape(-1)).reshape(*nbr.shape, c)


def _weighted(w: torch.Tensor, nx: torch.Tensor) -> torch.Tensor:
    """part [B,Nq,Kp,C] f32 = sum_k w[k,p] * nx[k]: an einsum in f32; in
    bf16 one kernel point at a time, so that each product is rounded to
    nx's dtype before the f32 sum over K."""
    if nx.dtype == torch.float32:
        return torch.einsum("bqkp,bqkc->bqpc", w, nx)
    wl = w.to(nx.dtype)
    return torch.stack([(wl[..., p, None] * nx).float().sum(2)
                        for p in range(w.shape[-1])], dim=2)


def kpconv_fused_plain(x: torch.Tensor, nbr: torch.Tensor, rel: torch.Tensor,
                       weights: torch.Tensor, kernel_points: torch.Tensor,
                       extent: float, influence: str = "linear",
                       aggregation: str = "sum") -> torch.Tensor:
    """Plain PyTorch version of the `kpconv_fused` kernel: x [B,Ns,C] in the
    compute dtype (f32 or bf16), nbr [B,Nq,K] int32, rel [B,Nq,K,3] f32,
    weights [Kp,C,Cout] f32, kernel_points [Kp,3] f32 -> [B,Nq,Cout] f32."""
    w = influence_weights(rel, kernel_points, extent, influence, aggregation)
    part = _weighted(w, gather_rows(x, nbr)).to(x.dtype).float()
    return torch.einsum("bqpc,pcd->bqd", part, weights.to(x.dtype).float())


def kpconv_fused_bwd_plain(x: torch.Tensor, nbr: torch.Tensor,
                           rel: torch.Tensor, weights: torch.Tensor,
                           kernel_points: torch.Tensor, g: torch.Tensor,
                           extent: float, influence: str = "linear",
                           aggregation: str = "sum"):
    """Plain PyTorch version of the `kpconv_fused_bwd` kernel: the inputs of
    the forward and the cotangent g [B,Nq,Cout] f32 -> (dx [B,Ns,C] f32,
    dW [Kp,C,Cout] f32). The shadow row's share of dx is dropped."""
    b, ns, c = x.shape
    w = influence_weights(rel, kernel_points, extent, influence, aggregation)
    gl = g.to(x.dtype).float()
    dpart = torch.einsum("bqd,pcd->bqpc", gl, weights.to(x.dtype).float())
    dnx = torch.einsum("bqkp,bqpc->bqkc", w, dpart)
    dx = g.new_zeros((b, ns + 1, c))
    dx.scatter_add_(1, nbr.long().reshape(b, -1, 1).expand(-1, -1, c),
                    dnx.reshape(b, -1, c))
    part = _weighted(w, gather_rows(x, nbr)).to(x.dtype).float()
    dw = torch.einsum("bqpc,bqd->pcd", part, gl)
    return dx[:, :ns], dw


def kpconv_forward(x, nbr, rel, weights, kernel_points, extent,
                   influence="linear", aggregation="sum") -> torch.Tensor:
    """`kpconv_fused_plain`'s function: the `kpconv_fused` kernel on CUDA
    tensors, the plain version on CPU ones."""
    _check_modes(influence, aggregation)
    if x.is_cuda:
        from .. import kernels
        return kernels.kpconv_fused(x, nbr, rel, weights, kernel_points,
                                    extent, influence, aggregation)
    return kpconv_fused_plain(x, nbr, rel, weights, kernel_points, extent,
                              influence, aggregation)


def kpconv_backward(x, nbr, rel, weights, kernel_points, g, extent,
                    influence="linear", aggregation="sum"):
    """`kpconv_fused_bwd_plain`'s function: the `kpconv_fused_bwd` kernel on
    CUDA tensors, the plain version on CPU ones."""
    _check_modes(influence, aggregation)
    if x.is_cuda:
        from .. import kernels
        return kernels.kpconv_fused_bwd(x, nbr, rel, weights, kernel_points,
                                        g, extent, influence, aggregation)
    return kpconv_fused_bwd_plain(x, nbr, rel, weights, kernel_points, g,
                                  extent, influence, aggregation)


class _KPConvFused(torch.autograd.Function):
    """Saves x (in the compute dtype), nbr, rel and the weights: the
    gathered features are gathered again by the backward kernel instead of
    being kept."""

    @staticmethod
    def forward(ctx, x, nbr, rel, weights, kernel_points, extent, influence,
                aggregation, compute_dtype):
        xc = x.to(compute_dtype).contiguous()
        ctx.save_for_backward(xc, nbr, rel, weights, kernel_points)
        ctx.modes = (extent, influence, aggregation)
        ctx.dtypes = (x.dtype, weights.dtype)
        return kpconv_forward(xc, nbr, rel, weights, kernel_points, extent,
                              influence, aggregation)

    @staticmethod
    def backward(ctx, g):
        xc, nbr, rel, weights, kernel_points = ctx.saved_tensors
        dx, dw = kpconv_backward(xc, nbr, rel, weights, kernel_points,
                                 g.float().contiguous(), *ctx.modes)
        return (dx.to(ctx.dtypes[0]) if ctx.needs_input_grad[0] else None,
                None, None,
                dw.to(ctx.dtypes[1]) if ctx.needs_input_grad[3] else None,
                None, None, None, None, None)


def kpconv_fused(x: torch.Tensor, nbr: torch.Tensor, rel: torch.Tensor,
                 weights: torch.Tensor, kernel_points: torch.Tensor,
                 extent: float, influence: str = "linear",
                 aggregation: str = "sum",
                 compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fused rigid KPConv, differentiable in x and weights: x [B,Ns,C],
    nbr [B,Nq,K] int32 (Ns = shadow), rel [B,Nq,K,3] f32, weights
    [Kp,C,Cout], kernel_points [Kp,3] -> [B,Nq,Cout] f32."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kpconv_fused: unsupported compute dtype "
                         f"{compute_dtype}")
    if nbr.shape != rel.shape[:-1] or rel.shape[-1] != 3 \
            or x.shape[0] != nbr.shape[0] \
            or weights.shape[:2] != (kernel_points.shape[0], x.shape[-1]):
        raise ValueError(
            f"kpconv_fused: shapes x {tuple(x.shape)}, nbr "
            f"{tuple(nbr.shape)}, rel {tuple(rel.shape)}, weights "
            f"{tuple(weights.shape)}, kernel_points "
            f"{tuple(kernel_points.shape)}")
    return _KPConvFused.apply(
        x, nbr.to(torch.int32).contiguous(), rel.float().contiguous(),
        weights.float().contiguous(), kernel_points.float().contiguous(),
        float(extent), influence, aggregation, compute_dtype)


def shared_rel(q_pts: torch.Tensor, s_pts: torch.Tensor, nbr: torch.Tensor,
               shadow_pos: float = 1e6) -> torch.Tensor:
    """rel [B,Nq,K,3] = s_pts[nbr] - q_pts, the shadow neighbour parked at
    `shadow_pos`; no gradient (the rigid path's geometry carries none)."""
    with torch.no_grad():
        b = s_pts.shape[0]
        s_pad = torch.cat([s_pts, s_pts.new_full((b, 1, 3), shadow_pos)], 1)
        idx = nbr.long() + (torch.arange(b, device=nbr.device)
                            * s_pad.shape[1])[:, None, None]
        return s_pad.reshape(-1, 3)[idx] - q_pts[:, :, None, :]
