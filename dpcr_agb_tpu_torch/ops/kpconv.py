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
gathered features [B,Nq,K,C] and the influences [B,Nq,K,Kp] never reach
device memory (the weighted features [B,Nq,Kp,C] pass through the kernels'
scratch, formed once and read once). On CPU tensors they run the
plain versions below (the gather, the influences and the two einsums of
`kpconv_apply_batched`).

Every sum of a backward runs in a fixed order on the card, so a train step
gives the same bits from run to run: dx of the fused op and of the plain
row gather (`gather_rows`, the strided shortcut's max pool) has one owner
per row of x, which walks the rows that name it in the order of the
neighbour list's reverse edge index (`reverse_edges`: built once per list
on the device, with no host sync; the device form of the JAX package's
host-side `_edge_transpose`).

compute_dtype bf16 (mixed precision): the features and the per-edge product
w*x are rounded to bf16, the sums over K and the products with the weights
(rounded to bf16) accumulate in f32, and the output is f32. The backward
rounds the cotangent and the weights to bf16 for `g @ W[p]^T` and
`part[p]^T g` and keeps the influences in f32 for dx."""
from __future__ import annotations

from typing import Optional, Tuple

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


def reverse_edges(nbr: torch.Tensor, ns: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reverse edge index of nbr [B,Nq,K] over Ns source rows (index
    Ns, or any index outside [0, Ns), is the shadow): (perm int32
    [B*Nq*K], off int32 [B*(Ns+1)+1]). perm sorts the flat edges stably by
    (sample, source row), each sample's shadow edges last; the edges that
    name row j of sample b are perm[off[b*(Ns+1)+j] : off[b*(Ns+1)+j+1]],
    in their order in nbr. Sample b's slices, less b*Nq*K, are
    `_edge_transpose(nbr[b], Ns)` of `dpcr_agb_tpu/ops/host_pyramid.py`.
    `torch.sort(stable=True)` and `searchsorted` on nbr's device: no value
    comes back to the host."""
    b = nbr.shape[0]
    idx = nbr.long()
    idx = torch.where((idx >= 0) & (idx < ns), idx, ns)
    key = (idx + (torch.arange(b, device=nbr.device) * (ns + 1)
                  )[:, None, None]).reshape(-1)
    sorted_key, perm = torch.sort(key, stable=True)
    off = torch.searchsorted(sorted_key, torch.arange(
        b * (ns + 1) + 1, device=nbr.device))
    return perm.to(torch.int32), off.to(torch.int32)


def _gather_plain(x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """The row gather as one flat `index_select` (the shadow reads a zero
    row); autograd's backward of it is an `index_add_`."""
    b, ns, c = x.shape
    x_pad = torch.cat([x, x.new_zeros((b, 1, c))], dim=1)
    idx = nbr.long() + (torch.arange(b, device=x.device) * (ns + 1)
                        )[:, None, None]
    return x_pad.reshape(b * (ns + 1), c).index_select(
        0, idx.reshape(-1)).reshape(*nbr.shape, c)


def gather_rows_bwd_plain(g: torch.Tensor, nbr: torch.Tensor, ns: int,
                          rev=None) -> torch.Tensor:
    """Plain PyTorch version of the `gather_rows_bwd` kernel: g [B,Nq,K,C],
    nbr [B,Nq,K] -> dx [B,Ns,C] of g's dtype, each row the sum of the g
    rows of the edges that name it (one `index_add_`, f32 sums; on CUDA in
    the order its atomics land), the shadow's rows dropped. rev (the
    kernel's reverse index) is not needed here."""
    b, nq, k, c = g.shape
    idx = nbr.long()
    idx = torch.where((idx >= 0) & (idx < ns), idx, ns) \
        + (torch.arange(b, device=g.device) * (ns + 1))[:, None, None]
    dx = torch.zeros((b * (ns + 1), c), dtype=torch.float32, device=g.device)
    dx.index_add_(0, idx.reshape(-1), g.reshape(-1, c).float())
    return dx.reshape(b, ns + 1, c)[:, :ns].to(g.dtype)


def _reverse(nbr: torch.Tensor, ns: int, rev):
    """rev, or nbr's reverse edge index where the caller has none: the one
    place the card's backward kernels get a missing index from."""
    return reverse_edges(nbr, ns) if rev is None else rev


def gather_rows_backward(g: torch.Tensor, nbr: torch.Tensor, ns: int,
                         rev: Optional[Tuple[torch.Tensor, torch.Tensor]]
                         = None) -> torch.Tensor:
    """`gather_rows_bwd_plain`'s function: the `gather_rows_bwd` kernel on
    CUDA tensors (over rev, nbr's reverse edge index, built here when not
    given), the plain version on CPU ones."""
    if g.is_cuda:
        from .. import kernels
        return kernels.gather_rows_bwd(g.contiguous(),
                                       _reverse(nbr, ns, rev), g.shape[0], ns)
    return gather_rows_bwd_plain(g, nbr, ns)


class _GatherRows(torch.autograd.Function):
    """The row gather with a backward summed in a fixed order; rev (nbr's
    reverse edge index or None) rides on ctx."""

    @staticmethod
    def forward(ctx, x, nbr, rev):
        ctx.save_for_backward(nbr)
        ctx.ns, ctx.rev = x.shape[1], rev
        return _gather_plain(x, nbr)

    @staticmethod
    def backward(ctx, g):
        nbr, = ctx.saved_tensors
        return gather_rows_backward(g, nbr, ctx.ns, ctx.rev), None, None


def gather_rows(x: torch.Tensor, nbr: torch.Tensor,
                rev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """x [B,Ns,C], nbr [B,Nq,K] (Ns = shadow) -> [B,Nq,K,C]; the shadow
    reads a zero row. The forward is one flat `index_select`; where x needs
    a gradient, its backward is `gather_rows_backward` over rev, nbr's
    reverse edge index (`reverse_edges(nbr, Ns)`, built by the backward
    when not given): on the card a fixed-order sum, the same bits from run
    to run, where autograd's `index_add_` adds with atomics."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _gather_plain(x, nbr)
    return _GatherRows.apply(x, nbr, rev)


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
    part = _weighted(w, _gather_plain(x, nbr)).to(x.dtype).float()
    return torch.einsum("bqpc,pcd->bqd", part, weights.to(x.dtype).float())


def kpconv_fused_bwd_plain(x: torch.Tensor, nbr: torch.Tensor,
                           rel: torch.Tensor, weights: torch.Tensor,
                           kernel_points: torch.Tensor, g: torch.Tensor,
                           extent: float, influence: str = "linear",
                           aggregation: str = "sum", rev=None):
    """Plain PyTorch version of the `kpconv_fused_bwd` kernel: the inputs of
    the forward and the cotangent g [B,Nq,Cout] f32 -> (dx [B,Ns,C] f32,
    dW [Kp,C,Cout] f32). The shadow row's share of dx is dropped. rev (the
    kernel's reverse index) is not needed here."""
    b, ns, c = x.shape
    w = influence_weights(rel, kernel_points, extent, influence, aggregation)
    gl = g.to(x.dtype).float()
    dpart = torch.einsum("bqd,pcd->bqpc", gl, weights.to(x.dtype).float())
    dnx = torch.einsum("bqkp,bqpc->bqkc", w, dpart)
    dx = g.new_zeros((b, ns + 1, c))
    dx.scatter_add_(1, nbr.long().reshape(b, -1, 1).expand(-1, -1, c),
                    dnx.reshape(b, -1, c))
    part = _weighted(w, _gather_plain(x, nbr)).to(x.dtype).float()
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
                    influence="linear", aggregation="sum", rev=None):
    """`kpconv_fused_bwd_plain`'s function: the `kpconv_fused_bwd` kernel on
    CUDA tensors (dx over rev, nbr's reverse edge index, built here when
    not given), the plain version on CPU ones."""
    _check_modes(influence, aggregation)
    if x.is_cuda:
        from .. import kernels
        return kernels.kpconv_fused_bwd(x, nbr, rel, weights, kernel_points,
                                        g, extent, influence, aggregation,
                                        _reverse(nbr, x.shape[1], rev))
    return kpconv_fused_bwd_plain(x, nbr, rel, weights, kernel_points, g,
                                  extent, influence, aggregation)


class _KPConvFused(torch.autograd.Function):
    """Saves x (in the compute dtype), nbr, rel and the weights, and keeps
    nbr's reverse edge index (or None) on ctx: the gathered features are
    gathered again by the backward kernel instead of being kept."""

    @staticmethod
    def forward(ctx, x, nbr, rel, weights, kernel_points, extent, influence,
                aggregation, compute_dtype, rev):
        xc = x.to(compute_dtype).contiguous()
        ctx.save_for_backward(xc, nbr, rel, weights, kernel_points)
        ctx.rev = rev
        ctx.modes = (extent, influence, aggregation)
        ctx.dtypes = (x.dtype, weights.dtype)
        return kpconv_forward(xc, nbr, rel, weights, kernel_points, extent,
                              influence, aggregation)

    @staticmethod
    def backward(ctx, g):
        xc, nbr, rel, weights, kernel_points = ctx.saved_tensors
        dx, dw = kpconv_backward(xc, nbr, rel, weights, kernel_points,
                                 g.float().contiguous(), *ctx.modes,
                                 rev=ctx.rev)
        return (dx.to(ctx.dtypes[0]) if ctx.needs_input_grad[0] else None,
                None, None,
                dw.to(ctx.dtypes[1]) if ctx.needs_input_grad[3] else None,
                None, None, None, None, None, None)


def kpconv_fused(x: torch.Tensor, nbr: torch.Tensor, rel: torch.Tensor,
                 weights: torch.Tensor, kernel_points: torch.Tensor,
                 extent: float, influence: str = "linear",
                 aggregation: str = "sum",
                 compute_dtype: torch.dtype = torch.float32,
                 rev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """Fused rigid KPConv, differentiable in x and weights: x [B,Ns,C],
    nbr [B,Nq,K] int32 (Ns = shadow), rel [B,Nq,K,3] f32, weights
    [Kp,C,Cout], kernel_points [Kp,3] -> [B,Nq,Cout] f32. rev: nbr's
    reverse edge index (`reverse_edges`) for the backward's dx, shared by
    every op over the same list; built by the backward when not given."""
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
        float(extent), influence, aggregation, compute_dtype, rev)


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


def deformed_influence(rel: torch.Tensor, kernel_points: torch.Tensor,
                       offsets: torch.Tensor, extent: float,
                       influence: str = "linear", aggregation: str = "sum"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deformable branch of `kp_influence_weights` (`dpcr_agb_tpu/
    models/kpconv.py`): rel [B,Nq,K,3] (the shadow neighbour parked at
    SHADOW_POS), kernel_points [Kp,3], offsets [B,Nq,Kp,3] that shift the
    kernel points per query -> (all_w [B,Nq,K,Kp], min_d2 [B,Nq,Kp], the
    least squared distance of each deformed kernel point to a neighbour,
    shadow included). Differentiable in offsets."""
    _check_modes(influence, aggregation)
    kp = kernel_points + offsets                             # [B,Nq,Kp,3]
    diff = rel.unsqueeze(-2) - kp.unsqueeze(2)               # [B,Nq,K,Kp,3]
    sq_d = torch.sum(torch.square(diff), dim=-1)
    min_d2 = torch.amin(sq_d, dim=2)
    if influence == "constant":
        w = torch.ones_like(sq_d)
    elif influence == "linear":
        w = torch.clamp(1.0 - torch.sqrt(sq_d) / extent, min=0.0)
    else:
        sigma = extent * 0.3
        w = torch.exp(-sq_d / (2 * sigma * sigma + 1e-9))
    if aggregation == "closest":
        first = torch.argmin(sq_d, dim=-1, keepdim=True)
        w = w * torch.zeros_like(w).scatter_(-1, first, 1.0)
    return w, min_d2


def kpconv_apply(nx: torch.Tensor, all_w: torch.Tensor,
                 weights: torch.Tensor,
                 modulations: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`kpconv_apply` of the JAX package over gathered rows, in f32: nx
    [B,Nq,K,C] (the neighbours' features, `gather_rows`), all_w
    [B,Nq,K,Kp], weights [Kp,C,Cout], modulations [B,Nq,Kp] scaling each
    kernel point's weighted features -> [B,Nq,Cout]. Two batched matmuls
    (sum over K, then over Kp and C)."""
    b, nq, k, c = nx.shape
    kp = all_w.shape[-1]
    weighted = torch.matmul(all_w.transpose(-1, -2), nx)     # [B,Nq,Kp,C]
    if modulations is not None:
        weighted = weighted * modulations.unsqueeze(-1)
    return torch.matmul(weighted.reshape(b, nq, kp * c),
                        weights.reshape(kp * c, -1))
