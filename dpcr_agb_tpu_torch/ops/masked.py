"""Masked reductions over padded point/voxel axes (counterpart of
`dpcr_agb_tpu/ops/masked.py`): tensors are padded to `[..., N, C]` with a
boolean validity `mask [..., N]`, and reductions only see valid rows."""
from __future__ import annotations

import torch

from ..parallel import all_reduce_sum

_NEG_INF = -1e30


def masked_sum(x: torch.Tensor, mask: torch.Tensor,
               axis: int = -2) -> torch.Tensor:
    """x [..., N, C], mask [..., N] -> [..., C]."""
    return torch.sum(x * mask.unsqueeze(-1).to(x.dtype), dim=axis)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis: int = -2,
                eps: float = 1e-12) -> torch.Tensor:
    m = mask.unsqueeze(-1).to(x.dtype)
    total = torch.sum(x * m, dim=axis)
    count = torch.sum(m, dim=axis)
    return total / torch.clamp(count, min=eps)


def masked_max(x: torch.Tensor, mask: torch.Tensor,
               axis: int = -2) -> torch.Tensor:
    """Max over valid rows; all-padding gives 0."""
    filled = torch.where(mask.unsqueeze(-1), x,
                         torch.full((), _NEG_INF, dtype=x.dtype,
                                    device=x.device))
    out = torch.amax(filled, dim=axis)
    any_valid = torch.any(mask, dim=-1, keepdim=True)
    return torch.where(any_valid, out, torch.zeros_like(out))


GLOBAL_POOL = {
    "sum": masked_sum,
    "add": masked_sum,
    "mean": masked_mean,
    "avg": masked_mean,
    "max": masked_max,
}


def masked_moments(x: torch.Tensor, mask: torch.Tensor, axes,
                   eps: float = 1e-12):
    """Per-channel (mean [C], var [C], count []) over all valid rows of the
    given axes; x [..., C], mask broadcastable to x[..., 0]. Under a
    process group (`parallel`) the rows are the global batch's, as the JAX
    mesh step computes them over the whole sharded batch: two
    differentiable SUMs over ranks, of (sum m*x, sum m) for the mean, then
    of sum m*(x - mean)^2 for the centred variance; the clamp applies to
    the global count."""
    m = mask.unsqueeze(-1).to(x.dtype)
    s = all_reduce_sum(torch.cat([torch.sum(x * m, dim=axes),
                                  torch.sum(m, dim=axes).reshape(1)]))
    count = torch.clamp(s[-1], min=eps)
    mean = s[:-1] / count
    var = all_reduce_sum(torch.sum(torch.square(x - mean) * m,
                                   dim=axes)) / count
    return mean, var, count
