"""Normalization over padded (masked) feature tensors (counterparts of
`MaskedBatchNorm`, `MaskedLayerNorm`, `MaskedInstanceNorm` and `MaskedGRN`
in `dpcr_agb_tpu/nn/norm.py`).

MaskedBatchNorm:
  * eval: running `mean`/`var` buffers (f32), applied in the activation
    dtype as (x - mean) * rsqrt(var + eps) * scale + bias, at every row
    (padding rows too: the caller masks downstream)
  * train: biased moments over valid rows only, in f32; the running stats
    follow the torch momentum convention with the unbiased variance
    (count clamped at 2)
  * under a process group (`parallel`), the moments are the global
    batch's (`masked_moments`) and the running stats take the global
    count, so they stay equal on every rank; this also holds for the
    train-mode forwards of calibrate and enable_bn. In bf16 the
    normalization's sums over the rows (its cotangents of the mean, the
    variance, scale and bias) are rounded once, after the SUM
    (`parallel.rounding.batch_norm`)
  * inside a rematerialized block the recompute leaves the running stats
    alone (`running_stats_frozen`): one forward, one momentum update"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..ops.masked import masked_moments
from ..parallel import all_reduce_sum
from ..parallel.rounding import batch_norm, sums_rounded_once

_FROZEN = [0]


@contextlib.contextmanager
def running_stats_frozen():
    """Train-mode MaskedBatchNorm forwards inside leave their running stats
    as they are (a rematerialized block's recompute in the backward)."""
    _FROZEN[0] += 1
    try:
        yield
    finally:
        _FROZEN[0] -= 1


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.1,
                 epsilon: float = 1e-5, affine: bool = True):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.scale = nn.Parameter(torch.ones(features)) if affine else None
        self.bias = nn.Parameter(torch.zeros(features)) if affine else None

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [..., C] (any leading axes), mask x.shape[:-1] bool."""
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean, var, count = masked_moments(x.float(), mask, axes)
            if not _FROZEN[0]:
                self._update_running_stats(mean, var, count)
        else:
            mean, var = self.mean, self.var
        dt = x.dtype
        if sums_rounded_once(dt):
            return batch_norm(x, mean, var, self.scale, self.bias,
                              self.epsilon)
        y = (x - mean.to(dt)) * torch.rsqrt(var.to(dt) + self.epsilon)
        if self.scale is not None:
            y = y * self.scale.to(dt) + self.bias.to(dt)
        return y

    @torch.no_grad()
    def _update_running_stats(self, mean, var, count):
        """The momentum update, with the unbiased variance (count clamped
        at 2)."""
        m = self.momentum
        n = torch.clamp(count, min=2.0)
        self.mean.mul_(1 - m).add_(m * mean)
        self.var.mul_(1 - m).add_(m * var * n / (n - 1.0))


class MaskedLayerNorm(nn.Module):
    """Per-row layer norm over the channels, in the activation dtype (as
    the JAX one computes it); padding rows come out as garbage and are
    masked downstream. No running stats."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.scale + self.bias


class MaskedInstanceNorm(nn.Module):
    """Per-sample, per-channel norm over the valid rows, in f32, cast back
    to the activation dtype: x [B, ..., C] with mask x.shape[:-1], the
    moments over every axis between the batch and the channels (the JAX
    one's rows of a [B, V, C] tensor; a dense volume's cells). No running
    stats."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(1, x.dim() - 1))
        m = mask.unsqueeze(-1).float()
        xf = x.float()
        count = torch.clamp(torch.sum(m, dim=axes, keepdim=True), min=1e-12)
        mean = torch.sum(xf * m, dim=axes, keepdim=True) / count
        var = torch.sum(torch.square(xf - mean) * m, dim=axes,
                        keepdim=True) / count
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.scale + self.bias).to(x.dtype)


class MaskedGRN(nn.Module):
    """Global response normalization over the valid rows: each channel's
    L2 norm over every row of the batch, divided by its mean over the
    channels, gates x as a learnable residual; zero at masked rows. No
    model of the JAX package builds it. Under a process group the sum of
    squares is the global batch's (a SUM over ranks)."""

    def __init__(self, features: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, features))
        self.beta = nn.Parameter(torch.zeros(1, features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask.unsqueeze(-1)
        xm = torch.where(m, x, torch.zeros_like(x))
        axes = tuple(range(x.dim() - 1))
        gx = torch.sqrt(all_reduce_sum(
            torch.sum(torch.square(xm), dim=axes, keepdim=True)))
        nx = gx / (torch.mean(gx, dim=-1, keepdim=True) + 1e-6)
        return torch.where(m, self.gamma * (x * nx) + self.beta + x,
                           torch.zeros_like(x))
