"""Masked batch normalization (counterpart of `MaskedBatchNorm` in
`dpcr_agb_tpu/nn/norm.py`).

  * eval: running `mean`/`var` buffers (f32), applied in the activation
    dtype as (x - mean) * rsqrt(var + eps) * scale + bias, at every row
    (padding rows too: the caller masks downstream)
  * train: biased moments over valid rows only, in f32; the running stats
    follow the torch momentum convention with the unbiased variance
    (count clamped at 2)"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.masked import masked_moments


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
            with torch.no_grad():
                m = self.momentum
                n = torch.clamp(count, min=2.0)
                self.mean.mul_(1 - m).add_(m * mean)
                self.var.mul_(1 - m).add_(m * var * n / (n - 1.0))
        else:
            mean, var = self.mean, self.var
        dt = x.dtype
        y = (x - mean.to(dt)) * torch.rsqrt(var.to(dt) + self.epsilon)
        if self.scale is not None:
            y = y * self.scale.to(dt) + self.bias.to(dt)
        return y
