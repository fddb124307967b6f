"""Shared network blocks (counterpart of `dpcr_agb_tpu/nn/blocks.py`):
activations, linear layers, the squeeze-excite layer and stochastic depth.

Parameter names and layouts follow the flax modules so that the weight
bridge (`dpcr_agb_tpu_torch/weights.py`) is a rename: a linear kernel is
[in, out]."""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masked import masked_mean

# jax.nn.gelu defaults to the tanh approximation; celu uses alpha=0.54
ACTIVATIONS = {
    "relu": F.relu,
    "celu": lambda x: F.celu(x, alpha=0.54),
    "silu": F.silu,
    "swish": F.silu,
    "elu": F.elu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "lrelu": lambda x: F.leaky_relu(x, 0.01),
}


def trunc_normal_(t: torch.Tensor, std: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Normal(0, std) truncated at +-2 std."""
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class TorchLinear(nn.Module):
    """Dense layer, kernel [in, out]; default init is torch nn.Linear's
    (U(+-1/sqrt(fan_in)) on kernel and bias)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None,
                 trunc_std: Optional[float] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = (nn.Parameter(torch.empty(features)) if use_bias
                     else None)
        with torch.no_grad():
            if trunc_std is not None:      # trunc_normal kernel, zero bias
                trunc_normal_(self.kernel, trunc_std, generator)
                if self.bias is not None:
                    self.bias.zero_()
            else:
                bound = 1.0 / in_features ** 0.5 if in_features > 0 else 0.0
                self.kernel.uniform_(-bound, bound, generator=generator)
                if self.bias is not None:
                    self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class SeparateLinear(nn.Module):
    """One independent Linear(in, 1) per regression target (`linear_{i}`),
    trunc_normal(0.02) kernels and zero biases, concatenated."""

    def __init__(self, in_features: int, num_targets: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_targets = num_targets
        for i in range(num_targets):
            self.add_module(f"linear_{i}", TorchLinear(
                in_features, 1, generator=generator, trunc_std=0.02))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([getattr(self, f"linear_{i}")(x)
                          for i in range(self.num_targets)], dim=-1)


class SELayer(nn.Module):
    """Squeeze-excite over valid rows, in f32: masked mean -> fc1 (C ->
    C/reduction) -> act -> fc2 -> sigmoid -> broadcast multiply."""

    def __init__(self, channels: int, act: Callable, reduction: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = act
        self.fc1 = TorchLinear(channels, channels // reduction,
                               generator=generator)
        self.fc2 = TorchLinear(channels // reduction, channels,
                               generator=generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [..., N, C], mask [..., N]."""
        xf = x.float()
        y = torch.sigmoid(self.fc2(self.act(self.fc1(masked_mean(xf, mask)))))
        return (xf * y.unsqueeze(-2)).to(x.dtype)


def _keep_mask(shape, keep: float, generator: Optional[torch.Generator],
               device: torch.device) -> torch.Tensor:
    """Bernoulli(keep) coins drawn from the caller's generator."""
    if generator is None:
        raise ValueError("a training-mode dropout needs the caller's "
                         "torch.Generator (forward(..., generator=g))")
    return torch.rand(shape, generator=generator, device=device) < keep


class DropPath(nn.Module):
    """Per-sample stochastic depth: drops a sample's whole residual branch
    with prob `rate` in training and rescales survivors by 1/keep; identity
    in eval. The coins come from the generator the caller passes."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        coin = _keep_mask(shape, keep, generator, x.device)
        return torch.where(coin, x / keep, torch.zeros_like(x))


class Dropout(nn.Module):
    """Elementwise dropout in training, survivors rescaled by 1/keep;
    identity in eval. The coins come from the generator the caller
    passes."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        coin = _keep_mask(x.shape, keep, generator, x.device)
        return torch.where(coin, x / keep, torch.zeros_like(x))
