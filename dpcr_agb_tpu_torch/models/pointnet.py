"""MPointNet, the paper's "PointNet" row (counterpart of `MPointNet` in
`dpcr_agb_tpu/models/pointnet.py`): shared per-row MLPs 64/128/1024 over
the voxel rows, a masked global pool, MLPs 512/256, dropout and the
SeparateLinear head.

The rows are a padded [B, N, C] tensor with a validity mask: the shared
MLPs are batched matmuls, BN sees valid rows only, the global pool is a
masked reduction. The forward runs in f32, as the JAX model does (the
reference's custom_fwd(cast_inputs=float32)); the model has no bf16 form.
Submodule names are the flax ones (`b1_lin`, `b1_bn`, ..., `m2_bn`,
`final`), so `weights.from_flax` maps the parameters as they are. No hand
kernel runs on its path: it is plain PyTorch."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.blocks import ACTIVATIONS, Dropout, SeparateLinear, TorchLinear
from ..nn.norm import MaskedBatchNorm
from ..ops.masked import GLOBAL_POOL


class MPointNet(nn.Module):
    def __init__(self, num_reg_targets: int, in_channels: int,
                 activation: str = "gelu", global_pool: str = "sum",
                 embedding_channel: int = 1024, dropout: float = 0.0,
                 bn_momentum: float = 0.1, add_pos: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.pool = GLOBAL_POOL[global_pool]
        self.add_pos = add_pos
        width = in_channels + (3 if add_pos else 0)
        for name, out in (("b1", 64), ("b2", 128), ("b3", embedding_channel),
                          ("m1", 512), ("m2", 256)):
            self.add_module(f"{name}_lin", TorchLinear(
                width, out, use_bias=False, generator=generator))
            self.add_module(f"{name}_bn", MaskedBatchNorm(
                out, momentum=bn_momentum))
            width = out
        self.dropout = Dropout(dropout)
        self.final = SeparateLinear(width, num_reg_targets, generator)

    def _block(self, name: str, x: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
        x = getattr(self, f"{name}_lin")(x)
        return self.act(getattr(self, f"{name}_bn")(x, mask))

    def forward(self, batch, generator: Optional[torch.Generator] = None,
                return_point_features: bool = False) -> torch.Tensor:
        """batch: a `Batch` of tensors on one device -> raw head output
        [B, num_reg_targets] in f32; with `return_point_features`, the
        per-row embedding [B, N, embedding_channel] after the shared MLPs.
        `generator` draws the dropout coins in training."""
        mask = batch.mask
        h = batch.x.float()
        if self.add_pos:
            h = torch.cat([batch.pos.float(), h], -1)
        for name in ("b1", "b2", "b3"):
            h = self._block(name, h, mask)
        if return_point_features:
            return h
        g = self.pool(h, mask)                                 # [B, E]
        # the pooled MLPs' BN runs over the batch axis: every row is valid
        pooled_mask = torch.ones(g.shape[:-1], dtype=torch.bool,
                                 device=g.device)
        for name in ("m1", "m2"):
            g = self._block(name, g, pooled_mask)
        return self.final(self.dropout(g, generator))
