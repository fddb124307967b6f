"""SimplestNet, the repository's sanity model (counterpart of
`SimplestNet` in `dpcr_agb_tpu/models/simplestnet.py`): three pointwise
blocks (linear with bias, GELU in its tanh form, masked BN) of widths 64,
128 and 128 over [x, pos], a masked mean over the valid points and the
SeparateLinear head `head`. It runs in f32 on fixed-count point batches
(the `fixed_xy` preset: 12000 points, all valid) and has no bf16 form."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import SeparateLinear, TorchLinear
from ..nn.norm import MaskedBatchNorm
from ..ops.masked import masked_mean

WIDTHS = (64, 128, 128)


class SimplestNet(nn.Module):
    def __init__(self, num_reg_targets: int, in_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        width = in_channels + 3
        for i, out in enumerate(WIDTHS):
            self.add_module(f"conv{i}", TorchLinear(width, out,
                                                    generator=generator))
            self.add_module(f"bn{i}", MaskedBatchNorm(out))
            width = out
        self.head = SeparateLinear(width, num_reg_targets, generator)

    def forward(self, batch,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """batch: a `Batch` of tensors on one device -> raw head output
        [B, num_reg_targets] in f32. `generator` is unused: SimplestNet has
        no dropout."""
        del generator
        mask = batch.mask
        h = torch.cat([batch.x.float(), batch.pos.float()], -1)
        for i in range(len(WIDTHS)):
            h = F.gelu(getattr(self, f"conv{i}")(h), approximate="tanh")
            h = getattr(self, f"bn{i}")(h, mask)
        return self.head(masked_mean(h, mask))
