"""Train, eval and calibrate steps (counterpart of `make_train_step`,
`make_eval_step` and `StepRunner` in `dpcr_agb_tpu/training/step.py`).

One train step: forward in training mode (BN batch moments over occupied
cells and running-stat updates, DropPath from the runner's generator),
the standardized regression loss, the backward, the elementwise gradient
clip, then the optimizer update. PyTorch runs eagerly, so there is no
jitted program: the runner holds the model, the optimizer, a
`torch.Generator` on the model's device, and the step and sample counts."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.base import (InstanceSpec, compute_reg_loss, convert_outputs,
                           reg_output)


class StepRunner:
    """Binds a model, its task spec and its optimizer; counts optimizer
    updates (`step`) and samples seen (`num_samples`)."""

    def __init__(self, net: torch.nn.Module, spec: InstanceSpec,
                 optimizer: torch.optim.Optimizer,
                 grad_clip: Optional[float] = None, seed: int = 0):
        self.net = net
        self.spec = spec
        self.optimizer = optimizer
        self.grad_clip = grad_clip
        self.device = next(net.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0
        self.num_samples = 0

    def _outputs(self, raw: torch.Tensor, batch, training: bool
                 ) -> Dict[str, torch.Tensor]:
        reg_out = convert_outputs(self.spec, raw)
        loss = compute_reg_loss(self.spec, reg_out, batch.y_reg,
                                batch.y_reg_mask, training=training)
        return {"loss": loss, "reg_out": reg_out}

    def train(self, batch) -> Dict[str, torch.Tensor]:
        """One optimizer update on `batch` (a host or device `Batch`).
        Returns the loss and the de-standardized predictions; the gradients
        stay on the parameters until the next step."""
        batch = batch.to(self.device)
        self.net.train()
        self.optimizer.zero_grad(set_to_none=True)
        out = self._outputs(self.net(batch, generator=self.generator),
                            batch, training=True)
        out["loss"].backward()
        if self.grad_clip:
            torch.nn.utils.clip_grad_value_(self.net.parameters(),
                                            self.grad_clip)
        self.optimizer.step()
        self.step += 1
        self.num_samples += int(batch.mask.shape[0])
        return {"loss": out["loss"].detach(),
                "reg_out": reg_output(self.spec, out["reg_out"].detach())}

    @torch.no_grad()
    def evaluate(self, batch) -> Dict[str, torch.Tensor]:
        """Eval-mode forward and loss (running BN stats, no dropout)."""
        batch = batch.to(self.device)
        self.net.eval()
        out = self._outputs(self.net(batch), batch, training=False)
        return {"loss": out["loss"],
                "reg_out": reg_output(self.spec, out["reg_out"])}

    @torch.no_grad()
    def calibrate(self, batch) -> Dict[str, torch.Tensor]:
        """Training-mode forward without gradients: BN running stats follow
        the batch (calibrate_bn); DropPath stays live, as in JAX."""
        batch = batch.to(self.device)
        self.net.train()
        out = self._outputs(self.net(batch, generator=self.generator),
                            batch, training=False)
        self.net.eval()
        return {"loss": out["loss"],
                "reg_out": reg_output(self.spec, out["reg_out"])}
