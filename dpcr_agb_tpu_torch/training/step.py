"""Train, eval and calibrate steps (counterpart of `make_train_step`,
`make_eval_step` and `StepRunner` in `dpcr_agb_tpu/training/step.py`).

One train step: forward in training mode (BN batch moments over occupied
cells and running-stat updates, DropPath from the runner's generator),
the standardized regression loss plus the terms the model recorded in
that forward (`internal_losses`: deformable KPConv's fitting and
repulsive regularizer, summed by module name as jax orders the sown
`losses` collection) plus the parameter regularizer of the model option
(`training/regularizers.py`), the backward, then the optimizer update
behind the elementwise gradient clip; with an `Accumulator` (gradient
accumulation) the update comes every k-th batch, from the mean gradient.
PyTorch runs eagerly, so there is no jitted program: the runner holds the
model, the optimizer, a `torch.Generator` on the model's device, and the
step, epoch and sample counts. Every step's outputs carry the batch's
per-sample metadata (`sample_meta`), as the JAX steps echo it, for the
trackers and the prediction writers. A batch copied to the card by
`data.batch.device_put` is waited for (`wait_ready`) before it is read.

Under a process group (`parallel`) each rank steps on its slice of the
global batch and the step gives the global batch's numbers, as the JAX
step over a mesh does: BN takes the global moments and the loss the
global target count (both through differentiable collectives), the
gradients are summed over ranks before the clip and the update, the
reported loss is the ranks' sum and the outputs' rows are gathered from
every rank. Explicit collectives rather than DistributedDataParallel:
DDP averages the gradients where the sum is the global loss's gradient,
broadcasts the buffers at every forward and orders its buckets its own
way."""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.batch import wait_ready
from ..models.base import (InstanceSpec, compute_reg_loss, convert_outputs,
                           reg_output)
from ..nn.blocks import Dropout
from ..parallel import (all_gather_rows, all_reduce_grads, all_reduce_sum,
                        world_size)
from ..weights import from_flax, to_flax
from .optim import Accumulator, jax_state, load_jax_state

log = logging.getLogger(__name__)

EVAL_SEED = 10_000_019


def _sample_meta(batch) -> Dict[str, Optional[torch.Tensor]]:
    return {"y_reg": batch.y_reg, "area_idx": batch.area_idx,
            "label_idx": batch.label_idx, "is_double": batch.is_double,
            "valid": batch.valid}


class StepRunner:
    """Binds a model, its task spec and its optimizer; counts optimizer
    updates (`step`), finished epochs (`epoch`) and samples seen
    (`num_samples`)."""

    def __init__(self, net: torch.nn.Module, spec: InstanceSpec,
                 optimizer: torch.optim.Optimizer,
                 grad_clip: Optional[float] = None, seed: int = 0,
                 accumulator: Optional[Accumulator] = None,
                 regularizer: Optional[Callable] = None):
        self.net = net
        self.regularizer = regularizer
        self.spec = spec
        self.optimizer = optimizer
        self.grad_clip = grad_clip
        self.accumulator = accumulator
        self.device = next(net.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0
        self.epoch = 0
        self.num_samples = 0

    def _outputs(self, raw: torch.Tensor, batch, training: bool
                 ) -> Dict[str, torch.Tensor]:
        reg_out = convert_outputs(self.spec, raw)
        loss = compute_reg_loss(self.spec, reg_out, batch.y_reg,
                                batch.y_reg_mask, training=training)
        return {"loss": loss, "reg_out": reg_out}

    def _result(self, out: Dict[str, torch.Tensor], batch) -> dict:
        """The step's outputs; under a process group the loss is the SUM
        of the ranks' (the global loss) and the rows are every rank's, in
        rank order (the global batch's)."""
        loss = all_reduce_sum(out["loss"].detach())
        meta = {k: all_gather_rows(v) for k, v in _sample_meta(batch).items()}
        return {"loss": loss, "loss_reg": loss,
                "reg_out": all_gather_rows(
                    reg_output(self.spec, out["reg_out"].detach())),
                "sample_meta": meta}

    def _on_device(self, batch):
        return wait_ready(batch.to(self.device))

    def train(self, batch) -> Dict[str, torch.Tensor]:
        """One train step on `batch` (a host or device `Batch`). Returns
        the loss and the de-standardized predictions; the gradients stay on
        the parameters until the next step."""
        batch = self._on_device(batch)
        self.net.train()
        self.optimizer.zero_grad(set_to_none=True)
        out = self._outputs(self.net(batch, generator=self.generator),
                            batch, training=True)
        # the model's terms (means over the batch's rows, equal row counts
        # on every rank) and the parameter penalty are global: each rank
        # adds 1/world of them, so the ranks' losses add up to them and
        # their gradients' SUM is their gradient
        terms = self.net.internal_losses() \
            if hasattr(self.net, "internal_losses") else {}
        if terms:
            out["loss"] = out["loss"] + sum(
                terms[k] for k in sorted(terms)) / world_size()
        if self.regularizer is not None:
            out["loss"] = out["loss"] + self.regularizer(
                dict(self.net.named_parameters())) / world_size()
        out["loss"].backward()
        params = [p for g in self.optimizer.param_groups
                  for p in g["params"]]
        # the global loss's gradient (the SUM of the ranks'), then the clip
        # and the update, as the JAX step clips the global gradient
        all_reduce_grads(params)
        if self.accumulator is None or self.accumulator.add(params):
            if self.grad_clip:
                torch.nn.utils.clip_grad_value_(params, self.grad_clip)
            self.optimizer.step()
        self.step += 1
        self.num_samples += int(batch.mask.shape[0]) * world_size()
        return self._result(out, batch)

    @torch.no_grad()
    def evaluate(self, batch, enable_dropout: bool = False,
                 rng_salt: int = 0, enable_bn: bool = False
                 ) -> Dict[str, torch.Tensor]:
        """Eval-mode forward and loss (running BN stats, no dropout).
        enable_dropout keeps the head Dropout live; enable_bn normalizes
        with the batch's own moments and leaves the running stats as they
        were. Both draw from a generator seeded by the salt."""
        batch = self._on_device(batch)
        gen = None
        if enable_dropout or enable_bn:
            gen = torch.Generator(device=self.device).manual_seed(
                EVAL_SEED + int(rng_salt))
        saved = None
        if enable_bn:
            saved = {k: v.clone() for k, v in self.net.named_buffers()}
            self.net.train()
        else:
            self.net.eval()
            if enable_dropout:
                for m in self.net.modules():
                    if isinstance(m, Dropout):
                        m.train()
        try:
            out = self._outputs(self.net(batch, generator=gen), batch,
                                training=False)
        finally:
            if saved is not None:
                for k, v in self.net.named_buffers():
                    v.copy_(saved[k])
            self.net.eval()
        return self._result(out, batch)

    @torch.no_grad()
    def calibrate(self, batch, salt: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
        """Training-mode forward without gradients: BN running stats follow
        the batch (calibrate_bn); DropPath stays live, as in JAX, drawing
        from the runner's generator or, with `salt`, from one seeded by
        it."""
        batch = self._on_device(batch)
        gen = self.generator if salt is None else torch.Generator(
            device=self.device).manual_seed(EVAL_SEED + int(salt))
        self.net.train()
        out = self._outputs(self.net(batch, generator=gen), batch,
                            training=False)
        self.net.eval()
        return self._result(out, batch)

    # -- state in the JAX package's checkpoint layout --------------------------
    def model_state(self) -> dict:
        """{"params", "batch_stats"} as flax nests them, numpy on the
        host."""
        params, stats = to_flax(self.net.state_dict())
        return {"params": params, "batch_stats": stats}

    def opt_state_leaves(self) -> list:
        named = dict(self.net.named_parameters())
        leaves = jax_state(self.optimizer, named)
        if self.accumulator is not None:
            leaves = self.accumulator.jax_leaves(leaves, named)
        return leaves

    def load_opt_state_leaves(self, leaves: list) -> None:
        named = dict(self.net.named_parameters())
        if self.accumulator is not None:
            leaves = self.accumulator.load_jax_leaves(list(leaves), named)
        load_jax_state(self.optimizer, named, list(leaves))

    def load_model_state(self, saved: dict) -> None:
        """Shape-checked partial load of a flax-layout model state: each
        variable whose saved shape matches is copied (cast to the model's
        dtype), the others keep their values with a warning."""
        current = self.net.state_dict()
        incoming = from_flax(saved.get("params", {}),
                             saved.get("batch_stats", {}))
        merged = {}
        for k, v in current.items():
            sv = incoming.get(k)
            if sv is not None and tuple(sv.shape) == tuple(v.shape):
                merged[k] = sv.to(v.dtype)
            else:
                if sv is not None:
                    log.warning(f"shape mismatch for {k}, keeping init")
                merged[k] = v
        self.net.load_state_dict(merged)


def host(tree):
    """Tensors of (nested dicts and lists of) step outputs as numpy arrays
    on the host."""
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree if tree is None else np.asarray(tree)
