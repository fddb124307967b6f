"""Optimizer and LR schedules with the reference semantics (counterpart of
`dpcr_agb_tpu/training/optim.py`).

`AdaBelief` reproduces the JAX `adabelief` transform, quirks included:
  * eps is ADDED INTO the second-moment state every step
  * the rectified (RAdam-style) step size is computed in f32 with `expm1`,
    and steps whose num_sma is below 5 (the first five) take the SGD branch
  * weight decay is decoupled (update -= lr * wd * p) and applies to every
    parameter, BN scale and biases included
  * the lr of an update is the schedule at the count BEFORE the increment
A missing gradient counts as zero, as in JAX where every parameter has one.
The gradient clip of the recipe is an elementwise value clip
(`torch.nn.utils.clip_grad_value_`, optax.clip), applied before the
optimizer by the step runner.

The scalar arithmetic (bias corrections, rectification, schedules) runs in
numpy float32, operation by operation, as the JAX version runs it in f32.
Only the JAX `adabelief`'s default branches (the recipe's) and the
CosineAnnealingWarmRestarts and constant schedules are ported."""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

f32 = np.float32


class AdaBelief(torch.optim.Optimizer):
    """AdaBelief over `params` with lr = lr_fn(count), in the JAX
    `adabelief`'s default branches: rectified, degenerating to SGD while
    num_sma < 5, weight decay decoupled and scaled by the lr. The update
    count is kept per group as `count` (the JAX state's `count`); each
    parameter's state holds f32 `exp_avg` and `exp_avg_var`."""

    def __init__(self, params, lr_fn: Callable, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-16,
                 weight_decay: float = 0.0):
        defaults = dict(count=0, lr=float(lr_fn(0)), b1=b1, b2=b2, eps=eps,
                        weight_decay=weight_decay)
        super().__init__(params, defaults)
        self.lr_fn = lr_fn

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdaBelief.step takes no closure")
        for group in self.param_groups:
            self._step_group(group)

    def _step_group(self, group: dict) -> None:
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        count = group["count"]
        stepf = f32(count + 1)
        lr = f32(self.lr_fn(count))
        bc1 = f32(1.0) - f32(b1) ** stepf
        log_b2 = f32(math.log(b2))
        beta2_t = np.exp(stepf * log_b2)
        one_minus_beta2_t = -np.expm1(stepf * log_b2)
        sma_max = f32(2.0 / (1.0 - b2) - 1.0)
        sma = sma_max - f32(2.0) * stepf * beta2_t / one_minus_beta2_t
        adaptive = sma >= f32(5.0)
        if adaptive:
            rect = np.sqrt(max(
                one_minus_beta2_t * (sma - f32(4.0)) / (sma_max - f32(4.0))
                * (sma - f32(2.0)) / sma * sma_max / (sma_max - f32(2.0)),
                f32(0.0))) / bc1
            k = float(-rect * lr)
        else:
            k = float(-(f32(1.0) / bc1) * lr)
        decay = float(lr * f32(group["weight_decay"]))

        for p in group["params"]:
            g = (p.grad if p.grad is not None
                 else torch.zeros_like(p)).float()
            st = self.state[p]
            if not st:
                st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                st["exp_avg_var"] = torch.zeros_like(p, dtype=torch.float32)
            m = b1 * st["exp_avg"] + (1 - b1) * g
            s = b2 * st["exp_avg_var"] + (1 - b2) * torch.square(g - m) + eps
            u = k * m / (torch.sqrt(s) + eps) if adaptive else k * m
            if decay:
                u = u - decay * p.float()
            p.add_(u.to(p.dtype))
            st["exp_avg"], st["exp_avg_var"] = m, s
        group["count"] = count + 1
        group["lr"] = float(lr)


def cosine_annealing_warm_restarts(base_lr: float, T_0: int, T_mult: int = 1,
                                   eta_min: float = 0.0) -> Callable:
    """torch's CosineAnnealingWarmRestarts in closed form, in f32 (the
    paper's recipe: T_0 10, T_mult 2, stepped per batch)."""
    def sched(count):
        t = f32(count)
        if T_mult == 1:
            t_cur = np.mod(t, f32(T_0))
            t_i = f32(T_0)
        else:
            n = np.floor(np.log(t / f32(T_0) * f32(T_mult - 1) + f32(1))
                         / f32(math.log(T_mult)))
            start = f32(T_0) * (f32(T_mult) ** n - f32(1)) / f32(T_mult - 1)
            t_i = f32(T_0) * f32(T_mult) ** n
            t_cur = t - start
        return f32(eta_min) + f32(base_lr - eta_min) * (
            f32(1) + np.cos(f32(math.pi) * t_cur / t_i)) / f32(2)
    return sched


def constant(base_lr: float) -> Callable:
    return lambda count: f32(base_lr)


SCHEDULERS = {
    "CosineAnnealingWarmRestarts": cosine_annealing_warm_restarts,
    "constant": lambda base_lr, **p: constant(base_lr),
}


def make_lr_fn(scheduler_cfg: Optional[dict], base_lr: float,
               update_on: str = "on_epoch", batches_per_epoch: int = 1,
               batch_size: int = 1, steps_per_update: int = 1) -> Callable:
    """lr(update_count) under the scheduler's update policy: stepped once
    per epoch (on_epoch), batch (on_num_batch) or sample (on_num_sample)."""
    if scheduler_cfg is None:
        return constant(base_lr)
    name = scheduler_cfg.get("class", "constant")
    if name not in SCHEDULERS:
        raise NotImplementedError(
            f"scheduler {name!r} is not ported yet (ported: "
            f"{sorted(SCHEDULERS)})")
    params = {k: v for k, v in (scheduler_cfg.get("params") or {}).items()
              if k != "lr"}
    sched = SCHEDULERS[name](base_lr, **params)
    if update_on == "on_num_batch":
        scale = steps_per_update
    elif update_on == "on_num_sample":
        scale = batch_size
    else:
        scale = None

    def lr_fn(count):
        if scale is None:
            return sched(int(count) // max(batches_per_epoch, 1))
        return sched(int(count) * scale)
    return lr_fn


def bn_momentum_fn(bn_scheduler_cfg: Optional[dict]) -> Optional[Callable]:
    """BN momentum schedule: clip(bn_momentum * bn_decay^(epoch //
    decay_step), bn_clip)."""
    if not bn_scheduler_cfg:
        return None
    params = bn_scheduler_cfg["params"]
    m0 = params.get("bn_momentum", 0.1)
    decay = params.get("bn_decay", 0.9)
    step = params.get("decay_step", 10)
    clip = params.get("bn_clip", 1e-2)

    def fn(epoch):
        return max(m0 * decay ** (int(epoch) // int(step)), clip)
    return fn
