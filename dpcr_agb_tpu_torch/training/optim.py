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

`SGD`, `Adam` and `AdamW` are the optax chains that the JAX trainer builds
for those `training.optim.optimizer.class` names (optax.sgd behind
add_decayed_weights, optax.adam, optax.adamw with its defaults), the lr
again a function of the update count. `jax_state` / `load_jax_state` give
and take each optimizer's state as the leaves of the JAX trainer's optax
state in tree order (the `.ckpt` layout), and `Accumulator` is
optax.MultiSteps (gradient accumulation): it averages the gradients of k
batches and steps once.

The scalar arithmetic (bias corrections, rectification, schedules) runs in
numpy float32, operation by operation, as the JAX version runs it in f32.
Every schedule of `conf/lr_scheduler/` is ported; ReduceLROnPlateau is a
constant here and the trainer scales it by the selection stage's loss.
Only the JAX `adabelief`'s default branches (the recipe's) are ported."""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

f32 = np.float32


class AdaBelief(torch.optim.Optimizer):
    """AdaBelief over `params` with lr = lr_fn(count), in the JAX
    `adabelief`'s default branches: rectified, degenerating to SGD while
    num_sma < 5, weight decay decoupled and scaled by the lr. The update
    count is kept per group as `count` (the JAX state's `count`); each
    parameter's state holds f32 `exp_avg` and `exp_avg_var`."""

    STATE = ("count", "exp_avg", "exp_avg_var")

    def __init__(self, params, lr_fn: Callable, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-16,
                 weight_decay: float = 0.0, decoupled_decay: bool = True,
                 fixed_decay: bool = False, rectify: bool = True,
                 degenerated_to_sgd: bool = True):
        if not (decoupled_decay and rectify and degenerated_to_sgd) \
                or fixed_decay:
            raise NotImplementedError(
                "AdaBelief: only the default branches are ported "
                "(decoupled, rectified, degenerating to SGD, lr-scaled "
                "decay)")
        defaults = dict(count=0, lr=float(lr_fn(0)), b1=b1, b2=b2, eps=eps,
                        weight_decay=float(weight_decay))
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


class _Scheduled(torch.optim.Optimizer):
    """An optimizer whose lr is lr_fn(update count), the count kept per
    group as `count`."""

    def __init__(self, params, lr_fn: Callable, **defaults):
        super().__init__(params, dict(count=0, lr=float(lr_fn(0)),
                                      **defaults))
        self.lr_fn = lr_fn

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__}.step takes no closure")
        for group in self.param_groups:
            lr = f32(self.lr_fn(group["count"]))
            self._step_group(group, lr)
            group["count"] += 1
            group["lr"] = float(lr)


class SGD(_Scheduled):
    """optax.sgd(lr_fn, momentum) behind add_decayed_weights(weight_decay):
    g' = g + wd * p; trace = g' + momentum * trace; p -= lr * trace."""

    STATE = ("trace", "count")

    def __init__(self, params, lr_fn: Callable, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(params, lr_fn, momentum=float(momentum),
                         weight_decay=float(weight_decay))

    def _step_group(self, group: dict, lr) -> None:
        for p in group["params"]:
            g = (p.grad if p.grad is not None
                 else torch.zeros_like(p)).float()
            if group["weight_decay"]:
                g = g + group["weight_decay"] * p.float()
            st = self.state[p]
            if not st:
                st["trace"] = torch.zeros_like(p, dtype=torch.float32)
            t = g + group["momentum"] * st["trace"]
            st["trace"] = t
            p.add_((-lr * t).to(p.dtype))


class Adam(_Scheduled):
    """optax.adam (b1 0.9, b2 0.999, eps 1e-8) then -lr; `weight_decay`
    adds wd * p to the update before the lr (optax.adamw)."""

    STATE = ("count", "mu", "nu", "count")

    def __init__(self, params, lr_fn: Callable, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, lr_fn, b1=b1, b2=b2, eps=eps,
                         weight_decay=float(weight_decay))

    def _step_group(self, group: dict, lr) -> None:
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        t = f32(group["count"] + 1)
        bc1 = f32(1) - f32(b1) ** t
        bc2 = f32(1) - f32(b2) ** t
        for p in group["params"]:
            g = (p.grad if p.grad is not None
                 else torch.zeros_like(p)).float()
            st = self.state[p]
            if not st:
                st["mu"] = torch.zeros_like(p, dtype=torch.float32)
                st["nu"] = torch.zeros_like(p, dtype=torch.float32)
            mu = (1 - b1) * g + b1 * st["mu"]
            nu = (1 - b2) * torch.square(g) + b2 * st["nu"]
            u = (mu / float(bc1)) / (torch.sqrt(nu / float(bc2)) + eps)
            if group["weight_decay"]:
                u = u + group["weight_decay"] * p.float()
            p.add_((-lr * u).to(p.dtype))
            st["mu"], st["nu"] = mu, nu


class AdamW(Adam):
    """optax.adamw: Adam with decoupled weight decay (optax's default
    1e-4)."""

    def __init__(self, params, lr_fn: Callable, weight_decay: float = 1e-4,
                 **kw):
        super().__init__(params, lr_fn, weight_decay=weight_decay, **kw)


OPTIMIZERS = {"adabelief": AdaBelief, "sgd": SGD, "adam": Adam,
              "adamw": AdamW}


def make_optimizer(name: str, params, lr_fn: Callable,
                   options: dict) -> torch.optim.Optimizer:
    """The optimizer a `training.optim.optimizer` entry names, with the
    keyword options the JAX trainer passes on (its `lr` dropped): SGD takes
    momentum and weight_decay, AdamW weight_decay, Adam none."""
    key = name.lower()
    if key not in OPTIMIZERS:
        raise ValueError(f"Unknown optimizer: {name}")
    options = {k: v for k, v in options.items() if k != "lr"}
    if key == "sgd":
        options = {k: options[k] for k in ("momentum", "weight_decay")
                   if k in options}
    elif key == "adam":
        options = {}
    elif key == "adamw":
        options = {k: options[k] for k in ("weight_decay",) if k in options}
    return OPTIMIZERS[key](params, lr_fn, **options)


def jax_state(opt: torch.optim.Optimizer,
              named_params: Dict[str, torch.Tensor]) -> List[np.ndarray]:
    """The optimizer's state as the leaves of the JAX trainer's optax
    state, in tree order: per-parameter slots in the order of the flax
    paths (sorted level by level), counts as int32 scalars."""
    order = _jax_order(named_params)
    count = np.asarray(opt.param_groups[0]["count"], np.int32)
    leaves: List[np.ndarray] = []
    for slot in type(opt).STATE:
        if slot == "count":
            leaves.append(count.copy())
            continue
        for name in order:
            p = named_params[name]
            st = opt.state.get(p) or {}
            t = st.get(slot)
            leaves.append(np.zeros(tuple(p.shape), np.float32) if t is None
                          else t.detach().cpu().numpy().astype(np.float32))
    return leaves


def load_jax_state(opt: torch.optim.Optimizer,
                   named_params: Dict[str, torch.Tensor],
                   leaves: List) -> None:
    """Set the optimizer's state from `jax_state`'s leaves."""
    order = _jax_order(named_params)
    slots = type(opt).STATE
    want = sum(1 if s == "count" else len(order) for s in slots)
    if len(leaves) != want:
        raise ValueError(f"optimizer state mismatch: {len(leaves)} saved vs "
                         f"{want} expected for {type(opt).__name__}")
    it = iter(leaves)
    count = None
    for slot in slots:
        if slot == "count":
            count = int(np.asarray(next(it)))
            continue
        for name in order:
            p = named_params[name]
            opt.state[p][slot] = torch.as_tensor(
                np.asarray(next(it), np.float32)).reshape(p.shape).to(
                p.device)
    for group in opt.param_groups:
        group["count"] = count


def _jax_order(named_params: Dict[str, torch.Tensor]) -> List[str]:
    """Parameter names in the order jax flattens the flax params dict."""
    return sorted(named_params, key=lambda n: n.split("."))


class Accumulator:
    """optax.MultiSteps(every_k): each call adds a batch's gradients into a
    running mean; the k-th sets them as the gradients and returns True (the
    caller clips and steps), the others return False and the parameters
    stay. Its JAX leaves are [mini_step, gradient_step, *inner, *acc]."""

    def __init__(self, every_k: int):
        self.every_k = int(every_k)
        self.mini_step = 0
        self.gradient_step = 0
        self.acc: Dict[torch.Tensor, torch.Tensor] = {}

    def add(self, params: List[torch.Tensor]) -> bool:
        n = self.mini_step
        for p in params:
            g = (p.grad if p.grad is not None
                 else torch.zeros_like(p)).float()
            acc = self.acc.get(p)
            if acc is None:
                acc = torch.zeros_like(p, dtype=torch.float32)
            self.acc[p] = acc + (g - acc) / (n + 1)
        if n + 1 < self.every_k:
            self.mini_step = n + 1
            return False
        for p in params:
            p.grad = self.acc[p].to(p.dtype)
            self.acc[p] = torch.zeros_like(self.acc[p])
        self.mini_step = 0
        self.gradient_step += 1
        return True

    def jax_leaves(self, inner: List[np.ndarray],
                   named_params: Dict[str, torch.Tensor]) -> List:
        acc = [self.acc[named_params[n]].cpu().numpy()
               if named_params[n] in self.acc
               else np.zeros(tuple(named_params[n].shape), np.float32)
               for n in _jax_order(named_params)]
        return [np.asarray(self.mini_step, np.int32),
                np.asarray(self.gradient_step, np.int32), *inner, *acc]

    def load_jax_leaves(self, leaves: List,
                        named_params: Dict[str, torch.Tensor]) -> List:
        """Restore the counters and sums; returns the inner leaves."""
        order = _jax_order(named_params)
        self.mini_step = int(np.asarray(leaves[0]))
        self.gradient_step = int(np.asarray(leaves[1]))
        acc = leaves[len(leaves) - len(order):]
        for n, a in zip(order, acc):
            p = named_params[n]
            self.acc[p] = torch.as_tensor(np.asarray(a, np.float32)).reshape(
                p.shape).to(p.device)
        return list(leaves[2:len(leaves) - len(order)])


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


def cosine_annealing(base_lr: float, T_max: int,
                     eta_min: float = 0.0) -> Callable:
    def sched(count):
        t = f32(count)
        return f32(eta_min) + f32(base_lr - eta_min) * (
            f32(1) + np.cos(f32(math.pi) * t / f32(T_max))) / f32(2)
    return sched


def exponential(base_lr: float, gamma: float) -> Callable:
    return lambda count: f32(base_lr) * f32(gamma) ** f32(count)


def step_lr(base_lr: float, step_size: int, gamma: float = 0.1) -> Callable:
    return lambda count: f32(base_lr) * f32(gamma) ** np.floor(
        f32(count) / f32(step_size))


def multi_step(base_lr: float, milestones, gamma: float = 0.1) -> Callable:
    ms = np.asarray(sorted(milestones), np.float32)

    def sched(count):
        passed = np.int32(np.sum(f32(count) >= ms))
        return f32(base_lr) * f32(gamma) ** passed
    return sched


def poly_lr(base_lr: float, max_iter: int, power: float = 0.9) -> Callable:
    def sched(count):
        t = np.minimum(f32(count), f32(max_iter))
        return f32(base_lr) * (f32(1) - t / f32(max_iter)) ** f32(power)
    return sched


def squared_lr(base_lr: float, max_iter: int) -> Callable:
    return poly_lr(base_lr, max_iter, power=2.0)


def linear_warmup_cosine_annealing(base_lr: float, warmup_epochs: int,
                                   max_epochs: int,
                                   warmup_start_lr: float = 0.0,
                                   eta_min: float = 0.0) -> Callable:
    def sched(count):
        t = f32(count)
        if t < f32(warmup_epochs):
            return f32(warmup_start_lr) + t * f32(
                base_lr - warmup_start_lr) / f32(max(warmup_epochs, 1))
        return f32(eta_min) + f32(base_lr - eta_min) * (f32(1) + np.cos(
            f32(math.pi) * (t - f32(warmup_epochs))
            / f32(max(max_epochs - warmup_epochs, 1)))) / f32(2)
    return sched


def cyclic_lr(base_lr: float, max_lr: float, step_size_up: int = 2000,
              step_size_down: Optional[int] = None) -> Callable:
    """torch's CyclicLR in its 'triangular' mode."""
    down = step_size_down or step_size_up
    period = step_size_up + down

    def sched(count):
        t = np.mod(f32(count), f32(period))
        if t < f32(step_size_up):
            frac = t / f32(step_size_up)
        else:
            frac = f32(1) - (t - f32(step_size_up)) / f32(down)
        return f32(base_lr) + f32(max_lr - base_lr) * frac
    return sched


def constant(base_lr: float) -> Callable:
    return lambda count: f32(base_lr)


SCHEDULERS = {
    "CosineAnnealingWarmRestarts": cosine_annealing_warm_restarts,
    "CosineAnnealingLR": cosine_annealing,
    "ExponentialLR": exponential,
    "StepLR": step_lr,
    "MultiStepLR": multi_step,
    "PolyLR": poly_lr,
    "SquaredLR": squared_lr,
    "LinearWarmupCosineAnnealingLR": linear_warmup_cosine_annealing,
    "CyclicLR": lambda base_lr, **p: cyclic_lr(p.pop("base_lr", base_lr),
                                               **p),
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
    if name == "ReduceLROnPlateau":
        # metric-driven: the trainer scales the lr (Trainer._apply_plateau)
        return constant(base_lr)
    if name not in SCHEDULERS:
        raise ValueError(f"Unknown scheduler {name!r} (known: "
                         f"{sorted(SCHEDULERS)}, ReduceLROnPlateau)")
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
