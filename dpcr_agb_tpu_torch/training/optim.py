"""Optimizer and LR schedules with the reference semantics (counterpart of
`dpcr_agb_tpu/training/optim.py`).

`AdaBelief` reproduces the JAX `adabelief` transform, quirks included:
  * eps is ADDED INTO the second-moment state every step
  * the rectified (RAdam-style) step size is computed in f32 with `expm1`,
    and steps whose num_sma is below 5 (the first five) take the SGD branch
    (or no step, with degenerated_to_sgd=False); unrectified, the second
    moment is bias-corrected by 1 - b2^t
  * weight decay is decoupled (update -= lr * wd * p, or wd * p with
    fixed_decay) and applies to every parameter, BN scale and biases
    included; decoupled_decay=False applies none, as in JAX
  * the lr of an update is the schedule at the count BEFORE the increment
A missing gradient counts as zero, as in JAX where every parameter has one.
The gradient clip of the recipe is an elementwise value clip
(`torch.nn.utils.clip_grad_value_`, optax.clip), applied before the
optimizer by the step runner.

`SGD`, `Adam` and `AdamW` are the optax chains that the JAX trainer builds
for those `training.optim.optimizer.class` names (optax.sgd behind
add_decayed_weights, optax.adam, optax.adamw with its defaults), the lr
again a function of the update count. `MultiTransform` is the JAX
trainer's optax.multi_transform of per-group settings (the model option's
`head_optim_settings` and `backbone_optim_settings`): the parameters
whose path names `head_namespace` form the `head` group, the rest the
`backbone`, each with its own optimizer. `jax_state` / `load_jax_state`
give and take an optimizer's state as the leaves of the JAX trainer's
optax state in tree order (the `.ckpt` layout), and `Accumulator` is
optax.MultiSteps (gradient accumulation): it averages the gradients of k
batches and steps once.

The scalar arithmetic (bias corrections, rectification, schedules) runs in
numpy float32, operation by operation, as the JAX version runs it in f32.
Every schedule of `conf/lr_scheduler/` is ported; ReduceLROnPlateau is a
constant here and the trainer scales it by the selection stage's loss."""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

f32 = np.float32


class _JaxState:
    """An optimizer's state as the JAX trainer's optax leaves (`jax_state`,
    `load_jax_state`) and as `weights.opt_state_from_optax`'s named form
    (`load_named`); `MultiTransform` offers the same three."""

    def jax_state(self, named_params: Dict[str, torch.Tensor]
                  ) -> List[np.ndarray]:
        order = _jax_order(named_params)
        count = np.asarray(self.param_groups[0]["count"], np.int32)
        leaves: List[np.ndarray] = []
        for slot in type(self).STATE:
            if slot == "count":
                leaves.append(count.copy())
                continue
            for name in order:
                p = named_params[name]
                t = (self.state.get(p) or {}).get(slot)
                leaves.append(
                    np.zeros(tuple(p.shape), np.float32) if t is None
                    else t.detach().cpu().numpy().astype(np.float32))
        return leaves

    def n_leaves(self, n_params: int) -> int:
        return sum(1 if s == "count" else n_params for s in type(self).STATE)

    def load_jax_state(self, named_params: Dict[str, torch.Tensor],
                       leaves: List) -> None:
        order = _jax_order(named_params)
        want = self.n_leaves(len(order))
        if len(leaves) != want:
            raise ValueError(f"optimizer state mismatch: {len(leaves)} saved "
                             f"vs {want} expected for {type(self).__name__}")
        it = iter(leaves)
        count = None
        for slot in type(self).STATE:
            if slot == "count":
                count = int(np.asarray(next(it)))
                continue
            for name in order:
                p = named_params[name]
                self.state[p][slot] = torch.as_tensor(
                    np.asarray(next(it), np.float32)).reshape(p.shape).to(
                    p.device)
        for group in self.param_groups:
            group["count"] = count

    def load_named(self, named_params: Dict[str, torch.Tensor],
                   named: dict) -> None:
        """The AdaBelief state from {"count", "exp_avg": {name: tensor},
        "exp_avg_var": {name: tensor}} keyed by parameter name."""
        if set(named["exp_avg"]) != set(named_params):
            raise ValueError(
                f"optimizer state names differ from the model's parameters: "
                f"{sorted(set(named['exp_avg']) ^ set(named_params))[:8]}")
        for name, p in named_params.items():
            self.state[p] = {
                k: named[k][name].to(p.device, torch.float32).reshape(p.shape)
                for k in ("exp_avg", "exp_avg_var")}
        for group in self.param_groups:
            group["count"] = int(named["count"])


class AdaBelief(_JaxState, torch.optim.Optimizer):
    """AdaBelief over `params` with lr = lr_fn(count), in every branch of
    the JAX `adabelief`: rectified or not (`rectify`), the rectified steps
    whose num_sma is below 5 taking the SGD step or none
    (`degenerated_to_sgd`), and weight decay decoupled and scaled by the
    lr, or fixed (`fixed_decay`), or, with decoupled_decay=False, not
    applied at all (the JAX transform leaves L2 to a caller that never
    adds it). The update count is kept per group as `count` (the JAX
    state's `count`); each parameter's state holds f32 `exp_avg` and
    `exp_avg_var`."""

    STATE = ("count", "exp_avg", "exp_avg_var")

    def __init__(self, params, lr_fn: Callable, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-16,
                 weight_decay: float = 0.0, decoupled_decay: bool = True,
                 fixed_decay: bool = False, rectify: bool = True,
                 degenerated_to_sgd: bool = True):
        defaults = dict(count=0, lr=float(lr_fn(0)), b1=b1, b2=b2, eps=eps,
                        weight_decay=float(weight_decay))
        super().__init__(params, defaults)
        self.lr_fn = lr_fn
        self.decoupled_decay = bool(decoupled_decay)
        self.fixed_decay = bool(fixed_decay)
        self.rectify = bool(rectify)
        self.degenerated_to_sgd = bool(degenerated_to_sgd)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdaBelief.step takes no closure")
        for group in self.param_groups:
            self._step_group(group)

    def _scale(self, b1: float, b2: float, count: int, lr):
        """(k, sqrt_bc2): the update of a parameter is k * m / (sqrt(s) /
        sqrt_bc2 + eps), the division left out where sqrt_bc2 is 1 (the
        rectified branch has none), or k * m when sqrt_bc2 is None (the
        SGD step)."""
        stepf = f32(count + 1)
        bc1 = f32(1.0) - f32(b1) ** stepf
        if not self.rectify:
            bc2 = f32(1.0) - f32(b2) ** stepf
            return float(-(lr / bc1)), float(np.sqrt(bc2))
        log_b2 = f32(math.log(b2))
        beta2_t = np.exp(stepf * log_b2)
        one_minus_beta2_t = -np.expm1(stepf * log_b2)
        sma_max = f32(2.0 / (1.0 - b2) - 1.0)
        sma = sma_max - f32(2.0) * stepf * beta2_t / one_minus_beta2_t
        if sma >= f32(5.0):
            rect = np.sqrt(max(
                one_minus_beta2_t * (sma - f32(4.0)) / (sma_max - f32(4.0))
                * (sma - f32(2.0)) / sma * sma_max / (sma_max - f32(2.0)),
                f32(0.0))) / bc1
            return float(-rect * lr), 1.0
        if self.degenerated_to_sgd:
            return float(-(f32(1.0) / bc1) * lr), None
        return -0.0, None   # JAX's -0.0 * lr * m: the zero's sign too

    def _step_group(self, group: dict) -> None:
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        count = group["count"]
        lr = f32(self.lr_fn(count))
        k, sqrt_bc2 = self._scale(b1, b2, count, lr)
        wd = f32(group["weight_decay"])
        decay = 0.0
        if self.decoupled_decay:
            decay = float(wd if self.fixed_decay else lr * wd)

        for p in group["params"]:
            g = (p.grad if p.grad is not None
                 else torch.zeros_like(p)).float()
            st = self.state[p]
            if not st:
                st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                st["exp_avg_var"] = torch.zeros_like(p, dtype=torch.float32)
            m = b1 * st["exp_avg"] + (1 - b1) * g
            s = b2 * st["exp_avg_var"] + (1 - b2) * torch.square(g - m) + eps
            if sqrt_bc2 is None:
                u = k * m
            else:
                r = torch.sqrt(s)
                u = k * m / ((r if sqrt_bc2 == 1.0 else r / sqrt_bc2) + eps)
            if decay:
                u = u - decay * p.float()
            p.add_(u.to(p.dtype))
            st["exp_avg"], st["exp_avg_var"] = m, s
        group["count"] = count + 1
        group["lr"] = float(lr)


class _Scheduled(_JaxState, torch.optim.Optimizer):
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


GROUPS = ("backbone", "head")


def group_of(name: str, head_namespace: str) -> str:
    """The group of a parameter: `head` when a part of its path (its
    `state_dict` key split at the dots, the flax path with the leaf's
    name) contains head_namespace, else `backbone`."""
    return "head" if any(head_namespace in p for p in name.split(".")) \
        else "backbone"


class MultiTransform:
    """optax.multi_transform over the `backbone` and `head` groups: one
    optimizer a group, each with its own settings and update count. It
    offers what the step runner and the checkpoints use of an optimizer:
    `param_groups` (both groups' in GROUPS order), `zero_grad`, `step`,
    `state_dict` and `load_state_dict` (a dict of the two)."""

    def __init__(self, optimizers: Dict[str, torch.optim.Optimizer],
                 names: Dict[str, List[str]], scheduled: List[str]):
        self.optimizers = optimizers
        self.names = names          # group -> its parameters' names
        self.scheduled = scheduled  # groups whose lr follows the schedule

    @property
    def param_groups(self) -> list:
        return [g for k in GROUPS for g in self.optimizers[k].param_groups]

    def zero_grad(self, set_to_none: bool = True) -> None:
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        for k in GROUPS:
            self.optimizers[k].step()

    def state_dict(self) -> dict:
        return {k: self.optimizers[k].state_dict() for k in GROUPS}

    def load_state_dict(self, state: dict) -> None:
        for k in GROUPS:
            self.optimizers[k].load_state_dict(state[k])

    def _own(self, k: str, named_params: Dict[str, torch.Tensor]) -> dict:
        return {n: named_params[n] for n in self.names[k]}

    def jax_state(self, named_params: Dict[str, torch.Tensor]
                  ) -> List[np.ndarray]:
        """The groups' chains one after the other in sorted order
        (`backbone`, `head`), each over its own parameters only (optax's
        masked leaves carry none of the other group's)."""
        return [leaf for k in GROUPS for leaf in
                self.optimizers[k].jax_state(self._own(k, named_params))]

    def load_jax_state(self, named_params: Dict[str, torch.Tensor],
                       leaves: List) -> None:
        leaves = list(leaves)
        sizes = {k: self.optimizers[k].n_leaves(len(self.names[k]))
                 for k in GROUPS}
        if len(leaves) != sum(sizes.values()):
            raise ValueError(f"optimizer state mismatch: {len(leaves)} "
                             f"saved vs {sum(sizes.values())} expected for "
                             f"the backbone and head groups")
        start = 0
        for k in GROUPS:
            self.optimizers[k].load_jax_state(
                self._own(k, named_params), leaves[start:start + sizes[k]])
            start += sizes[k]

    def load_named(self, named_params: Dict[str, torch.Tensor],
                   named: dict) -> None:
        """{group: the named form over the group's parameters}."""
        for k in GROUPS:
            self.optimizers[k].load_named(self._own(k, named_params),
                                          named[k])

    @property
    def lr_fn(self) -> Optional[Callable]:
        """The schedule of the groups that follow one (None when both set
        their own `lr`)."""
        return self.optimizers[self.scheduled[0]].lr_fn \
            if self.scheduled else None

    @lr_fn.setter
    def lr_fn(self, lr_fn: Callable) -> None:
        """A new schedule (the plateau's scale) for the groups that follow
        one; a group with its own `lr` keeps its constant."""
        for k in self.scheduled:
            self.optimizers[k].lr_fn = lr_fn


def make_grouped_optimizer(name: str,
                           named_params: Dict[str, torch.Tensor],
                           lr_fn: Callable, options: dict,
                           head_settings: dict, backbone_settings: dict,
                           head_namespace: str = "final") -> MultiTransform:
    """The JAX trainer's per-group optimizer: each group gets the
    optimizer `name` with `options` overridden by its settings; a group
    whose settings name `lr` runs that constant instead of the schedule.
    The elementwise clip of the recipe stays the step runner's (one clip
    value for both groups, as each group's chain clips with it)."""
    names = {k: [] for k in GROUPS}
    for n in named_params:
        names[group_of(n, head_namespace)].append(n)
    empty = [k for k in GROUPS if not names[k]]
    if empty:
        raise ValueError(f"per-group optimizer settings: no parameter falls "
                         f"in the {empty[0]} group (head_namespace="
                         f"{head_namespace!r})")
    optimizers, scheduled = {}, []
    for k, settings in (("backbone", backbone_settings),
                        ("head", head_settings)):
        settings = dict(settings or {})
        fn = lr_fn
        if "lr" in settings:
            fn = constant(float(settings["lr"]))
        else:
            scheduled.append(k)
        opts = {**{o: v for o, v in options.items() if o != "lr"},
                **{o: v for o, v in settings.items() if o != "lr"}}
        optimizers[k] = make_optimizer(
            name, [named_params[n] for n in names[k]], fn, opts)
    return MultiTransform(optimizers, names, scheduled)


def jax_state(opt, named_params: Dict[str, torch.Tensor]
              ) -> List[np.ndarray]:
    """The optimizer's state as the leaves of the JAX trainer's optax
    state, in tree order: per-parameter slots in the order of the flax
    paths (sorted level by level), counts as int32 scalars; a
    `MultiTransform`'s is optax's multi_transform state."""
    return opt.jax_state(named_params)


def load_jax_state(opt, named_params: Dict[str, torch.Tensor],
                   leaves: List) -> None:
    """Set the optimizer's state from `jax_state`'s leaves."""
    opt.load_jax_state(named_params, list(leaves))


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
