"""The port's train state and its checkpoint.

The train state is the model's parameters and BN running stats (its
`state_dict`), the optimizer's state, the update count `step` and
`num_samples`. It is saved into the serving checkpoint format
(`serving.save_checkpoint`, `<checkpoint_dir>/<model_name>.pt`) under the
one extra key `train_state`, so `load_serving_bundle` reads the file
unchanged. Reading the JAX package's msgpack `.ckpt` is not ported."""
from __future__ import annotations

import os
from typing import Dict, List

import torch

from ..serving import save_checkpoint
from .step import StepRunner

TRAIN_STATE_KEY = "train_state"


def save_train_checkpoint(checkpoint_dir: str, model_name: str,
                          runner: StepRunner, option: dict,
                          in_channels: int, data_cfg: dict,
                          target_stats: Dict[str, List[float]],
                          reg_targets: List[str]) -> str:
    """Write the serving checkpoint of runner.net with the train state
    beside it; returns its path."""
    return save_checkpoint(
        checkpoint_dir, model_name, runner.net, option, in_channels,
        data_cfg, target_stats, reg_targets,
        extra={TRAIN_STATE_KEY: {
            "optimizer": runner.optimizer.state_dict(),
            "step": runner.step, "num_samples": runner.num_samples}})


def load_train_state(runner: StepRunner, checkpoint_dir: str,
                     model_name: str, weight_name: str = "latest") -> None:
    """Restore weights, BN stats, optimizer state and counters into a
    runner built for the same model."""
    path = os.path.join(checkpoint_dir, f"{model_name}.pt")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if TRAIN_STATE_KEY not in ckpt:
        raise KeyError(f"{path}: no {TRAIN_STATE_KEY!r} (a serving-only "
                       "checkpoint)")
    runner.net.load_state_dict(ckpt["weights"][weight_name])
    ts = ckpt[TRAIN_STATE_KEY]
    runner.optimizer.load_state_dict(ts["optimizer"])
    runner.step = int(ts["step"])
    runner.num_samples = int(ts["num_samples"])


def load_named_optimizer_state(runner: StepRunner, named: dict) -> None:
    """Set the AdaBelief state from {"count", "exp_avg": {name: tensor},
    "exp_avg_var": {name: tensor}} keyed by parameter name (the form
    `weights.opt_state_from_optax` returns)."""
    params = dict(runner.net.named_parameters())
    if set(named["exp_avg"]) != set(params):
        raise ValueError(
            f"optimizer state names differ from the model's parameters: "
            f"{sorted(set(named['exp_avg']) ^ set(params))[:8]}")
    for name, p in params.items():
        runner.optimizer.state[p] = {
            k: named[k][name].to(p.device, torch.float32).reshape(p.shape)
            for k in ("exp_avg", "exp_avg_var")}
    for group in runner.optimizer.param_groups:
        group["count"] = int(named["count"])
