"""The port's train state and its checkpoint, and the JAX package's
checkpoint file.

The train state is the model's parameters and BN running stats (its
`state_dict`), the optimizer's state, the update count `step` and
`num_samples`. It is saved into the serving checkpoint format
(`serving.save_checkpoint`, `<checkpoint_dir>/<model_name>.pt`) under the
one extra key `train_state`, so `load_serving_bundle` reads the file
unchanged.

`Checkpoint` reads and writes the JAX package's `<model_name>.ckpt`
(`dpcr_agb_tpu/training/state.py` Checkpoint): flax msgpack (the port's
own codec, `training/msgpack.py`) of `model_pool` (each distinct model
state once, by content hash), `model_refs` (weight name -> pool id),
`stats`, `optimizer`, `schedulers`, `run_config` and `dataset_properties`.
A model state is `{"params": ..., "batch_stats": ...}` as flax nests them;
`weights.from_flax` maps it onto a `state_dict`.

`ModelCheckpoint` is the trainer's file-backed manager of such a `.ckpt`
(counterpart of `ModelCheckpoint` in `dpcr_agb_tpu/training/state.py`):
`latest` after each train stage, `best_<metric>` snapshots on the
selection stage only, per-stage stats, and the optimizer's state as the
leaves of the JAX trainer's optax state (`training/optim.jax_state`; with
per-group settings its multi_transform state, the `backbone` group's
chain, then the `head` group's). The `.pt` train state carries a
per-group optimizer's two state_dicts."""
from __future__ import annotations

import hashlib
import logging
import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..serving import save_checkpoint
from . import msgpack
from .step import StepRunner

log = logging.getLogger(__name__)

TRAIN_STATE_KEY = "train_state"
_LATEST = "latest"


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
    `weights.opt_state_from_optax` returns); a per-group optimizer takes
    {group: such a dict} over each group's parameters."""
    runner.optimizer.load_named(dict(runner.net.named_parameters()), named)


def dpcr_env_snapshot() -> Dict[str, str]:
    """Every DPCR_* variable of the environment (the JAX trainer stores
    them in run_config["dpcr_env"]: they select execution paths)."""
    return {k: os.environ[k] for k in sorted(os.environ)
            if k.startswith("DPCR_")}


def check_env_snapshot(saved_run_config: Optional[dict]) -> List[str]:
    """Compare a checkpoint's DPCR_* snapshot with the environment; warn
    and return the names that differ (empty when they match or the
    checkpoint holds no snapshot). Changes nothing."""
    saved = (saved_run_config or {}).get("dpcr_env")
    if saved is None:
        return []
    current = dpcr_env_snapshot()
    diff = sorted({k for k in set(saved) | set(current)
                   if saved.get(k) != current.get(k)})
    if diff:
        log.warning(
            "DPCR_* environment differs from the checkpoint's snapshot — "
            "execution paths (and for DPCR_KP_CALIB_PCT the model math) "
            "may not reproduce: %s",
            {k: {"saved": saved.get(k), "current": current.get(k)}
             for k in diff})
    return diff


class Checkpoint:
    """The contents of a JAX `.ckpt`: `models` {weight name: model state},
    per-stage `stats`, `optimizer` (name, state), `schedulers`,
    `run_config` and `dataset_properties`. Names that share a pool entry
    share one state object."""

    def __init__(self, run_config: Optional[dict] = None,
                 dataset_properties: Optional[dict] = None):
        self.models: Dict[str, Any] = {}
        self.stats: Dict[str, List[dict]] = {"train": [], "val": [],
                                             "test": []}
        self.optimizer: Optional[tuple] = None
        self.schedulers: Dict[str, Any] = {}
        self.run_config = run_config or {}
        self.dataset_properties = dataset_properties or {}

    def to_bytes(self) -> bytes:
        """The JAX layout: each distinct state once in `model_pool` under
        its content hash (states that are one object are hashed once),
        `model_refs` naming a pool id for each weight name."""
        pool: Dict[str, Any] = {}
        refs: Dict[str, str] = {}
        ident: Dict[int, str] = {}
        for name, state in self.models.items():
            pid = ident.get(id(state))
            if pid is None:
                pid = _state_fingerprint(state)
                pool.setdefault(pid, state)
                ident[id(state)] = pid
            refs[name] = pid
        payload = {
            "model_pool": pool, "model_refs": refs, "stats": self.stats,
            "optimizer": {"name": self.optimizer[0],
                          "state": self.optimizer[1]}
            if self.optimizer else {},
            "schedulers": self.schedulers,
            "run_config": self.run_config,
            "dataset_properties": self.dataset_properties,
        }
        return msgpack.packb(_msgpack_safe(payload))

    @classmethod
    def from_bytes(cls, data) -> "Checkpoint":
        payload = msgpack.unpackb(data)
        ckpt = cls(payload.get("run_config"),
                   payload.get("dataset_properties"))
        if "model_pool" in payload:
            pool = payload["model_pool"]
            ckpt.models = {name: pool[pid]
                           for name, pid in payload["model_refs"].items()}
        else:  # the JAX package's first layout: the states themselves
            ckpt.models = dict(payload.get("models", {}))
        ckpt.stats = {k: list(v) for k, v in payload.get("stats",
                                                         {}).items()}
        opt = payload.get("optimizer") or {}
        if opt:
            ckpt.optimizer = (opt.get("name"), opt.get("state"))
        ckpt.schedulers = payload.get("schedulers", {})
        return ckpt

    def get_model_state(self, weight_name: str = _LATEST):
        """The state of `weight_name`: that name, else `best_<name>`, else
        the stage-prefixed best keys ending in `_<name>` (the val stage's
        first), else `latest` with a warning; KeyError without any."""
        key = weight_name if weight_name in self.models \
            else f"best_{weight_name}"
        if key not in self.models:
            suffix = [k for k in sorted(self.models)
                      if k.endswith(f"_{weight_name}")]
            if suffix:
                key = next((k for k in suffix if k.startswith("best_val_")),
                           suffix[0])
        if key not in self.models:
            if _LATEST in self.models:
                log.warning(f"weight_name={weight_name!r} not found, using "
                            f"latest. Available: {sorted(self.models)}")
                key = _LATEST
            else:
                raise KeyError(f"No weights {weight_name!r} in checkpoint "
                               f"(have {sorted(self.models)})")
        return self.models[key]


def _leaves(tree, path: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _state_fingerprint(state) -> str:
    """Content hash of a model state: every leaf's path, dtype, shape and
    bytes."""
    h = hashlib.blake2b(digest_size=16)
    for path, leaf in _leaves(state):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu().contiguous()
            dtype = str(t.dtype)
            raw = (t.view(torch.int16) if t.dtype == torch.bfloat16
                   else t).numpy()
        else:
            raw = np.ascontiguousarray(leaf)
            dtype = raw.dtype.str
        h.update(str((path, dtype, raw.shape)).encode())
        h.update(raw.reshape(-1).view(np.uint8))
    return h.hexdigest()


def _msgpack_safe(obj):
    """Trees as the JAX package writes them: str keys, tuples as lists."""
    if isinstance(obj, dict):
        return {str(k): _msgpack_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_msgpack_safe(v) for v in obj]
    return obj


class ModelCheckpoint:
    """The `<check_name>.ckpt` of a run: loaded from `load_dir` on resume
    (and copied into `save_dir` when that differs, so the original is not
    overwritten), saved into `save_dir`."""

    def __init__(self, load_dir: str, check_name: str, selection_stage: str,
                 run_config: Optional[dict] = None,
                 dataset_properties: Optional[dict] = None,
                 resume: bool = False, save_dir: Optional[str] = None,
                 write: bool = True):
        # write=False (a rank other than 0): read, never write the file
        self.check_name = check_name
        self.selection_stage = selection_stage
        self.save_dir = Path(save_dir or load_dir or ".")
        self.save_dir.mkdir(parents=True, exist_ok=True)
        path = Path(load_dir or ".") / f"{check_name}.ckpt"
        if resume and path.exists():
            self.checkpoint = Checkpoint.from_bytes(path.read_bytes())
            if write and Path(load_dir).resolve() != \
                    self.save_dir.resolve():
                (self.save_dir / f"{check_name}.ckpt").write_bytes(
                    path.read_bytes())
        else:
            self.checkpoint = Checkpoint(run_config, dataset_properties)

    @property
    def path(self) -> Path:
        return self.save_dir / f"{self.check_name}.ckpt"

    @property
    def start_epoch(self) -> int:
        return len(self.checkpoint.stats.get("train", [])) + 1

    def is_empty(self) -> bool:
        return not self.checkpoint.models

    def save(self) -> None:
        tmp = self.path.with_suffix(".ckpt.tmp")
        tmp.write_bytes(self.checkpoint.to_bytes())
        os.replace(tmp, self.path)

    def save_best_models_under_current_metrics(
            self, state, stage: str, epoch: int, metrics: Dict[str, float],
            metric_funcs: Dict[str, Callable],
            optimizer_name: str = "AdaBelief",
            persist: bool = True) -> List[str]:
        """Record the stage's metrics; returns the names of the metrics
        that improved. `state` gives `model_state()` (the flax layout),
        `opt_state_leaves()`, `step`, `epoch` and `num_samples`. The train
        stage sets `latest`; a metric with "total_" or "loss_" in its name
        is tracked, and its `best_` snapshot kept on the selection stage
        only. persist=False updates the checkpoint in memory only (the
        trainer writes the file once per epoch)."""
        ckpt = self.checkpoint
        stats = ckpt.stats.setdefault(stage, [])
        state_dict = state.model_state()
        current_stat: Dict[str, Any] = {"epoch": epoch}
        improved: List[str] = []

        if stage == "train":
            ckpt.models[_LATEST] = state_dict
        else:
            latest_stats = stats[-1] if stats else None
            for metric_name, value in metrics.items():
                if all(k not in metric_name for k in ("total_", "loss_")):
                    continue
                current_stat[metric_name] = value
                func = _find_func(metric_name, metric_funcs)
                if func is None:
                    continue
                if latest_stats is None:
                    current_stat[f"best_{metric_name}"] = value
                    if self.selection_stage == stage:
                        ckpt.models[f"best_{metric_name}"] = state_dict
                else:
                    prev_best = latest_stats.get(f"best_{metric_name}", value)
                    best = func(prev_best, value)
                    current_stat[f"best_{metric_name}"] = best
                    if (self.selection_stage == stage and value == best
                            and value != prev_best):
                        ckpt.models[f"best_{metric_name}"] = state_dict
                        improved.append(metric_name)

        ckpt.optimizer = (optimizer_name,
                          {"opt_state": {"flat": state.opt_state_leaves()},
                           "step": state.step, "epoch": state.epoch,
                           "num_samples": state.num_samples})
        stats.append(current_stat)
        if persist:
            self.save()
        return improved


def _find_func(metric_name: str, metric_funcs: Dict[str, Callable]):
    """The first metric function whose key is a substring of the name."""
    for key, fn in metric_funcs.items():
        if key in metric_name:
            return fn
    return None
