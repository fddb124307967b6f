"""Base metric tracker (counterpart of
`dpcr_agb_tpu/metrics/base_tracker.py`): it takes plain dictionaries of
host values from the step runner, averages the losses, and writes one
JSON line per published epoch and stage to `<log_dir>/metrics.jsonl`.
wandb and tensorboard are used only when they are installed and asked for,
as in the JAX package.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from .meters import AverageValueMeter

try:  # wandb is optional: keep the surface, gate the dependency
    import wandb  # noqa: F401
    _WANDB_AVAILABLE = True
except ImportError:
    _WANDB_AVAILABLE = False


class BaseTracker:
    def __init__(self, stage: str, wandb_log: bool = False,
                 use_tensorboard: bool = False, log_dir: Optional[str] = "."):
        # log_dir=None: metrics are computed but never written to disk —
        # non-zero ranks of a multi-host run (every rank sees the same
        # replicated metrics; only process 0 owns the files)
        self._wandb = wandb_log and _WANDB_AVAILABLE
        self._use_tensorboard = use_tensorboard and log_dir is not None
        self._log_dir = log_dir
        self._tb_writer = None
        if self._use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                os.makedirs(os.path.join(log_dir, "tensorboard"), exist_ok=True)
                self._tb_writer = SummaryWriter(os.path.join(log_dir, "tensorboard"))
            except ImportError:
                self._use_tensorboard = False
        self._jsonl_path = (os.path.join(log_dir, "metrics.jsonl")
                            if log_dir is not None else None)
        self._stage = stage
        self._finalised = False
        self._loss_meters: Dict[str, AverageValueMeter] = {}
        self.reset(stage)

    @property
    def stage(self) -> str:
        return self._stage

    def reset(self, stage: str = "train"):
        self._stage = stage
        self._loss_meters = {}
        self._finalised = False

    def track(self, tracked: Dict[str, Any], **kwargs):
        """Accumulate the losses of one step. `tracked["losses"]` maps loss
        name -> scalar."""
        losses = tracked.get("losses", {})
        for name, value in losses.items():
            key = f"{self._stage}_{name}"
            if key not in self._loss_meters:
                self._loss_meters[key] = AverageValueMeter()
            self._loss_meters[key].add(float(value))

    def get_loss(self) -> Dict[str, float]:
        return {k: m.value()[0] for k, m in self._loss_meters.items() if m.n > 0}

    def get_metrics(self, verbose: bool = False) -> Dict[str, Any]:
        return self.get_loss()

    def finalise(self, **kwargs):
        self._finalised = True

    def get_publish_metrics(self, epoch: int):
        metrics = self.get_metrics()
        return metrics, epoch

    def publish_metrics(self, metrics: Dict[str, Any], epoch: int, step: Optional[int] = None):
        record = {"epoch": epoch, "stage": self._stage, **metrics}
        if self._jsonl_path is not None:
            with open(self._jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        if self._tb_writer is not None:
            for key, value in metrics.items():
                name = key.replace(f"{self._stage}_", "", 1)
                self._tb_writer.add_scalar(f"{name}/{self._stage}", value, epoch)
            self._tb_writer.flush()
        if self._wandb:
            import wandb
            wandb.log({**metrics, "epoch": epoch})

    def publish_best_tables(self, improved, metrics: Dict[str, Any],
                            epoch: int):
        """Log one wandb.Table per newly-improved best metric, snapshotting
        ALL current metrics at that best epoch (reference
        model_checkpoint.py:296-342: `{stage}_best_{metric}` tables with
        columns [epoch, metric, value]). No-op without wandb."""
        if not self._wandb or not improved:
            return
        import wandb
        log_metrics = {}
        prefix = f"{self._stage}_"
        for metric_name in improved:
            short = metric_name[len(prefix):] \
                if metric_name.startswith(prefix) else metric_name
            table = wandb.Table(columns=["epoch", "metric", "value"])
            for metric, value in metrics.items():
                # our metric keys already carry the stage prefix
                table.add_data(epoch, metric, value)
            log_metrics[f"{self._stage}_best_{short}"] = table
        wandb.log(log_metrics)

    def print_summary(self):
        metrics = self.get_metrics(verbose=True)
        print("".join(f"    {k} = {v}\n" for k, v in metrics.items()))

    @property
    def metric_func(self):
        return {"loss": min}
