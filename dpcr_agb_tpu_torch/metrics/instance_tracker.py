"""Per-(area × target) RMSE/MAE/R² tracker for instance regression
(counterpart of `dpcr_agb_tpu/metrics/instance_tracker.py`):
  * metric keys `{stage}_{area}_{target}_{rmse|mae|r2}` plus a "total" area
  * R² uses the per-area per-stage dataset target mean (fixed, not batch mean)
  * NaN targets (float) or -1 (int) are masked out (instance_tracker.py:116-121)
  * train-stage metrics suppressed unless `log_train_metrics`
  * metric goals: loss/_rmse -> min (drives best-checkpoint selection)
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np

from .base_tracker import BaseTracker
from .meters import MAEMeter, MSEMeter, R2Meter


@dataclass
class TrackerSpec:
    """The slice of dataset state the tracker needs (dataset.get_tracker builds it)."""
    area_names: List[str]
    reg_targets: List[str]                      # regression target names, ordered
    # target_means[area][stage] -> np.ndarray [n_targets] (may contain NaN)
    target_means: Dict[str, Dict[str, np.ndarray]]
    has_reg_targets: bool = True
    log_train_metrics: bool = True
    extra: Dict[str, Any] = field(default_factory=dict)


class InstanceTracker(BaseTracker):
    def __init__(self, spec: TrackerSpec, stage: str = "train",
                 wandb_log: bool = False, use_tensorboard: bool = False,
                 log_dir: str = "."):
        self._spec = spec
        self.area_name_map = OrderedDict(
            (a, i) for i, a in enumerate(spec.area_names))
        super().__init__(stage, wandb_log, use_tensorboard, log_dir)
        self._metric_goals = {"loss": "minimize"}
        self._metric_func = {"loss": min}
        if spec.has_reg_targets:
            self._metric_goals.update(
                {"_rmse": "minimize", "_mae": "minimize", "_r2": "maximize"})
            self._metric_func.update({"_rmse": min, "loss_reg": min})

    def _track_this_stage(self) -> bool:
        return self._stage != "train" or self._spec.log_train_metrics

    def reset(self, stage: str = "train"):
        super().reset(stage=stage)
        spec = self._spec
        self._rmse: Dict[str, Dict[str, MSEMeter]] = {}
        self._mae: Dict[str, Dict[str, MAEMeter]] = {}
        self._r2: Dict[str, Dict[str, R2Meter]] = {}
        if not (spec.has_reg_targets and self._track_this_stage()):
            return
        area_names = [a for a in list(spec.area_names) + ["total"]
                      if spec.target_means.get(a, {}).get(stage) is not None]
        for area_name in area_names:
            self._rmse[area_name] = {}
            self._mae[area_name] = {}
            self._r2[area_name] = {}
            for i, target_name in enumerate(spec.reg_targets):
                mean = spec.target_means[area_name][stage][i]
                if np.all(np.isnan(mean)):
                    continue
                self._rmse[area_name][target_name] = MSEMeter(root=True)
                self._mae[area_name][target_name] = MAEMeter()
                self._r2[area_name][target_name] = R2Meter(mean)

    def track(self, tracked: Dict[str, Any], **kwargs):
        """`tracked` carries: losses {name: scalar}; and when regression outputs
        are present: reg_out [B,T] de-standardized predictions, reg_y [B,T] raw
        targets (NaN = missing), area_idx [B] int indices into area_names."""
        super().track(tracked)
        if not (self._spec.has_reg_targets and self._track_this_stage()):
            return
        outputs = tracked.get("reg_out")
        targets = tracked.get("reg_y")
        if outputs is None or targets is None:
            return
        outputs = np.asarray(outputs, dtype=np.float64)
        targets = np.asarray(targets, dtype=np.float64)
        areas = np.asarray(tracked.get(
            "area_idx", np.zeros(len(outputs), dtype=np.int64)))
        valid = tracked.get("sample_mask")  # padded rows of the batch, if any
        if valid is not None:
            valid = np.asarray(valid, dtype=bool)
            outputs, targets, areas = outputs[valid], targets[valid], areas[valid]

        no_nans = ~np.isnan(targets)
        if not no_nans.any():
            return
        for i, target_name in enumerate(self._spec.reg_targets):
            no_nan = no_nans[:, i]
            if not no_nan.any():
                continue
            out = outputs[no_nan, i]
            target = targets[no_nan, i]
            area = areas[no_nan]
            for area_name in self._spec.area_names:
                area_idx = area == self.area_name_map[area_name]
                if area_idx.any():
                    self._add(area_name, target_name, out[area_idx], target[area_idx])
            self._add("total", target_name, out, target)

    def _add(self, area_name: str, target_name: str, out, target):
        meters = self._rmse.get(area_name, {})
        if target_name not in meters:
            return
        self._rmse[area_name][target_name].add(out, target)
        self._mae[area_name][target_name].add(out, target)
        self._r2[area_name][target_name].add(out, target)

    def get_metrics(self, verbose: bool = False) -> Dict[str, Any]:
        metrics = super().get_loss()
        if self._spec.has_reg_targets and self._track_this_stage():
            for area_name in list(self._spec.area_names) + ["total"]:
                if area_name not in self._r2:
                    continue
                for target_name in self._spec.reg_targets:
                    if target_name not in self._r2[area_name]:
                        continue
                    prefix = f"{self._stage}_{area_name}_{target_name}"
                    metrics[f"{prefix}_rmse"] = self._rmse[area_name][target_name].value()
                    metrics[f"{prefix}_mae"] = self._mae[area_name][target_name].value()
                    metrics[f"{prefix}_r2"] = self._r2[area_name][target_name].value()
        return metrics

    @property
    def metric_func(self):
        return self._metric_func

    @property
    def metric_goals(self):
        return self._metric_goals
