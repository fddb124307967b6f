"""Instance-regression task machinery (counterpart of
`dpcr_agb_tpu/models/base.py`): targets are standardized inside the loss,
labels = (y - center) / scale; predictions live in standardized space and
`reg_output` de-standardizes them for reporting."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from ..parallel import all_reduce_sum

F16_EPS = float(np.finfo(np.float16).eps)


def smoothl1(x, y):
    """Smooth L1 with beta 1 (torch's default)."""
    d = torch.abs(x - y)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def mape(x, y):
    nonzero = y != 0
    safe_y = torch.where(nonzero, y, torch.ones_like(y))
    return torch.where(nonzero, torch.abs((y - x) / safe_y),
                       torch.zeros_like(y))


REG_LOSSES: Dict[str, Callable] = {
    "smoothl1": smoothl1,
    "l2": lambda x, y: torch.square(x - y),
    "l1": lambda x, y: torch.abs(x - y),
    "mape": mape,
    "smape": lambda x, y: torch.abs(y - x) / (torch.abs(x) + torch.abs(y)
                                              + F16_EPS),
}

OUT_ACT: Dict[str, Callable] = {
    "linear": lambda x: x,
    "elu": lambda x: torch.where(x > 0, x, torch.expm1(x)),
    "relu": lambda x: torch.clamp(x, min=0),
}


@dataclasses.dataclass(frozen=True)
class InstanceSpec:
    """Static task config: per-target scale/center/weights and the output
    activations."""
    num_reg_targets: int
    scale: np.ndarray              # [T]
    center: np.ndarray             # [T]
    weights: np.ndarray            # [T]
    loss_names: Sequence[str] = ("smoothl1",)
    out_activation: str = "linear"
    report_activation: str = "linear"
    double_batch: bool = False


def _avg_stat(stats_dict: dict, feat_idx: np.ndarray, default: float
              ) -> float:
    """nanmean over every entry (the areas and 'total') that has train
    stats; `default` when there is none or one target is NaN in all."""
    vals = [np.asarray(area["train"], dtype=np.float64)[feat_idx]
            for area in stats_dict.values() if "train" in area]
    if not vals:
        return default
    arr = np.array(vals, dtype=np.float64)
    if np.isnan(arr).all(axis=0).any():
        return default
    return float(np.nanmean(arr, axis=0)[0])


def build_instance_spec(dataset, option) -> InstanceSpec:
    """The task spec of a dataset's regression targets (counterpart of
    `dpcr_agb_tpu/models/base.build_instance_spec`): per target, weight,
    normalization (standard: center the averaged train mean, scale the
    averaged train std; min-max: center the min, scale max - min; other:
    0 and 1), then center_override, scale_override and scale_mult; the
    loss names of `reg_loss_fn` and the output activations of the model
    option."""
    get = option.get if hasattr(option, "get") else option.__getitem__
    reg_targets = [t for t in dataset.targets
                   if dataset.targets[t]["task"] == "regression"]
    n = len(reg_targets)
    scale = np.ones(n)
    center = np.zeros(n)
    weights = np.ones(n)
    targets_idx = np.asarray(dataset.reg_targets_idx, dtype=bool)
    for i, t in enumerate(reg_targets):
        tcfg = dataset.targets[t]
        weights[i] = tcfg.get("weight", 1)
        norm = tcfg.get("normalization", "standard")
        feat_idx = np.zeros_like(targets_idx)
        feat_idx[np.flatnonzero(targets_idx)[i]] = True
        if norm == "standard":
            center[i] = _avg_stat(dataset.get_mean_targets(), feat_idx, 0.0)
            scale[i] = _avg_stat(dataset.get_std_targets(), feat_idx, 1.0)
        elif norm == "min-max":
            center[i] = _avg_stat(dataset.get_min_targets(), feat_idx, 0.0)
            scale[i] = _avg_stat(dataset.get_max_targets(), feat_idx,
                                 1.0) - center[i]
        center[i] = tcfg.get("center_override", center[i])
        scale[i] = tcfg.get("scale_override", scale[i])
        scale[i] *= tcfg.get("scale_mult", 1.0)

    loss_strs = get("reg_loss_fn", "smoothl1") or "smoothl1"
    loss_names = tuple(s.strip() for s in str(loss_strs).split(",")
                       if s.strip())
    for s in loss_names:
        if s not in REG_LOSSES:
            raise ValueError(f"Unknown reg loss: {s}")
    return InstanceSpec(
        num_reg_targets=n, scale=scale.astype(np.float32),
        center=center.astype(np.float32), weights=weights.astype(np.float32),
        loss_names=loss_names,
        out_activation=str(get("reg_out_activation", "linear")
                           or "linear").lower(),
        report_activation=str(get("reg_out_report_activation", "linear")
                              or "linear").lower(),
        double_batch=bool(get("double_batch",
                              getattr(dataset, "double_batch", False))),
    )


def convert_outputs(spec: InstanceSpec, raw: torch.Tensor) -> torch.Tensor:
    """Head output -> standardized regression predictions."""
    return OUT_ACT[spec.out_activation](raw[:, : spec.num_reg_targets])


def reg_output(spec: InstanceSpec, reg_out: torch.Tensor) -> torch.Tensor:
    """De-standardize + report activation."""
    scale = torch.as_tensor(spec.scale, device=reg_out.device)
    center = torch.as_tensor(spec.center, device=reg_out.device)
    return OUT_ACT[spec.report_activation](reg_out * scale + center)


def compute_reg_loss(spec: InstanceSpec, reg_out: torch.Tensor,
                     y_reg: torch.Tensor, y_mask: torch.Tensor,
                     training: bool) -> torch.Tensor:
    """Standardized masked regression loss: reg_out [B,T] standardized
    predictions, y_reg [B,T] raw targets (NaN allowed where y_mask [B,T] is
    False). Returns mean(weights) * sum over spec.loss_names of the masked
    mean loss. In training with spec.double_batch, consecutive views are
    paired and averaged 0.5/0.5 against the first view's labels."""
    dev = reg_out.device
    scale = torch.as_tensor(spec.scale, device=dev)
    center = torch.as_tensor(spec.center, device=dev)
    y_safe = torch.where(y_mask, torch.nan_to_num(y_reg),
                         torch.zeros_like(y_reg))
    labels = (y_safe - center) / scale
    if training and spec.double_batch:
        out1, out2 = reg_out[0::2], reg_out[1::2]
        labels, y_mask = labels[0::2], y_mask[0::2]

        def elementwise(fn):
            return 0.5 * fn(out1, labels) + 0.5 * fn(out2, labels)
    else:
        def elementwise(fn):
            return fn(reg_out, labels)

    loss = torch.zeros((), dtype=reg_out.dtype, device=dev)
    for name in spec.loss_names:
        el = elementwise(REG_LOSSES[name])
        w = y_mask.to(el.dtype)
        loss = loss + torch.sum(el * w) / _target_count(w)
    return torch.mean(torch.as_tensor(spec.weights, device=dev)) * loss


def _target_count(w: torch.Tensor) -> torch.Tensor:
    """The loss's denominator: the present targets, clamped at 1. Under a
    process group it counts the global batch's (a SUM over ranks, taken
    without gradient, clamped after the sum), so that the per-rank losses,
    each its local numerator over it, add up to the global loss and their
    gradients' SUM is its gradient; a mean of per-rank means would be
    another loss wherever the ranks hold different numbers of targets."""
    return torch.clamp(all_reduce_sum(torch.sum(w).detach()), min=1.0)
