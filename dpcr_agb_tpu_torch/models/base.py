"""Instance-regression task machinery (counterpart of
`dpcr_agb_tpu/models/base.py`): targets are standardized inside the loss,
labels = (y - center) / scale; predictions live in standardized space and
`reg_output` de-standardizes them for reporting."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import numpy as np
import torch

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
        loss = loss + torch.sum(el * w) / torch.clamp(torch.sum(w), min=1.0)
    return torch.mean(torch.as_tensor(spec.weights, device=dev)) * loss
