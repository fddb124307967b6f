"""Instance-regression output handling (counterpart of the serving half of
`dpcr_agb_tpu/models/base.py`): predictions live in standardized space,
`reg_output` de-standardizes them for reporting."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import numpy as np
import torch

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
