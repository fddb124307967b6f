"""Streaming metric meters as plain-numpy accumulators (counterpart of
`dpcr_agb_tpu/metrics/meters.py`), with the reference meters' semantics:
  * MSEMeter   — torchnet.meter.MSEMeter(root=True) used for RMSE
  * MAEMeter   — torch_points3d/metrics/meters/maemeter.py:4-22
  * R2Meter    — torch_points3d/metrics/meters/r2meter.py:4-26 (1 - SSres/SStot
                 against a FIXED dataset mean, not the batch mean)
  * APPRXMeter — torch_points3d/metrics/meters/apprxmeter.py:4-25
  * AverageValueMeter — torchnet meter used for losses (mean of added values)

All meters accept numpy arrays and Python scalars.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np


def _np(x: Any) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


class AverageValueMeter:
    """Running mean/std of scalar values (losses)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.n = 0
        self.sum = 0.0
        self.sq_sum = 0.0

    def add(self, value, n: int = 1):
        v = float(_np(value))
        self.n += n
        self.sum += v * n
        self.sq_sum += v * v * n

    def value(self):
        if self.n == 0:
            return math.nan, math.nan
        mean = self.sum / self.n
        if self.n == 1:
            return mean, math.inf
        var = max(0.0, (self.sq_sum - self.n * mean * mean) / (self.n - 1))
        return mean, math.sqrt(var)


class MSEMeter:
    def __init__(self, root: bool = False):
        self.root = root
        self.reset()

    def reset(self):
        self.n = 0
        self.sesum = 0.0

    def add(self, output, target):
        output, target = _np(output), _np(target)
        self.n += output.size
        self.sesum += float(np.sum((output - target) ** 2))

    def value(self):
        mse = self.sesum / max(1, self.n)
        return math.sqrt(mse) if self.root else mse


class MAEMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.n = 0
        self.abssum = 0.0

    def add(self, output, target):
        output, target = _np(output), _np(target)
        self.n += output.size
        self.abssum += float(np.sum(np.abs(output - target)))

    def value(self):
        return self.abssum / max(1, self.n)


class R2Meter:
    """Incremental R² against a fixed target mean (the dataset/stage mean)."""

    def __init__(self, target_mean: float):
        self.target_mean = float(target_mean)
        self.reset()

    def reset(self):
        self.n = 0
        self.ressum = 0.0
        self.totsum = 0.0

    def add(self, output, target):
        output, target = _np(output), _np(target)
        self.n += output.size
        self.ressum += float(np.sum((output - target) ** 2))
        self.totsum += float(np.sum((target - self.target_mean) ** 2))

    def value(self):
        if self.n > 0 and self.totsum > 0:
            return 1.0 - self.ressum / self.totsum
        return 0.0


class APPRXMeter:
    """|1 - sum(pred)/sum(target)| — aggregate-total approximation error
    (reference metrics/meters/apprxmeter.py:4-25)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.pred_sum = 0.0
        self.target_sum = 0.0
        self.n = 0

    def add(self, output, target):
        output = _np(output)
        target = _np(target)
        self.pred_sum += float(output.sum())
        self.target_sum += float(target.sum())
        self.n += output.size

    def value(self) -> float:
        if self.n == 0 or self.target_sum == 0:
            return float("nan")
        return abs(1.0 - self.pred_sum / self.target_sum)
