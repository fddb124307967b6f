"""Ad-hoc timing helpers (counterpart of `dpcr_agb_tpu/utils/timer.py`):
a Welford running mean and variance, and a decorator that logs each
call's wall time into one, kept per function name."""
from __future__ import annotations

import functools
import logging
import time

import numpy as np

log = logging.getLogger(__name__)


class RunningStats:
    """Welford running mean and variance."""

    def __init__(self):
        self.n = 0
        self.old_m = 0.0
        self.new_m = 0.0
        self.old_s = 0.0
        self.new_s = 0.0

    def clear(self):
        self.n = 0

    def push(self, x):
        self.n += 1
        if self.n == 1:
            self.old_m = self.new_m = x
            self.old_s = 0.0
        else:
            self.new_m = self.old_m + (x - self.old_m) / self.n
            self.new_s = self.old_s + (x - self.old_m) * (x - self.new_m)
            self.old_m = self.new_m
            self.old_s = self.new_s

    def mean(self):
        return self.new_m if self.n else 0.0

    def variance(self):
        return self.new_s / (self.n - 1) if self.n > 1 else 0.0

    def std(self):
        return float(np.sqrt(self.variance()))


_FUNC_STATS: dict = {}


def time_func(func=None, *, name=None):
    """Decorator logging each call's wall time (debug level) into a
    RunningStats, exposed as `wrapper.stats`."""
    if func is None:
        return functools.partial(time_func, name=name)
    label = name or func.__qualname__
    stats = _FUNC_STATS.setdefault(label, RunningStats())

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return func(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            stats.push(dt)
            log.debug(f"{label}: {dt*1e3:.2f} ms "
                      f"(mean {stats.mean()*1e3:.2f} +- {stats.std()*1e3:.2f})")

    wrapper.stats = stats
    return wrapper
