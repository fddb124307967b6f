"""Per-plot point statistics (counterpart of `dpcr_agb_tpu/data/stats.py`):
height moments, height and density quantiles. Kurtosis (Fisher's) and skew
are the biased estimators that `scipy.stats.kurtosis` and `scipy.stats.skew`
give by default, NaN for a constant height or a single point as there; the
GPU machine has no scipy."""
from __future__ import annotations

from typing import Dict

import numpy as np

QUANTILES = [0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99]


def _standard_moments(z: np.ndarray):
    """(skew, Fisher kurtosis), biased, as scipy.stats computes them."""
    mean = z.mean()
    d = z - mean
    m2 = np.mean(d ** 2)
    m3 = np.mean(d ** 2 * d)
    m4 = np.mean((d ** 2) ** 2)
    if m2 <= (np.finfo(np.float64).resolution * mean) ** 2:
        return np.nan, np.nan
    return m3 / m2 ** 1.5, m4 / m2 ** 2.0 - 3.0


def compute_local_stats(pos: np.ndarray, suffix: str = "") -> Dict[str, float]:
    z = pos[:, 2].astype(np.float64)
    out: Dict[str, float] = {}
    out[f"h_mean{suffix}"] = float(z.mean())
    out[f"h_std{suffix}"] = float(z.std())
    mean = z.mean()
    out[f"h_coov{suffix}"] = float(z.std() / mean) if mean != 0 else 0.0
    skew, kurt = _standard_moments(z)
    out[f"h_kur{suffix}"] = float(kurt)
    out[f"h_skew{suffix}"] = float(skew)
    for q in QUANTILES:
        out[f"h_q{int(q * 100)}{suffix}"] = float(np.quantile(z, q))
    # density quantiles: points per xy cell on a 1 m grid
    xy = pos[:, :2]
    cells = np.floor(xy).astype(np.int64)
    _, counts = np.unique(cells, axis=0, return_counts=True)
    for q in QUANTILES:
        out[f"d_q{int(q * 100)}{suffix}"] = float(np.quantile(counts, q))
    out[f"d_max{suffix}"] = float(counts.max())
    return out
