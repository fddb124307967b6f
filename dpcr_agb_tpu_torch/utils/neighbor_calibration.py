"""KPConv's neighbour-limit calibration (counterpart of
`dpcr_agb_tpu/utils/neighbor_calibration.py`): sample training plots, run
the KPConv radius and subsampling schedule over them on the host (the
native point ops) and report each level's neighbour count at a percentile,
the per-level caps `models.KPConv.extra_options.neighborhood_limits`
takes."""
from __future__ import annotations

import logging
from typing import List, Sequence

import numpy as np

from .. import native

log = logging.getLogger(__name__)


def calibrate_neighborhood_limits(
        samples: Sequence[dict], first_subsampling_dl: float,
        conv_radius: float = 2.5, num_layers: int = 5,
        percentile: float = 90.0, max_k: int = 256) -> List[int]:
    """For each pyramid level, the neighbour count (at most max_k) that
    covers `percentile`% of the query neighbourhoods of `samples`
    (transformed sample dicts with `pos`); at least 1."""
    counts: List[List[int]] = [[] for _ in range(num_layers)]
    for sample in samples:
        pts = np.asarray(sample["pos"], np.float32)
        r = first_subsampling_dl * conv_radius
        for layer in range(num_layers):
            nbr = native.radius_neighbors(pts, pts, r, max_k)
            counts[layer].extend((nbr < len(pts)).sum(axis=1).tolist())
            if layer < num_layers - 1:
                dl = 2 * r / conv_radius
                pts, _ = native.grid_subsample(pts, dl)
            r *= 2
    limits = []
    for layer in range(num_layers):
        arr = np.asarray(counts[layer])
        lim = int(np.percentile(arr, percentile)) if len(arr) else 0
        limits.append(max(lim, 1))
        log.info(
            f"layer {layer}: neighbors p50={np.percentile(arr, 50):.0f} "
            f"p90={np.percentile(arr, 90):.0f} "
            f"p99={np.percentile(arr, 99):.0f} max={arr.max()} -> "
            f"limit {limits[-1]}")
    return limits


def run_find_neighbour_dist(dataset, model_option: dict, n_samples: int = 32,
                            percentile: float = 90.0) -> List[int]:
    """The limits of `n_samples` plots of the dataset's train split (its
    test split when it has none), drawn without replacement by
    default_rng(0) and run through the train chain with that generator;
    [] for a model option without a KPConv `config`."""
    cfg = model_option.get("config")
    if not cfg:
        log.warning("find_neighbour_dist: model has no KPConv-style config")
        return []
    arch = list(cfg.get("architecture", []))
    num_layers = sum(1 for b in arch if "strided" in b or "pool" in b) + 1
    rng = np.random.default_rng(0)
    ds = dataset.train_dataset or dataset.test_dataset
    transform = dataset.transform_for("train")
    idxs = rng.choice(len(ds), size=min(n_samples, len(ds)), replace=False)
    samples = [transform(rng, ds.get(int(i))) for i in idxs]
    return calibrate_neighborhood_limits(
        samples, float(cfg.get("first_subsampling_dl", 0.0125)),
        float(cfg.get("conv_radius", 2.5)), num_layers, percentile)
