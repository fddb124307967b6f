"""Sample filters and the point-class filter (counterparts in
`dpcr_agb_tpu/transforms/filters.py`). A sample filter returns a bool
(keep the whole sample); no dataset hook calls one. `ClassificationFilter`
is a point transform, which the NFI `noground` pre_transform names
(conf/data/instance/NFI/noground/default.yaml)."""
from __future__ import annotations

import numpy as np

from .core import Transform, num_points, register


@register
class FCompose:
    """Sample filters combined with a boolean operation. As in the JAX
    package, the first filter is called twice (once to start, once in the
    loop), so a random first filter draws twice."""

    def __init__(self, list_filter, boolean_operation=np.logical_and):
        if len(list_filter) == 0:
            raise ValueError("FCompose needs at least one filter")
        self.list_filter = list_filter
        self.boolean_operation = boolean_operation

    def __call__(self, rng, sample) -> bool:
        res = self.list_filter[0](rng, sample)
        for f in self.list_filter:
            res = self.boolean_operation(res, f(rng, sample))
        return bool(res)


@register
class PlanarityFilter:
    """Keep a sample by the planarity (l2 - l1) / l3 of its covariance
    spectrum (ascending l1 <= l2 <= l3): <= thresh, or > thresh when not
    is_leq."""

    def __init__(self, thresh=0.3, is_leq=True):
        self.thresh, self.is_leq = thresh, is_leq

    def __call__(self, rng, sample) -> bool:
        pos = sample["pos"].astype(np.float64)
        centered = pos - pos.mean(axis=0, keepdims=True)
        cov = centered.T @ centered / len(pos)
        eig = np.sort(np.linalg.eigvalsh(cov))
        planarity = (eig[1] - eig[0]) / eig[2]
        return planarity <= self.thresh if self.is_leq \
            else planarity > self.thresh


@register
class RandomFilter:
    """Keep a sample with probability thresh."""

    def __init__(self, thresh=0.3):
        self.thresh = thresh

    def __call__(self, rng, sample) -> bool:
        return rng.random() < self.thresh


@register
class ClassificationFilter(Transform):
    """Keep (or remove, keep=False) the points whose class channel
    x[:, feature_index] is one of class_indices, in every per-point array
    but those of leading size 1; with remove_feat the channel is dropped
    from x afterwards (x becomes None when it was the only one)."""

    def __init__(self, feature_index: int, class_indices: list,
                 keep: bool = True, remove_feat: bool = True):
        self.feature_index = feature_index
        self.class_indices = list(class_indices)
        self.keep = keep
        self.remove_feat = remove_feat

    def __call__(self, rng, sample):
        cls = sample["x"][:, self.feature_index]
        mask = np.isin(cls, self.class_indices)
        if not self.keep:
            mask = ~mask
        n = num_points(sample)
        out = dict(sample)
        for key, item in sample.items():
            if (isinstance(item, np.ndarray) and item.ndim >= 1
                    and item.shape[0] == n and item.shape[0] != 1):
                out[key] = item[mask]
        if self.remove_feat:
            xf = out["x"]
            if xf.shape[1] == 1:
                out["x"] = None
            else:
                out["x"] = np.concatenate(
                    [xf[:, :self.feature_index],
                     xf[:, self.feature_index + 1:]], axis=1)
        return out
