"""Point-class filter (counterpart of `ClassificationFilter` in
`dpcr_agb_tpu/transforms/filters.py`), which the NFI `noground`
pre_transform names (conf/data/instance/NFI/noground/default.yaml)."""
from __future__ import annotations

import numpy as np

from .core import Transform, num_points, register


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
