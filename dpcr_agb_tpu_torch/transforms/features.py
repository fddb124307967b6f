"""Input featurization transforms of the sparse_xy chain (counterparts in
`dpcr_agb_tpu/transforms/features.py`)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .core import Transform, register


@register
class AddOnes(Transform):
    """sample['ones'] = ones [N,1]."""

    def __call__(self, rng, sample):
        sample = dict(sample)
        sample["ones"] = np.ones((sample["pos"].shape[0], 1), dtype=np.float32)
        return sample


@register
class XYZFeature(Transform):
    """Copy selected pos axes into pos_x/pos_y/pos_z."""

    def __init__(self, add_x=False, add_y=False, add_z=True):
        self.axes = [i for i, add in enumerate((add_x, add_y, add_z)) if add]
        self.names = [("pos_x", "pos_y", "pos_z")[i] for i in self.axes]

    def __call__(self, rng, sample):
        sample = dict(sample)
        for name, ax in zip(self.names, self.axes):
            sample[name] = sample["pos"][:, ax].copy()
        return sample


@register
class AddXYDistanceToCenter(Transform):
    """Euclidean xy distance to a fixed center."""

    def __init__(self, center_x: float, center_y: float):
        self.center = np.array([[center_x, center_y]], dtype=np.float32)

    def __call__(self, rng, sample):
        xy = sample["pos"][:, :2]
        sample = dict(sample)
        sample["xy_distance"] = np.linalg.norm(
            xy - self.center, axis=1).astype(np.float32)
        return sample


class AddFeatByKey(Transform):
    """Concat one named attribute onto x."""

    def __init__(self, add_to_x, feat_name, input_nc_feat=None, strict=True):
        self.add_to_x = add_to_x
        self.feat_name = feat_name
        self.input_nc_feat = input_nc_feat
        self.strict = strict

    def __call__(self, rng, sample):
        if not self.add_to_x:
            return sample
        feat = sample.get(self.feat_name)
        if feat is None:
            if self.strict:
                raise KeyError(
                    f"Sample should contain attribute {self.feat_name}")
            return sample
        if self.input_nc_feat:
            feat_dim = 1 if feat.ndim == 1 else feat.shape[-1]
            if self.input_nc_feat != feat_dim and self.strict:
                raise ValueError(f"feat {self.feat_name} shape {feat.shape} "
                                 f"!= {self.input_nc_feat}")
        if feat.ndim == 1:
            feat = feat[:, None]
        sample = dict(sample)
        x = sample.get("x")
        if x is None:
            sample["x"] = feat.astype(np.float32)
        else:
            if x.shape[0] != feat.shape[0]:
                raise ValueError(
                    f"x and {self.feat_name} can't be concatenated: "
                    f"{x.shape[0]} vs {feat.shape[0]}")
            if x.ndim == 1:
                x = x[:, None]
            sample["x"] = np.concatenate([x, feat], axis=-1).astype(
                np.float32)
        return sample


@register
class AddFeatsByKeys(Transform):
    """Concat several named attributes onto x, optionally deleting them."""

    def __init__(self, list_add_to_x: List[bool], feat_names: List[str],
                 input_nc_feats: Optional[List[Optional[int]]] = None,
                 stricts: Optional[List[bool]] = None,
                 delete_feats: Optional[List[bool]] = None):
        n = len(feat_names)
        if n == 0 or len(list_add_to_x) != n:
            raise ValueError("feat_names and list_add_to_x must be non-empty "
                             "and of equal length")
        input_nc_feats = input_nc_feats or [None] * n
        stricts = stricts or [True] * n
        self.feat_names = feat_names
        self.delete_feats = delete_feats
        self.steps = [AddFeatByKey(a, f, input_nc_feat=nc, strict=s)
                      for a, f, nc, s in zip(list_add_to_x, feat_names,
                                             input_nc_feats, stricts)]

    def __call__(self, rng, sample):
        for step in self.steps:
            sample = step(rng, sample)
        if self.delete_feats:
            sample = dict(sample)
            for name, delete in zip(self.feat_names, self.delete_feats):
                if delete:
                    sample.pop(name, None)
        return sample
