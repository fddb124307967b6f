"""Feature-space augmentations (counterparts in
`dpcr_agb_tpu/transforms/feature_augment.py`): the chromatic ones on
`rgb`, `DropFeature` on any named feature and `Jitter` on `x`. Airborne
NFI plots carry no `rgb`; a preset that names a chromatic augmentation
needs a sample that does."""
from __future__ import annotations

import numpy as np

from .core import Sample, Transform, register


@register
class NormalizeRGB(Transform):
    """Scale rgb to [0, 1] when it is not already there (0-255 input)."""

    def __init__(self, normalize: bool = True):
        self.normalize = normalize

    def __call__(self, rng, sample: Sample) -> Sample:
        rgb = np.asarray(sample["rgb"], np.float32)
        if self.normalize and not (rgb.max(initial=0) <= 1
                                   and rgb.min(initial=0) >= 0):
            rgb = rgb / 255.0
        sample = dict(sample)
        sample["rgb"] = rgb
        return sample


@register
class ChromaticTranslation(Transform):
    """With probability 0.95, one random colour shift of every point,
    clipped to [0, 1]."""

    def __init__(self, trans_range_ratio: float = 1e-1):
        self.trans_range_ratio = trans_range_ratio

    def __call__(self, rng, sample: Sample) -> Sample:
        if rng.random() >= 0.95:
            return sample
        sample = dict(sample)
        tr = (rng.random((1, 3)).astype(np.float32) - 0.5) \
            * 2 * self.trans_range_ratio
        sample["rgb"] = np.clip(sample["rgb"] + tr, 0.0, 1.0)
        return sample


@register
class ChromaticAutoContrast(Transform):
    """With probability 0.2, blend the colours toward their per-channel
    rescaled contrast (a random blend factor, or blend_factor)."""

    def __init__(self, randomize_blend_factor: bool = True,
                 blend_factor: float = 0.5):
        self.randomize_blend_factor = randomize_blend_factor
        self.blend_factor = blend_factor

    def __call__(self, rng, sample: Sample) -> Sample:
        if rng.random() >= 0.2:
            return sample
        feats = np.asarray(sample["rgb"], np.float32)
        lo = feats.min(axis=0, keepdims=True)
        hi = feats.max(axis=0, keepdims=True)
        if not hi.max() > 0:
            raise ValueError("invalid color value: all channels are <= 0")
        contrast = (feats - lo) / np.maximum(hi - lo, 1e-12)
        blend = (float(rng.random()) if self.randomize_blend_factor
                 else self.blend_factor)
        sample = dict(sample)
        sample["rgb"] = (1 - blend) * feats + blend * contrast
        return sample


@register
class ChromaticJitter(Transform):
    """With probability 0.95, per-point gaussian colour noise, clipped to
    [0, 1]."""

    def __init__(self, std: float = 0.01):
        self.std = std

    def __call__(self, rng, sample: Sample) -> Sample:
        if rng.random() >= 0.95:
            return sample
        sample = dict(sample)
        noise = rng.standard_normal(
            (sample["rgb"].shape[0], 3)).astype(np.float32) * self.std
        sample["rgb"] = np.clip(sample["rgb"] + noise, 0.0, 1.0)
        return sample


@register
class DropFeature(Transform):
    """With probability drop_proba, zero a named feature."""

    def __init__(self, drop_proba: float = 0.2, feature_name: str = "rgb"):
        self.drop_proba = drop_proba
        self.feature_name = feature_name

    def __call__(self, rng, sample: Sample) -> Sample:
        if rng.random() >= self.drop_proba:
            return sample
        sample = dict(sample)
        sample[self.feature_name] = np.zeros_like(sample[self.feature_name])
        return sample


@register
class Jitter(Transform):
    """With probability p, gaussian noise (mu, sigma) on the feature
    matrix x."""

    def __init__(self, mu: float = 0.0, sigma: float = 0.01,
                 p: float = 0.95):
        self.mu = mu
        self.sigma = sigma
        self.p = p

    def __call__(self, rng, sample: Sample) -> Sample:
        if rng.random() >= self.p:
            return sample
        sample = dict(sample)
        x = np.asarray(sample["x"], np.float32)
        sample["x"] = x + rng.standard_normal(
            x.shape).astype(np.float32) * self.sigma + self.mu
        return sample
