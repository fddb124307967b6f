"""Transform-layer core (counterpart of `dpcr_agb_tpu/transforms/core.py`):
sample dict conventions, masking, registry, composition.

A sample is a plain dict of numpy arrays: `pos` [N,3] float32 always, other
per-point arrays with leading dim N, and per-sample values. Every transform
is a callable `t(rng, sample) -> sample` with an explicit
`np.random.Generator`, so a pipeline is a pure function of (seed, sample)."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

Sample = Dict[str, Any]

TRANSFORM_REGISTRY: Dict[str, type] = {}


def register(cls: type) -> type:
    """Class decorator: make a transform instantiable by its class name."""
    key = cls.__name__
    if key in TRANSFORM_REGISTRY and TRANSFORM_REGISTRY[key] is not cls:
        raise ValueError(f"Duplicate transform registration: {key}")
    TRANSFORM_REGISTRY[key] = cls
    return cls


def num_points(sample: Sample) -> int:
    return int(sample["pos"].shape[0])


def _is_pointwise(key: str, value: Any, n: int, skip: Sequence[str]) -> bool:
    return (isinstance(value, np.ndarray) and value.ndim >= 1
            and value.shape[0] == n and key not in skip)


def apply_mask(sample: Sample, mask: np.ndarray,
               skip_list: Sequence[str] = ()) -> Sample:
    """Boolean-mask all per-point arrays except keys in skip_list."""
    n = num_points(sample)
    out = dict(sample)
    for k, v in sample.items():
        if _is_pointwise(k, v, n, skip_list):
            out[k] = v[mask]
    return out


def apply_index(sample: Sample, idx: np.ndarray,
                skip_list: Sequence[str] = ()) -> Sample:
    """Index/reorder all per-point arrays; `pos` is always indexed. Arrays
    with leading dim 1 are left alone (per-sample rows)."""
    n = num_points(sample)
    out = dict(sample)
    for k, v in sample.items():
        if k == "pos" or (_is_pointwise(k, v, n, skip_list)
                          and v.shape[0] != 1):
            out[k] = v[idx]
    return out


def unique_int_rows(rows: np.ndarray):
    """(uniq, inverse) for integer-valued [N, D] rows, in numeric
    lexicographic order: the columns are packed into one mixed-radix int64
    key and stable-sorted (np.unique(axis=0) when the key would overflow)."""
    if len(rows) == 0:
        return rows.copy(), np.empty(0, dtype=np.int64)
    c = rows.astype(np.int64) if rows.dtype != np.int64 else rows
    lo = c.min(axis=0)
    c = c - lo
    radix = c.max(axis=0).astype(np.int64) + 1
    bits = sum(int(r - 1).bit_length() for r in radix)
    if bits > 62:
        uniq, inverse = np.unique(rows, axis=0, return_inverse=True)
        return uniq, inverse.ravel()
    key = c[:, 0]
    for d in range(1, c.shape[1]):
        key = key * radix[d] + c[:, d]
    order = np.argsort(key, kind="stable")
    sk = key[order]
    isnew = np.empty(len(sk), dtype=bool)
    isnew[0] = True
    np.not_equal(sk[1:], sk[:-1], out=isnew[1:])
    inverse = np.empty(len(sk), dtype=np.int64)
    inverse[order] = np.cumsum(isnew) - 1
    return rows[order[isnew]], inverse


def shuffle_sample(rng: np.random.Generator, sample: Sample) -> Sample:
    """Permute all per-point arrays together (skip lists ignored)."""
    n = num_points(sample)
    perm = rng.permutation(n)
    out = dict(sample)
    for k, v in sample.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n:
            out[k] = v[perm]
    return out


class Transform:
    """Base class: subclasses implement __call__(rng, sample) -> sample."""

    def __call__(self, rng: np.random.Generator, sample: Sample) -> Sample:
        raise NotImplementedError

    def __repr__(self):
        attrs = ", ".join(f"{k}={v!r}" for k, v in vars(self).items()
                          if not k.startswith("_"))
        return f"{type(self).__name__}({attrs})"


class Compose(Transform):
    def __init__(self, transforms: List[Callable]):
        self.transforms = list(transforms)

    def __call__(self, rng, sample):
        for t in self.transforms:
            sample = t(rng, sample)
        return sample


def instantiate_transform(entry: dict) -> Transform:
    """One transform from a plain dict {transform: Name, params: {...}}."""
    name = entry["transform"]
    params = entry.get("params", {}) or {}
    if name not in TRANSFORM_REGISTRY:
        raise ValueError(f"Unknown or unported transform: {name}. "
                         f"Known: {sorted(TRANSFORM_REGISTRY)}")
    return TRANSFORM_REGISTRY[name](**params)


def _flatten(entries):
    for e in entries:
        if isinstance(e, (list, tuple)):
            yield from _flatten(e)
        else:
            yield e


def instantiate_transforms(cfg_list) -> Compose:
    """A Compose from a (possibly nested) list of plain transform dicts."""
    if cfg_list is None:
        return Compose([])
    return Compose([instantiate_transform(e) for e in _flatten(cfg_list)])


def instantiate_batch_transforms(cfg_list) -> Optional[Callable]:
    """Batch-level transforms (a list of samples in, a list out) from a
    preset's `pre_batch_collate_transform` list; None when there are none.
    A transform that is not batch-level raises."""
    if cfg_list is None:
        return None
    ts = [instantiate_transform(e) for e in _flatten(cfg_list)]
    for t in ts:
        if not getattr(t, "batch_level", False):
            raise ValueError(f"{t!r} is not a batch-level transform")
    if not ts:
        return None

    def apply(samples):
        for t in ts:
            samples = t(samples)
        return samples
    return apply
