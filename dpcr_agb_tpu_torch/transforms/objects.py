"""Object insertion, the paper's "treeadd" robustness test (counterpart of
`dpcr_agb_tpu/transforms/objects.py`): single trees from the processed
treeDB dataset are placed at random angles in an annulus outside the plot
radius, optionally density-matched by a top-view resampling that keeps
higher points more often (`topview_sample`).

Host numpy code on the sample's own generator, drawing in the JAX
package's order, so one seed gives the same points in both packages. The
loader runs chains on several threads at once: the `in_memory` cache is
filled under a lock, every load hands out copies, and no loaded object is
changed in place."""
from __future__ import annotations

import glob as globmod
import math
import os
import threading
from itertools import chain
from typing import Dict, List, Optional

import numpy as np

from .core import Sample, Transform, register
from .transforms import Random3AxisRotation


def topview_sample(rng: np.random.Generator, sample: Sample,
                   num_samples: int) -> Sample:
    """num_samples points drawn with replacement, weighted by z (airborne
    lidar sees the crowns): every per-point array of the sample is indexed
    alike."""
    n = sample["pos"].shape[0]
    z = np.clip(sample["pos"][:, 2].astype(np.float64), 1e-9, None)
    choice = rng.choice(n, size=num_samples, replace=True, p=z / z.sum())
    out = dict(sample)
    for k, v in sample.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n \
                and v.shape[0] != 1:
            out[k] = v[choice]
    return out


def _copied(obj: dict) -> dict:
    return {k: v.copy() if isinstance(v, np.ndarray) else v
            for k, v in obj.items()}


@register
class RadiusObjectAdder(Transform):
    """Add 1..n_max_objects processed objects (the `.npz` samples of the
    treeDB dataset, `<root_folder>/<dataset_name>/<processed_folder>/
    <split>/<area>/*.npz`) at a random angle and a radius in
    [min_radius (+ half the object's pos_deviation), max_radius], with
    probability p (on doubled samples only with only_doubled_batch).
    Objects without features get zero features of the sample's dtype;
    `indicator_key` names a per-point 0/1 array marking the added points.
    Raises at the first call when no processed object exists."""

    def __init__(self, areas, root_folder: str, dataset_name: str,
                 processed_folder: str, min_radius: float, max_radius: float,
                 n_max_objects, rot_x: float = 0.0, rot_y: float = 0.0,
                 rot_z: float = 0.0, indicator_key: Optional[str] = None,
                 adjust_point_density: bool = False,
                 density_topview_sample: bool = False, density_index: int = 0,
                 density_adjustment=(1.0, 1.0), split: str = "train",
                 zero_center_z: bool = False, only_doubled_batch: bool = False,
                 in_memory: bool = False, p: float = 0.5):
        areas = areas.to_dict() if hasattr(areas, "to_dict") else dict(areas)
        self.areas = {a: cfg for a, cfg in areas.items()
                      if cfg and cfg.get("type") == "object"}
        self.processed_dir = os.path.join(root_folder, dataset_name,
                                          processed_folder, split)
        self.object_files: List[str] = self._find_objects()
        self.min_radius = float(min_radius)
        self.max_radius = float(max_radius)
        if isinstance(n_max_objects, int):
            n_max_objects = {"object": n_max_objects, "scene": n_max_objects}
        self.n_max_objects = (n_max_objects.to_dict()
                              if hasattr(n_max_objects, "to_dict")
                              else dict(n_max_objects))
        self.rotation = Random3AxisRotation(apply_rotation=True, rot_x=rot_x,
                                            rot_y=rot_y, rot_z=rot_z)
        self.indicator_key = indicator_key
        self.adjust_point_density = adjust_point_density
        self.density_topview_sample = density_topview_sample
        self.density_index = int(density_index)
        self.density_adjustment = (float(density_adjustment[0]),
                                   float(density_adjustment[1])) \
            if not isinstance(density_adjustment, (int, float)) \
            else (float(density_adjustment), float(density_adjustment))
        self.zero_center_z = zero_center_z
        self.only_doubled_batch = only_doubled_batch
        self.in_memory = in_memory
        self.memory: Dict[str, dict] = {}
        self.p = float(p)
        self._lock = threading.Lock()

    def _find_objects(self) -> List[str]:
        return sorted(chain(*[
            globmod.glob(os.path.join(self.processed_dir, a, "*.npz"))
            for a in self.areas]))

    def _load(self, path: str) -> dict:
        """The object's arrays, always a private copy."""
        if self.in_memory:
            with self._lock:
                cached = self.memory.get(path)
            if cached is not None:
                return _copied(cached)
        with np.load(path, allow_pickle=False) as z:
            obj = {k: z[k] for k in z.files}
        if self.in_memory:
            with self._lock:
                self.memory.setdefault(path, _copied(obj))
        return obj

    def __call__(self, rng: np.random.Generator, sample: Sample) -> Sample:
        if not self.object_files:
            found = self._find_objects()
            if not found:
                raise AssertionError(
                    f"no objects for RadiusObjectAdder under "
                    f"{self.processed_dir} (process the treeDB dataset first)")
            self.object_files = found
        ori_n = None
        gated = rng.random() < self.p and (
            not self.only_doubled_batch
            or bool(sample.get("is_double", False)))
        out = dict(sample)
        if gated:
            area_name = str(sample.get("area_name", ""))
            sample_type = "object" if area_name in self.areas else "scene"
            n_objects = int(rng.integers(1, self.n_max_objects.get(
                sample_type, 1) + 1))
            files = list(rng.choice(self.object_files, n_objects,
                                    replace=True))
            pos_parts, feat_parts = [], []
            i = 0
            while i < len(files):
                obj = self._load(str(files[i]))
                i += 1
                if self.zero_center_z:
                    obj["pos"] = obj["pos"].copy()
                    obj["pos"][:, 2] -= obj["pos"][:, 2].min()
                obj = self.rotation(rng, obj)

                if self.adjust_point_density and "local_stats" in sample \
                        and "local_stats" in obj:
                    s_d = float(np.atleast_1d(
                        sample["local_stats"])[self.density_index])
                    o_d = float(np.atleast_1d(
                        obj["local_stats"])[self.density_index])
                    f = rng.random() * (self.density_adjustment[1]
                                        - self.density_adjustment[0]) \
                        + self.density_adjustment[0]
                    drop_ratio = (s_d * f) / max(o_d, 1e-9)
                    if drop_ratio < 1:
                        keep = max(1, int(drop_ratio * len(obj["pos"])))
                        if self.density_topview_sample:
                            obj = topview_sample(rng, obj, keep)
                        else:
                            idx = rng.choice(len(obj["pos"]), keep,
                                             replace=False)
                            obj = {k: (v[idx] if isinstance(v, np.ndarray)
                                       and v.ndim >= 1
                                       and v.shape[0] == len(obj["pos"])
                                       else v) for k, v in obj.items()}

                min_radius = self.min_radius
                if "pos_deviation" in obj:
                    min_radius += float(
                        np.sqrt((np.asarray(obj["pos_deviation"]) ** 2).sum())
                    ) / 2.0
                    if min_radius > self.max_radius:
                        # too wide for the annulus: draw another object
                        files.append(rng.choice(self.object_files))
                        continue
                angle = rng.uniform(0, 2 * math.pi)
                radius = rng.uniform(min_radius, self.max_radius)
                shift = np.array([[math.cos(angle), math.sin(angle), 0.0]],
                                 np.float32) * radius
                pos_parts.append(obj["pos"] + shift)
                feat_parts.append(obj.get("x"))

            ori_n = out["pos"].shape[0]
            out["pos"] = np.concatenate([out["pos"], *pos_parts], axis=0)
            if out.get("x") is not None:
                if feat_parts and feat_parts[0] is not None:
                    out["x"] = np.concatenate([out["x"], *feat_parts], axis=0)
                else:
                    out["x"] = np.concatenate(
                        [out["x"], np.zeros((out["pos"].shape[0] - ori_n,
                                             out["x"].shape[1]),
                                            out["x"].dtype)], axis=0)

        if self.indicator_key is not None:
            indicator = np.zeros(out["pos"].shape[0], np.float32)
            if ori_n is not None:
                indicator[ori_n:] = 1.0
            out[self.indicator_key] = indicator
        return out
