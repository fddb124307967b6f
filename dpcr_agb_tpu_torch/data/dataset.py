"""NFI LAS plot dataset (counterpart of `dpcr_agb_tpu/data/dataset.py`).

Plot extraction and the pre_transform run once and cache one `.npz` per
sample at `<dataroot>/<dataset_name>/<processed_folder>/<split>/<area>/
<i>.npz` with a `done.flag` per split and area, in the JAX package's format
and paths, so either package reads the cache the other wrote. Each file
is written to a temporary name and renamed into place (`atomic.py`), so
ranks that share a dataroot never read a partial file. The random
train chain runs later, in the loader, with an explicit generator.

A sample is the transform-layer dict: pos [N,3] f32 centered on the plot
(xy on the plot coordinate, z on the minimum), optional x features,
y_reg / y_reg_mask, stats, label_idx, area_idx and area_name. Plots are
cut with the port's KD-tree (`native.KDTree2D`), which returns a plot's
points in scikit-learn's KDTree order, the order the JAX package's samples
have."""
from __future__ import annotations

import glob as globmod
import logging
import os
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..metrics import InstanceTracker, TrackerSpec
from ..native import KDTree2D
from ..transforms import Compose, instantiate_transforms
from ..transforms.core import instantiate_batch_transforms
from .atomic import atomic_write
from .labels import ensure_split, process_label_files
from .las_io import read_pt
from .stats import compute_local_stats
from .table import Table

log = logging.getLogger(__name__)

_DETERMINISTIC_RNG = np.random.default_rng(0)  # pre_transforms draw nothing


class Las:
    """One split of one or more areas, cached as
    processed/<split>/<area>/<i>.npz."""

    def __init__(self, data_path: str, areas: "OrderedDict[str, dict]",
                 split: str, targets: Dict[str, dict],
                 feature_cols: List[str], stats_cols: List[str],
                 pre_transform: Optional[Compose],
                 save_processed: bool = True,
                 processed_folder: str = "processed",
                 in_memory: bool = False, xy_radius: float = 15.0,
                 save_local_stats: bool = False, min_pts_outer: int = 100,
                 min_pts_inner: int = 0, pos_cache: Optional[dict] = None):
        self.data_path = Path(data_path)
        self.processed_dir = self.data_path / processed_folder
        self.areas = areas
        self.split = split
        self.targets = targets or {}
        self.reg_targets = [t for t in self.targets
                            if self.targets[t]["task"] == "regression"]
        self.feature_cols = list(feature_cols or [])
        self.stats_cols = list(stats_cols or [])
        self.pre_transform = pre_transform
        self.save_processed = save_processed
        self.in_memory = in_memory
        self.xy_radius = xy_radius
        self.save_local_stats = save_local_stats
        self.min_pts_outer = min_pts_outer
        self.min_pts_inner = min_pts_inner
        self.pos_cache = pos_cache if pos_cache is not None else {}
        self.area_names = list(areas.keys())
        self.memory: Dict[int, dict] = {}
        self._files: List[Path] = []
        self.local_stats_keys: List[str] = []
        self.process()

    # -- processing ---------------------------------------------------------
    def process(self) -> None:
        file_idx = 0
        for area_idx, area_name in enumerate(self.areas):
            area = self.areas[area_name]
            out_dir = self.processed_dir / self.split / area_name
            flag = out_dir / "done.flag"
            labels: Table = area["labels"]
            rows = labels.select(labels[area["split_col"]] == self.split)
            if flag.exists():
                files = sorted(out_dir.glob("*.npz"),
                               key=lambda p: int(p.stem))
                self._files.extend(files)
                file_idx += len(files)
                continue
            if len(rows) == 0:
                continue
            out_dir.mkdir(parents=True, exist_ok=True)
            if area["type"] == "scene":
                pos_all, feats_all, tree = self._load_scene(area_name, area)
            missing_idx = []
            for i in range(len(rows)):
                row = rows.row(i)
                if area["type"] == "object":
                    pos_all, feats_all, _ = read_pt(
                        row["pt_file"], self.feature_cols,
                        area.get("delimiter", ","))
                    tree = KDTree2D(pos_all[:, :2])
                center = np.array([row["x"], row["y"]], dtype=np.float64)
                point_idxs = tree.query_radius(center, self.xy_radius)
                inner_idxs = tree.query_radius(center, self.xy_radius / 2.0)
                sample = self._build_sample(
                    area_idx, int(rows.index[i]), row, pos_all, feats_all,
                    point_idxs, inner_idxs)
                if sample is None:
                    missing_idx.append(rows.index[i])
                    continue
                f = out_dir / f"{file_idx}.npz"
                if self.save_processed:
                    with atomic_write(f) as tmp, open(tmp, "wb") as fh:
                        np.savez_compressed(
                            fh, **{k: v for k, v in sample.items()
                                   if v is not None})
                if self.in_memory:
                    self.memory[file_idx] = sample
                self._files.append(f)
                file_idx += 1
            area["labels"] = labels.drop_index(missing_idx)
            if self.save_processed:
                with atomic_write(flag) as tmp:
                    open(tmp, "wb").close()

    def _load_scene(self, area_name: str, area: dict):
        cached = self.pos_cache.get(area_name)
        if cached is not None:
            return cached
        pts = [read_pt(f, self.feature_cols, area.get("delimiter", ","))
               for f in area["pt_files"]]
        pos = np.concatenate([p[0] for p in pts], axis=0)
        feats = (np.concatenate([p[1] for p in pts], axis=0)
                 if self.feature_cols else None)
        tree = KDTree2D(pos[:, :2])
        self.pos_cache[area_name] = (pos, feats, tree)
        return pos, feats, tree

    def _build_sample(self, area_idx: int, label_idx: int, row: dict,
                      pos_all, feats_all, point_idxs, inner_idxs
                      ) -> Optional[dict]:
        if len(point_idxs) < self.min_pts_outer:
            log.warning(f"only {len(point_idxs)} points in plot, skipping")
            return None
        if len(inner_idxs) < self.min_pts_inner:
            log.warning(f"only {len(inner_idxs)} inner points, skipping")
            return None
        pos = pos_all[point_idxs].astype(np.float64)
        inner = pos_all[inner_idxs].astype(np.float64)
        # center: xy on the plot coordinate, z on the min
        center = pos.min(axis=0, keepdims=True).copy()
        center[:, 0] = row["x"]
        center[:, 1] = row["y"]
        pos = (pos - center).astype(np.float32)
        inner = (inner - center).astype(np.float32)

        sample: dict = {"pos": pos}
        if feats_all is not None:
            sample["x"] = feats_all[point_idxs].astype(np.float32)
        if self.targets:
            y = np.array([row.get(t, np.nan) for t in self.reg_targets],
                         dtype=np.float32)
            sample["y_reg"] = y
            sample["y_reg_mask"] = ~np.isnan(y)
        if self.stats_cols:
            sample["stats"] = np.array(
                [row.get(c, np.nan) for c in self.stats_cols],
                dtype=np.float32)
        if self.save_local_stats:
            ls = compute_local_stats(pos)
            ls.update(compute_local_stats(inner, "_inner"))
            self.local_stats_keys = list(ls.keys())
            sample["local_stats"] = np.array(list(ls.values()),
                                             dtype=np.float32)
        sample["label_idx"] = np.int64(label_idx)
        sample["area_idx"] = np.int64(area_idx)
        sample["area_name"] = np.str_(self.area_names[area_idx])
        if self.pre_transform is not None:
            sample = self.pre_transform(_DETERMINISTIC_RNG, sample)
            if sample["pos"].shape[0] == 0:
                log.warning("pre_transform reduced sample to 0 points, "
                            "skipping")
                return None
        return sample

    # -- access -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._files)

    def get(self, idx: int) -> dict:
        if self.in_memory and idx in self.memory:
            return dict(self.memory[idx])
        with np.load(self._files[idx]) as z:
            sample = {k: z[k] for k in z.files}
        for k in ("label_idx", "area_idx"):
            if k in sample:
                sample[k] = sample[k][()] if sample[k].ndim == 0 \
                    else sample[k]
        if self.in_memory:
            self.memory[idx] = sample
        return dict(sample)

    @property
    def num_reg_classes(self) -> int:
        return len(self.reg_targets)


class RandomSampler:
    """Shuffled index stream; double_batch repeats each index twice in a
    row; truncated to a multiple of batch_size."""

    def __init__(self, n: int, batch_size: int, double_batch: bool = False):
        self.n = n
        self.batch_size = batch_size
        self.double_batch = double_batch

    def indices(self, rng: np.random.Generator) -> np.ndarray:
        idx = rng.permutation(self.n)
        if self.double_batch:
            idx = np.repeat(idx, 2)
        n_keep = (len(idx) // self.batch_size) * self.batch_size
        return idx[:n_keep]


class BalancedRandomSampler:
    """Class-balanced index stream: indices drawn with inverse-frequency
    class weights."""

    def __init__(self, labels: np.ndarray, batch_size: int):
        self.labels = np.asarray(labels)
        self.batch_size = batch_size
        classes, counts = np.unique(self.labels, return_counts=True)
        weights = {c: 1.0 / n for c, n in zip(classes, counts)}
        self.weights = np.array([weights[lab] for lab in self.labels])
        self.weights /= self.weights.sum()

    def indices(self, rng: np.random.Generator) -> np.ndarray:
        n = (len(self.labels) // self.batch_size) * self.batch_size
        return rng.choice(len(self.labels), size=n, p=self.weights)


class LasDataset:
    """Dataset facade: label processing, per-split Las datasets, target
    stats, transform pipelines and the tracker factory."""

    SPLITS = ("train", "val", "test")

    def __init__(self, dataset_opt):
        self.dataset_opt = dataset_opt
        get = dataset_opt.get
        self.targets = _plain(get("targets", {}) or {})
        self.target_keys = list(self.targets.keys())
        self.reg_targets = [t for t in self.targets
                            if self.targets[t]["task"] == "regression"]
        self.reg_targets_idx = [self.targets[t]["task"] == "regression"
                                for t in self.targets]
        self.features = list(get("features", []) or [])
        self.stats_cols = list(get("stats", []) or [])
        self.xy_radius = get("xy_radius", 15)
        self.transform_type = dataset_opt["transform_type"]
        if self.transform_type not in dataset_opt:
            presets = [k for k in dataset_opt.keys()
                       if isinstance(get(k), (dict, type(dataset_opt)))
                       and "train_transform" in (get(k) or {})]
            raise ValueError(
                f"Unknown transform_type {self.transform_type!r}. "
                f"Available presets: {sorted(presets)}")
        tt_cfg = _plain(get(self.transform_type, {}) or {})
        self.double_batch = tt_cfg.get("double_batch", False)
        self.log_train_metrics = get("log_train_metrics", True)
        self._data_path = os.path.join(get("dataroot", "data"),
                                       get("dataset_name", ""))
        self.processed_folder = get("processed_folder", "processed")

        self.pre_transform = instantiate_transforms(
            tt_cfg.get("pre_transform") or _plain(get("pre_transform")))
        self.train_transform = instantiate_transforms(
            tt_cfg.get("train_transform"))
        self.val_transform = instantiate_transforms(
            tt_cfg.get("val_transform", tt_cfg.get("test_transform")))
        self.test_transform = instantiate_transforms(
            tt_cfg.get("test_transform"))
        self.pre_batch_collate_transform = instantiate_batch_transforms(
            tt_cfg.get("pre_batch_collate_transform")
            or _plain(get("pre_batch_collate_transform")))

        # null area values are deletions (e.g. a synthetic config dropping
        # the inherited NFI area)
        self.areas: "OrderedDict[str, dict]" = OrderedDict(
            (k, v) for k, v in _plain(dataset_opt["areas"]).items()
            if v is not None)
        self._process_area_labels()

        in_memory = get("in_memory", False)
        save_processed = get("save_processed", True)
        save_local_stats = get("save_local_stats", False)
        train_subset = get("train_subset", False)
        min_pts_outer = get("min_pts_outer", 500)
        min_pts_inner = get("min_pts_inner", 250)

        if train_subset:
            rs = np.random.RandomState(43)
            for area in self.areas.values():
                lb = area["labels"]
                idx = lb.index[lb[area["split_col"]] == "train"]
                drop = rs.choice(idx, int(len(idx) * (1 - train_subset)),
                                 replace=False)
                area["labels"] = lb.drop_index(drop)

        pos_cache: dict = {}
        self.datasets: Dict[str, Optional[Las]] = {}
        for split in self.SPLITS:
            avail = any((a["labels"][a["split_col"]] == split).sum() > 0
                        for a in self.areas.values())
            if not avail:
                self.datasets[split] = None
                continue
            log.info(f"Init {split} dataset")
            self.datasets[split] = Las(
                self._data_path, self.areas, split, self.targets,
                self.features, self.stats_cols, self.pre_transform,
                save_processed=save_processed,
                processed_folder=self.processed_folder, in_memory=in_memory,
                xy_radius=self.xy_radius, save_local_stats=save_local_stats,
                min_pts_outer=min_pts_outer, min_pts_inner=min_pts_inner,
                pos_cache=pos_cache)

        self._set_label_stats()
        self.has_reg_targets = len(self.reg_targets) > 0

    # -- labels ---------------------------------------------------------------
    def _process_area_labels(self) -> None:
        get = self.dataset_opt.get
        for area_name, area in self.areas.items():
            if area.get("labels") is not None:
                continue
            area["delimiter"] = area.get("delimiter", get("delimiter", ","))
            pt_files = area["pt_files"]
            if isinstance(pt_files, str):
                pt_files = [pt_files]
            unpacked = []
            for f in pt_files:
                unpacked.extend(sorted(globmod.glob(
                    str(Path(self._data_path) / "raw" / f))))
            pt_files = unpacked

            labels = process_label_files(area, area_name, self.targets,
                                         self._data_path)
            if area["type"] == "object":
                def find_pt_file(ident):
                    for ptf in pt_files:
                        if str(ident) in ptf:
                            return ptf
                    return "None"
                labels = labels.copy()
                labels["pt_file"] = labels.map(area["pt_identifier"],
                                               find_pt_file)
                n0 = len(labels)
                labels = labels.select(labels["pt_file"] != "None")
                if len(labels) != n0:
                    log.warning(f"{n0 - len(labels)} removed due to missing "
                                "pt_file")
                pt_files = labels["pt_file"].tolist()
            area["pt_files"] = pt_files
            split_col = area.get("split_col", get("split_col", "split"))
            area["split_col"] = split_col
            area["labels"] = ensure_split(labels, area, self.targets,
                                          split_col)

    # -- stats ----------------------------------------------------------------
    def _stat_targets(self, stat_fn) -> "OrderedDict[str, dict]":
        """Per-area and total target stats per available split. As in the
        JAX package, and unlike the reference (which gates an area's train
        stats on its val split's size), each split's stats are gated on
        that split's own size."""
        targets = [f"{t}_" if self.targets[t]["task"] == "classification"
                   else t for t in self.targets]
        out: "OrderedDict[str, dict]" = OrderedDict()
        out["total"] = {s: [] for s in self.SPLITS if self.datasets.get(s)}
        for area_name, area in self.areas.items():
            sc = area["split_col"]
            lb = area["labels"]
            area_dict = {}
            for split in self.SPLITS:
                if self.datasets.get(split) is None:
                    continue
                values = lb.select(lb[sc] == split).values(targets)
                if values.shape[0] > 1:
                    with np.errstate(all="ignore"):
                        area_dict[split] = stat_fn(values, 0)
                    out["total"][split].append(values)
            if area_dict:
                out[area_name] = area_dict
        for split in list(out["total"].keys()):
            vals = out["total"][split]
            if vals:
                with np.errstate(all="ignore"):
                    out["total"][split] = stat_fn(np.concatenate(vals, 0), 0)
            else:
                del out["total"][split]
        return out

    def _set_label_stats(self) -> None:
        self.mean_targets_ = self._stat_targets(np.nanmean)
        self.std_targets_ = self._stat_targets(np.nanstd)
        self.min_targets_ = self._stat_targets(np.nanmin)
        self.max_targets_ = self._stat_targets(np.nanmax)

    def get_mean_targets(self):
        return self.mean_targets_

    def get_std_targets(self):
        return self.std_targets_

    def get_min_targets(self):
        return self.min_targets_

    def get_max_targets(self):
        return self.max_targets_

    # -- interface for models and the trainer ---------------------------------
    @property
    def train_dataset(self):
        return self.datasets.get("train")

    @property
    def val_dataset(self):
        return self.datasets.get("val")

    @property
    def test_dataset(self):
        return self.datasets.get("test")

    @property
    def num_reg_classes(self) -> int:
        return len(self.reg_targets)

    @property
    def num_classes(self) -> int:
        return len(self.targets)

    @property
    def area_names(self) -> List[str]:
        return list(self.areas.keys())

    def transform_for(self, split: str):
        return {"train": self.train_transform, "val": self.val_transform,
                "test": self.test_transform}[split]

    def first_sample(self, split: str = "train",
                     transformed: bool = True) -> dict:
        ds = self.datasets[split] or next(
            d for d in self.datasets.values() if d)
        sample = ds.get(0)
        if transformed:
            sample = self.transform_for(split)(np.random.default_rng(0),
                                               sample)
        return sample

    @property
    def feature_dimension(self) -> int:
        split = "train" if self.datasets.get("train") else \
            next(s for s in self.SPLITS if self.datasets.get(s))
        x = self.first_sample(split).get("x")
        return 0 if x is None else int(x.shape[-1])

    def tracker_spec(self) -> TrackerSpec:
        means = {}
        for area_name, d in self.mean_targets_.items():
            means[area_name] = {s: np.asarray(v) for s, v in d.items()}
        return TrackerSpec(
            area_names=self.area_names, reg_targets=self.reg_targets,
            target_means=means, has_reg_targets=self.has_reg_targets,
            log_train_metrics=self.log_train_metrics)

    def get_tracker(self, wandb_log: bool, tensorboard_log: bool,
                    log_dir: Optional[str] = ".") -> InstanceTracker:
        return InstanceTracker(self.tracker_spec(), wandb_log=wandb_log,
                               use_tensorboard=tensorboard_log,
                               log_dir=log_dir)

    def get_labels(self, area_name: str) -> Table:
        return self.areas[area_name]["labels"]


def _plain(obj):
    if hasattr(obj, "to_dict"):
        return obj.to_dict()
    return obj


def instantiate_dataset(dataset_opt) -> LasDataset:
    """The dataset a `conf/data` config names (only LasDataset exists).
    `synthetic: true` configs generate an NFI-like dataset on first use."""
    cls_path = dataset_opt.get("class", "las_dataset.LasDataset")
    if not str(cls_path).endswith("LasDataset"):
        raise ValueError(f"Unknown dataset class: {cls_path}")
    if dataset_opt.get("synthetic", False):
        root = os.path.join(dataset_opt.get("dataroot", "data"),
                            dataset_opt.get("dataset_name", "synthetic"))
        if not os.path.exists(os.path.join(root, "raw", "nfi.gpkg")):
            from .synthetic import generate_nfi_like_dataset
            n = int(dataset_opt.get("synthetic_plots", 64))
            spatial = bool(dataset_opt.get("synthetic_spatial", False))
            log.info(f"Generating synthetic NFI-like dataset ({n} plots, "
                     f"spatial_signal={spatial}) at {root}")
            generate_nfi_like_dataset(root, n_plots=n,
                                      spatial_signal=spatial)
    return LasDataset(dataset_opt)
