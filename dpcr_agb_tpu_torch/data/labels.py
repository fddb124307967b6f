"""Label tables and splits (counterpart of `dpcr_agb_tpu/data/labels.py`),
over the port's column table (`data/table.Table`) instead of pandas.

Label files are .csv / .txt (read with the `csv` module and pandas'
dtype inference for what these files hold) or .gpkg point layers
(`visualization/gpkg.read_gpkg`). The rows keep pandas' row order and
index labels throughout, since a row's index label becomes its sample's
`label_idx` and its position fixes the order in which plots are
processed."""
from __future__ import annotations

import logging
import os
from typing import Dict

import numpy as np

from .query import query_mask
from .table import Table

log = logging.getLogger(__name__)


def read_label_file(path: str) -> Table:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".csv", ".txt"):
        df = Table.read_csv(path)
        if "x" not in df.columns or "y" not in df.columns:
            df["x"] = 0.0
            df["y"] = 0.0
        return df
    if ext == ".gpkg":
        from ..visualization.gpkg import read_gpkg
        return read_gpkg(path)
    raise ValueError(f"Unsupported label file type: {path}")


def _to_numeric(values: np.ndarray) -> np.ndarray:
    """pd.to_numeric(errors="coerce") followed by a float factor: float64,
    NaN where a value does not parse."""
    if values.dtype.kind in "iufb":
        return values.astype(np.float64)
    out = np.full(len(values), np.nan)
    for i, v in enumerate(values.tolist()):
        try:
            out[i] = float(v)
        except (TypeError, ValueError):
            pass
    return out


def process_label_files(area: dict, area_name: str, targets: Dict[str, dict],
                        data_path: str) -> Table:
    """Load and merge an area's label files with target aliasing, unit
    factors and the classification mapping."""
    label_files = area["label_files"]
    if isinstance(label_files, str):
        label_files = [label_files]
    assert len(label_files) > 0, f"no labels given, check area {area_name}"

    frames = []
    for lf in label_files:
        lb = read_label_file(os.path.join(data_path, "raw", lf))
        alias_targets = area.get("alias_targets", list(targets.keys()))
        assert len(alias_targets) == len(targets)
        target_metric_factor = area.get("target_metric_factor") or {}
        for ori_target, alias_target in zip(targets, alias_targets):
            task = targets[ori_target]["task"]
            if alias_target in lb.columns:
                lb[ori_target] = lb[alias_target]
                if task in ("regression", "mol"):
                    lb[ori_target] = _to_numeric(lb[ori_target]) * float(
                        target_metric_factor.get(ori_target, 1.0))
            else:
                lb[ori_target] = np.nan
            if task == "classification":
                mapping = targets[ori_target]["class_mapping"]
                lb[f"{ori_target}_"] = np.array(
                    [float(mapping[v]) if _hashable(v) and v in mapping
                     else np.nan for v in lb[ori_target].tolist()],
                    dtype=np.float64)
        frames.append(lb)
    labels = Table.concat(frames) if len(frames) > 1 else frames[0]

    target_keys = list(targets.keys())
    n_labels = len(labels)
    nans_allowed = area.get("nans_allowed", True)
    missing = labels.isna(target_keys)
    fully_missing = int(missing.all(axis=1).sum())
    if fully_missing > 0:
        log.info(f"{fully_missing} of {n_labels} labels fully missing in "
                 f"{area_name}")
        if fully_missing == n_labels:
            area["has_labels"] = False
    if not nans_allowed:
        labels = labels.select(~missing.any(axis=1))

    query = area.get("label_query")
    if query is not None:
        labels = labels.select(query_mask(labels, query))
        if n_labels > len(labels):
            log.warning(f"{n_labels - len(labels)} samples filtered by: "
                        f"{query}")
    return labels.reset_index()


def _hashable(v) -> bool:
    try:
        hash(v)
    except TypeError:
        return False
    return True


def ensure_split(labels: Table, area: dict, targets: Dict[str, dict],
                 split_col: str) -> Table:
    """Create a train/val/test split column when absent, with the seed-42
    shuffle of the reference; rows with every must-be-present target
    missing go to train and come first."""
    if split_col in labels.columns:
        return labels
    target_keys = list(targets.keys())
    must = np.array(area.get("targets_must_be_present",
                             [True] * len(target_keys)), dtype=bool)
    must_keys = list(np.array(target_keys)[must])
    miss = labels.isna(must_keys)
    val_ratio = area.get("val_ratio", 0.1)
    test_ratio = area.get("test_ratio", 0.1)

    labels = labels.copy()
    if (len(must_keys) > 0 and miss.all()) or val_ratio == test_ratio == 0.0:
        labels[split_col] = "train"
        return labels

    if must.any():
        partly_missing = miss.all(axis=1)
        missing_part = labels.select(partly_missing)
        missing_part[split_col] = "train"
        full_part = labels.select(~partly_missing)
    else:
        missing_part = Table()
        full_part = labels.copy()

    index = full_part.index.copy()
    rs = np.random.RandomState(42)
    rs.shuffle(index)
    train_end = int(len(index) * (1 - (val_ratio + test_ratio)))
    val_end = int(len(index) * (1 - test_ratio))
    full_part.set_at(index[:train_end], split_col, "train")
    if val_ratio != 0 and val_end > train_end:
        full_part.set_at(index[train_end:val_end], split_col, "val")
    if test_ratio != 0 and len(index) > val_end:
        full_part.set_at(index[val_end:], split_col, "test")
    if len(missing_part):
        return Table.concat([missing_part, full_part])
    return full_part
