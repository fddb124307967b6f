"""Prediction export for the instance task (counterpart of
`dpcr_agb_tpu/visualization/visualizer.py`): collects each stage's
de-standardized predictions with their area and label ids, then at the
epoch's end joins them onto the area's label table and appends
`<area>_<stage>_preds.csv` and the `<area>_preds` layer of
`<area>_preds.gpkg`, the files the root `eval_scores.py` and the eval
notebooks read. Format "ply" writes each sample's points with its
predicted and true targets as per-point columns to
`viz/<stage>_<epoch>/<area>/<label_idx>.ply`. Formats "tensorboard" and
"wandb" add point-cloud panels of the first `num_samples_per_epoch`
samples of a stage (-1: every sample), coloured by height: tensorboard's
`add_mesh` into `<save_dir>/tensorboard_viz`, and a wandb `Object3D`
subsampled to `wandb_max_points` (when a wandb run is open). Where the
package is missing, each logs one warning and turns itself off, as the
JAX visualizer does."""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np

from ..data.table import Table
from .gpkg import write_gpkg

log = logging.getLogger(__name__)

FORMATS = ("csv", "gpkg", "ply", "tensorboard", "wandb")


class Visualizer:
    def __init__(self, viz_cfg, num_batches: Dict[str, int], batch_size: int,
                 save_dir: str):
        get = viz_cfg.get if hasattr(viz_cfg, "get") else (viz_cfg or {}).get
        fmt = get("format", ["csv"])
        self._format = [fmt] if isinstance(fmt, str) else list(fmt or [])
        unknown = sorted(set(self._format) - set(FORMATS))
        if unknown:
            raise NotImplementedError(
                f"visualization formats {unknown} are not ported (the port "
                f"writes {list(FORMATS)})")
        self._save_csv = "csv" in self._format
        self._save_gpkg = "gpkg" in self._format
        self._save_ply = "ply" in self._format
        self._save_tb = "tensorboard" in self._format
        self._save_wandb = "wandb" in self._format
        n3d = int(get("num_samples_per_epoch", 4) or 4)
        self._num_samples_3d = float("inf") if n3d < 0 else n3d
        self._wandb_max_points = int(get("wandb_max_points", 10000) or 10000)
        self._save_dir = save_dir
        self._rows: List[dict] = []
        self._stage = "test"
        self._epoch = 0
        self._seen_3d = 0
        self._tb_writer = None

    @property
    def is_active(self) -> bool:
        return bool(self._format)

    @property
    def wants_pos(self) -> bool:
        """Only the point-cloud exporters read the points."""
        return self._save_ply or self._save_tb or self._save_wandb

    def reset(self, epoch: int, stage: str):
        self._epoch = epoch
        self._stage = stage
        self._rows = []
        self._seen_3d = 0

    def save_visuals(self, reg_out: np.ndarray, y_reg: np.ndarray,
                     area_idx: np.ndarray, label_idx: np.ndarray,
                     area_names: List[str], reg_targets: List[str],
                     sample_mask: Optional[np.ndarray] = None,
                     pos: Optional[np.ndarray] = None,
                     pos_mask: Optional[np.ndarray] = None):
        """Collect one batch of de-standardized predictions; with `pos`
        given, also write each sample's points (ply) and the stage's first
        panels (tensorboard, wandb)."""
        if not self.is_active:
            return
        for i in range(len(reg_out)):
            if sample_mask is not None and not sample_mask[i]:
                continue
            ai = int(area_idx[i])
            area = area_names[ai] if 0 <= ai < len(area_names) \
                else f"area{ai}"
            row = {"area": area, "label_idx": int(label_idx[i])}
            for t, name in enumerate(reg_targets):
                row[f"pred_{name}"] = float(reg_out[i, t])
                row[f"y_{name}"] = float(y_reg[i, t])
            self._rows.append(row)
            if self._save_ply and pos is not None:
                self._write_sample_ply(row, area, pos[i], None if
                                       pos_mask is None else pos_mask[i],
                                       reg_targets)
            if (self._save_tb or self._save_wandb) and pos is not None \
                    and self._seen_3d < self._num_samples_3d:
                self._seen_3d += 1
                p = np.asarray(pos[i], np.float32)
                if pos_mask is not None:
                    p = p[np.asarray(pos_mask[i], bool)]
                name = f"{area}_{row['label_idx']}"
                if self._save_tb:
                    self._write_tensorboard_mesh(name, p)
                if self._save_wandb:
                    self._write_wandb_cloud(name, p)

    def _write_sample_ply(self, row, area, pos_i, mask_i, reg_targets):
        from ..data.las_io import write_ply
        p = np.asarray(pos_i, np.float32)
        if mask_i is not None:
            p = p[np.asarray(mask_i, bool)]
        area_dir = os.path.join(self._save_dir, "viz",
                                f"{self._stage}_{self._epoch}", str(area))
        os.makedirs(area_dir, exist_ok=True)
        cols = {}
        for name in reg_targets:
            cols[f"pred_{name}"] = np.full(len(p), row[f"pred_{name}"],
                                           np.float32)
            cols[f"y_{name}"] = np.full(len(p), row[f"y_{name}"], np.float32)
        write_ply(os.path.join(area_dir, f"{row['label_idx']}.ply"), p,
                  **cols)

    @staticmethod
    def _z_colors(p: np.ndarray) -> np.ndarray:
        """uint8 [N,3] colours by height: a blue, green, yellow ramp."""
        z = p[:, 2].astype(np.float64)
        span = max(z.max() - z.min(), 1e-9) if len(z) else 1.0
        t = (z - (z.min() if len(z) else 0.0)) / span
        r = np.clip(2 * t - 0.5, 0, 1)
        g = np.clip(1.5 * t + 0.2, 0, 1)
        b = np.clip(1.0 - 1.8 * t, 0, 1)
        return (np.stack([r, g, b], 1) * 255).astype(np.uint8)

    def _write_tensorboard_mesh(self, name: str, p: np.ndarray) -> None:
        """An add_mesh point panel, coloured by height."""
        try:
            import torch
            if self._tb_writer is None:
                from torch.utils.tensorboard import SummaryWriter
                d = os.path.join(self._save_dir, "tensorboard_viz")
                os.makedirs(d, exist_ok=True)
                self._tb_writer = SummaryWriter(d)
            self._tb_writer.add_mesh(
                f"{self._stage}/{name}", torch.from_numpy(p[None]),
                colors=torch.from_numpy(self._z_colors(p)[None]),
                config_dict={"material": {"size": 0.3}},
                global_step=self._epoch)
        except Exception as e:  # an optional logger never stops a stage
            log.warning(f"tensorboard 3D export unavailable: {e}")
            self._save_tb = False

    def _write_wandb_cloud(self, name: str, p: np.ndarray) -> None:
        """An Object3D upload of x, y, z and the height colours, at most
        wandb_max_points of them (a seed-0 permutation)."""
        try:
            import wandb
            if wandb.run is None:
                return
            if len(p) > self._wandb_max_points:
                sel = np.random.default_rng(0).permutation(
                    len(p))[: self._wandb_max_points]
                p = p[sel]
            cloud = np.concatenate(
                [p, self._z_colors(p).astype(np.float32)], axis=1)
            wandb.log({f"{self._stage}/{name}": wandb.Object3D(cloud)},
                      commit=False)
        except Exception as e:
            log.warning(f"wandb 3D export unavailable: {e}")
            self._save_wandb = False

    def finalize_epoch(self, dataset=None):
        """Join the stage's predictions onto the label tables and append
        the csv and gpkg exports, one per area (areas in sorted order)."""
        if not (self._save_csv or self._save_gpkg) or not self._rows:
            self._rows = []
            return
        os.makedirs(self._save_dir, exist_ok=True)
        names = [k for k in self._rows[0] if k != "area"]
        for area_name in sorted({r["area"] for r in self._rows}):
            rows = [r for r in self._rows if r["area"] == area_name]
            out = Table({n: [r[n] for r in rows] for n in names})
            out["epoch"] = int(self._epoch)
            out["stage"] = self._stage
            labels = None
            if dataset is not None:
                try:
                    labels = dataset.get_labels(str(area_name))
                except KeyError:  # an area without a label table
                    labels = None
            joined = out if labels is None else _join_labels(out, labels)
            if self._save_csv:
                path = os.path.join(self._save_dir,
                                    f"{area_name}_{self._stage}_preds.csv")
                joined.write_csv(path, append=True,
                                 header=not os.path.exists(path))
            if self._save_gpkg:
                path = os.path.join(self._save_dir, f"{area_name}_preds.gpkg")
                gdf = joined.copy()
                for axis in ("x", "y"):
                    src = f"label_{axis}" if f"label_{axis}" in gdf else axis
                    gdf[axis] = gdf[src] if src in gdf \
                        else np.full(len(gdf), np.nan)
                write_gpkg(path, gdf, layer=f"{area_name}_preds",
                           append=True)
        self._rows = []


def _join_labels(out: Table, labels: Table) -> Table:
    """out's rows with the label row of each `label_idx` appended as
    `label_<column>` (a left join on the label table's index: a label
    missing from it gives missing values, int and bool columns then
    becoming float64 and object as pandas makes them)."""
    pos = {int(l): i for i, l in enumerate(labels.index)}
    where = np.array([pos.get(int(l), -1) for l in out["label_idx"]],
                     dtype=np.int64)
    hit = where >= 0
    joined = out.copy()
    for name in labels.columns:
        col = labels[name]
        if hit.all():
            values = col[where]
        elif col.dtype.kind in "iuf":
            values = np.where(hit, col[np.maximum(where, 0)].astype(
                np.float64), np.nan)
        else:
            values = np.array([col[w] if w >= 0 else np.nan
                               for w in where] + [None], dtype=object)[:-1]
        joined[f"label_{name}"] = values
    return joined
