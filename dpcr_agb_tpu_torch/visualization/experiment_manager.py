"""Experiment browsing (counterpart of
`dpcr_agb_tpu/visualization/experiment_manager.py`): enumerate run
directories, load their metric histories and checkpoints (the `.ckpt`
files the port's trainer writes, read by the port's `Checkpoint`), and
locate best epochs."""
from __future__ import annotations

import glob as globmod
import json
import os
from typing import Dict, List, Optional

class ExperimentFolder:
    """One run directory: <run_dir>/{<model>.ckpt, metrics.jsonl, *_preds.*}."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir

    @property
    def checkpoints(self) -> List[str]:
        return sorted(globmod.glob(os.path.join(self.run_dir, "*.ckpt")))

    @property
    def model_name(self) -> Optional[str]:
        cks = self.checkpoints
        return os.path.splitext(os.path.basename(cks[0]))[0] if cks else None

    def metrics_history(self) -> List[dict]:
        path = os.path.join(self.run_dir, "metrics.jsonl")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

    def metric_series(self, key: str) -> List[tuple]:
        return [(rec["epoch"], rec[key]) for rec in self.metrics_history()
                if key in rec]

    def best_epoch(self, key: str, mode: str = "min") -> Optional[tuple]:
        series = self.metric_series(key)
        if not series:
            return None
        fn = min if mode == "min" else max
        return fn(series, key=lambda t: t[1])

    def prediction_files(self) -> Dict[str, List[str]]:
        return {
            "csv": sorted(globmod.glob(
                os.path.join(self.run_dir, "**", "*_preds.csv"),
                recursive=True)),
            "gpkg": sorted(globmod.glob(
                os.path.join(self.run_dir, "**", "*_preds.gpkg"),
                recursive=True)),
        }

    def load_checkpoint(self):
        from ..training.state import Checkpoint
        cks = self.checkpoints
        if not cks:
            raise FileNotFoundError(f"no checkpoint in {self.run_dir}")
        with open(cks[0], "rb") as f:
            return Checkpoint.from_bytes(f.read())

    def summary(self) -> dict:
        hist = self.metrics_history()
        out = {"run_dir": self.run_dir, "model": self.model_name,
               "epochs": max((r.get("epoch", 0) for r in hist), default=0)}
        rmse_keys = sorted({k for r in hist for k in r
                            if k.endswith("_rmse") and "val" in k})
        for k in rmse_keys[:4]:
            best = self.best_epoch(k, "min")
            if best:
                out[f"best_{k}"] = {"epoch": best[0],
                                    "value": round(float(best[1]), 4)}
        return out


class ExperimentManager:
    """Scan a tree of run directories (reference ExperimentManager)."""

    def __init__(self, root: str = "outputs"):
        self.root = root

    def find_runs(self) -> List[ExperimentFolder]:
        ckpts = globmod.glob(os.path.join(self.root, "**", "*.ckpt"),
                             recursive=True)
        return [ExperimentFolder(d) for d in
                sorted({os.path.dirname(c) for c in ckpts})]

    def summarize(self) -> List[dict]:
        return [run.summary() for run in self.find_runs()]
