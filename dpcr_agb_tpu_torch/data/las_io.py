"""Point-file reading for serving (counterpart of
`dpcr_agb_tpu/data/las_io.read_pt`), without pandas.

Reads `.npz` (a `pos` [N,3] array plus an optional `features` [N,F] array)
and `.csv`/`.txt` (header with x, y, z and the feature columns). LAS/LAZ
input needs the LAS reader and the native laszip library, which are not
ported yet."""
from __future__ import annotations

import csv
import os
from typing import List, Optional, Tuple

import numpy as np


def read_pt(path: str, feature_cols: List[str] = (),
            delimiter: str = ",") -> Tuple[np.ndarray, Optional[np.ndarray],
                                           None]:
    """Returns (pos [N,3] float32, features [N,F] float32 or None, None)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        with np.load(path) as z:
            feats = (z["features"].astype(np.float32)
                     if "features" in z else None)
            return z["pos"].astype(np.float32), feats, None
    if ext in (".csv", ".txt", ".xyz"):
        with open(path, newline="") as f:
            rows = list(csv.reader(f, delimiter=delimiter))
        header, body = rows[0], rows[1:]
        cols = {c.strip().lower(): i for i, c in enumerate(header)}
        table = np.asarray(body, dtype=np.float64).reshape(len(body), -1)
        pos = table[:, [cols["x"], cols["y"], cols["z"]]].astype(np.float32)
        feats = None
        if feature_cols:
            by_name = {c.strip(): i for i, c in enumerate(header)}
            feats = table[:, [by_name[c] for c in feature_cols]].astype(
                np.float32)
        return pos, feats, None
    if ext in (".las", ".laz"):
        raise NotImplementedError(
            f"{path}: LAS/LAZ input is not ported yet (needs the LAS reader "
            "and the native laszip library); convert the plot to .npz")
    raise ValueError(f"Unsupported point file extension: {path}")
