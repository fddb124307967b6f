"""Label-free inference CLI of the port (counterpart of the root
`predict.py`): loads a checkpoint, the port's `<model_name>.pt` or, when
there is none, the JAX package's `<model_name>.ckpt`, rebuilds the model
and the deterministic eval transforms from it alone (`serving.py`), runs
every input plot file (.las, .laz, .ply, .npz, .npy, .csv, .txt or .xyz,
one plot per file) through the model and writes de-standardized
predictions to csv, as the root `predict.py` does.

    python -m dpcr_agb_tpu_torch.predict checkpoint_dir=outputs/run \\
        model_name=SENet14|...|KPConv|SimplestNet|PointNext|PointNet \\
        input='plots/*.laz' \\
        output=preds.csv [batch_size=16] [weight_name=latest] \\
        [transform_type=sparse_xy] [centers=centers.csv] [device=cpu]

`weight_name` names a weight set: a `.pt` holds the ones training wrote
("latest"); a `.ckpt` resolves it as the JAX package does (the name,
`best_<name>`, a stage-prefixed best key, else "latest" with a warning).
`transform_type` picks a `.ckpt`'s eval preset (`<tt>_eval`, else `<tt>`;
by default the one it was trained with). It runs on CUDA unless
`device=cpu` is given, and raises when there is no CUDA device and the CPU
was not asked for. `centers=` (csv with columns file,x,y) pins each
plot's XY center; without it the XY mean of the points is used. Z is
always centered on the minimum."""
from __future__ import annotations

import csv
import glob
import logging
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .data.batch import Batch, collate
from .data.las_io import read_pt
from .models.base import convert_outputs, reg_output
from .serving import ServingBundle, load_serving_bundle

log = logging.getLogger(__name__)


def _parse(overrides: List[str]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for o in overrides:
        if "=" not in o:
            raise ValueError(f"expected key=value, got {o!r}")
        k, v = o.split("=", 1)
        out[k] = v
    for req in ("checkpoint_dir", "model_name", "input"):
        if req not in out:
            raise ValueError(f"predict requires {req}=")
    return out


def sample_from_file(path: str, feature_cols: List[str],
                     center_xy: Optional[tuple], pre_transform
                     ) -> Optional[dict]:
    """One plot file -> a centered sample after the pre_transform (None
    when nothing is left)."""
    pos, feats, _ = read_pt(path, feature_cols)
    if len(pos) == 0:
        log.warning(f"{path}: empty point cloud, skipping")
        return None
    pos = np.asarray(pos, np.float64)
    center = pos.min(axis=0, keepdims=True).copy()
    if center_xy is not None:
        center[:, 0], center[:, 1] = center_xy
    else:
        center[:, 0] = pos[:, 0].mean()
        center[:, 1] = pos[:, 1].mean()
    sample: dict = {"pos": (pos - center).astype(np.float32)}
    if feature_cols and feats is not None:
        sample["x"] = np.asarray(feats, np.float32)
    sample["label_idx"] = np.int64(0)
    sample["area_idx"] = np.int64(0)
    if pre_transform is not None:
        rng = np.random.default_rng(0)  # pre_transforms are deterministic
        sample = pre_transform(rng, sample)
        if sample["pos"].shape[0] == 0:
            log.warning(f"{path}: pre_transform left 0 points, skipping")
            return None
    return sample


def load_samples(bundle: ServingBundle, files: List[str],
                 centers: Optional[Dict[str, tuple]] = None
                 ) -> Tuple[List[dict], List[str]]:
    """Pre- and eval-transformed samples with NaN targets, and their file
    names. One rng, seeded 0, runs through all files in order."""
    centers = centers or {}
    rng = np.random.default_rng(0)
    samples, names = [], []
    for path in files:
        s = sample_from_file(path, bundle.feature_cols,
                             centers.get(os.path.basename(path)),
                             bundle.pre_transform)
        if s is None:
            continue
        samples.append(bundle.eval_transform(rng, s))
        names.append(os.path.basename(path))
    n_targets = len(bundle.reg_targets)
    for s in samples:  # label-free: NaN targets, all-False loss masks
        s["y_reg"] = np.full(n_targets, np.nan, np.float32)
        s["y_reg_mask"] = np.zeros(n_targets, bool)
    return samples, names


def make_batches(bundle: ServingBundle, samples: List[dict],
                 batch_size: int) -> List[Tuple[Batch, int]]:
    """Host batches (collate padded to batch_size + post_collate), each
    with its count of real samples."""
    out = []
    for i in range(0, len(samples), batch_size):
        chunk = samples[i:i + batch_size]
        batch = collate(chunk, bundle.collate_spec, pad_to_batch=batch_size)
        if bundle.post_collate is not None:
            batch = bundle.post_collate(batch)
        out.append((batch, len(chunk)))
    return out


@torch.no_grad()
def forward_raw(bundle: ServingBundle, batch: Batch) -> torch.Tensor:
    """Raw head output [B, T] of one host batch, on the bundle's device."""
    return bundle.net(batch.to(bundle.device))


def describe_batch(batch: Batch) -> str:
    """The padded sizes of a batch, for the logs."""
    if isinstance(batch.aux, dict) and "zcells" in batch.aux:
        return (f"V bucket {batch.mask.shape[1]}, z cells "
                f"{len(batch.aux['zcells'])}")
    return f"N bucket {batch.mask.shape[1]}"


def predictions(bundle: ServingBundle, raw: torch.Tensor) -> np.ndarray:
    """Raw head output -> de-standardized predictions [B, T] (numpy)."""
    out = reg_output(bundle.spec, convert_outputs(bundle.spec, raw.float()))
    return out.cpu().numpy()


def main(overrides=None) -> str:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = _parse(list(overrides if overrides is not None else sys.argv[1:]))
    bundle = load_serving_bundle(args["checkpoint_dir"], args["model_name"],
                                 args.get("weight_name", "latest"),
                                 device=args.get("device"),
                                 transform_type=args.get("transform_type"))

    files = sorted(glob.glob(args["input"]))
    if os.path.isdir(args["input"]):
        files = sorted(glob.glob(os.path.join(args["input"], "*")))
    if not files:
        raise FileNotFoundError(f"no input files match {args['input']!r}")
    centers: Dict[str, tuple] = {}
    if args.get("centers"):
        with open(args["centers"]) as f:
            for row in csv.DictReader(f):
                centers[row["file"]] = (float(row["x"]), float(row["y"]))

    samples, names = load_samples(bundle, files, centers)
    if not samples:
        raise ValueError("no usable input files")
    bs = int(args.get("batch_size", 16))
    rows = []
    for i, (batch, n) in enumerate(make_batches(bundle, samples, bs)):
        preds = predictions(bundle, forward_raw(bundle, batch))[:n]
        log.info("batch %d: %d plots, %s", i, n, describe_batch(batch))
        for name, p in zip(names[i * bs:i * bs + n], preds):
            rows.append([name] + [float(v) for v in p])

    out_path = args.get("output") or os.path.join(args["checkpoint_dir"],
                                                  "predictions.csv")
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file"] + [f"pred_{t}" for t in bundle.reg_targets])
        w.writerows(rows)
    log.info(f"wrote {len(rows)} predictions to {out_path}")
    return out_path


if __name__ == "__main__":
    main()
