"""Model building and collate policy (counterpart of the Minkowski builder,
the dense-path `post_collate` and the SPARSE `_collate_spec` of
`dpcr_agb_tpu/models/factory.py`)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..data.batch import Batch, CollateSpec, normalize_sparse_rows
from .minkowski import SparseResNet, build_resnet

_MINKOWSKI = "minkowski.MinkowskiBaselineModel"


def build_model(option: dict, num_reg_targets: int, in_channels: int,
                generator: Optional[torch.Generator] = None):
    """(module, conv_type) for one `conf/models` entry; only the Minkowski
    sparse-voxel ResNets are ported."""
    if option["class"] != _MINKOWSKI:
        raise NotImplementedError(
            f"model class {option['class']!r} is not ported yet (ported: "
            f"{_MINKOWSKI})")
    name = option["model_name"]
    if name == "MinkowskiPointNet":
        raise NotImplementedError("MPointNet is left for a later slice of "
                                  "the port")
    net = build_resnet(name, option, num_reg_targets, in_channels, generator)
    return net, option.get("conv_type", "SPARSE")


def make_post_collate(net) -> Optional[Callable[[Batch], Batch]]:
    """Dense-grid SparseResNet: pick the batch's z bucket (the smallest of
    {48, 64, 80, z_max} that holds its max z + 1), normalize the rows to
    (D, H, zb) and tag the bucket as aux['zcells'] (length zb)."""
    if not isinstance(net, SparseResNet):
        return None
    z_max_dim = net.dense_dims[2]
    buckets = sorted({min(b, z_max_dim) for b in (48, 64, 80, z_max_dim)})
    dxy = net.dense_dims[:2]

    def post_collate(batch: Batch) -> Batch:
        coords = np.asarray(batch.coords)
        mask = np.asarray(batch.mask)
        z_need = int(coords[..., 2][mask].max()) + 1 if mask.any() else 1
        zb = next((b for b in buckets if b >= z_need), z_max_dim)
        batch = normalize_sparse_rows(batch, (*dxy, zb))
        return dataclasses.replace(batch,
                                   aux={"zcells": np.zeros(zb, np.int8)})

    return post_collate


def collate_spec(conv_type: str, data_cfg: dict) -> CollateSpec:
    """The SPARSE collate: voxel counts padded to the bucket ladder."""
    if conv_type != "SPARSE":
        raise NotImplementedError(f"conv_type {conv_type!r} collate is left "
                                  "for a later slice of the port")
    return CollateSpec(conv_type="sparse", use_coords=True,
                       buckets=tuple(data_cfg.get("buckets",
                                                  (4096, 8192, 16384))),
                       min_bucket=int(data_cfg.get("min_bucket", 1024)))
