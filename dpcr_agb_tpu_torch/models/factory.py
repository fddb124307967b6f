"""Model building and collate policy (counterpart of `_build_minkowski`,
`_build_kpconv`, the dense-path `post_collate` and `_collate_spec` of
`dpcr_agb_tpu/models/factory.py`)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..data.batch import Batch, CollateSpec, normalize_sparse_rows
from .kpconv import build_kpconv
from .minkowski import SparseResNet, build_resnet

_MINKOWSKI = "minkowski.MinkowskiBaselineModel"
_KPCONV = "kpconv.KPConv"


def build_model(option: dict, num_reg_targets: int, in_channels: int,
                generator: Optional[torch.Generator] = None):
    """(module, conv_type) for one `conf/models` entry; the Minkowski
    sparse-voxel ResNets and the rigid KPConv net are ported."""
    if option["class"] == _KPCONV:
        net = build_kpconv(option, num_reg_targets, in_channels, generator)
        return net, option.get("conv_type", "PARTIAL_DENSE")
    if option["class"] != _MINKOWSKI:
        raise NotImplementedError(
            f"model class {option['class']!r} is not ported yet (ported: "
            f"{_MINKOWSKI}, {_KPCONV})")
    name = option["model_name"]
    if name == "MinkowskiPointNet":
        raise NotImplementedError("MPointNet is left for a later slice of "
                                  "the port")
    net = build_resnet(name, option, num_reg_targets, in_channels, generator)
    return net, option.get("conv_type", "SPARSE")


def make_post_collate(net) -> Optional[Callable[[Batch], Batch]]:
    """Dense-grid SparseResNet: pick the batch's z bucket (the smallest of
    {48, 64, 80, z_max} that holds its max z + 1), normalize the rows to
    (D, H, zb) and tag the bucket as aux['zcells'] (length zb). KPCNN has
    none: its pyramid is built on the device inside the forward."""
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
    """SPARSE: voxel counts padded to the bucket ladder. Anything else
    (PARTIAL_DENSE, DENSE): point counts padded to the preset's fixed
    `num_points`, or without one to the next power of two from
    `min_bucket`."""
    min_bucket = int(data_cfg.get("min_bucket", 1024))
    if conv_type == "SPARSE":
        return CollateSpec(conv_type="sparse", use_coords=True,
                           buckets=tuple(data_cfg.get("buckets",
                                                      (4096, 8192, 16384))),
                           min_bucket=min_bucket)
    preset = data_cfg.get(str(data_cfg.get("transform_type"))) or {}
    num_points = preset.get("num_points")
    if num_points is None and data_cfg.get("fixed") is not None:
        num_points = data_cfg["fixed"].get("num_points")
    return CollateSpec(conv_type="dense", num_points=num_points,
                       min_bucket=min_bucket)
