"""Model building and collate policy (counterpart of `_build_minkowski`,
`_build_simplest`, `_build_kpconv`, `_build_pointnext`,
`make_post_collate`, `export_aux` and `_collate_spec` of
`dpcr_agb_tpu/models/factory.py`)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..data.batch import Batch, CollateSpec, normalize_sparse_rows
from ..ops.host_pyramid import (kpconv_pyramid_plan, make_kpconv_post_collate,
                                make_sparse_post_collate)
from ..parallel import world_size
from .kpconv import DEFAULT_POINT_FRACS, KPCNN, build_kpconv
from .minkowski import SparseResNet, build_resnet
from .pointnet import MPointNet
from .pointnext import build_pointnext
from .simplestnet import SimplestNet

_MINKOWSKI = "minkowski.MinkowskiBaselineModel"
_KPCONV = "kpconv.KPConv"
_SIMPLEST = "simplestnet.SimplestNet"
_POINTNEXT = "pointnext.PointNext"


def f32_only(option: dict) -> bool:
    """Whether a `conf/models` entry is MPointNet, SimplestNet or a
    PointNeXt / PointNet encoder, which compute in f32 only, as the JAX
    models do (they have no bf16 form)."""
    return option["class"] in (_SIMPLEST, _POINTNEXT) or (
        option["class"] == _MINKOWSKI
        and option.get("model_name") == "MinkowskiPointNet")


def has_bn_schedule(option: dict) -> bool:
    """Whether the BN-momentum schedule reaches the entry's model: the JAX
    trainer sets a model's `bn_momentum` field, which SimplestNet and the
    PointNeXt models do not have."""
    return option["class"] not in (_SIMPLEST, _POINTNEXT)


def build_model(option: dict, num_reg_targets: int, in_channels: int,
                generator: Optional[torch.Generator] = None):
    """(module, conv_type) for one `conf/models` entry; the Minkowski
    sparse-voxel ResNets and MPointNet, SimplestNet, the KPConv net (rigid,
    deformable and modulated) and PointNeXt (with the PointNet encoder)
    are ported. MPointNet takes
    the JAX factory's defaults (relu, mean pool, no dropout, BN momentum
    0.1, no positions) where the entry names none."""
    cls = option["class"]
    if f32_only(option) and (option.get("extra_options") or {}).get("bf16"):
        raise ValueError(f"{option.get('model_name', cls)} runs in f32 only "
                         f"(the JAX model has no bf16 form): bf16 is not an "
                         f"option for it")
    if cls == _KPCONV:
        net = build_kpconv(option, num_reg_targets, in_channels, generator)
        return net, option.get("conv_type", "PARTIAL_DENSE")
    if cls == _SIMPLEST:
        return SimplestNet(num_reg_targets, in_channels, generator), \
            "PARTIAL_DENSE"
    if cls == _POINTNEXT:
        return build_pointnext(option, num_reg_targets, in_channels,
                               generator), "PARTIAL_DENSE"
    if cls != _MINKOWSKI:
        raise NotImplementedError(
            f"model class {cls!r} is not ported yet (ported: "
            f"{_MINKOWSKI}, {_SIMPLEST}, {_KPCONV}, {_POINTNEXT})")
    name = option["model_name"]
    if name == "MinkowskiPointNet":
        return MPointNet(
            num_reg_targets, in_channels,
            activation=option.get("activation", "relu"),
            global_pool=option.get("global_pool", "mean"),
            dropout=option.get("dropout", 0.0),
            bn_momentum=option.get("bn_momentum", 0.1),
            add_pos=option.get("add_pos", False),
            generator=generator), "SPARSE"
    net = build_resnet(name, option, num_reg_targets, in_channels, generator)
    return net, option.get("conv_type", "SPARSE")


def make_post_collate(net) -> Optional[Callable[[Batch], Batch]]:
    """Dense-grid SparseResNet: pick the batch's z bucket (the smallest of
    {48, 64, 80, z_max} that holds its max z + 1; z_max when the process
    group holds more than one rank), normalize the rows to
    (D, H, zb) and tag the bucket as aux['zcells'] (length zb). Map-mode
    SparseResNet: its levels and kernel maps built on the host
    (`ops/host_pyramid.py`, native route) at the net's level caps. KPCNN: its
    neighbour pyramid built on the host (`ops/host_pyramid.py`) at the
    net's neighbour caps (40 a level where it names none) and point
    fractions, into aux. MPointNet, SimplestNet and the PointNeXt models
    have none (they read the rows as they are)."""
    if isinstance(net, KPCNN):
        n_levels = len(net.levels)
        klims = list(net.neighborhood_limits or [40] * n_levels)
        deform_levels = [any("deformable" in b for b in lv)
                         for lv in net.levels]

        def plan_fn(n0: int) -> dict:
            return kpconv_pyramid_plan(
                net.first_subsampling_dl, net.conv_radius, n_levels, n0,
                net.point_fracs or DEFAULT_POINT_FRACS, klims, deform_levels,
                net.deform_radius / net.conv_radius)

        return make_kpconv_post_collate(plan_fn)
    if not isinstance(net, SparseResNet):
        return None
    if net.dense_dims is None:
        return make_sparse_post_collate(net.pyramid_plan)
    z_max_dim = net.dense_dims[2]
    buckets = sorted({min(b, z_max_dim) for b in (48, 64, 80, z_max_dim)})
    dxy = net.dense_dims[:2]

    def post_collate(batch: Batch) -> Batch:
        if world_size() > 1:
            # every rank must take the same shape, and the bucket turns on
            # the local batch's z extent: the full extent under several
            # processes, as the JAX package pins it
            zb = z_max_dim
        else:
            coords = np.asarray(batch.coords)
            mask = np.asarray(batch.mask)
            z_need = int(coords[..., 2][mask].max()) + 1 if mask.any() \
                else 1
            zb = next((b for b in buckets if b >= z_need), z_max_dim)
        batch = normalize_sparse_rows(batch, (*dxy, zb))
        return dataclasses.replace(batch,
                                   aux={"zcells": np.zeros(zb, np.int8)})

    return post_collate


def export_aux(net) -> Optional[dict]:
    """The static `batch.aux` of a fixed-shape export (`export_model.py`),
    or None. The models whose aux is input-dependent, KPCNN's neighbour
    pyramids and map mode's kernel maps (both built per batch by the host
    post-collate), cannot be baked into an artifact and raise. The
    dense-grid nets get their FULL z extent (length dense_dims[2]), so
    that serving inputs of any height fit: the smallest z bucket that a
    probe through `make_post_collate` would pick would crop tall plots."""
    if isinstance(net, KPCNN) or (
            isinstance(net, SparseResNet) and net.dense_dims is None):
        raise ValueError(
            f"{type(net).__name__} consumes host-precomputed, input-dependent "
            "batch.aux (neighbor pyramids / kernel maps) and cannot be "
            "exported as a standalone artifact; serve it with "
            "dpcr_agb_tpu_torch.predict")
    if isinstance(net, SparseResNet):
        return {"zcells": np.zeros(net.dense_dims[2], np.int8)}
    return None


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
