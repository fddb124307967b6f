"""Checkpoint-only serving bundle (counterpart of `dpcr_agb_tpu/serving.py`):
the model, its task spec, the eval transform pipelines and the weights,
rebuilt from a port checkpoint alone.

A port checkpoint is `<checkpoint_dir>/<model_name>.pt`, written with
`torch.save`, holding plain Python objects and tensors only:
  format        CHECKPOINT_FORMAT
  model_name    the `conf/models` key ("SENet14", "SENet50", "KPConv")
  option        that model entry (class, model_name, activation, ...)
  in_channels   the model's input feature width
  data          features, scales, centers, first_subsampling and the
                pre_transform / train_transform / test_transform lists as
                plain dicts
  target_stats  {"scale", "center", "weights"} per regression target
  reg_targets   target names
  weights       {weight_name: state_dict}
  numerics      the float32 settings the writing process ran with
                (`device.numerics()`: TF32 off, as the entry points pin it)
A checkpoint written by training also holds `train_state` (optimizer
state and counters, `training/state.py`), which serving ignores. Reading
the JAX package's `.ckpt` files (flax msgpack) is not ported."""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .data.batch import CollateSpec
from .device import numerics, resolve_device
from .models.base import InstanceSpec
from .models.factory import build_model, collate_spec, make_post_collate
from .transforms import Compose, instantiate_transforms

CHECKPOINT_FORMAT = "dpcr_agb_tpu_torch.checkpoint/1"

# The NFI dataset's pre_transform (conf/data/instance/NFI/default.yaml), the
# sparse_xy train and test chains (conf/data/instance/NFI/transforms/
# sparse-xy.yaml) and the xy ones (xy.yaml), with the ${data.*} values
# substituted: the machines that train and serve have no YAML reader.
_SKIP = ["y_mol", "y_mol_mask", "y_cls", "y_cls_mask", "y_reg", "y_reg_mask"]
_HEXAGON = [[0., 0.5], [0.25, 0.9330127], [0.75, 0.9330127], [1., 0.5],
            [0.75, 0.0669873], [0.25, 0.0669873]]
_SCALE_POS = {"transform": "ScalePos", "params": {
    "scale_x": 30, "scale_y": 30, "scale_z": 40, "op": "div"}}
_CENTER = {"transform": "MoveCenterPosPerSample",
           "params": {"center_x": 0.5, "center_y": 0.5}}


def _feats(max_points: int) -> list:
    """The point caps and the [ones, pos_z, xy_distance] features."""
    return [
        {"transform": "MaxPoints",
         "params": {"num": max_points, "skip_list": _SKIP}},
        {"transform": "MinPoints", "params": {"num": 500, "skip_list": _SKIP}},
        {"transform": "XYZFeature",
         "params": {"add_x": False, "add_y": False, "add_z": True}},
        {"transform": "AddOnes"},
        {"transform": "AddXYDistanceToCenter",
         "params": {"center_x": 0.5, "center_y": 0.5}},
        {"transform": "AddFeatsByKeys", "params": {
            "list_add_to_x": [True, True, True],
            "feat_names": ["ones", "pos_z", "xy_distance"],
            "delete_feats": [True, True, True],
            "input_nc_feats": [1, 1, 1]}},
    ]


_QUANTIZE = {"transform": "GridSampling3D", "params": {
    "size": 0.0125, "quantize_coords": True, "mode": "last"}}
# the augmentations both train chains start with, and the deterministic
# prefix of both test chains
_AUG_PREFIX = [
    {"transform": "RandomGroundRemoval", "params": {
        "min_v": 0.05, "max_v": 0.5, "p": 0.1, "min_points": 500,
        "skip_list": _SKIP}},
    {"transform": "RandomDropout", "params": {
        "dropout_ratio": 0.2, "dropout_application_ratio": 0.5,
        "min_points": 500, "skip_list": _SKIP}},
    _SCALE_POS,
    {"transform": "RandomNoise", "params": {"sigma": 0.0025}},
    {"transform": "Random3AxisRotation", "params": {
        "apply_rotation": True, "rot_x": 0, "rot_y": 0, "rot_z": 180}},
    {"transform": "RandomShiftPos", "params": {
        "p": 0.5, "max_x": 0.01, "max_y": 0.01, "max_z": 0.0}},
    _CENTER,
    {"transform": "StartZFromZero"},
    {"transform": "AddRandomPoints", "params": {
        "n_max_points": 12000, "add_ratio_min": 0.01,
        "add_ratio_max": 0.2, "p": 0.25}},
    {"transform": "CopyJitterRandomPoints", "params": {
        "n_max_points": 12000, "add_ratio_min": 0.01,
        "add_ratio_max": 0.2, "p": 0.25, "sigma": 0.005,
        "clip": 0.015}},
    {"transform": "RandomPolygon2dExtend", "params": {
        "polygons": [_HEXAGON], "rotate": 180, "skip_list": _SKIP}},
]
_DET_PREFIX = [
    _SCALE_POS,
    _CENTER,
    {"transform": "StartZFromZero"},
    {"transform": "Polygon2dExtend",
     "params": {"polygon": _HEXAGON, "skip_list": _SKIP}},
]
_NFI = {
    "features": [],
    "x_scale": 30, "y_scale": 30, "z_scale": 40,
    "x_center": 0.5, "y_center": 0.5,
    "first_subsampling": 0.0125,
    "pre_transform": [
        {"transform": "DBSCANZOutlierRemoval",
         "params": {"eps": 1.5, "min_samples": 10, "skip_list": _SKIP}},
        {"transform": "StartZFromZero"},
        {"transform": "ZFilter",
         "params": {"z_min": -1.0e-5, "z_max": 50, "skip_keys": _SKIP}},
    ],
}
NFI_SPARSE_XY = {
    "transform_type": "sparse_xy",
    **_NFI,
    "train_transform": [
        *_AUG_PREFIX,
        *_feats(16000),
        _QUANTIZE,
        {"transform": "RandomCoordsFlip",
         "params": {"ignored_axis": "z", "p": 0.5}},
        {"transform": "ShiftVoxels"},
    ],
    "test_transform": [*_DET_PREFIX, *_feats(16000), _QUANTIZE],
}
# The xy chains of the KPConv net (conf/data/instance/NFI/transforms/
# xy.yaml): the same prefixes, capped at 6144 points, no quantization.
NFI_XY = {
    "transform_type": "xy",
    **_NFI,
    "train_transform": [*_AUG_PREFIX, *_feats(6144)],
    "test_transform": [*_DET_PREFIX, *_feats(6144)],
}


def nfi_sparse_xy_data_cfg() -> dict:
    """A fresh copy of the NFI + sparse_xy data config."""
    return copy.deepcopy(NFI_SPARSE_XY)


def nfi_xy_data_cfg() -> dict:
    """A fresh copy of the NFI + xy data config (KPConv)."""
    return copy.deepcopy(NFI_XY)


@dataclasses.dataclass
class ServingBundle:
    net: torch.nn.Module
    spec: InstanceSpec
    conv_type: str
    collate_spec: CollateSpec
    post_collate: Optional[Callable]
    pre_transform: Compose
    eval_transform: Compose
    reg_targets: List[str]
    feature_cols: List[str]
    data_cfg: dict
    option: dict
    device: torch.device


def save_checkpoint(checkpoint_dir: str, model_name: str,
                    net: torch.nn.Module, option: dict, in_channels: int,
                    data_cfg: dict, target_stats: Dict[str, List[float]],
                    reg_targets: List[str],
                    weight_name: str = "latest",
                    extra: Optional[dict] = None) -> str:
    """Write `<checkpoint_dir>/<model_name>.pt` (with the keys of `extra`
    beside the serving ones); returns its path."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, f"{model_name}.pt")
    state = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    torch.save({
        "format": CHECKPOINT_FORMAT, "model_name": model_name,
        "option": copy.deepcopy(option), "in_channels": int(in_channels),
        "data": copy.deepcopy(data_cfg),
        "target_stats": {k: [float(x) for x in v]
                         for k, v in target_stats.items()},
        "reg_targets": list(reg_targets),
        "weights": {weight_name: state},
        "numerics": numerics(),
        **(extra or {}),
    }, path)
    return path


def load_serving_bundle(checkpoint_dir: str, model_name: str,
                        weight_name: str = "latest",
                        device=None) -> ServingBundle:
    """Rebuild everything needed for inference from the checkpoint alone,
    with the model in eval mode on `device` (CUDA unless "cpu" is asked
    for)."""
    dev = resolve_device(device)
    path = os.path.join(checkpoint_dir, f"{model_name}.pt")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if ckpt.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(f"{path}: not a {CHECKPOINT_FORMAT} checkpoint")
    if weight_name not in ckpt["weights"]:
        raise KeyError(f"{path}: no weights {weight_name!r} "
                       f"(has {sorted(ckpt['weights'])})")
    option, data_cfg = ckpt["option"], ckpt["data"]
    ts = ckpt["target_stats"]
    n_targets = len(ts["scale"])
    net, conv_type = build_model(option, n_targets, ckpt["in_channels"])
    net.load_state_dict(ckpt["weights"][weight_name])
    net.to(dev).eval()
    spec = InstanceSpec(
        num_reg_targets=n_targets,
        scale=np.asarray(ts["scale"], np.float32),
        center=np.asarray(ts["center"], np.float32),
        weights=np.asarray(ts["weights"], np.float32),
        out_activation=str(option.get("reg_out_activation", "linear")
                           or "linear").lower(),
        report_activation=str(option.get("reg_out_report_activation",
                                         "linear") or "linear").lower())
    return ServingBundle(
        net=net, spec=spec, conv_type=conv_type,
        collate_spec=collate_spec(conv_type, data_cfg),
        post_collate=make_post_collate(net),
        pre_transform=instantiate_transforms(data_cfg.get("pre_transform")),
        eval_transform=instantiate_transforms(data_cfg["test_transform"]),
        reg_targets=list(ckpt["reg_targets"])
        or [f"target_{i}" for i in range(n_targets)],
        feature_cols=list(data_cfg.get("features", []) or []),
        data_cfg=data_cfg, option=option, device=dev)
