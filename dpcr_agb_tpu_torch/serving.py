"""Checkpoint-only serving bundle (counterpart of `dpcr_agb_tpu/serving.py`):
the model, its task spec, the eval transform pipelines and the weights,
rebuilt from a checkpoint alone: the port's `<model_name>.pt`, or the JAX
package's `<model_name>.ckpt` (flax msgpack, `training/state.Checkpoint`).

A port checkpoint is `<checkpoint_dir>/<model_name>.pt`, written with
`torch.save`, holding plain Python objects and tensors only:
  format        CHECKPOINT_FORMAT
  model_name    the `conf/models` key ("SENet14", "SENet50", "KPConv",
                "MPointNet", "SimplestNet", "PointNext", "PointNet")
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
state and counters, `training/state.py`), which serving ignores.

From a JAX `.ckpt`, as `dpcr_agb_tpu/serving.py` reads it: the option is
run_config["models"][model_name]; the data config run_config["data"]; the
preset `{tt}_eval`, else `tt` (tt: `transform_type=`, else the stored
one) gives the test_transform, and its pre_transform, else the data
config's, the pre_transform; target_stats and reg_targets come from
dataset_properties; the weights are the state that `get_model_state`
names, mapped by `weights.from_flax`, and the model's input width is read
off them (`weights.in_channels_of`). A stored chain that names a
transform the port lacks raises with its name."""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .data.batch import Batch, CollateSpec
from .device import numerics, resolve_device
from .models.base import InstanceSpec, convert_outputs, reg_output
from .models.factory import build_model, collate_spec, make_post_collate
from .transforms import Compose, instantiate_transforms
from .weights import from_flax, in_channels_of

CHECKPOINT_FORMAT = "dpcr_agb_tpu_torch.checkpoint/1"

# The NFI dataset's pre_transform (conf/data/instance/NFI/default.yaml), the
# sparse_xy train and test chains (conf/data/instance/NFI/transforms/
# sparse-xy.yaml), the xy ones (xy.yaml) and the fixed_xy ones
# (fixed-xy.yaml), with the ${data.*} values substituted: the machines that
# train and serve have no YAML reader.
_SKIP = ["y_mol", "y_mol_mask", "y_cls", "y_cls_mask", "y_reg", "y_reg_mask"]
_HEXAGON = [[0., 0.5], [0.25, 0.9330127], [0.75, 0.9330127], [1., 0.5],
            [0.75, 0.0669873], [0.25, 0.0669873]]
_SCALE_POS = {"transform": "ScalePos", "params": {
    "scale_x": 30, "scale_y": 30, "scale_z": 40, "op": "div"}}
_CENTER = {"transform": "MoveCenterPosPerSample",
           "params": {"center_x": 0.5, "center_y": 0.5}}


# the [ones, pos_z, xy_distance] features every NFI chain ends with
_FEATURES = [
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


def _feats(max_points: int) -> list:
    """The point caps and the features."""
    return [
        {"transform": "MaxPoints",
         "params": {"num": max_points, "skip_list": _SKIP}},
        {"transform": "MinPoints", "params": {"num": 500, "skip_list": _SKIP}},
        *_FEATURES,
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


# The fixed_xy chains of SimplestNet and PointNeXt (conf/data/instance/NFI/
# transforms/fixed-xy.yaml): the same prefixes, then exactly 12000 points
# (FixedPointsOwn, resampling with the fewest duplicates when a plot has
# fewer) and the same features; collate pads every batch to 12000.
_FIXED_SUFFIX = [
    {"transform": "FixedPointsOwn",
     "params": {"num": 12000, "skip_list": _SKIP}},
    *_FEATURES,
]
NFI_FIXED_XY = {
    "transform_type": "fixed_xy",
    **_NFI,
    "fixed_xy": {"num_points": 12000},
    "train_transform": [*_AUG_PREFIX, *_FIXED_SUFFIX],
    "test_transform": [*_DET_PREFIX, *_FIXED_SUFFIX],
}


def nfi_sparse_xy_data_cfg() -> dict:
    """A fresh copy of the NFI + sparse_xy data config."""
    return copy.deepcopy(NFI_SPARSE_XY)


def nfi_xy_data_cfg() -> dict:
    """A fresh copy of the NFI + xy data config (KPConv)."""
    return copy.deepcopy(NFI_XY)


def nfi_fixed_xy_data_cfg() -> dict:
    """A fresh copy of the NFI + fixed_xy data config (SimplestNet,
    PointNeXt)."""
    return copy.deepcopy(NFI_FIXED_XY)


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


class ExportModule(torch.nn.Module):
    """A bundle's net as a function of plain tensors, the form that
    `export_model.py` exports: (pos [B,N,3] f32, x [B,N,C] f32, mask [B,N]
    bool, coords [B,N,3] int32 with PAD_COORD padding) -> de-standardized
    predictions [B, T] f32. The Batch is built as the JAX package's
    `scripts/export_model.py` builds it (zero targets and indices, coords
    only for the sparse collate, the static `aux`), and the head output
    goes through `reg_output(convert_outputs(...))` as `predict.predictions`
    does."""

    def __init__(self, bundle: ServingBundle, aux: Optional[dict]):
        super().__init__()
        self.net = bundle.net
        self.spec = bundle.spec
        self.aux = aux
        self.use_coords = bool(bundle.collate_spec.use_coords)

    def forward(self, pos: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                coords: torch.Tensor) -> torch.Tensor:
        bs, t, dev = pos.shape[0], len(self.spec.scale), pos.device
        batch = Batch(
            pos=pos, x=x, mask=mask,
            y_reg=torch.zeros((bs, t), dtype=torch.float32, device=dev),
            y_reg_mask=torch.zeros((bs, t), dtype=torch.bool, device=dev),
            area_idx=torch.zeros(bs, dtype=torch.int32, device=dev),
            label_idx=torch.zeros(bs, dtype=torch.int64, device=dev),
            is_double=torch.zeros(bs, dtype=torch.bool, device=dev),
            coords=coords if self.use_coords else None, aux=self.aux)
        raw = self.net(batch)
        return reg_output(self.spec, convert_outputs(self.spec, raw.float()))


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
                        device=None,
                        transform_type: Optional[str] = None
                        ) -> ServingBundle:
    """Rebuild everything needed for inference from the checkpoint alone,
    with the model in eval mode on `device` (CUDA unless "cpu" is asked
    for): `<model_name>.pt` when it is there, else `<model_name>.ckpt`.
    `transform_type` picks a JAX checkpoint's eval preset; a port
    checkpoint holds the chains of one preset only."""
    dev = resolve_device(device)
    pt = os.path.join(checkpoint_dir, f"{model_name}.pt")
    jax_ckpt = os.path.join(checkpoint_dir, f"{model_name}.ckpt")
    if os.path.exists(pt):
        stored = _read_port_checkpoint(pt, weight_name, transform_type)
    elif os.path.exists(jax_ckpt):
        stored = _read_jax_checkpoint(jax_ckpt, model_name, weight_name,
                                      transform_type)
    else:
        raise FileNotFoundError(f"no checkpoint of {model_name!r}: neither "
                                f"{pt} nor {jax_ckpt} exists")
    option, data_cfg, ts = stored.option, stored.data_cfg, stored.target_stats
    n_targets = len(ts["scale"])
    net, conv_type = build_model(option, n_targets, stored.in_channels)
    net.load_state_dict(stored.state_dict)
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
        pre_transform=instantiate_transforms(stored.pre_transform),
        eval_transform=instantiate_transforms(stored.test_transform),
        reg_targets=list(stored.reg_targets)
        or [f"target_{i}" for i in range(n_targets)],
        feature_cols=list(data_cfg.get("features", []) or []),
        data_cfg=data_cfg, option=option, device=dev)


@dataclasses.dataclass
class _Stored:
    """What a checkpoint file holds for serving, whichever its format."""
    option: dict
    data_cfg: dict
    pre_transform: Optional[list]
    test_transform: Optional[list]
    target_stats: Dict[str, List[float]]
    reg_targets: List[str]
    state_dict: Dict[str, torch.Tensor]
    in_channels: int


def _read_port_checkpoint(path: str, weight_name: str,
                          transform_type: Optional[str]) -> _Stored:
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if ckpt.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(f"{path}: not a {CHECKPOINT_FORMAT} checkpoint")
    if weight_name not in ckpt["weights"]:
        raise KeyError(f"{path}: no weights {weight_name!r} "
                       f"(has {sorted(ckpt['weights'])})")
    data_cfg = ckpt["data"]
    if transform_type not in (None, data_cfg.get("transform_type")):
        raise ValueError(f"{path} holds the {data_cfg.get('transform_type')}"
                         f" chains only, not {transform_type!r}")
    return _Stored(ckpt["option"], data_cfg, data_cfg.get("pre_transform"),
                   data_cfg["test_transform"], ckpt["target_stats"],
                   ckpt["reg_targets"], ckpt["weights"][weight_name],
                   ckpt["in_channels"])


def _read_jax_checkpoint(path: str, model_name: str, weight_name: str,
                         transform_type: Optional[str]) -> _Stored:
    # imported here: training.state imports this module
    from .training.state import Checkpoint, check_env_snapshot
    with open(path, "rb") as f:
        ckpt = Checkpoint.from_bytes(f.read())
    rc = ckpt.run_config
    check_env_snapshot(rc)
    data_cfg = rc["data"]
    option = rc["models"][model_name]
    tt = transform_type or data_cfg["transform_type"]
    preset = next((c for c in (f"{tt}_eval", tt) if c in data_cfg), None)
    if preset is None:
        raise ValueError(f"{path}: transform preset {tt!r} not in the "
                         "stored config")
    chains = dict(data_cfg[preset] or {})
    saved = ckpt.get_model_state(weight_name)
    state = from_flax(saved["params"], saved.get("batch_stats"))
    props = ckpt.dataset_properties
    return _Stored(option, data_cfg,
                   chains.get("pre_transform") or data_cfg.get(
                       "pre_transform"),
                   chains.get("test_transform"), props["target_stats"],
                   list(props.get("reg_targets", [])), state,
                   in_channels_of(option, state))
