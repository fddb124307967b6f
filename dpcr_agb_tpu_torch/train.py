"""Training CLI of the port, in two forms.

With the root `train.py`'s config grammar (no `input=`), it composes the
repository's `conf/` tree and runs the trainer (`training/trainer.py`):
epochs over an NFI-layout dataset (areas, label tables, splits, the
processed cache), val and test stages, metrics in `<run_dir>/metrics.jsonl`
and best-metric snapshots in `<run_dir>/<model_name>.ckpt`, the JAX
package's checkpoint format:

    python -m dpcr_agb_tpu_torch.train task=instance \\
        models=instance/minkowski_baseline model_name=SENet14 \\
        data=instance/synthetic/reg data.transform_type=sparse_xy \\
        training=nfi/minkowski lr_scheduler=cosineawr \\
        update_lr_scheduler_on=on_num_batch [device=cpu]

With `input=`, a few optimizer steps of a sparse-voxel ResNet/SENet
(SENet14 unless named otherwise), of the KPConv net, of MPointNet, of
SimplestNet or of PointNeXt (`PointNext`, `PointNet`) on `.npz` plots,
then a port checkpoint that `predict` serves:

    python -m dpcr_agb_tpu_torch.train input='plots/*.npz' \\
        checkpoint_dir=outputs/run \\
        [model_name=SENet14|...|MPointNet|SimplestNet|PointNext|PointNet] \\
        [steps=100] [batch_size=16] [seed=0] [bf16=false] \\
        [dense_dims=88,88,104|null] [level_caps=16384,12288,...] [device=cpu]

Each `.npz` holds `pos` [N,3] and one scalar per regression target
(`BMag_ha`, `V_ha`); a missing or NaN target is masked out of the loss.
Targets are standardized by their mean and standard deviation over the
training plots (np.nanmean, np.nanstd). Every plot goes through the NFI
pre_transform once; every step draws `batch_size` plots from a reshuffled
stream, runs the model's train chain on each (sparse_xy for the
sparse-voxel nets and MPointNet, xy for KPConv, fixed_xy for SimplestNet
and PointNeXt),
collates and post-collates them, and takes one step of the paper's recipe
(the same for every model): AdaBelief (lr 5e-3, weight
decay 1e-2) behind an elementwise gradient clip at 100, with
CosineAnnealingWarmRestarts (T_0 10, T_mult 2) stepped per batch. It runs
on CUDA unless `device=cpu` is given, and raises when there is no CUDA
device and the CPU was not asked for. `bf16=true` is the bf16 compute dtype
of the sparse-voxel nets' convs, and for KPConv that of the fused
kernel-point convolution only; MPointNet, SimplestNet and PointNeXt run
in f32 only, as the JAX models do, and refuse it. `dense_dims` applies to
the sparse-voxel nets, whose level-0 execution modes are read from
DPCR_L0, DPCR_STEM_MODE, DPCR_POOL_BWD, DPCR_SPARSE_POOL and DPCR_POOL_FWD
when the model is built (`models/minkowski.py`); `dense_dims=null` is
their map mode, with `level_caps` its voxel cap a level (the config form:
`models.<name>.extra_options.dense_dims=null` and `...level_caps=[...]`).

Both forms run on CUDA unless `device=cpu` is given, and raise when there
is no CUDA device and the CPU was not asked for."""
from __future__ import annotations

import copy
import dataclasses
import glob
import logging
import os
import sys
from typing import Dict, List

import numpy as np
import torch

from .cli import CONF_DIR, split_device
from .data.batch import Batch, collate
from .device import resolve_device
from .parallel import destroy, maybe_init_distributed
from .models.base import InstanceSpec
from .models.factory import (build_model, collate_spec, f32_only,
                              make_post_collate)
from .predict import describe_batch, sample_from_file
from .serving import (nfi_fixed_xy_data_cfg, nfi_sparse_xy_data_cfg,
                      nfi_xy_data_cfg)
from .training.optim import AdaBelief, make_lr_fn
from .training.state import save_train_checkpoint
from .training.step import StepRunner
from .transforms import instantiate_transforms

log = logging.getLogger(__name__)

REG_TARGETS = ["BMag_ha", "V_ha"]
# conf/models/instance/minkowski_baseline.yaml: the ResNet/SENet entries
# share everything but model_name


def _resnet_entry(model_name: str) -> dict:
    return {"class": "minkowski.MinkowskiBaselineModel",
            "conv_type": "SPARSE", "model_name": model_name, "D": 3,
            "activation": "gelu", "first_stride": 1, "dropout": 0.0,
            "drop_path": 0.01, "global_pool": "sum"}


SENET14 = _resnet_entry("SENet14")
# conf/models/instance/kpconv.yaml with data.first_subsampling substituted
KPCONV = {"class": "kpconv.KPConv", "conv_type": "PARTIAL_DENSE",
          "model_name": "KPConv",
          "config": {
              "in_points_dim": 3, "in_features_dim": "FEAT",
              "in_radius": 1.0,
              "architecture": [
                  "simple", "resnetb", "resnetb_strided", "resnetb",
                  "resnetb", "resnetb_strided", "resnetb", "resnetb",
                  "resnetb_strided", "resnetb", "resnetb",
                  "resnetb_strided", "resnetb", "resnetb", "global_sum"],
              "first_features_dim": 64, "use_batch_norm": True,
              "batch_norm_momentum": 0.02, "activation": "relu",
              "num_kernel_points": 15, "first_subsampling_dl": 0.0125,
              "conv_radius": 2.5, "deform_radius": 5.0, "KP_extent": 1.0,
              "KP_influence": "linear", "aggregation_mode": "sum",
              "fixed_kernel_points": "center", "modulated": False},
          "extra_options": {"kp_disposition": "auto"}}
# conf/models/instance/minkowski_baseline.yaml:7-16 (README.md's MPointNet
# recipe) and conf/models/instance/simplestnet.yaml
MPOINTNET = {"class": "minkowski.MinkowskiBaselineModel",
             "conv_type": "SPARSE", "model_name": "MinkowskiPointNet",
             "D": 3, "activation": "gelu", "first_stride": 1,
             "dropout": 0.0, "global_pool": "sum", "add_pos": True}
SIMPLESTNET = {"class": "simplestnet.SimplestNet",
               "conv_type": "PARTIAL_DENSE"}
# conf/models/instance/pointnext.yaml and pointnet.yaml with
# data.first_subsampling substituted
POINTNEXT = {"class": "pointnext.PointNext", "conv_type": "PARTIAL_DENSE",
             "arch": "pointnext_s", "radius": 0.0125, "radius_scaling": 2,
             "nsample": 32, "stride": 4, "activation": "relu",
             "num_points": 8192, "use_mlps": True}
POINTNET = {"class": "pointnext.PointNext", "conv_type": "PARTIAL_DENSE",
            "arch": "pointnet", "radius": 0.0125, "stride": 4,
            "num_points": 8192}
MODELS = {"SENet14": (SENET14, nfi_sparse_xy_data_cfg),
          "KPConv": (KPCONV, nfi_xy_data_cfg),
          "MPointNet": (MPOINTNET, nfi_sparse_xy_data_cfg),
          "SimplestNet": (SIMPLESTNET, nfi_fixed_xy_data_cfg),
          "PointNext": (POINTNEXT, nfi_fixed_xy_data_cfg),
          "PointNet": (POINTNET, nfi_fixed_xy_data_cfg),
          **{key: (_resnet_entry(key), nfi_sparse_xy_data_cfg)
             for key in ("SENet18", "SENet34", "SENet50", "SENet101")},
          **{key: (_resnet_entry(key + "_"), nfi_sparse_xy_data_cfg)
             for key in ("ResNet14", "ResNet18", "ResNet34", "ResNet50",
                         "ResNet101")}}
# conf/training/nfi/minkowski.yaml and kpconv.yaml (the same recipe),
# conf/lr_scheduler/cosineawr.yaml
RECIPE = {"base_lr": 5e-3, "weight_decay": 1e-2, "grad_clip": 100.0,
          "lr_scheduler": {"class": "CosineAnnealingWarmRestarts",
                           "params": {"T_0": 10, "T_mult": 2}},
          "update_lr_scheduler_on": "on_num_batch"}


def _parse(overrides: List[str]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for o in overrides:
        if "=" not in o:
            raise ValueError(f"expected key=value, got {o!r}")
        k, v = o.split("=", 1)
        out[k] = v
    for req in ("input", "checkpoint_dir"):
        if req not in out:
            raise ValueError(f"train requires {req}=")
    return out


def model_option(model_name: str, bf16: bool, dense_dims=None,
                 level_caps=None) -> dict:
    """The model's entry with extra_options.bf16, dense_dims (the string
    "null": map mode) and level_caps set where they are given."""
    if model_name not in MODELS:
        raise NotImplementedError(f"{model_name}: the port trains "
                                  f"{sorted(MODELS)} yet")
    option = copy.deepcopy(MODELS[model_name][0])
    extra = dict(option.get("extra_options", {}))
    if bf16:
        if f32_only(option):
            raise ValueError(f"{model_name} runs in f32 only (the JAX model "
                             f"has no bf16 form): bf16=true is refused")
        extra["bf16"] = True
    for key, value in (("dense_dims", dense_dims),
                       ("level_caps", level_caps)):
        if value is None:
            continue
        if option["class"] != "minkowski.MinkowskiBaselineModel" \
                or f32_only(option):
            raise ValueError(f"{key} applies to the sparse-voxel nets")
        extra[key] = None if value == "null" else [int(n) for n in value]
    if extra:
        option["extra_options"] = extra
    return option


def load_plots(files: List[str], data_cfg: dict,
               reg_targets: List[str]) -> List[dict]:
    """Every plot file as a pre-transformed sample with its targets
    (y_reg, and y_reg_mask False where a target is missing or NaN)."""
    pre = instantiate_transforms(data_cfg.get("pre_transform"))
    samples = []
    for path in files:
        s = sample_from_file(path, list(data_cfg.get("features", []) or []),
                             None, pre)
        if s is None:
            continue
        with np.load(path) as z:
            y = np.array([float(z[t]) if t in z else np.nan
                          for t in reg_targets], np.float32)
        s["y_reg"] = y
        s["y_reg_mask"] = ~np.isnan(y)
        samples.append(s)
    return samples


def target_stats(samples: List[dict]) -> Dict[str, List[float]]:
    """Standardization of each target over the training plots: center =
    nanmean, scale = nanstd (1 where it is 0 or undefined), weights 1."""
    y = np.stack([s["y_reg"] for s in samples]).astype(np.float64)
    center = np.nanmean(y, axis=0)
    scale = np.nanstd(y, axis=0)
    scale = np.where(np.isfinite(scale) & (scale > 0), scale, 1.0)
    center = np.where(np.isfinite(center), center, 0.0)
    return {"scale": [float(v) for v in scale],
            "center": [float(v) for v in center],
            "weights": [1.0] * y.shape[1]}


class BatchStream:
    """Host batches for training: plots drawn from a stream reshuffled at
    each pass, the train chain run on each draw (one rng through all),
    then collate and post_collate."""

    def __init__(self, samples: List[dict], train_cfg: list, net, conv_type,
                 data_cfg: dict, batch_size: int, seed: int):
        self.samples = samples
        self.transform = instantiate_transforms(train_cfg)
        self.spec = collate_spec(conv_type, data_cfg)
        self.post_collate = make_post_collate(net)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.order: List[int] = []

    def next(self) -> Batch:
        picked = []
        while len(picked) < self.batch_size:
            if not self.order:
                self.order = list(self.rng.permutation(len(self.samples)))
            picked.append(self.order.pop(0))
        batch = collate([self.transform(self.rng, dict(self.samples[i]))
                         for i in picked], self.spec)
        return self.post_collate(batch) if self.post_collate else batch


def build_runner(net, stats: Dict[str, List[float]], seed: int,
                 recipe: dict = RECIPE) -> StepRunner:
    spec = InstanceSpec(num_reg_targets=len(stats["scale"]),
                        scale=np.asarray(stats["scale"], np.float32),
                        center=np.asarray(stats["center"], np.float32),
                        weights=np.asarray(stats["weights"], np.float32))
    lr_fn = make_lr_fn(recipe["lr_scheduler"], recipe["base_lr"],
                       recipe["update_lr_scheduler_on"])
    opt = AdaBelief(net.parameters(), lr_fn,
                    weight_decay=recipe["weight_decay"])
    return StepRunner(net, spec, opt, grad_clip=recipe["grad_clip"],
                      seed=seed)


IN_CHANNELS = 3  # ones, pos_z, xy_distance


@dataclasses.dataclass
class TrainSetup:
    runner: StepRunner
    stream: BatchStream
    option: dict
    data_cfg: dict
    stats: Dict[str, List[float]]


def setup(files: List[str], model_name: str = "SENet14", bf16: bool = False,
          dense_dims=None, batch_size: int = 16, seed: int = 0,
          device=None, level_caps=None) -> TrainSetup:
    """Everything a run needs before its first step: the plots through the
    pre_transform, the target standardization, the model built from `seed`
    on `device`, its step runner and the stream of host batches."""
    dev = resolve_device(device)
    option = model_option(model_name, bf16, dense_dims, level_caps)
    data_cfg = MODELS[model_name][1]()
    samples = load_plots(files, data_cfg, REG_TARGETS)
    if not samples:
        raise ValueError("no usable training plots")
    stats = target_stats(samples)
    net, conv_type = build_model(option, len(REG_TARGETS), IN_CHANNELS,
                                 generator=torch.Generator().manual_seed(seed))
    net.to(dev)
    stream = BatchStream(samples, data_cfg["train_transform"], net,
                         conv_type, data_cfg, batch_size, seed)
    return TrainSetup(build_runner(net, stats, seed), stream, option,
                      data_cfg, stats)


def train_from_config(overrides: List[str]):
    """The config form: compose `conf/config.yaml` with the overrides and
    train; returns the Trainer."""
    from .config import load_config
    from .training.trainer import Trainer
    device, overrides = split_device(overrides)
    started = maybe_init_distributed(device)
    try:
        dev = resolve_device(device)
        cfg = load_config(CONF_DIR, "config", overrides)
        if cfg.get("pretty_print"):
            print(cfg.pretty())
        trainer = Trainer(cfg, device=dev)
        trainer.train()
    finally:
        if started:
            destroy()
    return trainer


def main(overrides=None):
    """Train. The config form returns the Trainer; the `input=` form
    returns {"checkpoint": path, "losses": [per-step loss]}."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    overrides = list(overrides if overrides is not None else sys.argv[1:])
    if not any(o.startswith("input=") for o in overrides):
        return train_from_config(overrides)
    if os.environ.get("DPCR_MULTIHOST", "0") == "1":
        raise ValueError("the input= form trains in one process; several "
                         "processes take the config form (the root "
                         "grammar)")
    args = _parse(overrides)
    files = sorted(glob.glob(args["input"]))
    if os.path.isdir(args["input"]):
        files = sorted(glob.glob(os.path.join(args["input"], "*.npz")))
    if not files:
        raise FileNotFoundError(f"no input files match {args['input']!r}")
    model_name = args.get("model_name", "SENet14")
    dims, caps = args.get("dense_dims"), args.get("level_caps")
    if dims and dims.lower() in ("null", "none"):
        dims = "null"
    elif dims:
        dims = dims.split(",")
    run = setup(files, model_name,
                bf16=args.get("bf16", "false").lower() in ("1", "true"),
                dense_dims=dims or None,
                batch_size=int(args.get("batch_size", 16)),
                seed=int(args.get("seed", 0)), device=args.get("device"),
                level_caps=caps.split(",") if caps else None)
    runner = run.runner
    losses = []
    for i in range(int(args.get("steps", 100))):
        batch = run.stream.next()
        loss = float(runner.train(batch)["loss"])
        losses.append(loss)
        log.info("step %d: loss %.6f, %s, lr %.6g", i, loss,
                 describe_batch(batch),
                 runner.optimizer.param_groups[0]["lr"])
    path = save_train_checkpoint(args["checkpoint_dir"], model_name, runner,
                                 run.option, IN_CHANNELS, run.data_cfg,
                                 run.stats, REG_TARGETS)
    log.info(f"wrote {path} after {runner.step} steps")
    return {"checkpoint": path, "losses": losses}


if __name__ == "__main__":
    main()
