"""Trainer orchestration (counterpart of `dpcr_agb_tpu/training/trainer.py`).

Builds the checkpoint manager, the dataset, the model, the loaders, the
tracker and the prediction writer from a composed config (the root CLIs'
grammar, `config/engine.py`), then runs epochs: a train stage tracked every
10th batch, then the val and test stages every `eval_frequency` epochs,
best-metric snapshots on the selection stage, early stop, the plateau lr
scale and the BN-momentum schedule. Eval outputs stay on the card during a
stage and come to the host once at its end.

It runs on `device` (CUDA unless the entry point was asked for the CPU).
On CUDA the loaders copy each batch to the card on their own stream, from
pinned memory, and the step waits on the batch's event. `enable_mixed`
gives bf16 compute to the models that have a bf16 form (the sparse-voxel
nets and KPConv); MPointNet, SimplestNet and the PointNeXt models stay f32
(logged), as the JAX trainer leaves models without a `dtype`.

KPConv's neighbour caps are calibrated at start-up, before the model is
built, as the JAX trainer does: 16 training plots through the host
pyramid's schedule, each level capped at the `calibrate_percentile` (90;
the DPCR_KP_CALIB_PCT variable overrides it) of its neighbour counts. The
caps go into the model option and the checkpoint's run_config, so that
eval, calibrate_bn and predict rebuild the same caps. Explicit
`extra_options.neighborhood_limits` win, and `auto_calibrate_limits:
False` keeps the default 40 a level. `debugging.find_neighbour_dist` logs
the caps of `num_find_neighbour_samples` plots at the start of `train`.

The model option's `regularizers` add an L1, L2 or elastic penalty over
the parameters to the loss (`training/regularizers.py`), and its
`head_optim_settings` / `backbone_optim_settings` give the parameters
under `head_namespace` (default `final`) and the rest optimizers of their
own (`training/optim.MultiTransform`), as the JAX trainer's
optax.multi_transform does.

Several processes, one card each (`torchrun` with DPCR_MULTIHOST=1; the
entry points start the group, `parallel.maybe_init_distributed`): each
rank loads its contiguous batch_size/world slice of every global batch
(`Loader(shard=(rank, world))`) and the step runner gives the global
batch's numbers (`training/step.py`). As the JAX trainer: batch_size must
divide by the world size; the V bucket is pinned to the ladder's top and
the z bucket to the full extent (`models/factory.make_post_collate`), so
every rank takes the same shapes; a dense collate without `num_points`
and a `pre_batch_collate` hook (ClampBatchSize: a per-shard clamp would
give another global batch) raise. Rank 0 alone writes the checkpoint,
metrics.jsonl, the prediction exports, tensorboard and wandb; the other
ranks track the same gathered rows without writing. The point-cloud
panels (ply, tensorboard and wandb clouds) are off: the points live in
the local shard only. Every rank reads the same `.ckpt` on resume, and
rank 0's weights are broadcast after the restore."""
from __future__ import annotations

import copy
import dataclasses
import logging
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.batch import device_put
from ..data.dataset import instantiate_dataset
from ..data.loader import Loader
from ..models.base import build_instance_spec
from ..models.factory import (build_model, collate_spec, f32_only,
                              has_bn_schedule, make_post_collate)
from ..nn.norm import MaskedBatchNorm
from ..parallel import broadcast_state, is_main, rank, world_size
from ..utils.neighbor_calibration import run_find_neighbour_dist
from ..visualization.visualizer import Visualizer
from .optim import (Accumulator, bn_momentum_fn, make_grouped_optimizer,
                    make_lr_fn, make_optimizer)
from .regularizers import build_regularizer
from .state import ModelCheckpoint, check_env_snapshot, dpcr_env_snapshot
from .step import StepRunner, host

log = logging.getLogger(__name__)


def _plain(cfg):
    return cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg or {})


class Trainer:
    def __init__(self, cfg, eval_mode: bool = False,
                 device: Optional[torch.device] = None):
        self._cfg = cfg
        self._eval_mode = eval_mode
        self.device = torch.device(device if device is not None else "cuda")
        # per-epoch and per-stage numbers of this process's run
        self.history: List[dict] = []
        self._initialize_trainer()

    # ------------------------------------------------------------------ init
    def _initialize_trainer(self) -> None:
        cfg = self._cfg
        self.training_cfg = cfg["training"]
        get_t = self.training_cfg.get
        self.epochs = int(get_t("epochs", 1))
        self.batch_size = int(get_t("batch_size", 2))
        self.shuffle = bool(get_t("shuffle", True))
        self.num_workers = int(get_t("num_workers", 4))
        self.seed = int(cfg.get("seed", 0) or 0)
        self.eval_frequency = int(cfg.get("eval_frequency", 1))
        self.selection_stage = str(cfg.get("selection_stage", "") or "val")
        self.update_lr_on = str(cfg.get("update_lr_scheduler_on",
                                        "on_epoch"))
        dbg = cfg.get("debugging", {}) or {}
        self.early_break = bool(dbg.get("early_break", False))
        self.num_batches_stop = dbg.get("num_batches", 0) or 0
        self.profiling = bool(dbg.get("profiling", False))
        self.progress_batches = int(dbg.get("progress_batches", 0) or 0)
        self.find_neighbour_dist = bool(dbg.get("find_neighbour_dist",
                                                False))
        self.num_find_neighbour_samples = int(
            dbg.get("num_find_neighbour_samples", 32))
        # several processes: rank 0 owns the files
        self._world = world_size()
        self._is_main = is_main()
        if self._world > 1 and self.batch_size % self._world:
            raise ValueError(
                f"multi-process run: batch_size {self.batch_size} must "
                f"divide by the world size {self._world}")

        checkpoint_dir = str(get_t("checkpoint_dir", "") or "")
        self.resume = bool(checkpoint_dir)
        self.run_dir = str(cfg.get("run_dir", ".") or ".")
        Path(self.run_dir).mkdir(parents=True, exist_ok=True)
        self.model_name = str(cfg["model_name"])

        run_config = _plain(cfg)
        run_config["dpcr_env"] = dpcr_env_snapshot()
        self.checkpoint = ModelCheckpoint(
            checkpoint_dir or self.run_dir, self.model_name,
            self.selection_stage, run_config=run_config,
            resume=self.resume, save_dir=self.run_dir, write=self._is_main)
        saved_stats = (self.checkpoint.checkpoint.dataset_properties
                       or {}).get("target_stats")
        if self.resume and not self.checkpoint.is_empty():
            saved = self.checkpoint.checkpoint.run_config
            check_env_snapshot(saved)
            # the forward-only entry points give no enable_mixed: inherit
            # the compute dtype the checkpoint trained with
            saved_tr = dict((saved or {}).get("training") or {})
            if get_t("enable_mixed", None) is None and \
                    saved_tr.get("enable_mixed"):
                self.training_cfg["enable_mixed"] = True
                log.info("inherited enable_mixed=True (bf16 compute) from "
                         "the checkpoint run config")

        t_data = time.perf_counter()
        self.dataset = instantiate_dataset(cfg["data"])
        # generation of a synthetic dataset, label processing and the plot
        # cuts (or the read of the processed cache)
        self.dataset_seconds = time.perf_counter() - t_data
        if self.model_name not in cfg["models"]:
            raise ValueError(f"Model {self.model_name!r} not found in models "
                             f"config. Available: {sorted(cfg['models'])}")
        self.option = copy.deepcopy(_plain(cfg["models"][self.model_name]))
        self._auto_calibrate_kpconv_limits()
        if bool(get_t("enable_mixed", False)):
            if f32_only(self.option):
                log.info(f"enable_mixed: {self.model_name} has no bf16 form "
                         "and trains in f32, as the JAX trainer leaves it")
            else:
                self.option["extra_options"] = {
                    **(self.option.get("extra_options") or {}), "bf16": True}
        in_channels = self.dataset.feature_dimension
        net, self.conv_type = build_model(
            self.option, self.dataset.num_reg_classes, in_channels,
            generator=torch.Generator().manual_seed(self.seed))
        self.net = net.to(self.device)
        self.spec = build_instance_spec(self.dataset, self.option)
        if self.resume and saved_stats and \
                self.option.get("override_target_stats", True):
            self.spec = _with_stats(self.spec, saved_stats)
            log.info("restored target normalization stats from checkpoint")
        props = self.checkpoint.checkpoint.dataset_properties
        props["target_stats"] = {
            k: np.asarray(getattr(self.spec, k)).tolist()
            for k in ("scale", "center", "weights")}
        props.setdefault("reg_targets", list(self.dataset.reg_targets))

        self.collate = collate_spec(self.conv_type,
                                    _plain(self.dataset.dataset_opt))
        self.post_collate = make_post_collate(self.net)
        self._create_loaders()

        optim_cfg = _plain(self.training_cfg.get("optim", {}) or {})
        base_lr = float(optim_cfg.get("base_lr", 1e-3))
        accum = int(optim_cfg.get("accumulated_gradient", 1) or 1)
        train_loader = self.loaders.get("train")
        self.lr_fn = make_lr_fn(
            optim_cfg.get("lr_scheduler"), base_lr, self.update_lr_on,
            batches_per_epoch=max((len(train_loader) if train_loader
                                   else 1) // accum, 1),
            batch_size=self.batch_size * accum, steps_per_update=accum)
        opt = optim_cfg.get("optimizer", {}) or {}
        self.optimizer_name = str(opt.get("class", "AdaBelief"))
        self._opt_params = dict(opt.get("params", {}) or {})
        grad_clip = float(optim_cfg.get("grad_clip", -1) or -1)
        head_set = dict(self.option.get("head_optim_settings") or {})
        back_set = dict(self.option.get("backbone_optim_settings") or {})
        if head_set or back_set:
            optimizer = make_grouped_optimizer(
                self.optimizer_name, dict(self.net.named_parameters()),
                self.lr_fn, self._opt_params, head_set, back_set,
                str(self.option.get("head_namespace", "final")))
        else:
            optimizer = make_optimizer(self.optimizer_name,
                                       self.net.parameters(), self.lr_fn,
                                       self._opt_params)
        self.runner = StepRunner(
            self.net, self.spec, optimizer,
            grad_clip=grad_clip if grad_clip > 0 else None, seed=self.seed,
            accumulator=Accumulator(accum) if accum > 1 else None,
            regularizer=build_regularizer(self.option))
        self.bn_momentum_fn = bn_momentum_fn(optim_cfg.get("bn_scheduler"))
        sched_cfg = optim_cfg.get("lr_scheduler") or {}
        self._plateau = None
        if str(sched_cfg.get("class", "")) == "ReduceLROnPlateau":
            p = sched_cfg.get("params", {}) or {}
            self._plateau = {
                "mode": str(p.get("mode", "min")),
                "factor": float(p.get("factor", 0.1)),
                "patience": int(p.get("patience", 10)),
                "best": None, "bad": 0, "scale": 1.0,
            }
        self._maybe_restore_weights()
        # every rank starts from rank 0's state
        broadcast_state(self.net)

        wandb_log = bool((self.training_cfg.get("wandb") or {}).get(
            "log", False)) and self._is_main
        if wandb_log:
            wandb_log = _wandb_init(self.training_cfg.get("wandb"),
                                    run_config, self.run_dir)
        tb_log = bool((self.training_cfg.get("tensorboard") or {}).get(
            "log", False)) and self._is_main
        # the other ranks compute the same gathered metrics and predictions
        # and write none of them
        self.tracker = self.dataset.get_tracker(
            wandb_log, tb_log,
            log_dir=self.run_dir if self._is_main else None)
        num_batches = {s: (len(l) if l else 0)
                       for s, l in self.loaders.items()}
        self.visualizer = Visualizer(
            (cfg.get("visualization", {}) or {}) if self._is_main
            else {"format": []},    # {} would take the csv default
            num_batches, self.batch_size, self.run_dir)
        self._wants_pos = self.visualizer.wants_pos
        if self._world > 1 and self._wants_pos:
            log.warning("multi-host: ply/3D point-cloud panels are disabled "
                        "(positions are host-local); csv/gpkg stay global")
            self._wants_pos = False

    def _auto_calibrate_kpconv_limits(self) -> None:
        """KPConv's per-level neighbour caps from 16 training plots (see the
        module docstring), written into the model option and into the
        checkpoint's run_config; nothing for other models, for explicit
        limits or with auto_calibrate_limits False."""
        option = self.option
        if "kpconv" not in str(option.get("class", "")).lower() or \
                not option.get("auto_calibrate_limits", True):
            return
        extra = dict(option.get("extra_options") or {})
        if extra.get("neighborhood_limits"):
            return
        env_pct = os.environ.get("DPCR_KP_CALIB_PCT")
        pct = (float(env_pct) if env_pct
               else float(option.get("calibrate_percentile", 90.0)))
        limits = run_find_neighbour_dist(self.dataset, option, n_samples=16,
                                         percentile=pct)
        if not limits:
            return
        extra["neighborhood_limits"] = [int(x) for x in limits]
        option["extra_options"] = extra
        # run_config was taken before the dataset existed
        rc = self.checkpoint.checkpoint.run_config
        try:
            rc["models"][self.model_name].setdefault("extra_options", {})
            rc["models"][self.model_name]["extra_options"][
                "neighborhood_limits"] = extra["neighborhood_limits"]
        except (KeyError, TypeError):
            pass
        log.info(f"auto-calibrated neighborhood_limits: {limits}")

    def _create_loaders(self) -> None:
        spec, shard = self.collate, None
        pre_batch = self.dataset.pre_batch_collate_transform
        if self._world > 1:
            # every rank must take the same shapes: a bucket chosen from
            # the local batch could differ between ranks
            if spec.buckets:
                spec = dataclasses.replace(spec,
                                           buckets=(max(spec.buckets),))
            elif spec.num_points is None:
                raise ValueError(
                    "multi-host run with a dense collate needs a "
                    "deterministic global shape: set the preset's "
                    "num_points (e.g. transform_type=fixed_xy) or a "
                    "bucket ladder")
            if pre_batch is not None:
                raise ValueError(
                    "multi-host run is incompatible with "
                    "pre_batch_collate_transform (per-shard clamping would "
                    "diverge from the single-process batch); drop the hook "
                    "or run single-host")
            shard = (rank(), self._world)
        self.loaders: Dict[str, Optional[Loader]] = {}
        streams = {}
        for split in ("train", "val", "test"):
            ds = self.dataset.datasets.get(split)
            if ds is None or len(ds) == 0:
                self.loaders[split] = None
                continue
            put_fn = None
            if self.device.type == "cuda":
                # the copy of batch k+1 overlaps the step of batch k
                streams[split] = torch.cuda.Stream(self.device)
                put_fn = (lambda b, _s=streams[split]:
                          device_put(b, self.device, _s))
            is_train = split == "train" and not self._eval_mode
            self.loaders[split] = Loader(
                ds, self.dataset.transform_for(split),
                batch_size=self.batch_size, spec=spec,
                shuffle=is_train and self.shuffle,
                double_batch=self.spec.double_batch and is_train,
                drop_last=is_train, seed=self.seed,
                num_workers=self.num_workers,
                post_collate=self.post_collate,
                pre_batch_collate=pre_batch, shard=shard, put_fn=put_fn)
        if not any(self.loaders.values()):
            raise RuntimeError("No data available in any split")
        for split, loader in self.loaders.items():
            if loader is not None and len(loader) == 0:
                raise RuntimeError(
                    f"The '{split}' split yields zero batches: "
                    f"{len(loader.dataset)} sample(s) with "
                    f"batch_size={loader.batch_size}"
                    + (" and drop_last" if loader.drop_last else "")
                    + ". Lower training.batch_size or provide more data "
                    "(e.g. data.synthetic_plots).")

    def _maybe_restore_weights(self) -> None:
        if self.checkpoint.is_empty():
            return
        weight_name = str(self.training_cfg.get("weight_name", "latest"))
        ckpt = self.checkpoint.checkpoint
        self.runner.load_model_state(ckpt.get_model_state(weight_name))
        opt = ckpt.optimizer
        if opt and opt[1] and not self._eval_mode:
            if str(opt[0]).lower() != self.optimizer_name.lower():
                log.warning(f"checkpoint optimizer {opt[0]} differs from "
                            f"{self.optimizer_name}: state not restored")
            else:
                self.runner.load_opt_state_leaves(opt[1]["opt_state"]["flat"])
                self.runner.step = int(opt[1].get("step", 0))
                self.runner.epoch = int(opt[1].get("epoch", 0))
                self.runner.num_samples = int(opt[1].get("num_samples", 0))
        log.info(f"Restored weights '{weight_name}' "
                 f"(epoch {self.checkpoint.start_epoch - 1})")

    # ------------------------------------------------------------------ loops
    @property
    def start_epoch(self) -> int:
        return self.checkpoint.start_epoch

    def _apply_plateau(self, metrics: dict) -> None:
        """ReduceLROnPlateau on the selection stage's loss: after `patience`
        evaluations without improvement the lr is scaled by `factor`; the
        optimizer's state is kept."""
        if self._plateau is None:
            return
        key = next((k for k in metrics if k.endswith("_loss")), None)
        if key is None:
            return
        value = float(metrics[key])
        st = self._plateau
        better = st["best"] is None or (
            value < st["best"] if st["mode"] == "min" else value > st["best"])
        if better:
            st["best"], st["bad"] = value, 0
            return
        st["bad"] += 1
        if st["bad"] > st["patience"]:
            st["scale"] *= st["factor"]
            st["bad"] = 0
            log.info(f"ReduceLROnPlateau: lr scale -> {st['scale']:g}")
            self.runner.optimizer.lr_fn = (
                lambda c, _b=self.lr_fn, _s=np.float32(st["scale"]):
                _b(c) * _s)

    def train(self) -> None:
        if self.find_neighbour_dist:
            limits = run_find_neighbour_dist(
                self.dataset, self.option, self.num_find_neighbour_samples)
            log.info(f"calibrated neighborhood_limits: {limits} "
                     "(pass via models.<name>.extra_options."
                     "neighborhood_limits)")
        start = self.start_epoch
        if start > self.epochs:
            # finished run resumed: one final test epoch
            self._test_epoch(start, "test")
            return
        for epoch in range(start, self.epochs + 1):
            log.info(f"EPOCH {epoch} / {self.epochs}")
            self._train_epoch(epoch)
            if self.profiling and self.num_batches_stop:
                return
            eval_stages = [s for s in ("val", "test")
                           if self.eval_frequency
                           and epoch % self.eval_frequency == 0
                           and self.loaders.get(s)]
            # one checkpoint write per epoch, at its last stage
            self._persist_next = not eval_stages
            for i, stage in enumerate(eval_stages):
                self._persist_next = i == len(eval_stages) - 1
                metrics = self._test_epoch(epoch, stage)
                if stage == (self.selection_stage or "val"):
                    self._apply_plateau(metrics)

    def eval(self, stage: str = "test") -> Dict[str, float]:
        if self.loaders.get(stage) is None:
            log.warning(f"No {stage} dataset, skipping")
            return {}
        return self._test_epoch(self.start_epoch - 1, stage)

    def iterate_epochs(self, n: int) -> None:
        """BN recalibration: forward-only train-mode epochs."""
        for i in range(n):
            log.info(f"BN calibration epoch {i + 1}/{n}")
            self.tracker.reset("train")
            for bi, batch in enumerate(self.loaders["train"].epoch(i)):
                out = self.runner.calibrate(batch, salt=i * 100003 + bi)
                self._track(out, every=10, batch_i=bi)
                if self._stop_early(bi):
                    break
            metrics = self.tracker.get_metrics()
            self.checkpoint.save_best_models_under_current_metrics(
                self.runner, "train", self.start_epoch - 1, metrics,
                self.tracker.metric_func, self.optimizer_name,
                persist=self._is_main)

    def _apply_bn_schedule(self, epoch: int) -> None:
        """The BN-momentum schedule: every masked BN of the model takes the
        epoch's momentum (SimplestNet and the PointNeXt models, which have
        no momentum field in the JAX package, excepted)."""
        if self.bn_momentum_fn is None or not has_bn_schedule(self.option):
            return
        m = self.bn_momentum_fn(epoch)
        bns = [b for b in self.net.modules()
               if isinstance(b, MaskedBatchNorm)]
        if bns and bns[0].momentum != m:
            log.info(f"BN momentum -> {m:.4f} (epoch {epoch})")
            for b in bns:
                b.momentum = m

    def _train_epoch(self, epoch: int) -> None:
        self._apply_bn_schedule(epoch)
        self.tracker.reset("train")
        self.visualizer.reset(epoch, "train")
        loader = self.loaders["train"]
        t0 = time.perf_counter()
        n_batches = len(loader)
        profiler = None
        if self.profiling and self.num_batches_stop:
            profiler = _start_profiler(self.device)
        # data_s: time blocked on the loader; step_s: the rest (dispatch,
        # and the 10th-batch metric fetch, where the card is waited for)
        progress = self.progress_batches or max(n_batches // 4, 1)
        data_s = step_s = first_s = 0.0
        it = iter(loader.epoch(epoch))
        bi = -1
        tracked_losses = []
        while True:
            td = time.perf_counter()
            batch = next(it, None)
            data_s += time.perf_counter() - td
            if batch is None:
                break
            bi += 1
            if bi == 0:  # the first batch: nothing to overlap it with
                first_s = data_s
            ts = time.perf_counter()
            out = self.runner.train(batch)
            if bi % 10 == 0:
                tracked_losses.append(self._track(out))
            step_s += time.perf_counter() - ts
            if bi and bi % progress == 0:
                n = bi + 1
                log.info(f"  batch {bi}/{n_batches}: "
                         f"data {data_s / n * 1e3:.0f} ms/b, "
                         f"step {step_s / n * 1e3:.0f} ms/b, "
                         f"{n * self.batch_size / (data_s + step_s):.1f} "
                         f"plots/s")
            if self._stop_early(bi):
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dur = time.perf_counter() - t0
        if profiler is not None:
            path = Path(self.run_dir) / "profile"
            path.mkdir(parents=True, exist_ok=True)
            profiler.stop()
            profiler.export_chrome_trace(str(path / "trace.json"))
            log.info(f"profile trace written to {path}")
        self.runner.epoch = epoch
        log.info(f"train epoch {epoch}: {bi + 1} batches in {dur:.1f}s "
                 f"({(bi + 1) * self.batch_size / max(dur, 1e-9):.1f} "
                 f"plots/s; data {data_s:.1f}s / step {step_s:.1f}s)")
        self.history.append({
            "epoch": epoch, "stage": "train", "batches": bi + 1,
            "seconds": dur, "data_seconds": data_s,
            "first_batch_data_seconds": first_s, "step_seconds": step_s,
            "plots_per_s": (bi + 1) * self.batch_size / max(dur, 1e-9),
            "tracked_losses": tracked_losses})
        self._finalize_epoch(epoch, "train")

    def _test_epoch(self, epoch: int, stage: str) -> Dict[str, float]:
        loader = self.loaders[stage]
        self.tracker.reset(stage)
        self.visualizer.reset(epoch, stage)
        voting_runs = int(self._cfg.get("voting_runs", 1) or 1)
        enable_dropout = bool(self._cfg.get("enable_dropout", False))
        enable_bn = bool(self._cfg.get("enable_bn", False))
        t0 = time.perf_counter()
        # outputs stay on the card during the stage and come to the host
        # once at its end; the ply writer reads each batch's points as it
        # comes
        pending = []
        n_batches = 0
        for run in range(voting_runs):
            for bi, batch in enumerate(loader.epoch(run)):
                out = self.runner.evaluate(
                    batch, enable_dropout=enable_dropout,
                    rng_salt=run * 100003 + bi, enable_bn=enable_bn)
                if self._wants_pos:
                    self._visualize(host(out), batch)
                pending.append(out)
                n_batches += 1
                if self._stop_early(bi):
                    break
        for out in host(pending):
            self._track(out)
            if not self._wants_pos:
                self._visualize(out, None)
        self.history.append({"epoch": epoch, "stage": stage,
                             "batches": n_batches,
                             "seconds": time.perf_counter() - t0})
        return self._finalize_epoch(epoch, stage)

    # ------------------------------------------------------------------ utils
    def _track(self, out, every: int = 1, batch_i: int = 0):
        """Track one step's outputs (host or device); returns its loss."""
        if every > 1 and batch_i % every:
            return None
        out = host(out)
        meta = out["sample_meta"]
        sample_mask = ~np.asarray(meta["is_double"])
        if meta["valid"] is not None:
            sample_mask &= np.asarray(meta["valid"])
        loss = float(out["loss"])
        self.tracker.track({
            "losses": {"loss": loss, "loss_reg": float(out["loss_reg"])},
            "reg_out": out["reg_out"], "reg_y": meta["y_reg"],
            "area_idx": meta["area_idx"], "sample_mask": sample_mask})
        return loss

    def _visualize(self, out, batch) -> None:
        if not self.visualizer.is_active:
            return
        meta = out["sample_meta"]
        sample_mask = ~np.asarray(meta["is_double"])
        if meta["valid"] is not None:
            sample_mask &= np.asarray(meta["valid"])
        wants_pos = self._wants_pos and batch is not None
        self.visualizer.save_visuals(
            out["reg_out"], meta["y_reg"], meta["area_idx"],
            meta["label_idx"], self.dataset.area_names,
            self.dataset.reg_targets, sample_mask=sample_mask,
            pos=host(batch.pos) if wants_pos else None,
            pos_mask=host(batch.mask) if wants_pos else None)

    def _finalize_epoch(self, epoch: int, stage: str) -> Dict[str, float]:
        self.tracker.finalise()
        metrics = self.tracker.get_metrics()
        improved = self.checkpoint.save_best_models_under_current_metrics(
            self.runner, stage, epoch, metrics, self.tracker.metric_func,
            self.optimizer_name,
            persist=getattr(self, "_persist_next", True) and self._is_main)
        if improved:
            log.info(f"improved: {', '.join(improved)}")
            self.tracker.publish_best_tables(improved, metrics, epoch)
        self.tracker.publish_metrics(metrics, epoch)
        self.visualizer.finalize_epoch(self.dataset)
        return metrics

    def _stop_early(self, batch_i: int) -> bool:
        if self.early_break and batch_i >= 0:
            return True
        return bool(self.num_batches_stop
                    and batch_i + 1 >= self.num_batches_stop)


def _with_stats(spec, stats: dict):
    import dataclasses
    return dataclasses.replace(
        spec, **{k: np.asarray(stats[k], np.float32)
                 for k in ("scale", "center", "weights")})


def _start_profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _wandb_init(wandb_cfg, run_config: dict, run_dir: str) -> bool:
    """wandb.init when wandb is installed; False (metrics.jsonl only)
    otherwise."""
    try:
        import wandb
    except ImportError:
        log.info("wandb requested but not installed; metrics go to "
                 "metrics.jsonl instead")
        return False
    get = wandb_cfg.get
    config = dict(get("config", {}) or {})
    config["run_config"] = run_config
    wandb.init(project=get("project", "default"), name=get("name") or None,
               tags=list(get("tags", []) or []), dir=run_dir, config=config,
               notes=get("notes") or None)
    return True
