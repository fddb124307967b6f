#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dpcr_agb_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--profile] [--out FILE]
                          [--only SENet14|KPConv|SENet14-denseL0|SENet50|
                                  MPointNet|SimplestNet|PointNeXt|PointNet|
                                  SENet14-map|SENet50-map|
                                  trainer|trainer-kpconv|trainer-pointnext|
                                  trainer-pointnet|trainer-map|treeadd|
                                  transforms]

Phases, each printing one JSON line; any failure exits non-zero:
  device   the card's name and power limit, the float32 settings pinned by
           `device.pin_numerics` (TF32 off: what the entry points pin);
           builds the kernels from dpcr_agb_tpu_torch/kernels/csrc for
           sm_90a (build seconds)
Then for each configuration (`--only` keeps one of them): SENet14 with the
sparse level 0, KPConv, SENet14 with the dense level 0 (DPCR_L0=dense,
DPCR_STEM_MODE=zfold2d_firewall, DPCR_POOL_BWD=pallas, set around its entry
points as a user would), SENet50 (bottleneck blocks, sparse level 0), and
MPointNet and SimplestNet (f32 only, as the JAX models; no kernel of the
port on their path, so no kernels phase, and serve and train must launch
none), and PointNeXt-S and the PointNet encoder (the `PointNext` and
`PointNet` entries, f32 only, `fixed_xy`: 12000 points a plot; their one
kernel is `fps`):
  kernels  in f32 and bf16, each kernel of the path held against its plain
           PyTorch version (stated tolerances; max|plain| beside each
           error), timed with CUDA events (median after warm-up) beside
           the plain version and one PyTorch call of the same function
           where there is one (time yardsticks the port never calls), and
           the least time the card could take (bound_ms, from what this
           run's data needs); each of the three also as device_ms: CUDA
           events around back-to-back calls queued behind a spin kernel,
           so without the host's launch path. kpconv_fused and
           kpconv_fused_bwd also the device ms of each of their own
           kernels (sub_kernels, torch.profiler). Every sum that a train
           step takes in a fixed order is checked to give the same bits in
           two runs (stem_sites_dw, kpconv_fused_bwd's dx and dW,
           gather_rows_bwd), and so are stem_sites, max_pool_k3s2_rows,
           max_pool_k3s2_bwd and max_pool_k3s2_bwd_vol.
           SENet14: stem_sites at the first serving batch's shapes (and
           at Cin 5 and 7: the batch's x and further random channels on
           its occupied rows, random weights; a launch a group of 4 input
           channels; emitted, not rows of the summary);
           max_pool_k3s2_rows, the sparse level 0's pool, at the first
           serving and the first train batch's (y and occ_l exact; timed
           beside the route it replaces, scatter_to_dense +
           occupancy_pool + the volume form, which is held exact too; its
           device time split by torch.profiler into the index build (a
           memset and three small kernels) and the pool kernel; the pool
           forward's own peak memory, which must stay below the C-wide
           full-resolution volume); stem_sites_dw and
           max_pool_k3s2_bwd at the first train batch's (SENet50 runs the
           same kernels at the same shapes: its rows are SENet14's unless
           it runs alone).
           KPConv: kpconv_fused and kpconv_fused_bwd on the inputs that
           the first serving batch gives the first layer (C 3 -> 32), a
           level-0 layer (C 16 -> 16) and the last level-4 layer (C 256 ->
           256); both at all 14 layers (the kpconv_layers line: errors,
           ms, device_ms and their sums) and at the bench's K 51 and 70;
           gather_rows_bwd at the first strided shortcut. Dense level 0:
           firewall_copy at the stem's input and output shapes of the
           first serving and the first train batch, from a contiguous and
           from a permuted (NCDHW-strided) source; max_pool_k3s2 on the
           dense path's pool input of the serving batch and
           max_pool_k3s2_bwd_vol on that of the train batch (exact, the
           same bits in two calls). PointNeXt / PointNet: fps at each
           sampling of the serving batch's forward (the input's 12000 ->
           8192, then PointNeXt's four set abstractions, 8192 -> 2048 ->
           512 -> 128 -> 32), its indices equal to fps_plain's (the plain
           loop on the card) and the same bits in two calls, and on the
           input's shapes with padded rows, a sample with fewer valid
           rows than it samples and an all-masked one, duplicates in
           other CTAs of a sample's cluster and an integer grid (exact
           ties); timed beside the plain loop (its device time from
           torch.profiler: a loop of ~8 kernels a step does not fit
           behind the spin); bound_ms from B (n - 1) N ~10 f32
           operations, beside the serial steps and step_us; each row
           with its plan (cluster, CTAs, threads, points a thread), the
           clusters the card holds at once and the SMs its CTAs ran on;
           the input's device time also from torch.profiler on the same
           calls as its CUDA events; fps_plans: each sampling's
           device_ms under every cluster size (indices checked too).
           max_pool_k3s2_rows, max_pool_k3s2_bwd and max_pool_k3s2_bwd_vol
           also fill_device_ms: the device time of torch.zero_ on a tensor
           of their output's size (y and occ_l; dx), the card's own floor
           for writing it
  serve    the full-width model (f32, then bf16): 16 synthetic plots dense
           enough that MaxPoints binds (sparse-voxel nets: V bucket 16384;
           KPConv: N bucket 8192) served by
           `dpcr_agb_tpu_torch.predict.main` (started from PyTorch's
           default float32 settings: it must pin TF32 off itself) from a
           port checkpoint with seeded random weights; checks 16 finite
           prediction rows, the launches of that run (sparse level 0:
           stem_sites and max_pool_k3s2_rows at least once, max_pool_k3s2
           never; KPConv: 14 kpconv_fused; dense level 0: firewall_copy 2,
           max_pool_k3s2 1, the row kernels 0), and that the raw outputs
           equal a run
           through the plain versions; prints plots/s (dense level 0: and
           that the same checkpoint served through the sparse level 0
           agrees; PointNeXt: the mean number of in-range ball-query
           neighbours of a valid query at each stage). KPConv's batches
           carry the pyramid that the entry points build on the host:
           forward_ms is that route's, beside host_pyramid_ms (the
           batch's post_collate on the host clock, cache off, median of
           5; two of them bit-identical); the
           device route (the batch without aux: the pyramid built in the
           forward, PRs 3-11's route) under device_route_forward_ms with
           pyramid_ms and its share, two device pyramids bit-identical,
           and host_vs_device_route_rel, max|Δ|/max|out| of the two
           routes' raw outputs (printed, not checked)
  train    the full-width model (f32, then bf16) trained by
           `dpcr_agb_tpu_torch.train.main` (it must pin TF32 off and
           record that in its checkpoint) for 6 steps at bs16 on the same
           plots and their targets: 6 finite losses, the launches of every
           step (KPConv: 14 kpconv_fused, 14 kpconv_fused_bwd and 4
           gather_rows_bwd; dense level 0: firewall_copy 3, max_pool_k3s2
           and max_pool_k3s2_bwd_vol 1, the row kernels 0); one step from
           one state through the kernels and through the plain versions
           (loss, every gradient, the updated parameters and BN running
           stats within stated tolerances; SENet14 f32: and how far a
           correct reordering of the stem's f32 sum moves that step, a
           reading, not a check: stem_order_witness); train_step_ms
           (median of 5 steps on a device-resident batch), and again with
           cudnn.deterministic, plots/s and peak memory (KPConv: on the
           host pyramid's batch, with the batch's host_pyramid_ms and the
           device route's device_route_train_step_ms beside it); then
           `predict.main` serves the trained checkpoint (16 finite rows);
           then train_reproducible: train.main a second time with the same
           seed, losses and final state compared bit for bit (KPConv must
           agree; elsewhere a differing run names the parameter where the
           difference starts and whether deterministic algorithms remove
           it)
  serve_jax_ckpt  (SENet14 with its sparse level 0, KPConv and
           PointNeXt; f32, full width) the serve phase's plots written as
           LAZ 1.4 (point format 6, `write_laz14`) and read back by the port's
           `read_las` (those positions also saved as .npz); the f32 port
           checkpoint's weights written as a JAX `.ckpt`
           (`weights.to_flax`, `training.state.Checkpoint.to_bytes`, with a
           run_config of model_name, models and the data config in the
           JAX layout, and dataset_properties of target_stats and
           reg_targets); `predict.main` on the `.ckpt` and the `.laz` plots
           and on the `.pt` and the `.npz` plots, each with the launch
           counts set to 0 just before it: the same plots listed, the
           predictions within 1e-5 * max|pred|, the same launches of every
           kernel, each of the path's forward kernels launched at least
           once; prints the `.ckpt`'s bytes and load seconds (decoded to
           tensors on the card), points per plot, LAZ decode ms per plot,
           both routes' predict_main_seconds, max_abs_diff and bit_equal
Then the sparse-voxel nets in map mode (`dense_dims=null`, full width, f32:
SENet14-map and SENet50-map), which launch none of the
port's kernels: their convs gather rows through kernel maps that the host
builds (`ops/host_pyramid.py`, native route) and multiply them on the card:
  data     the serving batch collated and its maps built once on the host
           (host_map_ms; every level's cap and voxels, the maps' MB)
  map_serve  `predict.main` from a port checkpoint (no kernel launch,
           every plot's pyramid built on the native route, 16 finite
           rows); on the serving batch: forward_ms (host batch to output),
           h2d_ms (`Batch.to`) and h2d_pinned_ms (`device_put` from pinned
           memory), the device-resident forward, peak memory, a
           torch.profiler split of the forward by kernel kind (row
           gathers, matmuls, the gathers' index_put backward, other) with
           the device's idle share; f32: map mode against the dense path
           (sparse level 0) with the same weights, their BN running means
           and offsets set to 0 (where the two are one function) and their
           running variances set to their inputs' second moments on this
           batch (so the outputs are O(1)), on this batch, which fits the
           volume and the caps: rtol 2e-3, atol 2e-3 * max|dense| (and
           max|out| at the unit variances, the check before slice 16)
  map_train  `train.main`'s input= form with dense_dims=null for 2 steps
           (finite losses, no launch in any step, the native route for
           every sample); on its first batch: host_map_ms, h2d_ms, the
           step of a fresh model on the device-resident batch, peak memory
           and the profiler's split of the step
Then (`--only trainer` runs it alone):
  trainer  the README's training command through the port's entry points
           (`train.main`: SENet14, sparse level 0, data=instance/synthetic/
           reg, transform sparse_xy, training=nfi/minkowski so bf16 compute
           through enable_mixed, cosineawr stepped per batch,
           visualization=eval) on 96 plots that the port's generator
           writes, bs16, 2 epochs, 4 loader threads: the splits against the
           seed-42 rule computed here from the generated labels;
           generate_seconds and process_seconds; per epoch the train
           batches, finite tracked losses, data and step seconds (and the
           first batch's wait) and plots/s; the val and test metrics of
           each epoch in metrics.jsonl under the JAX keys; the .ckpt read
           back (`latest`, `best_val_*` only, stats of each stage); the
           launches of stem_sites and max_pool_k3s2_rows equal to the
           forwards counted at the step runner, of stem_sites_dw and
           max_pool_k3s2_bwd to its train steps, of every other kernel 0.
           Then `eval.main` twice on the checkpoint alone (weight_name
           latest, the train batch size): its test predictions equal to the
           train run's last test epoch bit for bit, or within 5e-2 of
           max|pred| if cuDNN chose another algorithm (which case is
           printed), the rest of each csv row equal, its metrics equal to
           those recomputed from its csv within 1e-6 relative, the second
           call the same bits; then `calibrate_bn.main` for one epoch:
           every weight bit-equal, BN running stats moved, the forward
           kernels launched once a forward and the backward ones never
  trainer_kpconv (`--only trainer-kpconv`) the same for KPConv's
           command (`models=instance/kpconv`, `data.transform_type=xy`,
           `training=nfi/kpconv`, no neighborhood_limits): the limits the
           trainer calibrated at start-up equal to a call of the port's
           run_find_neighbour_dist on its dataset and stored in the
           .ckpt's run_config; kpconv_fused 14 a forward, kpconv_fused_bwd
           14 and gather_rows_bwd 4 a train step, every other kernel 0;
           eval.main's test predictions bit-equal to the train run's (no
           cuDNN on this path); host_pyramid_ms of each batch the train
           run's loader threads built
  trainer_pointnext, trainer_pointnet (`--only trainer-pointnext`,
           `trainer-pointnet`) the same for the two PointNeXt entries
           (`models=instance/pointnext model_name=PointNext` and
           `models=instance/pointnet model_name=PointNet`,
           `data.transform_type=fixed_xy`, `training=nfi/pointnet`), on 48
           plots: f32 under enable_mixed (no bf16 form), fps 5 (PointNet
           1) a forward and no other kernel, eval.main bit-equal
  trainer_map (`--only trainer-map`) the same for SENet14's command with
           `models.SENet14.extra_options.dense_dims=null`, on 24 plots: no
           kernel launch anywhere; host_pyramid_ms of each batch, its maps
           built in the loader's threads
  treeadd  (`--only treeadd`) docs/treedb.md through the port: a synthetic
           treeDB (the port's generate_tree_db, 40 trees) processed by the
           port's train route (SimplestNet on data=instance/treeDB/ALS,
           transform trees, one epoch: the .npz objects with pos, x and
           local_stats), then SENet14 (sparse level 0, the trainer's
           command) one epoch on 32 NFI-like plots, then `eval.main` on
           its checkpoint with data.transform_type=sparse_xy_treeadd_eval
           and with sparse_xy: the points RadiusObjectAdder added to each
           plot (at least one tree each, none in the plain eval),
           stem_sites and max_pool_k3s2_rows launched once a forward, each
           eval's seconds and how far the trees moved the test
           predictions
  transforms (`--only transforms`) the 37 transforms of slice 16: each
           timed on one full synthetic plot on the host (host_ms_per_plot,
           points in and out); then SENet14's trainer command (sparse
           level 0, bf16) with data.features=[classification] and a preset
           passed through the root grammar (`augmented_preset`: sparse_xy's
           chains with the z-outlier and density filters, crops, samplers,
           drawn parameters, elastic distortion and z_distance_to_top on x,
           so Cin 5 at the stem; ClampBatchSize 12000 points a batch of
           4), one epoch on 32 plots under its own dataroot, then eval.main
           on its checkpoint: the stem's Cin, 6 finite step losses,
           stem_sites and max_pool_k3s2_rows once a forward,
           stem_sites_dw and max_pool_k3s2_bwd once a step, every other
           kernel 0; the samples ClampBatchSize dropped (at least one);
           points per sample after each transform of the train chain;
           finite test predictions; train_main_seconds, eval_main_seconds
Then a total line with the script's seconds, the kernels summary line, the nvidia-smi name/power-limit line, and
last `{"ok": true, "device": {...}}`. Without CUDA (or without the rest of
the repository) it exits non-zero before printing any result."""
from __future__ import annotations

import argparse
import contextlib
import csv
import glob
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# published H100 SXM peaks (dense): f32 outside the tensor cores, bf16
# tensor cores, HBM bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

STEM_SRC = "dpcr_agb_tpu_torch/kernels/csrc/stem_sites.cu"
POOL_SRC = "dpcr_agb_tpu_torch/kernels/csrc/max_pool.cu"
DW_SRC = "dpcr_agb_tpu_torch/kernels/csrc/stem_dw.cu"
POOL_BWD_SRC = "dpcr_agb_tpu_torch/kernels/csrc/max_pool_bwd.cu"
STEM_REPLACES = "dpcr_agb_tpu/ops/pallas_stem.py:216"
POOL_REPLACES = "dpcr_agb_tpu/ops/pallas_pool.py:213"
# the Pallas stem is forward-only: the JAX package's stem dW is XLA
# autodiff of the row stem's patch matmul
DW_REPLACES = "dpcr_agb_tpu/ops/sparse_stem.py:413"
POOL_BWD_REPLACES = "dpcr_agb_tpu/ops/pallas_pool.py:251"
FW_SRC = "dpcr_agb_tpu_torch/kernels/csrc/firewall_copy.cu"
FW_REPLACES = "dpcr_agb_tpu/ops/dense_stem.py:103"
KP_FWD_SRC = "dpcr_agb_tpu_torch/kernels/csrc/kpconv_fwd.cu"
KP_BWD_SRC = "dpcr_agb_tpu_torch/kernels/csrc/kpconv_bwd.cu"
KP_FWD_REPLACES = "dpcr_agb_tpu/ops/pallas_kpconv.py:222"
KP_BWD_REPLACES = "dpcr_agb_tpu/ops/pallas_kpconv.py:249"
# no Pallas kernel: the JAX package's gather backward is XLA autodiff of
# its row gather
GATHER_REPLACES = "dpcr_agb_tpu/models/kpconv.py:59"
FPS_SRC = "dpcr_agb_tpu_torch/kernels/csrc/fps.cu"
# no Pallas kernel: the JAX package's farthest point sampling is a
# lax.fori_loop that XLA compiles
FPS_REPLACES = "dpcr_agb_tpu/ops/neighbors.py:108"
# every kernel of the port (kernels.LAUNCHES)
ALL_KERNELS = ("stem_sites", "max_pool_k3s2", "stem_sites_dw",
               "max_pool_k3s2_bwd", "kpconv_fused", "kpconv_fused_bwd",
               "firewall_copy", "max_pool_k3s2_bwd_vol", "gather_rows_bwd",
               "max_pool_k3s2_rows", "fps")
N_PLOTS = 16     # one serving batch of bench.py's size, the train batch
DENSITY = 60.0   # points per m^2: MaxPoints binds (16000 and 6144)
TRAIN_STEPS = 6
# The execution modes of the sparse-voxel nets' level 0 (the JAX package's
# variables; the port reads them when a model is built). Every path runs
# with all five set or cleared, whatever the caller's environment holds.
MODE_VARS = ("DPCR_L0", "DPCR_STEM_MODE", "DPCR_POOL_BWD",
             "DPCR_SPARSE_POOL", "DPCR_POOL_FWD")
_SPARSE_L0 = {"env": {}, "kernels": "sparse_l0",
              "forward": ("stem_sites", "max_pool_k3s2_rows"),
              "backward": ("stem_sites_dw", "max_pool_k3s2_bwd"),
              "exact": None, "never": ("max_pool_k3s2",)}
_ROW_KERNELS = {"stem_sites": 0, "stem_sites_dw": 0, "max_pool_k3s2_bwd": 0,
                "max_pool_k3s2_rows": 0}
# MPointNet and SimplestNet: plain PyTorch, f32 only, no launch of any of
# the port's kernels in a forward or a step
_NO_KERNELS = {"env": {}, "kernels": None, "forward": (), "backward": (),
               "exact": None, "launch_none": True}


def _only(**counts) -> dict:
    """Launch counts of every kernel: those given, the others 0."""
    return {k: counts.get(k, 0) for k in ALL_KERNELS}
# per path: the entry points' model_name, the mode variables, which
# kernels phase it gets, whether serve_jax_ckpt serves it from a JAX
# `.ckpt` and `.laz` plots, the kernels serving launches and the ones training
# adds, the kernels it must never launch (the sparse level 0 pools its
# rows without the volume form), and where the count is fixed, the
# launches of each kernel in one forward and in one train step (KPCNN's 14
# blocks hold one KPConv each and 4 strided shortcuts; the dense level 0
# copies the stem's input, its output and the output's cotangent, and
# pools once each way); and whether
# two same-seed runs of train.main must agree bit for bit (every sum of
# the KPConv step runs in a fixed order; the sparse-voxel nets' f32 steps
# go through cuDNN's own choice of algorithms)
MODELS = {
    "SENet14": {"model_name": "SENet14", **_SPARSE_L0, "jax_ckpt": True},
    "KPConv": {"model_name": "KPConv", "env": {}, "kernels": "kpconv",
               "jax_ckpt": True,
               "forward": ("kpconv_fused",),
               "backward": ("kpconv_fused_bwd", "gather_rows_bwd"),
               "exact": {"forward": {"kpconv_fused": 14,
                                     "gather_rows_bwd": 0},
                         "step": {"kpconv_fused": 14,
                                  "kpconv_fused_bwd": 14,
                                  "gather_rows_bwd": 4}},
               "reproducible": True, "conditioned": True},
    "SENet14-denseL0": {
        "model_name": "SENet14", "kernels": "dense_l0",
        "env": {"DPCR_L0": "dense", "DPCR_STEM_MODE": "zfold2d_firewall",
                "DPCR_POOL_BWD": "pallas"},
        "forward": ("firewall_copy", "max_pool_k3s2"),
        "backward": ("max_pool_k3s2_bwd_vol",),
        "exact": {"forward": {"firewall_copy": 2, "max_pool_k3s2": 1,
                              "max_pool_k3s2_bwd_vol": 0, **_ROW_KERNELS},
                  "step": {"firewall_copy": 3, "max_pool_k3s2": 1,
                           "max_pool_k3s2_bwd_vol": 1, **_ROW_KERNELS}}},
    "SENet50": {"model_name": "SENet50", **_SPARSE_L0},
    "MPointNet": {"model_name": "MPointNet", **_NO_KERNELS},
    "SimplestNet": {"model_name": "SimplestNet", **_NO_KERNELS},
    # PointNeXt-S: the input's sampling and four set abstractions; the
    # PointNet encoder: the input's sampling. No kernel in the backward.
    # Their steps are as ill-conditioned as KPConv's (BN over the batch's
    # rows in the head, over neighbourhoods): the step check is widened
    # the same way
    "PointNeXt": {"model_name": "PointNext", "env": {}, "kernels": "fps",
                  "jax_ckpt": True, "forward": ("fps",), "backward": (),
                  "exact": {"forward": _only(fps=5), "step": _only(fps=5)},
                  "conditioned": True},
    "PointNet": {"model_name": "PointNet", "env": {}, "kernels": "fps",
                 "shares": "input:", "forward": ("fps",), "backward": (),
                 "exact": {"forward": _only(fps=1), "step": _only(fps=1)},
                 "conditioned": True},
    # map mode (dense_dims null): gathers through host-built kernel maps
    # and matmuls, none of the port's kernels; its own phases
    # (run_map_model), in f32 (trainer-map trains it in bf16)
    "SENet14-map": {"model_name": "SENet14", **_NO_KERNELS,
                    "map_mode": ("float32",)},
    "SENet50-map": {"model_name": "SENet50", **_NO_KERNELS,
                    "map_mode": ("float32",)},
}
# the KPConv layers whose inputs the kernels phase takes from the first
# serving batch: (block, case)
KP_CASES = ((0, "level 0, first layer"), (1, "level 0"), (13, "level 4"))
# kernel path against plain path after one train step: loss (relative),
# all gradients as one vector (relative L2), each gradient (relative L2,
# floored at 1e-3 of the global gradient norm for the ones that vanish up
# to rounding, e.g. conv biases ahead of a train-mode BN), all updated
# parameters as one vector, each parameter's update (floored the same
# way) and each BN running stat (relative L2). In f32 the two stems sum in
# different orders, so a near-tie in a pool window may route its cotangent
# to another row: one such flip moves the stem's dW by ~3e-4 of its norm,
# hence 1e-3 for each gradient and update beside 1e-4 for all of them.
STEP_TOL = {"float32": {"loss": 1e-5, "grads": 1e-4, "grad": 1e-3,
                        "params": 1e-5, "update": 1e-3, "stat": 1e-5},
            "bfloat16": {"loss": 1e-2, "grads": 5e-2, "grad": 5e-2,
                         "params": 1e-2, "update": 5e-2, "stat": 1e-2}}
# KPConv is held to the same tolerances, widened by its conditioning: the
# gradient of the freshly initialised 14-block net moves by ~1e-3 (f32)
# and ~1e-1 (bf16, where any change flips roundings in every layer) when
# one f32 rounding is applied to its input features, on the plain path
# alone. `compare_train_steps(conditioning=True)` measures that in the run
# and allows each quantity 4 times what one rounding does to it.

RECORD = []
# the KPConv layer sweep of the kernels phase (its sums stand beside the
# serve and train profiles)
KP_SWEEP: dict = {}


@contextlib.contextmanager
def mode_env(env: dict):
    """The five mode variables set to `env` (cleared where it has none)
    while a path's models are built; the caller's values come back after."""
    saved = {k: os.environ.pop(k, None) for k in MODE_VARS}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def model_options(model_name: str) -> dict:
    """The model's `conf/models` entry at f32 and with extra_options.bf16
    (the sparse-voxel nets: bf16 convs; KPConv: bf16 inside the fused
    convolution only); MPointNet and SimplestNet at f32 only."""
    from dpcr_agb_tpu_torch import train
    from dpcr_agb_tpu_torch.models.factory import f32_only
    out = {"float32": train.model_option(model_name, bf16=False)}
    if not f32_only(out["float32"]):
        out["bfloat16"] = train.model_option(model_name, bf16=True)
    return out


def emit(obj: dict) -> None:
    RECORD.append(obj)
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median of n CUDA-event timings of fn() after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int = 5, skip: int = 0) -> float:
    """Median host-clock ms of fn() from an idle card to the end of its
    device work, over `reps` calls after `skip` warm-up calls."""
    import torch
    times = []
    for i in range(skip + reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= skip:
            times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def uncached_post_collate(net):
    """The entry points' post_collate of `net` with its pyramid cache off
    (DPCR_PYRAMID_CACHE_MB=0 while it is made), so that each call builds
    the host pyramid anew."""
    from dpcr_agb_tpu_torch.models.factory import make_post_collate
    saved = os.environ.get("DPCR_PYRAMID_CACHE_MB")
    os.environ["DPCR_PYRAMID_CACHE_MB"] = "0"
    try:
        return make_post_collate(net)
    finally:
        os.environ.pop("DPCR_PYRAMID_CACHE_MB", None)
        if saved is not None:
            os.environ["DPCR_PYRAMID_CACHE_MB"] = saved


def host_pyramid_facts(net, host_batch, what: str) -> dict:
    """KPConv's host pyramid of a host batch (its aux removed): the
    post_collate on the host clock with the cache off, median of 5, and
    two of them bit-identical."""
    import dataclasses
    bare = dataclasses.replace(host_batch, aux=None)
    post = uncached_post_collate(net)
    one, two = post(bare).aux, post(bare).aux
    moved = [k for k in one if not np.array_equal(one[k], two[k])]
    if moved or set(one) != set(host_batch.aux) or any(
            not np.array_equal(one[k], host_batch.aux[k]) for k in one):
        raise AssertionError(f"{what}: host pyramids of one batch differ "
                             f"(from each other in {moved}, or from the "
                             "entry point's)")
    return {"host_pyramid_ms": wall_ms(lambda: post(bare)),
            "host_pyramid_reproducible": True}


_SLEEP_CYCLES_PER_MS = []


def _sleep_cycles_per_ms() -> float:
    """GPU clock cycles of `torch.cuda._sleep` per ms (timed once)."""
    import torch
    if not _SLEEP_CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS.append(20_000_000 / start.elapsed_time(end))
    return _SLEEP_CYCLES_PER_MS[0]


def device_ms(fn, n: int = 20, warmup: int = 3, reps: int = 3,
              attempts: int = 3) -> float:
    """Device time of one fn() without the host's launch path: CUDA events
    around n back-to-back calls, queued behind a spin kernel that lasts
    four times as long as their enqueueing, over n (median of reps). A rep
    whose enqueueing outlasted its spin (the calls would have waited for
    the host) is taken again behind a spin twice as long, `attempts` times
    in all; then it raises."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    enqueue_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    spin_ms = 4 * enqueue_ms + 2.0
    times = []
    for _ in range(reps):
        for _ in range(attempts):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(spin_ms * _sleep_cycles_per_ms()))
            t = time.perf_counter()
            start.record()
            for _ in range(n):
                fn()
            end.record()
            queued_ms = (time.perf_counter() - t) * 1e3
            end.synchronize()
            if queued_ms <= spin_ms:
                break
            spin_ms *= 2
        else:
            raise AssertionError(f"device_ms: enqueueing took {queued_ms} "
                                 f"ms, longer than the {spin_ms / 2} ms "
                                 f"spin, {attempts} times")
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def device_ms_of(fn, ms: float, attempts: int = 3,
                 optional: bool = False):
    """`device_ms` with as many calls as take ~0.1 s at `ms` a call (3 to
    20). With `optional`, None where fn waits for the host (a plain
    version that reads a value back): its device time then cannot be told
    from the host's. Otherwise that raises."""
    n = max(3, min(20, int(100.0 / max(ms, 1e-3))))
    try:
        return device_ms(fn, n=n, warmup=1 if n < 20 else 3,
                         attempts=attempts)
    except AssertionError:
        if not optional:
            raise
        return None


def device_row(kernel, plain, library, ms: float, plain_ms: float,
               library_ms) -> dict:
    """device_ms of a kernel (which must have one), of its plain version
    and of its yardstick (None where there is none or where it waits for
    the host), timed as `device_ms_of` times them."""
    return {"device_ms": device_ms_of(kernel, ms),
            # a plain version that reads a value back never fits the spin
            "plain_device_ms": device_ms_of(plain, plain_ms, attempts=1,
                                            optional=True),
            "library_device_ms": None if library is None
            else device_ms_of(library, library_ms, optional=True)}


def _device_events(fn, reps: int) -> dict:
    """Device ms per fn() of each kernel, memset and copy that fn puts on
    the card, by name, from torch.profiler over reps calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def kernel_ms(fn, reps: int = 5) -> dict:
    """Device ms per fn() of each of the port's kernels (namespace dpcr)
    that fn launches, from torch.profiler over reps calls."""
    out = {}
    for key, ms in _device_events(fn, reps).items():
        if "dpcr::" in key:
            name = key.split("dpcr::", 1)[1].split("<")[0].split("(")[0]
            out[name] = out.get(name, 0.0) + ms
    return out


def fill_device_ms(like, numel: int) -> float:
    """device_ms of torch.zero_ on a tensor of numel elements of like's
    dtype on its device: the card's own fill rate at the size of a
    kernel's output, the floor of a kernel that writes all of it."""
    import torch
    buf = torch.empty(numel, dtype=like.dtype, device=like.device)
    ms = device_ms(buf.zero_)
    del buf
    torch.cuda.empty_cache()
    return ms


@contextlib.contextmanager
def plain_ops():
    """Route the models' eleven kernel ops to their plain PyTorch versions
    (the reference runs of the serve and train phases); raises if a kernel
    launched inside, i.e. if the reference did not really take the plain
    path."""
    from dpcr_agb_tpu_torch import kernels
    from dpcr_agb_tpu_torch.ops import (dense_stem, kpconv, neighbors, pool,
                                        sparse_stem)
    routes = [(neighbors, "fps", "fps_plain"),
              (sparse_stem, "stem_conv_sites", "stem_conv_sites_plain"),
              (sparse_stem, "stem_conv_sites_dw", "stem_conv_sites_dw_plain"),
              (pool, "masked_max_pool", "masked_max_pool_plain"),
              (pool, "masked_max_pool_rows", "masked_max_pool_rows_plain"),
              (pool, "masked_max_pool_bwd_rows",
               "masked_max_pool_bwd_rows_plain"),
              (pool, "masked_max_pool_bwd_vol",
               "masked_max_pool_bwd_vol_plain"),
              (dense_stem, "firewall_copy", "firewall_copy_plain"),
              (kpconv, "kpconv_forward", "kpconv_fused_plain"),
              (kpconv, "kpconv_backward", "kpconv_fused_bwd_plain"),
              (kpconv, "gather_rows_backward", "gather_rows_bwd_plain")]
    saved = [getattr(mod, name) for mod, name, _ in routes]
    for mod, name, plain in routes:
        setattr(mod, name, getattr(mod, plain))
    before = dict(kernels.LAUNCHES)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(routes, saved):
            setattr(mod, name, fn)
    if kernels.LAUNCHES != before:
        raise AssertionError(f"the plain reference run launched kernels: "
                             f"{before} -> {kernels.LAUNCHES}")


def write_plots(root: str, n: int, seed: int, density: float) -> list:
    """n synthetic plots in world coordinates with their `generate_plot`
    targets (BMag_ha, V_ha)."""
    from dpcr_agb_tpu_torch.data.synthetic import generate_plot
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    files = []
    for i in range(n):
        pts, biomass, volume = generate_plot(rng, density=density)
        world = pts + np.array([5.1e5, 6.05e6, 150.0], np.float32)
        path = os.path.join(root, f"plot_{i:03d}.npz")
        np.savez(path, pos=world, BMag_ha=biomass, V_ha=volume)
        files.append(path)
    return files


def make_checkpoint(root: str, name: str, model_name: str, option: dict,
                    seed: int) -> str:
    """A port checkpoint of the model with seeded random weights and BN
    running stats drawn from the same generator."""
    import torch
    from dpcr_agb_tpu_torch import train
    from dpcr_agb_tpu_torch.models.factory import build_model
    from dpcr_agb_tpu_torch.serving import save_checkpoint
    g = torch.Generator().manual_seed(seed)
    net, _ = build_model(option, 2, 3, generator=g)
    with torch.no_grad():
        for key, buf in net.named_buffers():
            if key.endswith(".mean"):
                buf.normal_(0.0, 0.1, generator=g)
            else:
                buf.uniform_(0.5, 1.5, generator=g)
    ckpt = os.path.join(root, name)
    save_checkpoint(ckpt, model_name, net, option, 3,
                    train.MODELS[model_name][1](),
                    {"scale": [60.0, 120.0], "center": [150.0, 300.0],
                     "weights": [0.5, 0.5]}, ["BMag_ha", "V_ha"])
    return ckpt


def ptxas_by_width(log: str, kernel: str) -> dict:
    """`nvcc -Xptxas=-v`'s report of each instance of `kernel` (templated
    on an int width and a bool): {"<width>" or "<width>/one_warp" (the
    bool set): registers, stack, spill bytes}."""
    out, width = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            w = re.search(kernel + r"ILi(\d+)ELb([01])E", m.group(1))
            width = None if not w else \
                w.group(1) + ("/one_warp" if w.group(2) == "1" else "")
            continue
        if width is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out.setdefault(width, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(width, {})["registers"] = int(m.group(1))
    return out


def stem_ptxas(log: str) -> dict:
    """`nvcc -Xptxas=-v`'s report of each stem_sites_kernel instance:
    {"<f32|bf16>/<Cin>/<one|wide>": registers, stack, spill bytes}."""
    out, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            w = re.search(r"stem_sites_kernelI(f|13__nv_bfloat16)Li(\d+)"
                          r"ELb([01])E", m.group(1))
            key = None if not w else "/".join((
                "f32" if w.group(1) == "f" else "bf16", w.group(2),
                "wide" if w.group(3) == "1" else "one"))
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out.setdefault(key, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


def phase_device(pinned: dict) -> dict:
    import torch
    from dpcr_agb_tpu_torch import kernels
    from dpcr_agb_tpu_torch.kernels import build
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    report = build.build(ptxas_verbose=True)
    seconds = time.perf_counter() - t0
    ptxas = {k: [ln for ln in v["log"].splitlines() if "ptxas" in ln][-6:]
             for k, v in report.items() if not k.startswith("fps")}
    fps_ptxas = None
    if not report["fps"]["cached"]:
        fps_ptxas = ptxas_by_width(report["fps"]["log"], "fps_kernel")
        spilled = {w: r for w, r in fps_ptxas.items()
                   if r["spill_stores"] or r["spill_loads"]}
        if len(fps_ptxas) != 2 * len(kernels.FPS_WIDTHS) or spilled:
            raise AssertionError(f"fps: ptxas -v per width {fps_ptxas} "
                                 f"(every width, no spill)")
    stem = None
    if not report["stem_sites"]["cached"]:
        # 2 types x Cin 1..4 x (one launch, a group of a wider input)
        stem = stem_ptxas(report["stem_sites"]["log"])
        spilled = {k: r for k, r in stem.items()
                   if r["spill_stores"] or r["spill_loads"]}
        if len(stem) != 16 or spilled:
            raise AssertionError(f"stem_sites: ptxas -v per instance {stem} "
                                 f"(16 instances, no spill)")
    out = {"phase": "device", "name": torch.cuda.get_device_name(0),
           "nvidia_smi": smi, "count": torch.cuda.device_count(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "numerics": pinned,
           "build_seconds": round(seconds, 3),
           "built": {k: not v["cached"] for k, v in report.items()},
           "ptxas": ptxas, "fps_ptxas": fps_ptxas, "stem_ptxas": stem}
    emit(out)
    return out


def _check_close(name, got, want, rtol, atol):
    import torch
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()) or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max abs err "
            f"{err.max().item()} (rtol {rtol}, atol {atol}), "
            f"{int(bad.sum())} elements out of tolerance")
    return err.max().item()


def _amax(t) -> float:
    return t.float().abs().max().item()


def _same_bits(a, b) -> bool:
    """a and b hold the same bits (torch.equal alone takes -0 for +0)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32}[a.element_size()]
        return torch.equal(a.contiguous().view(view),
                           b.contiguous().view(view))
    return torch.equal(a, b)


def stem_work(vol, coords, mask) -> tuple:
    """What the stem's data needs: (non-zero values in the occupied sites'
    7^3 neighbourhoods, summed over sites and input channels; volume cells
    within reach of an occupied site)."""
    import torch
    import torch.nn.functional as F
    b, d, h, w = vol.shape[:4]
    ones = torch.ones(1, 1, 7, 7, 7, device=vol.device)
    lim = torch.tensor([d - 1, h - 1, w - 1], device=coords.device)
    c = torch.minimum(coords.long().clamp(min=0), lim)
    bi = torch.arange(b, device=c.device)[:, None].expand_as(mask)
    nz = (vol != 0).sum(-1).to(torch.float32)[:, None]       # [B,1,D,H,W]
    at = F.conv3d(nz, ones, padding=3)[:, 0][bi, c[..., 0], c[..., 1],
                                             c[..., 2]]
    n_nonzero = int(torch.where(mask, at, torch.zeros_like(at)).sum().item())
    sites = torch.zeros((b, 1, d, h, w), device=vol.device)
    cm = c[mask]
    sites[bi[mask], 0, cm[:, 0], cm[:, 1], cm[:, 2]] = 1.0
    reach = int((F.conv3d(sites, ones, padding=3) > 0).sum().item())
    return n_nonzero, reach


def pool_work(occ) -> tuple:
    """What the pool's data needs: (occupied input cells, occupied inputs
    summed over all output windows)."""
    import torch.nn.functional as F
    o = (occ[..., 0] > 0).float()[:, None]                   # [B,1,D,H,W]
    in_windows = F.avg_pool3d(o, 3, 2, 1, count_include_pad=True).sum() * 27
    return int(o.sum().item()), round(in_windows.item())


STEM_WIDE_CIN = (5, 7)     # widths checked beside the main path's


def stem_row(vol, coords, mask, wts, bias, dtname: str, smi: str,
             case=None) -> tuple:
    """stem_sites on (vol, coords, mask, wts, bias) against its plain
    version (f32: rtol 1e-4, atol 1e-4; bf16: atol 2e-2 * max|plain|) and
    a second call (the same bits), timed beside the plain version and
    cuDNN's dense k7 conv of the volume, with its bound from the work the
    data needs -> (row, the kernel's output)."""
    import torch
    import torch.nn.functional as F
    from dpcr_agb_tpu_torch import kernels
    from dpcr_agb_tpu_torch.ops.sparse_stem import (stem_conv_sites,
                                                    stem_conv_sites_plain)
    dt = vol.dtype
    n_sites = int(mask.sum())
    cin, cout = wts.shape[1], wts.shape[2]
    n_nonzero, n_reach = stem_work(vol, coords, mask)
    what = f"stem_sites {dtname}" + (f" {case}" if case else "")
    got = stem_conv_sites(vol, coords, mask, wts, bias)
    want = stem_conv_sites_plain(vol, coords, mask, wts, bias)
    torch.cuda.synchronize()
    if dt == torch.float32:     # accumulation order only
        err = _check_close(what, got, want, 1e-4, 1e-4)
        tol = "rtol 1e-4, atol 1e-4"
    else:                       # compared in bf16
        scale = want.float().abs().max().item()
        err = _check_close(what, got, want, 0.0, 2e-2 * scale)
        tol = "atol 2e-2 * max|plain| (bf16)"
    # sums in a fixed order: a second call, the same bits
    if not _same_bits(stem_conv_sites(vol, coords, mask, wts, bias), got):
        raise AssertionError(f"{what}: two calls give different bits")
    ms = time_ms(lambda: stem_conv_sites(vol, coords, mask, wts, bias))
    plain_ms = time_ms(lambda: stem_conv_sites_plain(
        vol, coords, mask, wts, bias))
    # yardstick: cuDNN's dense k7 conv of the NCDHW Cin volume, whose
    # values at the sites are the kernel's
    vol_nc = vol.permute(0, 4, 1, 2, 3).contiguous()
    w_nc = wts.reshape(7, 7, 7, cin, cout).permute(4, 3, 0, 1, 2) \
        .contiguous()
    dense = F.conv3d(vol_nc, w_nc, bias, padding=3)
    lib_err = _at_sites_err(dense, coords, mask, got)
    del dense
    lib_ms = time_ms(lambda: F.conv3d(vol_nc, w_nc, bias, padding=3),
                     n=5, warmup=1)
    devs = device_row(
        lambda: stem_conv_sites(vol, coords, mask, wts, bias),
        lambda: stem_conv_sites_plain(vol, coords, mask, wts, bias),
        lambda: F.conv3d(vol_nc, w_nc, bias, padding=3), ms,
        plain_ms, lib_ms)
    del vol_nc
    # what this data needs: the volume cells within reach of an occupied
    # site, and one product per non-zero neighbour value and output
    # channel (the kernel skips the zeros)
    esz = vol.element_size()
    nbytes = (n_reach * cin * esz + coords.numel() * 4 + mask.numel()
              + wts.numel() * esz + bias.numel() * esz + got.numel() * esz)
    flops = 2.0 * n_nonzero * cout
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtname] * 1e3
    plan = kernels.stem_sites_plan(*vol.shape[:4], coords.shape[1], cin,
                                   dt == torch.bfloat16)
    row = {
        "name": "stem_sites", "dtype": dtname, "route": "cuda",
        "source": STEM_SRC, "replaces": STEM_REPLACES, "case": case,
        "launches": None, "max_abs_err": err,
        "max_abs_plain": _amax(want), "tolerance": tol,
        "reproducible": True,
        "ms": ms, "plain_ms": plain_ms, **devs,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": lib_ms,
        "library": "F.conv3d k7 pad 3 on the NCDHW Cin volume",
        "library_max_abs_err_at_sites": lib_err,
        "plan": {k: plan[k] for k in ("groups", "warps", "blocks",
                                      "smem_bytes")},
        "shape": {"vol": list(vol.shape), "coords": list(coords.shape),
                  "weights": list(wts.shape),
                  "occupied_sites": n_sites,
                  "cells_in_reach": n_reach,
                  "nonzero_neighbour_values": n_nonzero,
                  "dense_flops": 2.0 * n_sites * 343 * cin * cout,
                  "needed_flops": flops, "needed_bytes": nbytes},
        "card": smi}
    del want
    return row, got


def phase_kernels(bundles: dict, batch, train_batch, smi: str,
                  seed: int) -> list:
    """The forward kernels at the first serving batch's shapes and the
    backward kernels at the first train batch's, f32 and bf16; stem_sites
    also at the widths of STEM_WIDE_CIN (emitted, not rows of the path)."""
    import torch
    from dpcr_agb_tpu_torch.ops.dense_grid import scatter_to_dense
    rows = []
    for dtname, bundle in bundles.items():
        net = bundle.net
        tb = batch.to(bundle.device)
        dims = net.level0_dims(tb)
        dt = net.dtype
        coords = tb.coords.contiguous()
        mask = tb.mask.contiguous()
        vol, _ = scatter_to_dense(coords, mask, tb.x.to(dt), dims)
        wts = net.stem_conv.kernel.detach().to(dt).contiguous()
        bias = net.stem_conv.bias.detach().to(dt).contiguous()
        with torch.no_grad():
            row, got = stem_row(vol, coords, mask, wts, bias, dtname, smi)
            rows.append(row)
            # wider inputs (a launch a group of 4 input channels): the
            # batch's x and further channels on its occupied rows
            gen = torch.Generator(device=tb.x.device).manual_seed(seed)
            for cin in STEM_WIDE_CIN:
                extra = torch.randn(tb.x.shape[:2] + (cin - tb.x.shape[2],),
                                    generator=gen, device=tb.x.device)
                xw = torch.cat([tb.x, extra * mask[..., None]], -1).to(dt)
                vw, _ = scatter_to_dense(coords, mask, xw, dims)
                ww = (torch.randn((343, cin, 64), generator=gen,
                                  device=tb.x.device) * 0.05).to(dt)
                emit({"phase": "kernels", **stem_row(
                    vw, coords, mask, ww.contiguous(), bias, dtname, smi,
                    f"Cin {cin}")[0]})
                del vw
                torch.cuda.empty_cache()

            # the pool input: the stem rows through BN + act, as on the
            # main path, pooled by the row form
            h_rows = net.act(net.stem_norm(got, mask)) * mask[..., None].to(dt)
            del vol, got
            torch.cuda.empty_cache()
            rows.append(pool_rows_row(coords, mask, h_rows, dims, dtname, smi,
                                      "serve batch", "serve"))
            del h_rows
            torch.cuda.empty_cache()
            rows += backward_kernel_rows(net, train_batch.to(bundle.device),
                                         dtname, smi, seed)
            torch.cuda.empty_cache()
    for r in rows:
        emit({"phase": "kernels", **r})
    return rows


def pool_forward_row(x, occ, dtname: str, smi: str, case=None) -> dict:
    """max_pool_k3s2 on the pool input x [B,D,H,W,C] under occ against its
    plain version (exact), timed beside `F.max_pool3d`."""
    import torch
    import torch.nn.functional as F
    from dpcr_agb_tpu_torch.ops.pool import (masked_max_pool,
                                             masked_max_pool_plain)
    got_p = masked_max_pool(x, occ)
    want_p = masked_max_pool_plain(x, occ)
    torch.cuda.synchronize()
    err_p = _check_close(f"max_pool_k3s2 {dtname}", got_p, want_p, 0.0, 0.0)
    ms_p = time_ms(lambda: masked_max_pool(x, occ))
    plain_ms_p = time_ms(lambda: masked_max_pool_plain(x, occ))
    filled = torch.where(occ > 0, x, torch.full((), float("-inf"),
                                                dtype=x.dtype,
                                                device=x.device))
    ncdhw = filled.permute(0, 4, 1, 2, 3).contiguous()
    del filled
    lib_ms = time_ms(lambda: F.max_pool3d(ncdhw, 3, 2, 1))
    devs = device_row(lambda: masked_max_pool(x, occ),
                      lambda: masked_max_pool_plain(x, occ),
                      lambda: F.max_pool3d(ncdhw, 3, 2, 1), ms_p, plain_ms_p,
                      lib_ms)
    del ncdhw
    # what this data needs: the occupancy, x at the occupied cells (the
    # rest counts as -inf), all of y; one max per occupied input value in
    # each window that holds it
    n_occ, in_windows = pool_work(occ)
    esz = x.element_size()
    nbytes = (occ.numel() + n_occ * x.shape[-1] + got_p.numel()) * esz
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = float(in_windows) * x.shape[-1] / PEAK_FLOPS["float32"] * 1e3
    return {
        "name": "max_pool_k3s2", "dtype": dtname, "case": case,
        "route": "cuda", "source": POOL_SRC, "replaces": POOL_REPLACES,
        "launches": None, "max_abs_err": err_p,
        "max_abs_plain": _amax(want_p), "tolerance": "exact",
        "ms": ms_p, "plain_ms": plain_ms_p, **devs,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": lib_ms,
        "library": "F.max_pool3d k3 s2 p1 on the -inf-filled NCDHW volume",
        "shape": {"x": list(x.shape), "y": list(got_p.shape),
                  "occupied_cells": n_occ,
                  "occupied_inputs_in_windows": in_windows,
                  "needed_bytes": nbytes},
        "card": smi}


def profiled_device_ms(fn, reps: int = 5) -> float:
    """Device ms per fn() from torch.profiler: every kernel, memset and
    copy that fn puts on the card, summed (for a route that reads a value
    back to the host, where `device_ms` cannot hold the queue)."""
    return sum(_device_events(fn, reps).values())


def pool_rows_row(coords, mask, h_rows, dims, dtname: str, smi: str,
                  case: str, counted_in: str) -> dict:
    """max_pool_k3s2_rows on the stem rows h_rows [B,V,C] against its plain
    version (y and occ_l exact, the same bits in two calls), timed beside
    the route it replaces on the main path (scatter_to_dense,
    occupancy_pool and the volume-form kernel, on the same rows, held
    exact against the same plain version); the
    pool forward's own peak memory over `pooled_rows`, which must stay
    below the C-wide full-resolution volume that route allocates."""
    import torch
    from dpcr_agb_tpu_torch.ops.dense_grid import (occupancy_pool,
                                                   scatter_to_dense)
    from dpcr_agb_tpu_torch.ops.pool import (masked_max_pool,
                                             masked_max_pool_rows,
                                             masked_max_pool_rows_plain,
                                             pooled_rows)
    b, v, c = h_rows.shape
    esz = h_rows.element_size()

    def kernel():
        return masked_max_pool_rows(coords, mask, h_rows, dims)

    def plain():
        return masked_max_pool_rows_plain(coords, mask, h_rows, dims)

    def previous():
        hv, occ_v = scatter_to_dense(coords, mask, h_rows, dims)
        return masked_max_pool(hv, occ_v), occupancy_pool(occ_v)

    def peak_gb(fn) -> float:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del out
        return peak / 1e9

    got_y, got_o = kernel()
    want_y, want_o = plain()
    torch.cuda.synchronize()
    err = _check_close(f"max_pool_k3s2_rows {case} {dtname}", got_y, want_y,
                       0.0, 0.0)
    _check_close(f"max_pool_k3s2_rows occ_l {case} {dtname}", got_o, want_o,
                 0.0, 0.0)
    if got_o.dtype != h_rows.dtype or got_y.shape != want_y.shape:
        raise AssertionError(f"max_pool_k3s2_rows {case} {dtname}: y "
                             f"{tuple(got_y.shape)}, occ_l {got_o.dtype}")
    again_y, again_o = kernel()
    if not (_same_bits(again_y, got_y) and _same_bits(again_o, got_o)):
        raise AssertionError(f"max_pool_k3s2_rows {case} {dtname}: two "
                             f"calls give different bits")
    del again_y, again_o
    # the route it replaces, through the volume-form kernel: exact too
    prev_y, prev_o = previous()
    torch.cuda.synchronize()
    prev_err = _check_close(f"max_pool_k3s2 (volume form) {case} {dtname}",
                            prev_y, want_y, 0.0, 0.0)
    _check_close(f"occupancy_pool {case} {dtname}", prev_o, want_o, 0.0, 0.0)
    amax, y_numel, o_numel = _amax(want_y), got_y.numel(), got_o.numel()
    del got_y, got_o, want_y, want_o, prev_y, prev_o
    ms, plain_ms, prev_ms = (time_ms(f) for f in (kernel, plain, previous))
    devs = device_row(kernel, plain, None, ms, plain_ms, None)
    # the kernel's device time in two parts (profiler sums): its pool
    # kernel, and the index build (the occupancy bits' memset and three
    # small kernels)
    events = _device_events(kernel, 5)
    pool_dev = sum(t for k, t in events.items() if "pool_rows_kernel" in k)
    fill = fill_device_ms(h_rows, y_numel + o_numel)
    prev_dev = device_ms_of(previous, prev_ms, optional=True)
    prev_dev_by = "device_ms"
    if prev_dev is None:
        prev_dev, prev_dev_by = profiled_device_ms(previous), "profiler"
    volume_gb = b * int(np.prod(dims)) * c * esz / 1e9
    peak = peak_gb(lambda: pooled_rows(coords, mask, h_rows, dims))
    prev_peak = peak_gb(previous)
    if not peak < volume_gb:
        raise AssertionError(f"max_pool_k3s2_rows {case} {dtname}: the pool "
                             f"forward peaks at {peak} GB, not below the "
                             f"{volume_gb} GB full-resolution volume")
    # what this data needs: the valid rows, coords and mask read once, y
    # and occ_l written once (the kernel's own cell -> row index is not
    # counted: the function does not need it); one max per occupied input
    # value in each window that holds it
    _, occ = scatter_to_dense(coords, mask, torch.ones_like(h_rows[..., :1]),
                              dims)
    n_occ, in_windows = pool_work(occ)
    n_valid = int(mask.sum())
    del occ
    nbytes = (n_valid * c * esz + coords.numel() * 4 + mask.numel()
              + (y_numel + o_numel) * esz)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = float(in_windows) * c / PEAK_FLOPS["float32"] * 1e3
    return {
        "name": "max_pool_k3s2_rows", "dtype": dtname, "case": case,
        "counted_in": counted_in, "route": "cuda", "source": POOL_SRC,
        "replaces": POOL_REPLACES, "launches": None, "max_abs_err": err,
        "max_abs_plain": amax, "tolerance": "exact (y and occ_l)",
        "reproducible": True, "ms": ms, "plain_ms": plain_ms, **devs,
        "index_build_device_ms": sum(events.values()) - pool_dev,
        "pool_kernel_device_ms": pool_dev, "fill_device_ms": fill,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": None,
        "library": "none: no one PyTorch call computes it; previous_route_ms "
                   "times the route it replaces",
        "previous_route": "scatter_to_dense + occupancy_pool + max_pool_k3s2 "
                          "(the volume form), the same rows",
        "previous_route_max_abs_err": prev_err,
        "previous_route_ms": prev_ms, "previous_route_device_ms": prev_dev,
        "previous_route_device_ms_by": prev_dev_by,
        "pool_forward_peak_gb": peak, "previous_route_peak_gb": prev_peak,
        "full_resolution_volume_gb": volume_gb,
        "shape": {"h_rows": list(h_rows.shape), "dims": list(dims),
                  "valid_rows": n_valid, "occupied_cells": n_occ,
                  "occupied_inputs_in_windows": in_windows,
                  "needed_bytes": nbytes},
        "card": smi}


def _dense_pool_input(net, tb) -> tuple:
    """The dense level 0 of `net` up to its pool, on the device batch tb:
    (h [B,D,H,W,64] after stem conv, BN and activation, its occupancy)."""
    from dpcr_agb_tpu_torch.ops.dense_grid import scatter_to_dense
    h, occ = scatter_to_dense(tb.coords, tb.mask, tb.x.to(net.dtype),
                              net.level0_dims(tb))
    h = net.stem_conv.forward_dense(h, occ, 1, net.stem_mode)
    b, width = h.shape[0], h.shape[-1]
    h = net.stem_norm(h.reshape(b, -1, width),
                      occ.reshape(b, -1) > 0).reshape(h.shape)
    return net.act(h) * occ.to(h.dtype), occ


def dense_l0_kernel_rows(bundles: dict, batch, train_batch, smi: str,
                         seed: int) -> list:
    """The dense level 0's kernels, f32 and bf16: firewall_copy at the
    stem's input and output shapes of the first serving and the first
    train batch, from a contiguous and from a permuted source (an NCDHW
    buffer behind the NDHWC view, what a convolution may hand back);
    max_pool_k3s2 on the dense path's pool input of the serving batch;
    max_pool_k3s2_bwd_vol on that of the train batch, cotangent drawn from
    `seed`. All exact."""
    import torch
    from dpcr_agb_tpu_torch.ops import dense_stem, pool
    from dpcr_agb_tpu_torch.ops.dense_grid import occupancy_pool
    rows = []
    for dtname, bundle in bundles.items():
        net, dev, dt = bundle.net, bundle.device, bundle.net.dtype
        g = torch.Generator(device=dev).manual_seed(seed)
        esz = torch.empty((), dtype=dt).element_size()
        for counted_in, hb in (("serve", batch), ("train", train_batch)):
            b = hb.mask.shape[0]
            dims = net.level0_dims(hb)
            for what, c in (("stem input", hb.x.shape[-1]),
                            ("stem output", net.stem_conv.kernel.shape[-1])):
                for layout in ("contiguous", "permuted"):
                    if layout == "contiguous":
                        src = torch.randn((b, *dims, c), generator=g,
                                          device=dev).to(dt)
                    else:
                        src = torch.randn((b, c, *dims), generator=g,
                                          device=dev).to(dt).permute(
                                              0, 2, 3, 4, 1)
                    got = dense_stem.firewall_copy(src)
                    want = dense_stem.firewall_copy_plain(src)
                    torch.cuda.synchronize()
                    if not got.is_contiguous() \
                            or got.data_ptr() == src.data_ptr():
                        raise AssertionError("firewall_copy: not a fresh "
                                             "contiguous tensor")
                    err = _check_close(f"firewall_copy {what} {layout} "
                                       f"{dtname}", got, want, 0.0, 0.0)
                    amax = _amax(want)
                    del got, want
                    def kernel():
                        return dense_stem.firewall_copy(src)

                    def plain():
                        return dense_stem.firewall_copy_plain(src)

                    def library():
                        return src.clone(
                            memory_format=torch.contiguous_format)

                    ms, plain_ms, lib_ms = (time_ms(f) for f in (
                        kernel, plain, library))
                    dev_ms, plain_dev_ms, lib_dev_ms = (device_ms(f) for f in (
                        kernel, plain, library))
                    nbytes = 2 * src.numel() * esz   # read once, write once
                    rows.append({
                        "name": "firewall_copy", "dtype": dtname,
                        "case": f"{what}, {counted_in} batch, {layout} "
                                f"source",
                        "counted_in": counted_in, "route": "cuda",
                        "source": FW_SRC, "replaces": FW_REPLACES,
                        "launches": None, "max_abs_err": err,
                        "max_abs_plain": amax, "tolerance": "exact",
                        "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": nbytes / PEAK_BYTES * 1e3,
                        "bound_by": "bytes", "library_ms": lib_ms,
                        "library": "Tensor.clone(memory_format="
                                   "contiguous_format)",
                        "device_ms": dev_ms, "plain_device_ms": plain_dev_ms,
                        "library_device_ms": lib_dev_ms,
                        "device_ms_over_library": dev_ms / lib_dev_ms,
                        "achieved_gb_per_s": nbytes / ms / 1e6,
                        "device_gb_per_s": nbytes / dev_ms / 1e6,
                        "shape": {"x": list(src.shape),
                                  "strides": list(src.stride()),
                                  "needed_bytes": nbytes},
                        "card": smi})
                    del src
                    torch.cuda.empty_cache()
        with torch.no_grad():
            x, occ = _dense_pool_input(net, batch.to(dev))
            rows.append(pool_forward_row(
                x, occ, dtname, smi, "dense level 0, serve batch"))
            del x, occ
            torch.cuda.empty_cache()
            tb = train_batch.to(dev)
            x, occ = _dense_pool_input(net, tb)
            occ_l = occupancy_pool(occ)
            y = pool.pallas_max_pool(x, occ, occ_l)
            ct = torch.randn(y.shape, generator=g, device=dev).to(dt) * occ_l
            got = pool.masked_max_pool_bwd_vol(x, occ, y, ct)
            want = pool.masked_max_pool_bwd_vol_plain(x, occ, y, ct)
            torch.cuda.synchronize()
            err = _check_close(f"max_pool_k3s2_bwd_vol {dtname}", got, want,
                               0.0, 0.0)
            amax, nonzero = _amax(want), int((got != 0).sum())
            del want
            if not _same_bits(pool.masked_max_pool_bwd_vol(x, occ, y, ct),
                              got):
                raise AssertionError(f"max_pool_k3s2_bwd_vol {dtname}: two "
                                     f"calls give different bits")
            ms = time_ms(lambda: pool.masked_max_pool_bwd_vol(x, occ, y, ct))
            plain_ms = time_ms(lambda: pool.masked_max_pool_bwd_vol_plain(
                x, occ, y, ct), n=3, warmup=1)
            # yardstick (time only: it routes a tie to one cell): aten's
            # max_pool3d backward on the -inf-filled NCDHW volume
            filled = torch.where(occ > 0, x, torch.full(
                (), float("-inf"), dtype=dt, device=dev))
            x_nc = filled.permute(0, 4, 1, 2, 3).contiguous()
            del filled, got
            _, idx = torch.nn.functional.max_pool3d(x_nc, 3, 2, 1,
                                                    return_indices=True)
            ct_nc = ct.permute(0, 4, 1, 2, 3).contiguous()
            aten_bwd = torch.ops.aten.max_pool3d_with_indices_backward
            lib_ms = time_ms(lambda: aten_bwd(
                ct_nc, x_nc, [3, 3, 3], [2, 2, 2], [1, 1, 1], [1, 1, 1],
                False, idx), n=5, warmup=1)
            devs = device_row(
                lambda: pool.masked_max_pool_bwd_vol(x, occ, y, ct),
                lambda: pool.masked_max_pool_bwd_vol_plain(x, occ, y, ct),
                lambda: aten_bwd(ct_nc, x_nc, [3, 3, 3], [2, 2, 2],
                                 [1, 1, 1], [1, 1, 1], False, idx),
                ms, plain_ms, lib_ms)
            del x_nc, ct_nc, idx
            torch.cuda.empty_cache()
            fill = fill_device_ms(x, x.numel())
            # what this data needs: the occupancy of every cell and dx
            # written once; x at the occupied cells, y and ct at the
            # distinct outputs that cover them; a compare and an add per
            # (occupied cell, covering output, channel)
            c = x.shape[-1]
            flat, valid = pool._pool_parents(tb.coords, tb.mask,
                                             net.level0_dims(tb))
            n_occ = int((occ > 0).sum())
            n_links = int(valid.sum())
            n_parents = int(torch.unique(flat[valid]).numel())
            nbytes = (occ.numel() + n_occ * c + 2 * n_parents * c
                      + x.numel()) * esz
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = 2.0 * n_links * c / PEAK_FLOPS["float32"] * 1e3
            rows.append({
                "name": "max_pool_k3s2_bwd_vol", "dtype": dtname,
                "case": "dense level 0, train batch", "route": "cuda",
                "source": POOL_BWD_SRC, "replaces": POOL_BWD_REPLACES,
                "launches": None, "max_abs_err": err, "max_abs_plain": amax,
                "tolerance": "exact", "reproducible": True, "ms": ms,
                "plain_ms": plain_ms, **devs, "fill_device_ms": fill,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes > t_ops else "operations",
                "library_ms": lib_ms,
                "library": "aten.max_pool3d_with_indices_backward on the "
                           "-inf-filled NCDHW volume (one cell per tie)",
                "shape": {"x": list(x.shape), "y": list(y.shape),
                          "occupied_cells": n_occ,
                          "cell_output_links": n_links,
                          "outputs_read": n_parents, "nonzero_dx": nonzero,
                          "needed_bytes": nbytes},
                "card": smi})
            del x, occ, occ_l, y, ct, tb
            torch.cuda.empty_cache()
    for r in rows:
        emit({"phase": "kernels", **r})
    return rows


def _at_sites_err(dense_nc, coords, mask, rows) -> float:
    """Max abs difference between a dense NCDHW result read at the occupied
    sites and the kernel's rows [B,V,C] there."""
    import torch
    b = coords.shape[0]
    bi = torch.arange(b, device=coords.device)[:, None].expand_as(mask)
    c = coords.long()
    at = dense_nc[bi[mask], :, c[mask][:, 0], c[mask][:, 1], c[mask][:, 2]]
    return (at.float() - rows[mask].float()).abs().max().item()


def backward_kernel_rows(net, tb, dtname: str, smi: str, seed: int) -> list:
    """stem_sites_dw and max_pool_k3s2_bwd at the first train batch's
    shapes (tb on the card): the level-0 volume and rows of that batch,
    cotangents drawn from `seed`."""
    import torch
    from dpcr_agb_tpu_torch.ops.dense_grid import scatter_to_dense
    from dpcr_agb_tpu_torch.ops.pool import (_pool_parents,
                                             masked_max_pool_bwd_rows,
                                             masked_max_pool_bwd_rows_plain,
                                             pooled_rows)
    from dpcr_agb_tpu_torch.ops.sparse_stem import (stem_conv_sites,
                                                    stem_conv_sites_dw,
                                                    stem_conv_sites_dw_plain)
    dev, dt = tb.coords.device, net.dtype
    dims = net.level0_dims(tb)
    coords, mask = tb.coords.contiguous(), tb.mask.contiguous()
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    with torch.no_grad():
        vol, _ = scatter_to_dense(coords, mask, tb.x.to(dt), dims)
        cin = vol.shape[-1]
        n_sites = int(mask.sum())
        ct = torch.randn((*mask.shape, 64), generator=g, device=dev).to(dt)
        ct = torch.where(mask[..., None], ct, torch.zeros_like(ct))
        got = stem_conv_sites_dw(vol, coords, mask, ct)
        want = stem_conv_sites_dw_plain(vol, coords, mask, ct)
        torch.cuda.synchronize()
        # f32 sums in both, in another order
        scale = want.abs().max().item()
        err = _check_close(f"stem_sites_dw {dtname}", got, want, 1e-4,
                           2e-5 * scale)
        # a fixed order: a second run, the same bits
        if not torch.equal(stem_conv_sites_dw(vol, coords, mask, ct), got):
            raise AssertionError(f"stem_sites_dw {dtname}: two runs give "
                                 f"different dW")
        ms = time_ms(lambda: stem_conv_sites_dw(vol, coords, mask, ct))
        plain_ms = time_ms(lambda: stem_conv_sites_dw_plain(vol, coords,
                                                             mask, ct))
        # yardstick: cuDNN's dense weight gradient of the k7 conv, with ct
        # scattered to the sites of the NCDHW volume
        vol_nc = vol.permute(0, 4, 1, 2, 3).contiguous()
        ct_v, _ = scatter_to_dense(coords, mask, ct, dims)
        ct_nc = ct_v.permute(0, 4, 1, 2, 3).contiguous()
        del ct_v
        lib_ms = time_ms(lambda: torch.nn.grad.conv3d_weight(
            vol_nc, (64, cin, 7, 7, 7), ct_nc, padding=3), n=5, warmup=1)
        devs = device_row(
            lambda: stem_conv_sites_dw(vol, coords, mask, ct),
            lambda: stem_conv_sites_dw_plain(vol, coords, mask, ct),
            lambda: torch.nn.grad.conv3d_weight(
                vol_nc, (64, cin, 7, 7, 7), ct_nc, padding=3),
            ms, plain_ms, lib_ms)
        del vol_nc, ct_nc
        torch.cuda.empty_cache()
        # what this data needs: the volume cells within reach of a site and
        # the sites' ct rows read once, dW written once; one product per
        # non-zero neighbour value and output channel
        n_nonzero, n_reach = stem_work(vol, coords, mask)
        esz = vol.element_size()
        nbytes = (n_reach * cin * esz + coords.numel() * 4 + mask.numel()
                  + n_sites * 64 * esz + got.numel() * 4)
        flops = 2.0 * n_nonzero * 64
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FLOPS[dtname] * 1e3
        rows.append({
            "name": "stem_sites_dw", "dtype": dtname, "route": "cuda",
            "source": DW_SRC, "replaces": DW_REPLACES, "launches": None,
            "max_abs_err": err, "max_abs_plain": scale,
            "tolerance": "rtol 1e-4, atol 2e-5 * max|plain| (f32 sums in "
                         "another order)", "reproducible": True,
            "ms": ms, "plain_ms": plain_ms, **devs,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": lib_ms,
            "library": "torch.nn.grad.conv3d_weight k7 pad 3, NCDHW",
            "shape": {"vol": list(vol.shape), "ct": list(ct.shape),
                      "dw": list(got.shape), "occupied_sites": n_sites,
                      "cells_in_reach": n_reach,
                      "nonzero_neighbour_values": n_nonzero,
                      "needed_flops": flops, "needed_bytes": nbytes},
            "card": smi})
        del got, want, ct

        # the pool's input: the stem rows through BN + act, as on the path
        wts = net.stem_conv.kernel.detach().to(dt).contiguous()
        bias = net.stem_conv.bias.detach().to(dt).contiguous()
        h_rows = net.act(net.stem_norm(stem_conv_sites(
            vol, coords, mask, wts, bias), mask)) * mask[..., None].to(dt)
        del vol
        torch.cuda.empty_cache()
        rows.append(pool_rows_row(coords, mask, h_rows, dims, dtname, smi,
                                  "train batch", "train"))
        y, occ_l = pooled_rows(coords, mask, h_rows, dims)
        ct = torch.randn(y.shape, generator=g, device=dev).to(dt)
        got = masked_max_pool_bwd_rows(coords, mask, h_rows, y, occ_l, ct,
                                       dims)
        want = masked_max_pool_bwd_rows_plain(coords, mask, h_rows, y, occ_l,
                                              ct, dims)
        torch.cuda.synchronize()
        err_p = _check_close(f"max_pool_k3s2_bwd {dtname}", got, want, 0.0,
                             0.0)
        # one owner per output value, sums in slot order: the same bits
        if not _same_bits(masked_max_pool_bwd_rows(
                coords, mask, h_rows, y, occ_l, ct, dims), got):
            raise AssertionError(f"max_pool_k3s2_bwd {dtname}: two calls "
                                 f"give different bits")
        ms_p = time_ms(lambda: masked_max_pool_bwd_rows(
            coords, mask, h_rows, y, occ_l, ct, dims))
        plain_ms_p = time_ms(lambda: masked_max_pool_bwd_rows_plain(
            coords, mask, h_rows, y, occ_l, ct, dims))
        # yardstick (time only: it routes a tie to one cell): aten's
        # max_pool3d backward on the -inf-filled NCDHW volume
        x, occ = scatter_to_dense(coords, mask, h_rows, dims)
        x = torch.where(occ > 0, x, torch.full((), float("-inf"), dtype=dt,
                                                device=dev))
        x_nc = x.permute(0, 4, 1, 2, 3).contiguous()
        del x, occ
        _, idx = torch.nn.functional.max_pool3d(x_nc, 3, 2, 1,
                                                return_indices=True)
        ct_nc = ct.permute(0, 4, 1, 2, 3).contiguous()
        aten_bwd = torch.ops.aten.max_pool3d_with_indices_backward
        lib_ms_p = time_ms(lambda: aten_bwd(ct_nc, x_nc, [3, 3, 3],
                                            [2, 2, 2], [1, 1, 1], [1, 1, 1],
                                            False, idx), n=5, warmup=1)
        devs = device_row(
            lambda: masked_max_pool_bwd_rows(coords, mask, h_rows, y, occ_l,
                                             ct, dims),
            lambda: masked_max_pool_bwd_rows_plain(coords, mask, h_rows, y,
                                                   occ_l, ct, dims),
            lambda: aten_bwd(ct_nc, x_nc, [3, 3, 3], [2, 2, 2], [1, 1, 1],
                             [1, 1, 1], False, idx), ms_p, plain_ms_p,
            lib_ms_p)
        del x_nc, ct_nc, idx
        torch.cuda.empty_cache()
        # what this data needs: coords and mask, h at the occupied rows, y
        # and ct at the distinct occupied parents they reach, occ_l there,
        # dx written once; a compare and an add per (row, parent, channel)
        c = h_rows.shape[-1]
        flat, valid = _pool_parents(coords, mask, dims)
        valid = valid & (occ_l.reshape(-1)[flat] > 0)
        n_links = int(valid.sum())
        n_parents = int(torch.unique(flat[valid]).numel())
        esz = h_rows.element_size()
        nbytes = (coords.numel() * 4 + mask.numel() + n_sites * c * esz
                  + n_parents * (2 * c + 1) * esz + got.numel() * esz)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = 2.0 * n_links * c / PEAK_FLOPS["float32"] * 1e3
        rows.append({
            "name": "max_pool_k3s2_bwd", "dtype": dtname, "route": "cuda",
            "source": POOL_BWD_SRC, "replaces": POOL_BWD_REPLACES,
            "launches": None, "max_abs_err": err_p,
            "max_abs_plain": _amax(want), "tolerance": "exact",
            "reproducible": True,
            "ms": ms_p, "plain_ms": plain_ms_p, **devs,
            "fill_device_ms": fill_device_ms(h_rows, got.numel()),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": lib_ms_p,
            "library": "aten.max_pool3d_with_indices_backward on the "
                       "-inf-filled NCDHW volume (one cell per tie)",
            "shape": {"h_rows": list(h_rows.shape), "y": list(y.shape),
                      "occupied_rows": n_sites, "row_parent_links": n_links,
                      "parents_read": n_parents, "needed_bytes": nbytes,
                      "nonzero_dx": int((got != 0).sum())},
            "card": smi})
    return rows


def kpconv_work(nbr, rel, kernel_points, extent: float, influence: str,
                aggregation: str, ns: int) -> dict:
    """What a fused KPConv's data needs: the non-shadow edges, the (edge,
    kernel point) pairs with a non-zero influence, the query rows with any
    neighbour, and the distinct rows of x that are read."""
    import torch
    from dpcr_agb_tpu_torch.ops.kpconv import influence_weights
    valid = nbr < ns
    w = influence_weights(rel, kernel_points, extent, influence, aggregation)
    pairs = int(((w != 0) & valid[..., None]).sum())
    del w
    b = nbr.shape[0]
    flat = (nbr.long() + torch.arange(b, device=nbr.device)[:, None, None]
            * ns)[valid]
    return {"edges": int(valid.sum()), "weighted_pairs": pairs,
            "active_rows": int(valid.any(-1).sum()),
            "rows_of_x_read": int(torch.unique(flat).numel())}


def capture_kpconv_inputs(net, tb) -> tuple:
    """One forward of the KPCNN `net` on the device batch tb: the inputs
    (nbr, x, rel) of each of its 14 KPConvs by block, and those of each
    strided shortcut's max pool (x, nbr) by block."""
    import torch
    from dpcr_agb_tpu_torch.models import kpconv as kmodel
    convs, pools = {}, {}
    blocks = [bi for bi, *_ in net.blocks if hasattr(net, f"block{bi}_kpconv")]
    hooks = [getattr(net, f"block{bi}_kpconv").register_forward_pre_hook(
        lambda mod, args, bi=bi: convs.__setitem__(
            bi, tuple(a.detach() for a in args[:3]))) for bi in blocks]
    pool, order = kmodel.max_pool_zero_shadow_batched, []

    def record(x, nbr, rev=None):
        order.append((x.detach(), nbr))
        return pool(x, nbr, rev)

    kmodel.max_pool_zero_shadow_batched = record
    try:
        with torch.no_grad():
            net(tb)
    finally:
        kmodel.max_pool_zero_shadow_batched = pool
        for h in hooks:
            h.remove()
    strided = [bi for bi, block, *_ in net.blocks if "strided" in block]
    return convs, dict(zip(strided, order))


# layers whose nbr the kernels are also held at with the bench's
# neighbourhood limits (bench.py:179: K 51 at level 2, 70 at level 3)
KP_WIDE_K = ((6, 2, 51), (9, 3, 70))
KP_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.0, 1e-2)}


def kpconv_layer_sweep(net, tb, convs: dict, smi: str, seed: int) -> dict:
    """kpconv_fused and kpconv_fused_bwd at all 14 layers of the first
    serving batch, f32 and bf16: each held against its plain version at
    the stated tolerances, dx and dW the same bits in two runs, timed (ms,
    device_ms; their sums over the 14 layers stand beside the profile's
    totals); then both at K 51 and 70 (the bench's limits) on level 2's and
    level 3's points, against their plain versions."""
    import torch
    from dpcr_agb_tpu_torch.ops import kpconv
    from dpcr_agb_tpu_torch.ops.neighbors import radius_neighbors
    dev = tb.pos.device
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    out = {"phase": "kpconv_layers", "card": smi}

    def check(what, x, nbr, rel, op, dtname, timed):
        dt = getattr(torch, dtname)
        ns = x.shape[1]
        rev = kpconv.reverse_edges(nbr, ns)
        w = op.weights.detach().contiguous()
        tail = (op.extent, op.influence, op.aggregation)
        args = (x.to(dt).contiguous(), nbr, rel, w, op.kernel_points)
        ct = torch.randn((*nbr.shape[:2], w.shape[-1]), generator=g,
                         device=dev)
        rtol, atol = KP_TOL[dtname]
        with torch.no_grad():
            want = kpconv.kpconv_fused_plain(*args, *tail)
            got = kpconv.kpconv_forward(*args, *tail)
            row = {"x": list(x.shape), "nbr": list(nbr.shape),
                   "cout": w.shape[-1],
                   "fwd_max_abs_err": _check_close(
                       f"kpconv_fused {what} {dtname}", got, want, rtol,
                       atol * _amax(want)),
                   "fwd_max_abs_plain": _amax(want)}
            dx_w, dw_w = kpconv.kpconv_fused_bwd_plain(*args, ct, *tail)
            dx, dw = kpconv.kpconv_backward(*args, ct, *tail, rev=rev)
            for n, a_, b_ in (("dx", dx, dx_w), ("dw", dw, dw_w)):
                row[f"{n}_max_abs_err"] = _check_close(
                    f"kpconv_fused_bwd {n} {what} {dtname}", a_, b_, rtol,
                    atol * _amax(b_))
                row[f"{n}_max_abs_plain"] = _amax(b_)
            dx2, dw2 = kpconv.kpconv_backward(*args, ct, *tail, rev=rev)
            if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
                raise AssertionError(f"kpconv_fused_bwd {what} {dtname}: "
                                     f"two runs differ")
            del want, got, dx_w, dw_w, dx, dw, dx2, dw2
            if timed:
                def fwd():
                    return kpconv.kpconv_forward(*args, *tail)

                def bwd():
                    return kpconv.kpconv_backward(*args, ct, *tail, rev=rev)

                row.update(fwd_ms=time_ms(fwd), fwd_device_ms=device_ms(fwd),
                           bwd_ms=time_ms(bwd), bwd_device_ms=device_ms(bwd))
        return row

    for dtname in ("float32", "bfloat16"):
        layers = []
        for bi in sorted(convs):
            nbr, x, rel = convs[bi]
            layers.append({"block": bi, **check(
                f"block {bi}", x, nbr, rel, getattr(net, f"block{bi}_kpconv"),
                dtname, True)})
        out[dtname] = {"layers": layers, **{
            f"{k}_sum": sum(r[k] for r in layers) for k in (
                "fwd_ms", "fwd_device_ms", "bwd_ms", "bwd_device_ms")}}
    # the bench's neighbourhood limits on this batch's pyramid
    pyr = tb.aux
    wide = []
    for bi, level, k in KP_WIDE_K:
        _, x, _ = convs[bi]
        p, m = pyr[f"kp_pts{level}"], pyr[f"kp_mask{level}"]
        r = net.first_subsampling_dl * net.conv_radius * 2 ** level
        nbr = radius_neighbors(p, m, p, m, r, k)
        rel = kpconv.shared_rel(p, p, nbr)
        for dtname in ("float32", "bfloat16"):
            wide.append({"block": bi, "level": level, "k": k,
                         "dtype": dtname,
                         "filled_slots": int((nbr < x.shape[1]).sum()),
                         **check(f"block {bi} K {k}", x, nbr, rel,
                                 getattr(net, f"block{bi}_kpconv"), dtname,
                                 False)})
    out["wide_k"] = wide
    emit(out)
    return out


def gather_kernel_rows(x, nbr, smi: str, seed: int) -> list:
    """gather_rows_bwd (the strided shortcut's gather backward) at the
    first shortcut's shapes of the first serving batch, f32: against its
    plain version (index_add_), the same bits in two runs, timed beside
    one `torch.index_add` of the same rows."""
    import torch
    from dpcr_agb_tpu_torch.ops import kpconv
    b, ns, c = x.shape
    g = torch.Generator(device=x.device).manual_seed(seed + 2)
    ct = torch.randn((*nbr.shape, c), generator=g, device=x.device)
    rev = kpconv.reverse_edges(nbr, ns)
    got = kpconv.gather_rows_backward(ct, nbr, ns, rev)
    want = kpconv.gather_rows_bwd_plain(ct, nbr, ns)
    torch.cuda.synchronize()
    err = _check_close("gather_rows_bwd", got, want, 1e-5, 1e-6 * _amax(want))
    if not torch.equal(kpconv.gather_rows_backward(ct, nbr, ns, rev), got):
        raise AssertionError("gather_rows_bwd: two runs differ")
    idx = (torch.where(nbr < ns, nbr.long(), ns)
           + (torch.arange(b, device=x.device) * (ns + 1))[:, None, None]
           ).reshape(-1)
    zero = torch.zeros((b * (ns + 1), c), device=x.device)
    flat = ct.reshape(-1, c)

    def kernel():
        return kpconv.gather_rows_backward(ct, nbr, ns, rev)

    def plain():
        return kpconv.gather_rows_bwd_plain(ct, nbr, ns)

    def library():
        return torch.index_add(zero, 0, idx, flat)

    ms, plain_ms, lib_ms = (time_ms(f) for f in (kernel, plain, library))
    devs = device_row(kernel, plain, library, ms, plain_ms, lib_ms)
    # nbr and the real edges' cotangent rows read once, dx written once
    # (the reverse index is the kernel's own helper, not counted: nbr
    # alone says where dx goes); an add per real edge and channel
    real = int((nbr < ns).sum())
    nbytes = real * c * 4 + nbr.numel() * 4 + b * ns * c * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = real * c / PEAK_FLOPS["float32"] * 1e3
    return [{
        "name": "gather_rows_bwd", "dtype": "float32",
        "case": "first strided shortcut (level 0 -> 1)", "route": "cuda",
        "source": KP_BWD_SRC, "replaces": GATHER_REPLACES, "launches": None,
        "max_abs_err": err, "max_abs_plain": _amax(want),
        "tolerance": "rtol 1e-5, atol 1e-6 * max|plain| (index_add_ adds "
                     "with atomics)",
        "ms": ms, "plain_ms": plain_ms, **devs,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": lib_ms,
        "library": "torch.index_add of the cotangent rows",
        "reproducible": True,
        "shape": {"x": list(x.shape), "nbr": list(nbr.shape),
                  "real_edges": real, "needed_bytes": nbytes},
        "card": smi}]


def phase_kpconv_kernels(bundle, batch, smi: str, seed: int) -> list:
    """kpconv_fused and kpconv_fused_bwd in f32 and bf16 on the inputs that
    the first serving batch gives the layers of KP_CASES (captured by
    hooks during one forward), cotangents drawn from `seed`; the sweep
    over all 14 layers and K 51/70 (`kpconv_layer_sweep`), and
    gather_rows_bwd."""
    import torch
    from dpcr_agb_tpu_torch.ops import kpconv
    net, dev = bundle.net, bundle.device
    tb = batch.to(dev)
    convs, pools = capture_kpconv_inputs(net, tb)
    KP_SWEEP.update(kpconv_layer_sweep(net, tb, convs, smi, seed))
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = gather_kernel_rows(*pools[min(pools)], smi, seed)
    for bi, case in KP_CASES:
        op = getattr(net, f"block{bi}_kpconv")
        nbr, x, rel = convs[bi]
        w = op.weights.detach().contiguous()
        kp = op.kernel_points
        tail = (op.extent, op.influence, op.aggregation)
        (b, ns, c), (n_kp, _, cout) = x.shape, w.shape
        nq, k = nbr.shape[1:]
        work = kpconv_work(nbr, rel, kp, *tail, ns)
        ct = torch.randn((b, nq, cout), generator=g, device=dev)
        shape = {"x": list(x.shape), "nbr": list(nbr.shape),
                 "weights": list(w.shape), "extent": op.extent, **work}
        for dtname, dt in (("float32", torch.float32),
                           ("bfloat16", torch.bfloat16)):
            args = (x.to(dt).contiguous(), nbr, rel, w, kp)
            esz = args[0].element_size()
            # f32: sums in another order, dx and dW through f32 atomics.
            # bf16: kernel and plain version round at the same places, but
            # a sum taken in another order can land on the other side of a
            # bf16 rounding (2^-8 of one term).
            rtol, atol = (1e-4, 1e-4) if dt == torch.float32 else (0.0, 1e-2)
            tol = f"rtol {rtol}, atol {atol} * max|plain|"
            with torch.no_grad():
                got = kpconv.kpconv_forward(*args, *tail)
                want = kpconv.kpconv_fused_plain(*args, *tail)
                torch.cuda.synchronize()
                scale = _amax(want)
                err = _check_close(f"kpconv_fused {case} {dtname}", got, want,
                                   rtol, atol * scale)
                del got, want
                ms = time_ms(lambda: kpconv.kpconv_forward(*args, *tail))
                plain_ms = time_ms(lambda: kpconv.kpconv_fused_plain(
                    *args, *tail), n=5, warmup=1)
                devs = device_row(
                    lambda: kpconv.kpconv_forward(*args, *tail),
                    lambda: kpconv.kpconv_fused_plain(*args, *tail), None,
                    ms, plain_ms, None)
                devs["sub_kernels"] = kernel_ms(
                    lambda: kpconv.kpconv_forward(*args, *tail))
                # each input read once (of x the distinct rows that some
                # neighbour list names), the output written once; a
                # multiply-add per weighted pair and channel, then per
                # active row, kernel point, channel and output channel
                nbytes = (work["rows_of_x_read"] * c * esz + nbr.numel() * 4
                          + rel.numel() * 4 + w.numel() * 4 + kp.numel() * 4
                          + b * nq * cout * 4)
                flops = 2.0 * c * (work["weighted_pairs"]
                                   + work["active_rows"] * n_kp * cout)
                t_bytes = nbytes / PEAK_BYTES * 1e3
                t_ops = flops / PEAK_FLOPS[dtname] * 1e3
                rows.append({
                    "name": "kpconv_fused", "dtype": dtname, "case": case,
                    "route": "cuda", "source": KP_FWD_SRC,
                    "replaces": KP_FWD_REPLACES, "launches": None,
                    "max_abs_err": err, "max_abs_plain": scale,
                    "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                    **devs, "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes > t_ops else "operations",
                    "library_ms": None,
                    "library": "none: no one PyTorch call computes it",
                    "shape": {**shape, "needed_flops": flops,
                              "needed_bytes": nbytes}, "card": smi})

                rev = kpconv.reverse_edges(nbr, ns)
                dx, dw = kpconv.kpconv_backward(*args, ct, *tail, rev=rev)
                dx_w, dw_w = kpconv.kpconv_fused_bwd_plain(*args, ct, *tail)
                torch.cuda.synchronize()
                scales = {"dx": _amax(dx_w), "dw": _amax(dw_w)}
                errs = {
                    "dx": _check_close(f"kpconv_fused_bwd dx {case} {dtname}",
                                       dx, dx_w, rtol, atol * scales["dx"]),
                    "dw": _check_close(f"kpconv_fused_bwd dW {case} {dtname}",
                                       dw, dw_w, rtol, atol * scales["dw"])}
                # dx and dW are summed in a fixed order: a second run, the
                # same bits
                dx2, dw2 = kpconv.kpconv_backward(*args, ct, *tail, rev=rev)
                if not (torch.equal(dx2, dx) and torch.equal(dw2, dw)):
                    raise AssertionError(f"kpconv_fused_bwd {case} {dtname}: "
                                         f"two runs give different dx or dW")
                del dx, dw, dx_w, dw_w, dx2, dw2

                def kernel():
                    return kpconv.kpconv_backward(*args, ct, *tail, rev=rev)

                def plain():
                    return kpconv.kpconv_fused_bwd_plain(*args, ct, *tail)

                ms = time_ms(kernel)
                # built once per neighbour list on the main path and shared
                # by every op over it, so outside the kernel's ms
                rev_ms = time_ms(lambda: kpconv.reverse_edges(nbr, ns))
                plain_ms = time_ms(plain, n=5, warmup=1)
                dev_ms = device_ms(kernel)
                plain_dev_ms = device_ms(plain, n=5, warmup=1)
                sub_kernels = kernel_ms(kernel)
                # the forward's inputs and g read once, dx and dW written
                # once (the reverse index is the kernel's own helper, not
                # counted: nbr alone says where dx goes); g @ W^T and
                # part^T g per active row, the weighted sums for part and
                # for dx per weighted pair
                nbytes = (work["rows_of_x_read"] * c * esz + nbr.numel() * 4
                          + rel.numel() * 4 + w.numel() * 4 + kp.numel() * 4
                          + ct.numel() * 4 + b * ns * c * 4 + w.numel() * 4)
                flops = 4.0 * c * (work["weighted_pairs"]
                                   + work["active_rows"] * n_kp * cout)
                t_bytes = nbytes / PEAK_BYTES * 1e3
                t_ops = flops / PEAK_FLOPS[dtname] * 1e3
                worst = max(errs, key=lambda k: errs[k] / max(scales[k],
                                                              1e-30))
                rows.append({
                    "name": "kpconv_fused_bwd", "dtype": dtname, "case": case,
                    "route": "cuda", "source": KP_BWD_SRC,
                    "replaces": KP_BWD_REPLACES, "launches": None,
                    "max_abs_err": errs[worst],
                    "max_abs_plain": scales[worst], "errors": errs,
                    "max_abs_plains": scales,
                    "tolerance": tol, "ms": ms,
                    "plain_ms": plain_ms, "device_ms": dev_ms,
                    "plain_device_ms": plain_dev_ms,
                    "reverse_edges_ms": rev_ms,
                    "sub_kernels": sub_kernels, "dw_reproducible": True,
                    "dx_reproducible": True,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes > t_ops else "operations",
                    "library_ms": None,
                    "library": "none: no one PyTorch call computes it",
                    "shape": {**shape, "g": list(ct.shape),
                              "needed_flops": flops, "needed_bytes": nbytes},
                    "card": smi})
            del args, rev
            torch.cuda.empty_cache()
        del nbr, x, rel, ct
    for r in rows:
        emit({"phase": "kernels", **r})
    return rows


def fps_work(b: int, n: int, n_samples: int) -> tuple:
    """bound_ms of one fps call and what binds it: the larger of its
    operations (each of the n_samples - 1 steps takes ~10 f32 operations
    at each of the B x N points: three differences, three products, two
    sums, the minimum, the comparison) over the card's f32 peak, and its
    bytes (pos and mask read once, the int64 indices written once) over
    its memory rate."""
    ops_ms = b * (n_samples - 1) * n * 10 / PEAK_FLOPS["float32"] * 1e3
    bytes_ms = (b * n * 13 + b * n_samples * 8) / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), \
        "operations" if ops_ms >= bytes_ms else "bytes"


def plain_loop_device_ms(fn) -> float:
    """The device time of one call of a plain loop that queues thousands
    of small kernels (no spin outlasts their enqueueing): the sum of its
    kernels' device times, torch.profiler over one call."""
    return sum(_device_events(fn, 1).values())


def fps_events_and_profiler_ms(fn, n: int = 10) -> dict:
    """One fps launch's device ms read two ways on the same n calls,
    queued behind a spin: CUDA events around them, and torch.profiler's
    sum of their kernels' durations (the two disagreed when taken on
    different calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(int(50 * _sleep_cycles_per_ms()))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "fps_kernel" in e.key]
    # None where the profiler recorded no fps launch at all
    kernels_ms = sum(e.self_device_time_total for e in seen) / 1e3
    return {"events_ms": start.elapsed_time(end) / n,
            "profiler_ms": kernels_ms / n if seen else None,
            "profiler_launches": sum(e.count for e in seen), "calls": n}


def _fps_row(what: str, pos, mask, n_samples: int, smi: str,
             timed: bool = True, start: int = 0) -> tuple:
    """fps on one input against fps_plain on the card: the indices equal,
    the same bits in two calls, the plan with the clusters the card holds
    at once (at least B: one wave) and the distinct SMs of each sample's
    CTAs; with `timed`, timed beside the plain loop (whose first call
    above is its warm-up) and the device ms a serial step (step_us).
    Returns (row, the kernel's indices)."""
    import torch
    from dpcr_agb_tpu_torch import kernels
    from dpcr_agb_tpu_torch.ops.neighbors import fps_plain
    b, n = mask.shape
    plan = kernels.fps_plan(n, b)
    smid = torch.full((plan["ctas"],), -1, dtype=torch.int32,
                      device=pos.device)
    idx = kernels.fps(pos, mask, n_samples, start, smid=smid)
    again = kernels.fps(pos, mask, n_samples, start)
    want = fps_plain(pos, mask, n_samples, start)
    torch.cuda.synchronize()
    if not torch.equal(idx, want):
        bad = (idx != want).any(0).nonzero()
        raise AssertionError(f"fps {what}: indices differ from fps_plain's "
                             f"from step {int(bad[0])} on")
    if not torch.equal(idx, again):
        raise AssertionError(f"fps {what}: two calls gave other indices")
    per_sample = smid.view(b, plan["cluster"]).cpu()
    resident = kernels.fps_active_clusters(plan)
    if b > resident:
        raise AssertionError(f"fps {what}: {b} clusters of {plan} do not "
                             f"fit on the card at once ({resident})")
    row = {"phase": "kernels", "name": "fps", "route": "cuda",
           "source": FPS_SRC, "replaces": FPS_REPLACES, "dtype": "float32",
           "case": f"{what}: [{b},{n}] -> {n_samples}"
                   + (f", start {start}" if start else ""), "launches": None,
           "max_abs_err": 0.0, "indices_equal": True, "reproducible": True,
           "serial_steps": n_samples - 1,
           "plan": {**plan,
                    "max_active_clusters": resident,
                    "sms_used": len(set(smid.tolist())),
                    "min_sms_a_sample": min(len(set(r.tolist()))
                                            for r in per_sample)},
           "card": smi}
    if not timed:
        return row, idx
    bound, by = fps_work(b, n, n_samples)
    ms = time_ms(lambda: kernels.fps(pos, mask, n_samples))
    dev_ms = device_ms_of(lambda: kernels.fps(pos, mask, n_samples), ms)
    row.update(
        ms=ms, device_ms=dev_ms,
        step_us=dev_ms / max(n_samples - 1, 1) * 1e3,
        plain_ms=time_ms(lambda: fps_plain(pos, mask, n_samples), n=2,
                         warmup=0),
        plain_device_ms=plain_loop_device_ms(
            lambda: fps_plain(pos, mask, n_samples)),
        plain_device_ms_from="torch.profiler: the sum of the plain loop's "
                             "kernels",
        bound_ms=bound, bound_by=by, library_ms=None,
        library_device_ms=None)
    return row, idx


def fps_plans_row(what: str, pos, mask, n_samples: int, want, smi: str
                  ) -> dict:
    """The device ms of one sampling under every cluster size that holds
    its points (the plan's threads for each), each checked against the
    plan's indices: what fps_plan's choice of cluster rests on."""
    import torch
    from dpcr_agb_tpu_torch import kernels
    b, n = mask.shape
    out = {}
    for c in kernels.FPS_CLUSTERS:
        try:
            plan = kernels.fps_plan(n, b, cluster=c)
        except ValueError:
            continue   # too few CTAs' registers for n
        got = kernels.fps(pos, mask, n_samples, plan=plan)
        if not torch.equal(got, want):
            raise AssertionError(f"fps {what}: a cluster of {c} gave other "
                                 f"indices than the plan's")
        fn = (lambda p=plan: kernels.fps(pos, mask, n_samples, plan=p))
        dev = device_ms_of(fn, time_ms(fn, n=3, warmup=1))
        out[c] = {"threads": plan["threads"], "per": plan["per"],
                  "device_ms": dev,
                  "step_us": dev / max(n_samples - 1, 1) * 1e3}
    return {"phase": "fps_plans", "case": f"{what}: [{b},{n}] -> "
            f"{n_samples}", "chosen": kernels.fps_plan(n, b)["cluster"],
            "by_cluster": out, "card": smi}


def phase_fps_kernels(key: str, bundle, batch, smi: str) -> list:
    """fps at each sampling that the forward of the first serving batch
    takes (the input's, then PointNeXt's set abstractions, each on the
    points the one before kept): the path's rows, each followed by its
    fps_plans line; the input's timed also by torch.profiler on the same
    calls as CUDA events. And, printed as checks of their own, on the
    input's shapes: padded rows (sample 1's last 2000 masked and far), a
    sample with fewer valid rows than it samples (sample 0: 5000) and an
    all-masked one (sample 2); each sample's last quarter a copy of its
    first (duplicates in other CTAs of the cluster), started at 7777;
    and an integer grid of 12^3 cells (exact ties everywhere)."""
    import torch
    from dpcr_agb_tpu_torch import kernels
    from dpcr_agb_tpu_torch.models import pointnext
    net = bundle.net
    tb = batch.to(bundle.device)
    pos, mask = tb.pos.float().contiguous(), tb.mask.contiguous()
    rows = []

    def sampled(name, pos, mask, n_out):
        row, idx = _fps_row(name, pos, mask, n_out, smi)
        row["model"] = key
        rows.append(row)
        emit(row)
        emit(fps_plans_row(name, pos, mask, n_out, idx, smi))
        return idx

    if net.num_points and pos.shape[1] > net.num_points:
        padded_pos, padded = pos.clone(), mask.clone()
        padded[0, 5000:] = False
        padded[1, -2000:] = False
        padded_pos[1, -2000:] = 1e6
        padded[2] = False
        row, _ = _fps_row("input, padded", padded_pos, padded,
                          net.num_points, smi, timed=False)
        emit({**row, "phase": "kernels_check", "model": key})
        quarter = pos.shape[1] // 4
        cross = pos.clone()
        cross[:, -quarter:] = pos[:, :quarter]
        row, _ = _fps_row("input, duplicates across CTAs", cross, mask,
                          net.num_points, smi, timed=False, start=7777)
        emit({**row, "phase": "kernels_check", "model": key})
        gen = torch.Generator(device=pos.device).manual_seed(0)
        grid = torch.randint(0, 12, pos.shape, generator=gen,
                             device=pos.device).float()
        row, _ = _fps_row("input, integer grid", grid, mask,
                          net.num_points, smi, timed=False)
        emit({**row, "phase": "kernels_check", "model": key})
        idx = sampled("input", pos, mask, net.num_points)
        emit({"phase": "fps_timing", "model": key,
              "case": f"input: {list(mask.shape)} -> {net.num_points}",
              **fps_events_and_profiler_ms(
                  lambda: kernels.fps(pos, mask, net.num_points)),
              "card": smi})
        pos = pointnext._gather_rows(pos, idx).contiguous()
        mask = pointnext._gather_rows(mask, idx).contiguous()
    for name in getattr(net, "order", ()):
        block = getattr(net, name)
        if isinstance(block, pointnext._SetAbstraction):
            n_out = max(pos.shape[1] // block.stride, 1)
            idx = sampled(name, pos, mask, n_out)
            pos = pointnext._gather_rows(pos, idx).contiguous()
            mask = pointnext._gather_rows(mask, idx).contiguous()
    del tb
    torch.cuda.empty_cache()
    return rows


def ball_query_fill(bundle, batch) -> list:
    """PointNeXt's ball queries in the forward of one batch, in order: the
    queries and supports, the radius and nsample, the mean number of
    in-range neighbours of a valid query and the share of valid queries
    whose nsample slots are all filled."""
    from dpcr_agb_tpu_torch import predict
    from dpcr_agb_tpu_torch.ops import neighbors
    real, seen = neighbors.radius_neighbors, []

    def counted(q_pts, q_mask, s_pts, s_mask, radius, k, *args, **kw):
        nbr = real(q_pts, q_mask, s_pts, s_mask, radius, k, *args, **kw)
        filled = (nbr < s_pts.shape[1]).sum(-1)
        n_q = max(int(q_mask.sum()), 1)
        seen.append({"queries": list(q_pts.shape[:2]),
                     "supports": int(s_pts.shape[1]), "radius": radius,
                     "nsample": k,
                     "mean_in_range": float(filled[q_mask].sum()) / n_q,
                     "full_share": float((filled[q_mask] == k).sum()) / n_q})
        return nbr

    neighbors.radius_neighbors = counted
    try:
        predict.forward_raw(bundle, batch)
    finally:
        neighbors.radius_neighbors = real
    return seen


def batch_facts(net, batch) -> dict:
    """The padded sizes of a host batch and what fills them."""
    n_valid = int(np.asarray(batch.mask).sum())
    if hasattr(net, "level0_dims"):          # the sparse-voxel nets
        return {"v_bucket": int(batch.coords.shape[1]),
                "zb": int(len(batch.aux["zcells"])),
                "dims": list(net.level0_dims(batch)),
                "occupied_voxels": n_valid}
    out = {"n_bucket": int(batch.mask.shape[1]), "valid_points": n_valid}
    if hasattr(net, "level_caps"):           # KPConv
        out["level_caps"] = net.level_caps(int(batch.mask.shape[1]))
        out["neighborhood_limits"] = list(net.neighborhood_limits
                                          or [40] * len(net.levels))
    return out


def check_launches(what: str, key: str, launches: dict, part: str) -> None:
    """The launches of one forward (`part` "forward") or one train step
    ("step") of path `key`: each of its kernels at least once, and where
    the path fixes the counts, exactly those."""
    spec = MODELS[key]
    exact = spec["exact"]
    names = spec["forward"] + (spec["backward"] if part == "step" else ())
    if spec.get("launch_none"):
        bad = {k: n for k, n in launches.items() if n}
        expected = "no launch of any of the port's kernels"
    elif exact is None:
        bad = {k: launches[k] for k in names if launches[k] < 1}
        bad.update({k: launches[k] for k in spec.get("never", ())
                    if launches[k] != 0})
        expected = (f"at least 1 of each, none of "
                    f"{list(spec.get('never', ()))}")
    else:
        bad = {k: launches[k] for k, n in exact[part].items()
               if launches[k] != n}
        expected = exact[part]
    if bad:
        raise AssertionError(f"{what}: launches {bad} on the main path "
                             f"(expected {expected}): {launches}")


def kpconv_serve_routes(bundle, batch, raw, what: str) -> dict:
    """KPConv's two pyramid routes on the serving batch. The host route
    (the entry points' since PR 12): `host_pyramid_facts`. The device route
    (PRs 3-11's: the batch without aux, the pyramid built inside the
    forward): its forward_ms and plots/s, the pyramid's own time and share
    of that forward, two of its pyramids bit-identical (no atomics in it).
    And how far the routes' raw outputs part, max|host - device| /
    max|host|: a reading, not a check (other level-1+ point orders, other
    neighbours at the radius boundary)."""
    import dataclasses
    import torch
    from dpcr_agb_tpu_torch import predict
    out = host_pyramid_facts(bundle.net, batch, what)
    bare = dataclasses.replace(batch, aux=None)
    raw_device = predict.forward_raw(bundle, bare).float()
    fwd = wall_ms(lambda: predict.forward_raw(bundle, bare), 5, 1) / 1e3
    tb = bare.to(bundle.device)
    one, two = (bundle.net.device_pyramid(tb.pos, tb.mask)
                for _ in range(2))
    moved = [k for k in one if not torch.equal(one[k], two[k])]
    if moved:
        raise AssertionError(f"{what}: two device pyramids of one batch "
                             f"differ in {moved}")
    del one, two
    pyramid_ms = time_ms(lambda: bundle.net.device_pyramid(tb.pos, tb.mask),
                         n=5, warmup=1)
    del tb
    return {**out, "device_route_forward_ms": fwd * 1e3,
            "device_route_plots_per_s": N_PLOTS / fwd,
            "pyramid_ms": pyramid_ms,
            "pyramid_share_of_forward": pyramid_ms / (fwd * 1e3),
            "pyramid_reproducible": True,
            "host_vs_device_route_rel": ((raw - raw_device).abs().max()
                                         / raw.abs().max()).item()}


def phase_serve(key: str, dtname: str, ckpt: str, plot_dir: str,
                out_dir: str, smi: str, with_profile: bool = False) -> dict:
    import torch
    from dpcr_agb_tpu_torch import kernels, predict
    model_name = MODELS[key]["model_name"]
    out_csv = os.path.join(out_dir, f"preds_{key}_{dtname}.csv")
    args = [f"checkpoint_dir={ckpt}", f"model_name={model_name}",
            f"input={plot_dir}/*.npz", f"output={out_csv}",
            f"batch_size={N_PLOTS}"]
    what = f"serve {key} {dtname}"
    kernels.reset_launches()
    t0 = time.perf_counter()
    _, pinned = from_default_numerics(lambda: predict.main(args), what)
    torch.cuda.synchronize()
    main_seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    # N_PLOTS plots at batch_size N_PLOTS: one forward
    check_launches(what, key, launches, "forward")
    check_predictions(out_csv, what)

    # the same batch through the kernels and through the plain versions
    bundle = predict.load_serving_bundle(ckpt, model_name)
    files = sorted(glob.glob(os.path.join(plot_dir, "*.npz")))
    samples, _ = predict.load_samples(bundle, files)
    (batch, _), = predict.make_batches(bundle, samples, N_PLOTS)
    raw = predict.forward_raw(bundle, batch).float()
    raw_plain = err = tol = None   # no kernel on the path: nothing to hold
    if not MODELS[key].get("launch_none"):
        with plain_ops():
            raw_plain = predict.forward_raw(bundle, batch).float()
        torch.cuda.synchronize()
        if dtname == "float32":
            err = _check_close(f"{what} raw output", raw, raw_plain, 1e-3,
                               1e-3 * _amax(raw_plain))
            tol = "rtol 1e-3, atol 1e-3 * max|plain| (TF32 off)"
        else:
            err = _check_close(f"{what} raw output", raw, raw_plain, 0.0,
                               5e-2 * _amax(raw_plain))
            tol = "atol 5e-2 * max|plain| (bf16)"

    # forward time of the batch (host batch -> device -> raw output)
    fwd = wall_ms(lambda: predict.forward_raw(bundle, batch), 5, 1) / 1e3
    extra = {}
    if MODELS[key]["kernels"] == "dense_l0":
        # the same checkpoint through the sparse level 0 (no mode set)
        with mode_env({}):
            sparse = predict.load_serving_bundle(ckpt, model_name)
        if not sparse.net.sparse_level0 or bundle.net.sparse_level0:
            raise AssertionError(f"{what}: level-0 forms not as set")
        raw_sparse = predict.forward_raw(sparse, batch).float()
        rel = 1e-3 if dtname == "float32" else 5e-2
        extra = {"sparse_level0_max_abs_err": _check_close(
                     f"{what} against the sparse level 0", raw, raw_sparse,
                     0.0, rel * _amax(raw_sparse)),
                 "sparse_level0_tolerance": f"atol {rel} * max|sparse|",
                 "modes": {k: getattr(bundle.net, k) for k in (
                     "l0_mode", "stem_mode", "pool_bwd")}}
        del sparse, raw_sparse
    if hasattr(bundle.net, "device_pyramid"):
        extra = kpconv_serve_routes(bundle, batch, raw, what)
    if MODELS[key]["kernels"] == "fps":
        extra = {"ball_query": ball_query_fill(bundle, batch)}
    profile = device_profile(lambda: predict.forward_raw(bundle, batch)) \
        if with_profile else None
    torch.cuda.reset_peak_memory_stats()
    predict.forward_raw(bundle, batch)
    torch.cuda.synchronize()
    out = {"phase": "serve", "model": key, "dtype": dtname,
           "plots": N_PLOTS, **batch_facts(bundle.net, batch),
           "launches": launches, "predict_main_seconds": main_seconds,
           "raw_max_abs_err_vs_plain": err,
           "raw_max_abs_plain": None if raw_plain is None else
           _amax(raw_plain), "tolerance": tol,
           "forward_ms": fwd * 1e3, "plots_per_s": N_PLOTS / fwd, **extra,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "numerics": pinned, "profile": profile, "card": smi}
    if key == "KPConv" and KP_SWEEP:
        out["kpconv_fused_14_layers_device_ms"] = \
            KP_SWEEP[dtname]["fwd_device_ms_sum"]
    emit(out)
    return out


def jax_data_cfg(data_cfg: dict) -> dict:
    """A port data config in the JAX run_config layout: the train and test
    chains under the preset that transform_type names."""
    tt = data_cfg["transform_type"]
    out = {k: v for k, v in data_cfg.items()
           if k not in ("train_transform", "test_transform")}
    out[tt] = {**(data_cfg.get(tt) or {}),
               "train_transform": data_cfg["train_transform"],
               "test_transform": data_cfg["test_transform"]}
    return out


def read_predictions(out_csv: str) -> tuple:
    """(plot names without their extension, predictions) of a csv of
    `predict.main`."""
    with open(out_csv) as f:
        rows = list(csv.reader(f))[1:]
    return ([os.path.splitext(r[0])[0] for r in rows],
            np.array([[float(v) for v in r[1:]] for r in rows]))


def phase_serve_jax_ckpt(key: str, pt_dir: str, plot_dir: str, tmp: str,
                         smi: str) -> dict:
    """The f32 checkpoint of path `key` served from a JAX `.ckpt` and LAZ
    plots, against the `.pt` and `.npz` route on the same positions."""
    import torch
    from dpcr_agb_tpu_torch import kernels, predict
    from dpcr_agb_tpu_torch.data.las_io import read_las, write_laz14
    from dpcr_agb_tpu_torch.training.state import Checkpoint
    from dpcr_agb_tpu_torch.weights import from_flax, to_flax
    model_name = MODELS[key]["model_name"]
    what = f"serve_jax_ckpt {key}"
    root = os.path.join(tmp, f"jax_ckpt_{key}")
    dirs = {d: os.path.join(root, d) for d in ("laz", "npz", "ckpt")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    stems = [os.path.splitext(os.path.basename(f))[0] for f in
             sorted(glob.glob(os.path.join(plot_dir, "*.npz")))]
    lazs = [os.path.join(dirs["laz"], f"{s}.laz") for s in stems]
    for s, path in zip(stems, lazs):
        write_laz14(path, np.load(os.path.join(plot_dir, f"{s}.npz"))["pos"])
    t0 = time.perf_counter()
    decoded = [read_las(path)[0] for path in lazs]
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(lazs)
    for s, pos in zip(stems, decoded):
        np.savez(os.path.join(dirs["npz"], f"{s}.npz"), pos=pos)

    pt = torch.load(os.path.join(pt_dir, f"{model_name}.pt"),
                    map_location="cpu", weights_only=True)
    weights = pt["weights"]["latest"]
    params, stats = to_flax(weights)
    ck = Checkpoint({"model_name": model_name,
                     "models": {model_name: pt["option"]},
                     "data": jax_data_cfg(pt["data"])},
                    {"target_stats": pt["target_stats"],
                     "reg_targets": pt["reg_targets"]})
    ck.models["latest"] = {"params": params, "batch_stats": stats}
    ckpt_path = os.path.join(dirs["ckpt"], f"{model_name}.ckpt")
    with open(ckpt_path, "wb") as f:
        f.write(ck.to_bytes())
    # the file decoded to tensors on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with open(ckpt_path, "rb") as f:
        state = Checkpoint.from_bytes(f.read()).get_model_state("latest")
    on_card = {k: v.to("cuda") for k, v in from_flax(
        state["params"], state["batch_stats"]).items()}
    torch.cuda.synchronize()
    load_seconds = time.perf_counter() - t0
    moved = [k for k in weights if not torch.equal(on_card[k].cpu(),
                                                   weights[k])]
    if moved or set(on_card) != set(weights):
        raise AssertionError(f"{what}: the .ckpt's weights differ from the "
                             f".pt's: {moved[:5]}")
    del on_card

    runs = {}
    for route, ckpt_dir, inputs in (
            ("ckpt_laz", dirs["ckpt"], f"{dirs['laz']}/*.laz"),
            ("pt_npz", pt_dir, f"{dirs['npz']}/*.npz")):
        out_csv = os.path.join(root, f"preds_{route}.csv")
        kernels.reset_launches()
        t0 = time.perf_counter()
        predict.main([f"checkpoint_dir={ckpt_dir}",
                      f"model_name={model_name}", f"input={inputs}",
                      f"output={out_csv}", f"batch_size={N_PLOTS}"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[route] = (seconds, dict(kernels.LAUNCHES),
                       *read_predictions(out_csv))
    (s_ckpt, l_ckpt, n_ckpt, p_ckpt), (s_pt, l_pt, n_pt, p_pt) = \
        runs["ckpt_laz"], runs["pt_npz"]
    if n_ckpt != n_pt or n_ckpt != stems:
        raise AssertionError(f"{what}: the CSVs list {n_ckpt} and {n_pt}, "
                             f"the plots are {stems}")
    if p_ckpt.shape != (N_PLOTS, 2) or not np.isfinite(p_ckpt).all():
        raise AssertionError(f"{what}: predictions {p_ckpt.shape}, "
                             f"finite={np.isfinite(p_ckpt).all()}")
    diff = float(np.abs(p_ckpt - p_pt).max())
    scale = float(np.abs(p_pt).max())
    if diff > 1e-5 * scale:
        raise AssertionError(f"{what}: predictions differ by {diff} "
                             f"(max|pred| {scale}, tolerance 1e-5 of it)")
    if l_ckpt != l_pt:
        raise AssertionError(f"{what}: launches {l_ckpt} on the .ckpt "
                             f"route, {l_pt} on the .pt route")
    check_launches(what, key, l_ckpt, "forward")
    out = {"phase": "serve_jax_ckpt", "model": key, "dtype": "float32",
           "plots": N_PLOTS, "ckpt_bytes": os.path.getsize(ckpt_path),
           "ckpt_load_seconds": load_seconds,
           "points_per_plot": [int(len(p)) for p in decoded],
           "laz_bytes_per_plot": [os.path.getsize(p) for p in lazs],
           "laz_decode_ms_per_plot": decode_ms,
           "predict_main_seconds": {"ckpt_laz": s_ckpt, "pt_npz": s_pt},
           "launches": l_ckpt, "max_abs_diff": diff, "max_abs_pred": scale,
           "bit_equal": bool(np.array_equal(p_ckpt, p_pt)),
           "tolerance": "1e-5 * max|pred|", "card": smi}
    emit(out)
    return out


def from_default_numerics(run, what: str) -> tuple:
    """run() (an entry point) started from PyTorch's default float32
    settings (TF32 on in cuDNN): returns (its result, the settings it left,
    i.e. its own pin); raises unless it turned TF32 off."""
    import torch
    from dpcr_agb_tpu_torch.device import numerics
    torch.backends.cudnn.allow_tf32 = True
    out = run()
    got = numerics()
    if got["cudnn_allow_tf32"] or got["matmul_allow_tf32"]:
        raise AssertionError(f"{what}: the entry point left TF32 on: {got}")
    return out, got


def check_predictions(out_csv: str, what: str) -> None:
    """The csv of `predict.main` holds N_PLOTS finite rows of 2 targets."""
    with open(out_csv) as f:
        rows = list(csv.reader(f))[1:]
    preds = np.array([[float(v) for v in r[1:]] for r in rows])
    if preds.shape != (N_PLOTS, 2) or not np.isfinite(preds).all():
        raise AssertionError(f"{what}: predictions {preds.shape}, "
                             f"finite={np.isfinite(preds).all()}")


def _rel(a, b, floor: float = 0.0) -> float:
    import torch
    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b)
            / max(torch.linalg.vector_norm(b).item(), floor, 1e-30)).item()


def _step_errors(got, want, before: dict, loss_got: float,
                 loss_want: float) -> tuple:
    """The errors of one stepped runner against another that started from
    the same state `before`: (errs, each gradient's error by name)."""
    import torch
    pk = dict(got.net.named_parameters())
    pp = dict(want.net.named_parameters())
    names = sorted(pp)

    def flat(tensors):
        return torch.cat([t.reshape(-1).double() for t in tensors])

    flat_p = flat(pp[n].grad for n in names)
    norm = torch.linalg.vector_norm(flat_p).item()
    grad = {n: _rel(pk[n].grad, pp[n].grad, 1e-3 * norm) for n in names}
    # each parameter's update, floored like the gradients: a parameter
    # whose gradient is rounding noise moves by noise on both sides
    upd_k = {n: pk[n].detach().double() - before[n].double() for n in names}
    upd_p = {n: pp[n].detach().double() - before[n].double() for n in names}
    norm_u = torch.linalg.vector_norm(flat(upd_p.values())).item()
    update = {n: _rel(upd_k[n], upd_p[n], 1e-3 * norm_u) for n in names}
    bk = dict(got.net.named_buffers())
    stat = {n: _rel(bk[n], b) for n, b in want.net.named_buffers()}
    errs = {"loss": abs(loss_got - loss_want) / max(abs(loss_want), 1e-30),
            "grads": _rel(flat(pk[n].grad for n in names), flat_p),
            "grad": max(grad.values()),
            "params": _rel(flat(pk[n].detach() for n in names),
                           flat(pp[n].detach() for n in names)),
            "update": max(update.values()), "stat": max(stat.values())}
    return errs, grad


def stem_order_witness(again, reordered, plain, batch, before: dict,
                       loss_plain: float) -> dict:
    """How far a correct f32 reordering of the stem's sum moves one train
    step: a reading beside the step check, which it does not change.
    `again` takes the plain step a second time, `reordered` takes it with
    the stem's patch product summed as four products over quarters of its
    343 taps, added in order (each through `stem_conv_sites_plain` with
    the other taps' weights zeroed: exact in f32). Returns each one's step
    errors against `plain`'s (the first is cuDNN's run-to-run difference
    alone) and whether they are within STEP_TOL, how many stem values the
    reordering changes, and how many of the level-0 pool's routes (a row
    and channel's count of the windows whose max it is) it changes."""
    import torch
    from dpcr_agb_tpu_torch.ops import pool, sparse_stem
    stem_plain = sparse_stem.stem_conv_sites_plain
    rows_plain = pool.masked_max_pool_rows_plain

    def quartered(vol, coords, mask, weights, bias=None):
        quarter = (torch.arange(343, device=weights.device) * 4) // 343
        y = None
        for q in range(4):
            w = torch.where((quarter == q)[:, None, None], weights, 0.0)
            part = stem_plain(vol, coords, mask, w)
            y = part if y is None else y + part
        if bias is None:
            return y
        return (y + bias.to(y.dtype)) * mask[..., None].to(y.dtype)

    seen = {}

    def step(runner, tag, stem):
        def stem_seen(*args):
            seen[tag, "stem"] = stem(*args).detach()
            return seen[tag, "stem"]

        def rows_seen(coords, mask, h_rows, dims):
            y, occ_l = rows_plain(coords, mask, h_rows, dims)
            seen[tag, "pool"] = (coords, mask, h_rows.detach(), y, occ_l,
                                 dims)
            return y, occ_l

        with plain_ops():
            sparse_stem.stem_conv_sites = stem_seen
            pool.masked_max_pool_rows = rows_seen
            out = runner.train(batch)
        torch.cuda.synchronize()
        errs, _ = _step_errors(runner, plain, before, float(out["loss"]),
                               loss_plain)
        return {"errors": errs, "within_step_tol": all(
            v <= STEP_TOL["float32"][k] for k, v in errs.items())}

    out = {"reordering": "the stem's 343 taps summed as four quarter "
                         "products, added in order",
           "plain_again_vs_plain": step(again, "again", stem_plain),
           "reordered_vs_plain": step(reordered, "reordered", quartered)}
    a, r = seen["again", "stem"], seen["reordered", "stem"]
    routes = {}
    for tag in ("again", "reordered"):
        coords, mask, h_rows, y, occ_l, dims = seen[tag, "pool"]
        routes[tag] = pool.masked_max_pool_bwd_rows_plain(
            coords, mask, h_rows, y, occ_l, torch.ones_like(y), dims)
    out.update(
        stem_values=a.numel(), stem_values_changed=int((a != r).sum()),
        stem_max_abs_change=(a - r).abs().max().item(),
        pool_routes=int(batch.mask.sum()) * a.shape[-1],
        pool_routes_changed=int((routes["again"] != routes["reordered"])
                                .sum()))
    return out


def compare_train_steps(run, batch, dtname: str, tols: dict,
                        conditioning: bool = False,
                        stem_order: bool = False) -> dict:
    """One train step on one device batch from one state, through the
    kernels (run.runner) and through the plain versions (a copy of the
    runner); the errors of the kernel path against the plain one, each held
    to its tolerance. With `conditioning`, a third copy takes the plain
    step on the batch with its features moved by one f32 rounding
    (x * (1 + 6e-8 * normal noise)): its errors against the plain step say
    how far one rounding of the input moves each quantity, and a quantity
    may then miss its tolerance by up to 4 times that. With `stem_order`
    (f32), two more plain copies give `stem_order_witness`'s reading."""
    import copy
    import dataclasses
    import torch
    from dpcr_agb_tpu_torch import train

    def plain_copy():
        r = train.build_runner(copy.deepcopy(run.runner.net), run.stats,
                               seed=0)
        r.generator.set_state(run.runner.generator.get_state())
        return r

    plain = plain_copy()
    moved = plain_copy() if conditioning else None
    witness = (plain_copy(), plain_copy()) if stem_order else None
    before = {n: p.detach().clone()
              for n, p in plain.net.named_parameters()}
    out_k = run.runner.train(batch)
    with plain_ops():
        out_p = plain.train(batch)
    torch.cuda.synchronize()
    lk, lp = float(out_k["loss"]), float(out_p["loss"])
    errs, grad = _step_errors(run.runner, plain, before, lk, lp)
    tol = dict(tols[dtname])
    out = {"loss_kernel": lk, "loss_plain": lp, "errors": errs,
           "worst_grads": sorted(grad.items(), key=lambda kv: -kv[1])[:3],
           "tolerance": tol}
    if moved is not None:
        g = torch.Generator(device=batch.x.device).manual_seed(1)
        noise = torch.randn(batch.x.shape, generator=g, device=batch.x.device)
        with plain_ops():
            out_m = moved.train(dataclasses.replace(
                batch, x=batch.x * (1 + 6e-8 * noise)))
        torch.cuda.synchronize()
        sens, _ = _step_errors(moved, plain, before, float(out_m["loss"]), lp)
        out["one_rounding_of_x_moves_the_plain_step_by"] = sens
        tol = {k: max(v, 4 * sens[k]) for k, v in tol.items()}
        out["tolerance_with_conditioning"] = tol
    if witness is not None:
        out["stem_order_witness"] = stem_order_witness(*witness, plain, batch,
                                                       before, lp)
    bad = {k: v for k, v in errs.items() if not v <= tol[k]}
    if bad or not np.isfinite(lk):
        raise AssertionError(f"train {dtname}: kernel step vs plain step "
                             f"out of tolerance {tol}: {errs}; loss {lk} vs "
                             f"{lp}; worst gradients {out['worst_grads']}")
    return out


def phase_train(key: str, dtname: str, plot_dir: str, out_dir: str,
                smi: str, seed: int, with_profile: bool = False) -> dict:
    import torch
    from dpcr_agb_tpu_torch import kernels, predict, train
    from dpcr_agb_tpu_torch.training.step import StepRunner
    model_name = MODELS[key]["model_name"]
    bf16 = dtname == "bfloat16"
    what = f"train {key} {dtname}"
    ckpt = os.path.join(out_dir, f"trained_{key}_{dtname}")
    args = [f"input={plot_dir}/*.npz", f"checkpoint_dir={ckpt}",
            f"model_name={model_name}", f"steps={TRAIN_STEPS}",
            f"batch_size={N_PLOTS}", f"seed={seed}",
            f"bf16={str(bf16).lower()}"]
    # each step's launches, read around StepRunner.train
    per_step, unwrapped = [], StepRunner.train

    def counted(self, batch):
        before = dict(kernels.LAUNCHES)
        out = unwrapped(self, batch)
        per_step.append({k: n - before[k]
                         for k, n in kernels.LAUNCHES.items()})
        return out

    kernels.reset_launches()
    StepRunner.train = counted
    try:
        t0 = time.perf_counter()
        result, pinned = from_default_numerics(lambda: train.main(args), what)
        torch.cuda.synchronize()
        main_seconds = time.perf_counter() - t0
    finally:
        StepRunner.train = unwrapped
    saved = torch.load(result["checkpoint"], map_location="cpu",
                       weights_only=True)["numerics"]
    if saved != pinned:
        raise AssertionError(f"{what}: the checkpoint records {saved}, the "
                             f"run pinned {pinned}")
    launches = dict(kernels.LAUNCHES)
    losses = result["losses"]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"{what}: losses {losses}")
    if len(per_step) != TRAIN_STEPS:
        raise AssertionError(f"{what}: {len(per_step)} steps counted")
    for i, step in enumerate(per_step):
        check_launches(f"{what} step {i}", key, step, "step")

    # one step from one state through the kernels and the plain versions
    files = sorted(glob.glob(os.path.join(plot_dir, "*.npz")))
    run = train.setup(files, model_name, bf16=bf16, batch_size=N_PLOTS,
                      seed=seed)
    host_batch = run.stream.next()
    batch = host_batch.to(run.runner.device)
    compared = None if MODELS[key].get("launch_none") else \
        compare_train_steps(run, batch, dtname, STEP_TOL,
                            conditioning=MODELS[key].get("conditioned",
                                                         False),
                            stem_order=key == "SENet14" and not bf16)

    # step time on the device-resident batch
    runner = run.runner
    step_s = wall_ms(lambda: runner.train(batch), 5, 2) / 1e3
    # the same steps with cuDNN held to its deterministic algorithms (the
    # entry points leave that choice to cuDNN)
    torch.backends.cudnn.deterministic = True
    try:
        det_step_s = wall_ms(lambda: runner.train(batch), 5, 2) / 1e3
    finally:
        torch.backends.cudnn.deterministic = pinned["cudnn_deterministic"]
    routes = kpconv_train_routes(runner, host_batch, batch, what) \
        if hasattr(runner.net, "device_pyramid") else {}
    torch.cuda.reset_peak_memory_stats()
    runner.train(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    reserved = torch.cuda.max_memory_reserved() / 1e9
    profile = device_profile(lambda: runner.train(batch)) \
        if with_profile else None
    facts = batch_facts(runner.net, host_batch)
    del run, runner
    torch.cuda.empty_cache()

    out_csv = os.path.join(out_dir, f"preds_trained_{key}_{dtname}.csv")
    predict.main([f"checkpoint_dir={ckpt}", f"model_name={model_name}",
                  f"input={plot_dir}/*.npz", f"output={out_csv}",
                  f"batch_size={N_PLOTS}"])
    check_predictions(out_csv, f"{what}: serving the checkpoint")
    repro = train_reproducible(key, dtname, args, result, files, seed)
    out = {"phase": "train", "model": key, "dtype": dtname,
           "plots": N_PLOTS, "steps": TRAIN_STEPS, "losses": losses,
           "launches": launches, "launches_per_step": per_step,
           "train_main_seconds": main_seconds, **facts,
           "kernel_vs_plain_step": compared,
           "train_step_ms": step_s * 1e3, "plots_per_s": N_PLOTS / step_s,
           "train_step_ms_cudnn_deterministic": det_step_s * 1e3,
           "cudnn_deterministic_cost": det_step_s / step_s - 1.0,
           **routes, "peak_mem_gb": peak, "peak_reserved_gb": reserved,
           "served_trained_checkpoint": N_PLOTS, "numerics": pinned,
           **repro, "profile": profile, "card": smi}
    if key == "KPConv" and KP_SWEEP:
        out["kpconv_14_layers_device_ms"] = {
            k: KP_SWEEP[dtname][f"{k}_device_ms_sum"] for k in ("fwd", "bwd")}
    emit(out)
    return out


def kpconv_train_routes(runner, host_batch, batch, what: str) -> dict:
    """KPConv's train batch: its host pyramid (`host_pyramid_facts`), and
    the device route's step (the batch without aux, median of 5 steps
    after 2, as train_step_ms), PRs 3-11's route."""
    import dataclasses
    out = host_pyramid_facts(runner.net, host_batch, what)
    bare = dataclasses.replace(batch, aux=None)
    step_ms = wall_ms(lambda: runner.train(bare), 5, 2)
    return {**out, "device_route_train_step_ms": step_ms,
            "device_route_plots_per_s": N_PLOTS / step_ms * 1e3}


def train_reproducible(key: str, dtname: str, args: list, first: dict,
                       files: list, seed: int) -> dict:
    """train.main a second time with the first run's arguments (the same
    seed and plots) into another checkpoint; its six losses and its final
    parameters and BN stats against the first run's, bit for bit. Where
    they differ, one step from the initial state on the first batch, taken
    twice, names the parameters whose gradients differ (the one nearest the
    loss first: where the difference starts) and the largest difference;
    then the same two steps under torch.use_deterministic_algorithms(True,
    warn_only=True), with the ops it warns about, and under
    cudnn.deterministic alone."""
    import copy
    import warnings
    import torch
    from dpcr_agb_tpu_torch import train
    what = f"train {key} {dtname}"
    args2 = [a + "_again" if a.startswith("checkpoint_dir=") else a
             for a in args]
    second = train.main(args2)
    torch.cuda.synchronize()

    def state(result):
        return torch.load(result["checkpoint"], map_location="cpu",
                          weights_only=True)["weights"]["latest"]

    a, b = state(first), state(second)
    moved = [k for k in a if not torch.equal(a[k], b[k])]
    same = first["losses"] == second["losses"] and not moved
    out = {"train_reproducible": same}
    if same:
        return out
    out["second_run_losses"] = second["losses"]
    out["state_entries_that_differ"] = len(moved)
    run = train.setup(files, MODELS[key]["model_name"],
                      bf16=dtname == "bfloat16", batch_size=N_PLOTS,
                      seed=seed)
    batch = run.stream.next().to(run.runner.device)
    net0, stats = copy.deepcopy(run.runner.net), run.stats
    del run

    def grads():
        r = train.build_runner(copy.deepcopy(net0), stats, seed=seed)
        r.train(batch)
        g = {n: p.grad.detach().clone() for n, p in r.net.named_parameters()}
        torch.cuda.synchronize()
        return g

    def compare(g1, g2) -> dict:
        names = [n for n in g1 if not torch.equal(g1[n], g2[n])]
        if not names:
            return {"grads_equal": True}
        diff = {n: (g1[n] - g2[n]).abs().max().item() for n in names}
        return {"grads_equal": False, "params_differing": len(names),
                "of_params": len(g1),
                "nearest_the_loss": names[-1],
                "its_max_abs_diff": diff[names[-1]],
                "first_in_model_order": names[0],
                "max_abs_diff": max(diff.values()),
                "at": max(diff, key=diff.get)}

    out["one_step_twice"] = compare(grads(), grads())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            det = compare(grads(), grads())
        finally:
            torch.use_deterministic_algorithms(False)
    det["ops_without_a_deterministic_implementation"] = sorted({
        str(w.message).split(" does not have")[0] for w in caught
        if "deterministic" in str(w.message)})
    out["in_deterministic_mode"] = det
    pinned = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out["with_cudnn_deterministic"] = compare(grads(), grads())
    finally:
        torch.backends.cudnn.deterministic = pinned
    print(f"{what}: two same-seed runs differ: {out}", file=sys.stderr)
    return out


# map mode's device kernels by kind: the row gathers, the matmuls, and
# the gathers' backward (index_put with accumulation: a sort of the
# indices, then indexing_backward_kernel)
MAP_KINDS = (("scatter", r"indexing_backward|index_put|[Rr]adix[Ss]ort|"
              r"DeviceSegmentedSort|DeviceMergeSort"),
             ("gather", r"index_elementwise|gather|index_select|"
              r"indexSelect|index_kernel"),
             ("matmul", r"gemm|Gemm|nvjet|xmma|cutlass|cublas"))


def device_profile(fn, reps: int = 3, kinds=None) -> dict:
    """torch.profiler over `reps` calls: device time by kernel (top 12, and
    every kernel of the port), and the device's busy share of the wall
    time; with `kinds` ((name, regex), ...) also the device ms a call of
    each kind (a kernel counts under the first that matches its name, else
    under "other")."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # device-side rows only (kernels, copies): the operator rows carry the
    # same time again, and so do annotations such as
    # "Optimizer.step#AdaBelief.step", which show up among the device rows
    # under the name of a host row
    rows = prof.key_averages()
    host = {e.key for e in rows
            if e.device_type == torch.autograd.DeviceType.CPU}
    events = [e for e in rows
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0 and e.key not in host]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    def row(e):
        return {"name": e.key[:90],
                "ms_per_rep": e.self_device_time_total / reps / 1e3,
                "calls_per_rep": e.count / reps}

    # the port's own kernels (namespace dpcr), whatever their rank
    own = [row(e) for e in events if "dpcr::" in e.key]
    out = {"reps": reps, "wall_ms_per_rep": wall_us / reps / 1e3,
           "device_busy_ms_per_rep": busy_us / reps / 1e3,
           "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
           "top": [row(e) for e in top], "port_kernels": own,
           "port_kernels_ms_per_rep": sum(r["ms_per_rep"] for r in own)}
    if kinds is not None:
        split = {name: 0.0 for name, _ in kinds}
        split["other"] = 0.0
        for e in events:
            kind = next((n for n, rx in kinds if re.search(rx, e.key)),
                        "other")
            split[kind] += e.self_device_time_total / reps / 1e3
        out["ms_by_kind"] = split
        out["share_by_kind"] = {k: v / max(out["device_busy_ms_per_rep"],
                                           1e-12)
                                for k, v in split.items()}
    return out


def run_model(key: str, tmp: str, plot_dir: str, smi: str, seed: int,
              with_profile: bool, have: list) -> list:
    """The kernels, serve and train phases of one path, with its mode
    variables set; returns its new kernel rows, and writes the launches it
    read into them and into the rows of `have` that it shares."""
    import torch
    from dpcr_agb_tpu_torch import predict, train
    spec = MODELS[key]
    model_name = spec["model_name"]
    ckpts = {k: make_checkpoint(tmp, f"ckpt_{key}_{k}", model_name, o, seed)
             for k, o in model_options(model_name).items()}
    bundles = {k: predict.load_serving_bundle(c, model_name)
               for k, c in ckpts.items()}
    files = sorted(glob.glob(os.path.join(plot_dir, "*.npz")))
    samples, _ = predict.load_samples(bundles["float32"], files)
    (batch, _), = predict.make_batches(bundles["float32"], samples, N_PLOTS)
    emit({"phase": "data", "model": key, "plots": N_PLOTS,
          "raw_points_per_plot": [int(np.load(f)["pos"].shape[0])
                                  for f in files],
          "rows_per_plot": [int(s["pos"].shape[0]) for s in samples],
          **batch_facts(bundles["float32"].net, batch)})
    # rows that an earlier path of the same kind measured at these shapes
    # (of the fps rows, PointNet's forward shares the input's sampling)
    shared = [r for r in have if r["kernels_phase"] == spec["kernels"]
              and (r.get("case") or "").startswith(spec.get("shares", ""))]
    if spec["kernels"] == "kpconv":
        krows = phase_kpconv_kernels(bundles["float32"], batch, smi, seed)
    elif spec["kernels"] == "fps" and not shared:
        krows = phase_fps_kernels(key, bundles["float32"], batch, smi)
    elif spec["kernels"] is None or shared:
        krows = []  # no kernel, or its kernels timed at these shapes already
    else:
        # the first batch that train.main draws from these plots
        train_batch = train.setup(files, model_name, batch_size=N_PLOTS,
                                  seed=seed).stream.next()
        emit({"phase": "data", "model": key, "train_batch": True,
              **batch_facts(bundles["float32"].net, train_batch)})
        phase = dense_l0_kernel_rows if spec["kernels"] == "dense_l0" \
            else phase_kernels
        krows = phase(bundles, batch, train_batch, smi, seed)
    for r in krows:
        r["kernels_phase"] = spec["kernels"]
    del bundles
    torch.cuda.empty_cache()

    def record(result: dict, counted_in: str) -> None:
        """The launches that `result`'s run read, into the rows measured
        at that run's shapes (forward kernels: the serving batch's, unless
        the row says it was taken at the train batch's)."""
        for r in krows + shared:
            default = "serve" if r["name"] in spec["forward"] else "train"
            if r["dtype"] != result["dtype"] \
                    or r.get("counted_in", default) != counted_in:
                continue
            n = result["launches"][r["name"]]
            r.setdefault("launches_by_path", {})[key] = n
            if r["launches"] is None:
                r["launches"] = n

    for dtname, ckpt in ckpts.items():
        record(phase_serve(key, dtname, ckpt, plot_dir, tmp, smi,
                           with_profile), "serve")
        torch.cuda.empty_cache()
    if spec.get("jax_ckpt"):
        phase_serve_jax_ckpt(key, ckpts["float32"], plot_dir, tmp, smi)
        torch.cuda.empty_cache()
    for dtname in ckpts:
        record(phase_train(key, dtname, plot_dir, tmp, smi, seed,
                           with_profile), "train")
        torch.cuda.empty_cache()
    return krows

# The trainer phases: the README's training command through the port's
# own entry points (SENet14, sparse level 0) and its KPConv counterpart
# (KPConv with no neighborhood_limits: calibrated at start-up, the host
# pyramid built in the loader's threads), both under enable_mixed (bf16
# compute), on a synthetic NFI-layout dataset the port generates and
# processes
TRAINER_PLOTS = 96
TRAINER_EPOCHS = 2
TRAINER_BS = 16
TRAINER_TARGETS = ("BMag_ha", "V_ha")
# eval.main's predictions against the train run's, when cuDNN picks
# another algorithm: the serve tolerance of bf16 (KPConv's path has no
# cuDNN call: its eval must give the same bits)
TRAINER_SERVE_TOL = 5e-2
# per phase (`--only` name): the model, its config groups, the launches
# of each kernel in one forward and in one train step (every other kernel
# 0), the kernels phase whose bf16 rows get the launches (of those, the
# ones `rows` picks), whether eval.main must repeat the train run's test
# predictions bit for bit, the compute dtype enable_mixed gives (the
# PointNeXt models have no bf16 form) and the plots generated
TRAINERS = {
    "trainer": {
        "phase": "trainer", "model_name": "SENet14",
        "groups": ["models=instance/minkowski_baseline",
                   "data.transform_type=sparse_xy", "training=nfi/minkowski"],
        "forward": {"stem_sites": 1, "max_pool_k3s2_rows": 1},
        "step": {"stem_sites_dw": 1, "max_pool_k3s2_bwd": 1},
        "kernels_phase": "sparse_l0", "eval_bit_equal": False},
    "trainer-kpconv": {
        "phase": "trainer_kpconv", "model_name": "KPConv",
        "groups": ["models=instance/kpconv", "data.transform_type=xy",
                   "training=nfi/kpconv"],
        "forward": {"kpconv_fused": 14},
        "step": {"kpconv_fused_bwd": 14, "gather_rows_bwd": 4},
        "kernels_phase": "kpconv", "eval_bit_equal": True},
    "trainer-pointnext": {
        "phase": "trainer_pointnext", "model_name": "PointNext",
        "groups": ["models=instance/pointnext",
                   "data.transform_type=fixed_xy", "training=nfi/pointnet"],
        "forward": {"fps": 5}, "step": {}, "kernels_phase": "fps",
        "rows": lambda r: r.get("model") == "PointNeXt",
        "eval_bit_equal": True, "dtype": "float32", "plots": 48},
    "trainer-pointnet": {
        "phase": "trainer_pointnet", "model_name": "PointNet",
        "groups": ["models=instance/pointnet",
                   "data.transform_type=fixed_xy", "training=nfi/pointnet"],
        "forward": {"fps": 1}, "step": {}, "kernels_phase": "fps",
        "rows": lambda r: r["case"].startswith("input:"),
        "eval_bit_equal": True, "dtype": "float32", "plots": 48},
    # SENet14's command in map mode: no kernel; the host maps built in the
    # loader's threads
    "trainer-map": {
        "phase": "trainer_map", "model_name": "SENet14",
        "groups": ["models=instance/minkowski_baseline",
                   "data.transform_type=sparse_xy", "training=nfi/minkowski",
                   "models.SENet14.extra_options.dense_dims=null"],
        "forward": {}, "step": {}, "kernels_phase": None,
        "eval_bit_equal": False, "plots": 24},
}


def trainer_overrides(root: str, key: str = "trainer") -> list:
    spec = TRAINERS[key]
    return ["task=instance", f"model_name={spec['model_name']}",
            "data=instance/synthetic/reg", *spec["groups"],
            "lr_scheduler=cosineawr", "update_lr_scheduler_on=on_num_batch",
            f"data.dataroot={root}/data",
            f"data.synthetic_plots={spec.get('plots', TRAINER_PLOTS)}",
            f"training.epochs={TRAINER_EPOCHS}",
            f"training.batch_size={TRAINER_BS}", "training.num_workers=4",
            "visualization=eval", f"run_dir={root}/run"]


def expected_splits(label_file: str) -> dict:
    """The seed-42 rule on the generated labels, computed here: the rows
    with every target present shuffled by RandomState(42), the first 80%
    train, the next 10% val, the rest test (rows missing every target go
    to train)."""
    from dpcr_agb_tpu_torch.visualization.gpkg import read_gpkg
    labels = read_gpkg(label_file)
    y = np.stack([labels[t] for t in TRAINER_TARGETS], 1)
    full = np.flatnonzero(~np.isnan(y).all(1))
    index = full.copy()
    np.random.RandomState(42).shuffle(index)
    n = len(index)
    train_end, val_end = int(n * 0.8), int(n * 0.9)
    return {"train": len(labels) - n + train_end,
            "val": val_end - train_end, "test": n - val_end}


class StepCounter:
    """Counts the runner's train steps and forwards (train, evaluate,
    calibrate) while installed, and each call's kernel launches."""

    def __init__(self):
        from dpcr_agb_tpu_torch.training.step import StepRunner
        self.cls = StepRunner
        self.calls = {"train": 0, "evaluate": 0, "calibrate": 0}
        self.saved = {k: getattr(StepRunner, k) for k in self.calls}

    def __enter__(self):
        for name, fn in self.saved.items():
            def counted(runner, *a, _name=name, _fn=fn, **k):
                self.calls[_name] += 1
                return _fn(runner, *a, **k)
            setattr(self.cls, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)

    @property
    def forwards(self) -> int:
        return sum(self.calls.values())


def check_trainer_launches(what: str, launches: dict, counter,
                           spec: dict) -> dict:
    """The phase's forward kernels their count a forward, its backward
    kernels their count a train step, and nothing else."""
    want = {k: n * counter.forwards for k, n in spec["forward"].items()}
    want.update({k: n * counter.calls["train"]
                 for k, n in spec["step"].items()})
    want.update({k: 0 for k in launches if k not in want})
    bad = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if bad or counter.forwards == 0:
        raise AssertionError(f"{what}: launches (got, counted) {bad}; "
                             f"calls {counter.calls}")
    return want


class PostCollateClock:
    """While installed, times every post_collate call of the trainers'
    loaders (in their threads, on the host clock)."""

    def __init__(self):
        import threading
        from dpcr_agb_tpu_torch.training import trainer
        self.module, self.saved = trainer, trainer.make_post_collate
        self.ms, self.lock = [], threading.Lock()

    def __enter__(self):
        def timed_factory(net):
            post = self.saved(net)
            if post is None:
                return None

            def timed(batch):
                t = time.perf_counter()
                out = post(batch)
                with self.lock:
                    self.ms.append((time.perf_counter() - t) * 1e3)
                return out
            return timed
        self.module.make_post_collate = timed_factory
        return self

    def __exit__(self, *exc):
        self.module.make_post_collate = self.saved


def read_pred_csv(path: str, epoch: int = None) -> tuple:
    """(header, rows) of a `<area>_<stage>_preds.csv`, the rows of one
    epoch when it is given."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    if epoch is not None:
        body = [r for r in body if r[header.index("epoch")] == str(epoch)]
    return header, body


def csv_metrics(path: str, stage: str, area: str) -> dict:
    """RMSE, MAE and R² of each target recomputed from a prediction csv:
    errors of pred against y (the sample's target), R² against the mean of
    the label table's values of that stage (the tracker's fixed mean)."""
    header, rows = read_pred_csv(path)
    col = {name: np.array([float(r[header.index(name)]) for r in rows])
           for name in header if name.startswith(("pred_", "y_", "label_"))
           and name.split("_", 1)[1] in TRAINER_TARGETS}
    out = {}
    for t in TRAINER_TARGETS:
        err = col[f"pred_{t}"] - col[f"y_{t}"]
        mean = float(np.mean(col[f"label_{t}"]))
        tot = float(np.sum((col[f"y_{t}"] - mean) ** 2))
        for who in (area, "total"):
            key = f"{stage}_{who}_{t}"
            out[f"{key}_rmse"] = float(np.sqrt(np.sum(err ** 2) / len(err)))
            out[f"{key}_mae"] = float(np.sum(np.abs(err)) / len(err))
            out[f"{key}_r2"] = 1.0 - float(np.sum(err ** 2)) / tot
    return out


def calibration_check(trainer, what: str) -> dict:
    """KPConv's start-up calibration: the trainer's limits against a call
    of the port's run_find_neighbour_dist on its dataset (16 plots, the
    entry's calibrate_percentile), and in the checkpoint's run_config."""
    from dpcr_agb_tpu_torch.utils.neighbor_calibration import \
        run_find_neighbour_dist
    option = dict(trainer.option)
    limits = option["extra_options"]["neighborhood_limits"]
    option["extra_options"] = {k: v for k, v in option["extra_options"]
                               .items() if k != "neighborhood_limits"}
    want = run_find_neighbour_dist(
        trainer.dataset, option, n_samples=16,
        percentile=float(option.get("calibrate_percentile", 90.0)))
    stored = trainer.checkpoint.checkpoint.run_config["models"][
        trainer.model_name]["extra_options"].get("neighborhood_limits")
    if limits != want or stored != limits or \
            trainer.net.neighborhood_limits != limits:
        raise AssertionError(f"{what}: calibrated {limits}, the script's "
                             f"call {want}, run_config {stored}, net "
                             f"{trainer.net.neighborhood_limits}")
    return {"neighborhood_limits": limits,
            "calibrate_percentile": option.get("calibrate_percentile")}


def phase_trainer(tmp: str, smi: str, krows: list,
                  key: str = "trainer") -> None:
    """train.main with the phase's command on a synthetic NFI dataset,
    then eval.main and calibrate_bn.main on its checkpoint (see the
    module docstring)."""
    import torch
    from dpcr_agb_tpu_torch import calibrate_bn, eval as ev, kernels, train
    from dpcr_agb_tpu_torch.data.synthetic import generate_nfi_like_dataset
    from dpcr_agb_tpu_torch.training.state import Checkpoint
    spec = TRAINERS[key]
    model_name = spec["model_name"]
    root = os.path.join(tmp, key)
    what = spec["phase"]
    t0 = time.perf_counter()
    n_plots = spec.get("plots", TRAINER_PLOTS)
    label_file = generate_nfi_like_dataset(
        os.path.join(root, "data", "synthetic"), n_plots=n_plots)
    generate_seconds = time.perf_counter() - t0
    want_splits = expected_splits(label_file)

    kernels.reset_launches()
    with StepCounter() as counter, PostCollateClock() as clock:
        t0 = time.perf_counter()
        trainer, pinned = from_default_numerics(
            lambda: train.main(trainer_overrides(root, key)), what)
        torch.cuda.synchronize()
        train_seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    counted = check_trainer_launches(f"{what}: train.main", launches,
                                     counter, spec)
    splits = {s: len(d) if d is not None else 0
              for s, d in trainer.dataset.datasets.items()}
    if splits != want_splits:
        raise AssertionError(f"{what}: splits {splits}, the seed-42 rule "
                             f"gives {want_splits}")
    dtname = spec.get("dtype", "bfloat16")
    if bool((trainer.option.get("extra_options") or {}).get("bf16")) != \
            (dtname == "bfloat16"):
        raise AssertionError(f"{what}: enable_mixed did not give "
                             f"{model_name} its {dtname} compute")
    calibrated = calibration_check(trainer, what) \
        if model_name == "KPConv" else {}
    epochs = []
    for h in trainer.history:
        if h["stage"] != "train":
            continue
        losses = h["tracked_losses"]
        if h["batches"] != want_splits["train"] // TRAINER_BS \
                or not losses or not np.isfinite(losses).all():
            raise AssertionError(f"{what}: epoch {h}")
        epochs.append({k: h[k] for k in (
            "epoch", "batches", "tracked_losses", "seconds", "data_seconds",
            "first_batch_data_seconds", "step_seconds", "plots_per_s")})
    if len(epochs) != TRAINER_EPOCHS:
        raise AssertionError(f"{what}: {len(epochs)} train epochs")
    run_dir = os.path.join(root, "run")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    stage_metrics = {}
    for epoch in range(1, TRAINER_EPOCHS + 1):
        for stage in ("val", "test"):
            rec = [r for r in records
                   if r["epoch"] == epoch and r["stage"] == stage]
            keys = [f"{stage}_loss"] + [
                f"{stage}_total_{t}_{m}" for t in TRAINER_TARGETS
                for m in ("rmse", "mae", "r2")]
            if len(rec) != 1 or not all(
                    np.isfinite(rec[0].get(k, np.nan)) for k in keys):
                raise AssertionError(f"{what}: {stage} metrics of epoch "
                                     f"{epoch}: {rec}")
            stage_metrics[f"{stage}_{epoch}"] = {k: rec[0][k] for k in keys}
    ckpt_path = os.path.join(run_dir, f"{model_name}.ckpt")
    with open(ckpt_path, "rb") as f:
        ckpt = Checkpoint.from_bytes(f.read())
    best = sorted(k for k in ckpt.models if k.startswith("best_val_"))
    if "latest" not in ckpt.models or not best or \
            any(k.startswith(("best_test", "best_train"))
                for k in ckpt.models) or \
            [len(ckpt.stats[s]) for s in ("train", "val", "test")] != \
            [TRAINER_EPOCHS] * 3:
        raise AssertionError(f"{what}: checkpoint models "
                             f"{sorted(ckpt.models)}, stats "
                             f"{ {s: len(v) for s, v in ckpt.stats.items()} }")
    if calibrated and ckpt.run_config["models"][model_name][
            "extra_options"].get("neighborhood_limits") != \
            calibrated["neighborhood_limits"]:
        raise AssertionError(f"{what}: the .ckpt's run_config lacks the "
                             f"calibrated limits {calibrated}")
    # into the kernels rows of the phase's compute dtype (bf16), or of any
    # dtype for a kernel that runs in f32 only (gather_rows_bwd)
    rows = [r for r in krows if r["kernels_phase"] == spec["kernels_phase"]
            and r["name"] in counted and spec.get("rows", bool)(r)]
    bf16 = {r["name"] for r in rows if r["dtype"] == "bfloat16"}
    for r in rows:
        if r["dtype"] == "bfloat16" or r["name"] not in bf16:
            r.setdefault("launches_by_path", {})[what] = \
                launches[r["name"]]
    process_seconds = trainer.dataset_seconds
    del trainer
    torch.cuda.empty_cache()

    # eval.main twice on the checkpoint alone (its own run_config)
    evals = []
    for i in (1, 2):
        kernels.reset_launches()
        with StepCounter() as ecount:
            t0 = time.perf_counter()
            results = ev.main([f"checkpoint_dir={run_dir}",
                               f"model_name={model_name}",
                               "weight_name=latest",
                               f"batch_size={TRAINER_BS}",
                               f"run_dir={root}/eval{i}",
                               "pretty_print=False"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        check_trainer_launches(f"{what}: eval.main {i}",
                               dict(kernels.LAUNCHES), ecount, spec)
        evals.append((results, seconds))
    train_csv = os.path.join(run_dir, "SYNTH_test_preds.csv")
    header, want_rows = read_pred_csv(train_csv, TRAINER_EPOCHS)
    eval_csv = os.path.join(root, "eval1", "SYNTH_test_preds.csv")
    got_header, got_rows = read_pred_csv(eval_csv)
    pred_cols = [i for i, h in enumerate(header) if h.startswith("pred_")]
    if got_header != header or len(got_rows) != len(want_rows) \
            or len(got_rows) != want_splits["test"] or any(
                [v for i, v in enumerate(g) if i not in pred_cols]
                != [v for i, v in enumerate(w) if i not in pred_cols]
                for g, w in zip(got_rows, want_rows)):
        raise AssertionError(f"{what}: eval's test csv rows differ from the "
                             "train run's beyond the predictions")
    got_p = np.array([[float(g[i]) for i in pred_cols] for g in got_rows])
    want_p = np.array([[float(w[i]) for i in pred_cols] for w in want_rows])
    bit_equal = bool(np.array_equal(got_p, want_p))
    max_diff = float(np.abs(got_p - want_p).max())
    bound = 0.0 if spec["eval_bit_equal"] else \
        TRAINER_SERVE_TOL * float(np.abs(want_p).max())
    if not bit_equal and max_diff > bound:
        raise AssertionError(f"{what}: eval predictions differ by {max_diff}"
                             f" (> {bound}) from the train run's")
    recomputed = csv_metrics(eval_csv, "test", "SYNTH")
    test_metrics = evals[0][0]["test"]
    worst = max(abs(test_metrics[k] - v) / max(abs(v), 1e-30)
                for k, v in recomputed.items())
    if worst > 1e-6:
        raise AssertionError(f"{what}: eval's test metrics differ from its "
                             f"csv's by {worst} (relative)")
    second = read_pred_csv(os.path.join(root, "eval2",
                                        "SYNTH_test_preds.csv"))[1]
    if second != got_rows:
        raise AssertionError(f"{what}: a second eval.main gave other bits")

    # calibrate_bn.main for one epoch
    kernels.reset_launches()
    with StepCounter() as ccount:
        t0 = time.perf_counter()
        calibrate_bn.main([f"checkpoint_dir={run_dir}",
                           f"model_name={model_name}",
                           f"run_dir={root}/calibrate", "epochs=1",
                           f"batch_size={TRAINER_BS}", "pretty_print=False"])
        torch.cuda.synchronize()
        cal_seconds = time.perf_counter() - t0
    check_trainer_launches(f"{what}: calibrate_bn.main",
                           dict(kernels.LAUNCHES), ccount, spec)
    if ccount.calls["calibrate"] == 0 or ccount.calls["train"]:
        raise AssertionError(f"{what}: calibrate_bn calls {ccount.calls}")
    with open(os.path.join(root, "calibrate", f"{model_name}.ckpt"),
              "rb") as f:
        cal = Checkpoint.from_bytes(f.read()).models["latest"]
    src = ckpt.models["latest"]

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from flat(tree[k], f"{prefix}/{k}")
        else:
            yield prefix, np.asarray(tree)

    same_w = all(np.array_equal(a, b) and a.dtype == b.dtype
                 for (_, a), (_, b) in zip(flat(cal["params"]),
                                           flat(src["params"])))
    moved = sum(not np.array_equal(a, b) for (_, a), (_, b) in zip(
        flat(cal["batch_stats"]), flat(src["batch_stats"])))
    if not same_w or not moved:
        raise AssertionError(f"{what}: calibrate_bn changed the weights "
                             f"({not same_w}) or no BN stat ({moved})")
    out = {"phase": what, "model": model_name, "dtype": dtname,
           "plots": n_plots, "batch_size": TRAINER_BS,
           "splits": splits, "generate_seconds": generate_seconds,
           "process_seconds": process_seconds,
           "train_main_seconds": train_seconds, "numerics": pinned,
           **calibrated, "epochs": epochs, "metrics": stage_metrics,
           "launches": {k: launches[k] for k in counted if counted[k]},
           "counted": {"forwards": counter.forwards,
                       "steps": counter.calls["train"]},
           "checkpoint_models": sorted(ckpt.models),
           "eval_main_seconds": [s for _, s in evals],
           "eval_bit_equal": bit_equal, "eval_max_abs_diff": max_diff,
           "eval_tolerance": None if bit_equal else bound,
           "eval_metrics_vs_csv_rel": worst,
           "eval_repeat_bit_equal": True,
           "calibrate_main_seconds": cal_seconds,
           "calibrate_forwards": ccount.calls["calibrate"],
           "bn_stats_moved": int(moved), "card": smi}
    if model_name == "KPConv" or key == "trainer-map":
        # the train run's batches (train, val and test stages), each
        # timed in its loader thread
        out["host_pyramid_ms_per_batch"] = clock.ms
        out["host_pyramid_ms_median"] = statistics.median(clock.ms)
    emit(out)


# Map mode (`dense_dims=null`, SENet14-map and SENet50-map): the host
# builds each batch's levels and kernel maps (343 binary searches a voxel
# for the stem alone), serially in `predict.make_batches` and in the
# `input=` form of train.main, so its phases keep the builds few
MAP_TRAIN_STEPS = 2
# map mode against the dense path on one batch that fits both: the JAX
# package's own check (tests/test_host_pyramid.py), 2e-3, taken relative
# to the outputs' size (rtol, and atol 2e-3 * max|dense|): the JAX check's
# freshly initialised net outputs ~1e-9, where an absolute 2e-3 holds
# anything
MAP_VS_DENSE_TOL = 2e-3


def reset_routes() -> None:
    from dpcr_agb_tpu_torch.ops import host_pyramid
    for k in host_pyramid.ROUTE_CALLS:
        host_pyramid.ROUTE_CALLS[k] = 0


def check_native_route(what: str, samples: int) -> dict:
    """Every map-mode pyramid since reset_routes() was built on the native
    route, one a sample."""
    from dpcr_agb_tpu_torch.ops import host_pyramid
    got = dict(host_pyramid.ROUTE_CALLS)
    if got != {"native": samples, "numpy": 0}:
        raise AssertionError(f"{what}: host pyramid routes {got}, expected "
                             f"{samples} native builds and no numpy one")
    return got


def map_batch_facts(net, host_batch) -> dict:
    """A map-mode host batch: its padded voxel count, each level's cap and
    voxels (the batch's sum and a sample's largest), the aux's bytes."""
    aux = host_batch.aux
    plan = net.pyramid_plan(int(host_batch.coords.shape[1]))
    masks = [np.asarray(aux[f"mask{l}"]) for l in range(plan["n_levels"])]
    return {"v_bucket": int(host_batch.coords.shape[1]),
            "occupied_voxels": int(np.asarray(host_batch.mask).sum()),
            "level_caps": list(plan["caps"]),
            "level_voxels": [int(m.sum()) for m in masks],
            "level_max_per_sample": [int(m.sum(1).max()) for m in masks],
            "aux_mb": sum(np.asarray(a).nbytes for a in aux.values()) / 1e6,
            "stem_map_shape": list(np.asarray(aux["stem_map"]).shape)}


def map_vs_dense(bundle, collated, host_batch, what: str) -> dict:
    """The map-mode net and the dense path (the default dense_dims, sparse
    level 0) with the same weights on the same plots: both raw outputs
    within MAP_VS_DENSE_TOL, on a batch that fits the volume (the dense
    post_collate keeps every row) and the caps (no level full).

    The two are one function only where every BN maps 0 to 0: the dense
    path normalizes its empty cells too, and its next conv reads them,
    where map mode reads the zero shadow. So both nets take the
    checkpoint's weights with each BN's running mean and offset set to 0
    (its scale kept), as they are at initialisation, where the JAX package
    makes its check. At the initial running variance (1) the outputs
    shrink to ~1e-7 through the net and any tolerance passes; so each
    BN's running variance is set to its input's second moment over the
    map-mode forward's rows on this batch (in one forward, layer by
    layer), which keeps 0 at 0 and the outputs O(1)."""
    import copy
    import torch
    from dpcr_agb_tpu_torch.models.factory import (build_model,
                                                    make_post_collate)
    from dpcr_agb_tpu_torch.nn.norm import MaskedBatchNorm
    mapped = copy.deepcopy(bundle.net)
    norms = [m for m in mapped.modules() if isinstance(m, MaskedBatchNorm)]

    def second_moment(m, args):
        x, mask = args
        m.var.copy_(x.float()[mask].pow(2).mean(0))

    device_batch = host_batch.to(bundle.device)
    with torch.no_grad():
        for m in norms:
            m.mean.zero_()
            if m.bias is not None:
                m.bias.zero_()
        uncalibrated = mapped(device_batch).float()
        hooks = [m.register_forward_pre_hook(second_moment) for m in norms]
        try:
            mapped(device_batch)
        finally:
            for h in hooks:
                h.remove()
        raw = mapped(device_batch).float()
    option = dict(bundle.option)
    option["extra_options"] = {k: v for k, v in option["extra_options"]
                               .items() if k != "dense_dims"}
    net, _ = build_model(option, raw.shape[1], mapped.stem_conv.kernel
                         .shape[1])
    net.load_state_dict(mapped.state_dict())
    net.to(bundle.device).eval()
    dense_batch = make_post_collate(net)(collated)
    kept = int(np.asarray(dense_batch.mask).sum())
    facts = map_batch_facts(bundle.net, host_batch)
    full = [l for l, (n, c) in enumerate(zip(facts["level_max_per_sample"],
                                              facts["level_caps"]))
            if n >= c]
    if kept != facts["occupied_voxels"] or full:
        raise AssertionError(f"{what}: the batch does not fit both paths "
                             f"(dense keeps {kept} of "
                             f"{facts['occupied_voxels']} voxels; levels at "
                             f"their cap {full})")
    with torch.no_grad():
        dense = net(dense_batch.to(bundle.device)).float()
    err = _check_close(f"{what}: map mode against the dense path", raw,
                       dense, MAP_VS_DENSE_TOL,
                       MAP_VS_DENSE_TOL * _amax(dense))
    del net, mapped
    return {"map_vs_dense_max_abs_err": err,
            "map_vs_dense_max_abs_dense": _amax(dense),
            "map_vs_dense_max_abs_at_unit_variance": _amax(uncalibrated),
            "map_vs_dense_tolerance": f"rtol {MAP_VS_DENSE_TOL}, atol "
                                      f"{MAP_VS_DENSE_TOL} * max|dense|; "
                                      "BN running means and offsets 0, "
                                      "running variances the inputs' "
                                      "second moments"}


def phase_map_serve(key: str, dtname: str, ckpt: str, plot_dir: str,
                    out_dir: str, collated, host_batch, host_ms: float,
                    smi: str) -> dict:
    """predict.main in map mode (no kernel launch, the native host route
    for each plot, 16 finite rows), then on the serving batch whose maps
    the host built once (`host_ms`): forward_ms (host batch to output),
    the copy to the card (`Batch.to`, pageable, and `device_put` from
    pinned memory), the device-resident forward, map against dense (f32),
    a torch.profiler split by kernel kind, peak memory."""
    import torch
    from dpcr_agb_tpu_torch import kernels, predict
    from dpcr_agb_tpu_torch.data.batch import device_put, wait_ready
    model_name = MODELS[key]["model_name"]
    what = f"map serve {key} {dtname}"
    out_csv = os.path.join(out_dir, f"preds_{key}_{dtname}.csv")
    kernels.reset_launches()
    reset_routes()
    t0 = time.perf_counter()
    _, pinned = from_default_numerics(lambda: predict.main([
        f"checkpoint_dir={ckpt}", f"model_name={model_name}",
        f"input={plot_dir}/*.npz", f"output={out_csv}",
        f"batch_size={N_PLOTS}"]), what)
    torch.cuda.synchronize()
    main_seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check_launches(what, key, launches, "forward")
    routes = check_native_route(what, N_PLOTS)
    check_predictions(out_csv, what)

    bundle = predict.load_serving_bundle(ckpt, model_name)
    net, dev = bundle.net, bundle.device
    if net.dense_dims is not None:
        raise AssertionError(f"{what}: the checkpoint built a dense net")
    kernels.reset_launches()
    raw = predict.forward_raw(bundle, host_batch).float()
    if not bool(torch.isfinite(raw).all()):
        raise AssertionError(f"{what}: non-finite raw output")
    fwd_ms = wall_ms(lambda: predict.forward_raw(bundle, host_batch), 3, 1)
    h2d_ms = wall_ms(lambda: host_batch.to(dev), 3, 1)
    stream = torch.cuda.Stream()
    pinned_ms = wall_ms(lambda: wait_ready(device_put(host_batch, dev,
                                                      stream)), 3, 1)
    tb = host_batch.to(dev)

    def forward():
        with torch.no_grad():
            return net(tb)
    device_fwd_ms = wall_ms(forward, 3, 1)
    extra = map_vs_dense(bundle, collated, host_batch, what) \
        if dtname == "float32" else {}
    kernels.reset_launches()
    profile = device_profile(forward, reps=3, kinds=MAP_KINDS)
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"{what}: kernels launched {kernels.LAUNCHES}")
    torch.cuda.reset_peak_memory_stats()
    forward()
    torch.cuda.synchronize()
    out = {"phase": "map_serve", "model": key, "dtype": dtname,
           "plots": N_PLOTS, **map_batch_facts(net, host_batch),
           "launches": launches, "host_routes": routes,
           "predict_main_seconds": main_seconds,
           "host_map_ms": host_ms, "h2d_ms": h2d_ms,
           "h2d_pinned_ms": pinned_ms, "forward_ms": fwd_ms,
           "plots_per_s": N_PLOTS / fwd_ms * 1e3,
           "device_resident_forward_ms": device_fwd_ms, **extra,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "numerics": pinned, "profile": profile, "card": smi}
    emit(out)
    del bundle, net, tb
    return out


def phase_map_train(key: str, dtname: str, plot_dir: str, out_dir: str,
                    smi: str, seed: int) -> dict:
    """train.main's `input=` form in map mode for MAP_TRAIN_STEPS steps
    (finite losses, no kernel launch in any step, the native host route
    for every sample drawn), then on its first batch (kept from that run):
    the host map build (the stream's post_collate, host clock), the copy
    to the card, the step of a freshly built model on the device-resident
    batch, peak memory and a torch.profiler split of the step by kernel
    kind."""
    import torch
    from dpcr_agb_tpu_torch import kernels, train
    from dpcr_agb_tpu_torch.training.step import StepRunner
    model_name = MODELS[key]["model_name"]
    bf16 = dtname == "bfloat16"
    what = f"map train {key} {dtname}"
    ckpt = os.path.join(out_dir, f"trained_{key}_{dtname}")
    args = [f"input={plot_dir}/*.npz", f"checkpoint_dir={ckpt}",
            f"model_name={model_name}", f"steps={MAP_TRAIN_STEPS}",
            f"batch_size={N_PLOTS}", f"seed={seed}",
            f"bf16={str(bf16).lower()}", "dense_dims=null"]
    per_step, unwrapped = [], StepRunner.train
    factory, built, clock = train.make_post_collate, [], []

    def counted(self, batch):
        before = dict(kernels.LAUNCHES)
        out = unwrapped(self, batch)
        per_step.append({k: n - before[k]
                         for k, n in kernels.LAUNCHES.items()})
        return out

    def timed_factory(net):
        post = factory(net)

        def timed(batch):
            t = time.perf_counter()
            out = post(batch)
            clock.append((time.perf_counter() - t) * 1e3)
            built.append(out)
            return out
        return timed

    kernels.reset_launches()
    reset_routes()
    StepRunner.train, train.make_post_collate = counted, timed_factory
    try:
        t0 = time.perf_counter()
        result, pinned = from_default_numerics(lambda: train.main(args), what)
        torch.cuda.synchronize()
        main_seconds = time.perf_counter() - t0
    finally:
        StepRunner.train, train.make_post_collate = unwrapped, factory
    losses = result["losses"]
    if len(losses) != MAP_TRAIN_STEPS or not np.isfinite(losses).all() \
            or len(per_step) != MAP_TRAIN_STEPS:
        raise AssertionError(f"{what}: losses {losses}, {len(per_step)} "
                             "steps counted")
    for i, step in enumerate(per_step):
        check_launches(f"{what} step {i}", key, step, "step")
    routes = check_native_route(what, MAP_TRAIN_STEPS * N_PLOTS)

    files = sorted(glob.glob(os.path.join(plot_dir, "*.npz")))
    runner = train.setup(files, model_name, bf16=bf16, dense_dims="null",
                         batch_size=N_PLOTS, seed=seed).runner
    host_batch = built[0]
    del built[1:]
    h2d_ms = wall_ms(lambda: host_batch.to(runner.device), 3, 1)
    batch = host_batch.to(runner.device)
    kernels.reset_launches()
    step_ms = wall_ms(lambda: runner.train(batch), 3, 1)
    torch.cuda.reset_peak_memory_stats()
    runner.train(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    reserved = torch.cuda.max_memory_reserved() / 1e9
    profile = device_profile(lambda: runner.train(batch), reps=1,
                             kinds=MAP_KINDS)
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"{what}: kernels launched {kernels.LAUNCHES}")
    out = {"phase": "map_train", "model": key, "dtype": dtname,
           "plots": N_PLOTS, "steps": MAP_TRAIN_STEPS, "losses": losses,
           "launches_per_step": per_step, "host_routes": routes,
           "train_main_seconds": main_seconds,
           **map_batch_facts(runner.net, host_batch),
           "host_map_ms": clock[0], "host_map_ms_per_step": clock,
           "h2d_ms": h2d_ms,
           "train_step_ms": step_ms, "plots_per_s": N_PLOTS / step_ms * 1e3,
           "peak_mem_gb": peak, "peak_reserved_gb": reserved,
           "numerics": pinned, "profile": profile, "card": smi}
    emit(out)
    del runner, batch, host_batch
    return out


def run_map_model(key: str, tmp: str, plot_dir: str, smi: str,
                  seed: int) -> None:
    """A map-mode path: the serving batch collated and its maps built on
    the host once (timed; the native route), then serve and train in each
    of the path's dtypes."""
    import torch
    from dpcr_agb_tpu_torch import predict, train
    from dpcr_agb_tpu_torch.data.batch import collate
    spec = MODELS[key]
    model_name = spec["model_name"]
    ckpts = {dt: make_checkpoint(tmp, f"ckpt_{key}_{dt}", model_name,
                                 train.model_option(
                                     model_name, bf16=dt == "bfloat16",
                                     dense_dims="null"), seed)
             for dt in spec["map_mode"]}
    bundle = predict.load_serving_bundle(ckpts["float32"], model_name)
    files = sorted(glob.glob(os.path.join(plot_dir, "*.npz")))
    samples, _ = predict.load_samples(bundle, files)
    collated = collate(samples, bundle.collate_spec, pad_to_batch=N_PLOTS)
    reset_routes()
    t0 = time.perf_counter()
    host_batch = bundle.post_collate(collated)
    host_ms = (time.perf_counter() - t0) * 1e3
    check_native_route(f"{key}: the serving batch", N_PLOTS)
    emit({"phase": "data", "model": key, "plots": N_PLOTS,
          **map_batch_facts(bundle.net, host_batch), "host_map_ms": host_ms})
    del bundle
    for dtname, ckpt in ckpts.items():
        phase_map_serve(key, dtname, ckpt, plot_dir, tmp, collated,
                        host_batch, host_ms, smi)
        torch.cuda.empty_cache()
        phase_map_train(key, dtname, plot_dir, tmp, smi, seed)
        torch.cuda.empty_cache()


# The treeadd eval (docs/treedb.md through the port): a synthetic treeDB
# processed by the port's train route, then SENet14 (sparse level 0)
# trained one epoch on NFI-like plots and evaluated with the
# sparse_xy_treeadd_eval preset
TREEDB_TREES = 40
TREEADD_PLOTS = 32


def phase_treeadd(tmp: str, smi: str, krows: list) -> None:
    """See the module docstring."""
    import torch
    from dpcr_agb_tpu_torch import eval as ev, kernels, train
    from dpcr_agb_tpu_torch.data.synthetic import generate_tree_db
    from dpcr_agb_tpu_torch.transforms.objects import RadiusObjectAdder
    what = "treeadd"
    root = os.path.join(tmp, what)
    data = os.path.join(root, "data")
    t0 = time.perf_counter()
    generate_tree_db(os.path.join(data, "treeDB"), n_trees=TREEDB_TREES)
    train.main(["task=instance", "models=instance/simplestnet",
                "model_name=SimplestNet", "data=instance/treeDB/ALS",
                "data.transform_type=trees", "+data.trees.num_points=2048",
                "training=default", "training.epochs=1",
                "training.batch_size=8", f"data.dataroot={data}",
                f"run_dir={root}/trees", "pretty_print=False"])
    torch.cuda.synchronize()
    treedb_seconds = time.perf_counter() - t0
    objects = sorted(glob.glob(os.path.join(
        data, "treeDB", "processed_treeDB_ALS", "train", "treeDB", "*.npz")))
    keys = set()
    for f in objects:
        with np.load(f) as z:
            keys |= set(z.files)
    if not objects or not {"pos", "x", "local_stats"} <= keys:
        raise AssertionError(f"{what}: processed treeDB objects "
                             f"{len(objects)}, keys {sorted(keys)}")

    overrides = [o for o in trainer_overrides(root, "trainer")
                 if not o.startswith(("data.synthetic_plots=",
                                      "training.epochs="))]
    t0 = time.perf_counter()
    train.main(overrides + [f"data.synthetic_plots={TREEADD_PLOTS}",
                            "training.epochs=1"])
    torch.cuda.synchronize()
    train_seconds = time.perf_counter() - t0
    run_dir = os.path.join(root, "run")
    spec = {"forward": {"stem_sites": 1, "max_pool_k3s2_rows": 1},
            "step": {}}
    added, unwrapped = [], RadiusObjectAdder.__call__

    def counting(self, rng, sample):
        out = unwrapped(self, rng, sample)
        added.append(int(out["pos"].shape[0] - sample["pos"].shape[0]))
        return out

    results = {}
    for preset in ("sparse_xy_treeadd_eval", "sparse_xy"):
        added.clear()
        kernels.reset_launches()
        RadiusObjectAdder.__call__ = counting
        try:
            with StepCounter() as count:
                t0 = time.perf_counter()
                metrics = ev.main([f"checkpoint_dir={run_dir}",
                                   "model_name=SENet14", "weight_name=latest",
                                   f"batch_size={TRAINER_BS}",
                                   f"run_dir={root}/eval_{preset}",
                                   f"data.transform_type={preset}",
                                   "pretty_print=False"])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
        finally:
            RadiusObjectAdder.__call__ = unwrapped
        launches = dict(kernels.LAUNCHES)
        check_trainer_launches(f"{what}: eval.main {preset}", launches,
                               count, spec)
        header, rows = read_pred_csv(os.path.join(
            root, f"eval_{preset}", "SYNTH_test_preds.csv"))
        results[preset] = {
            "eval_main_seconds": seconds, "forwards": count.forwards,
            "launches": {k: launches[k] for k in spec["forward"]},
            "points_added_per_plot": list(added),
            "test_preds": np.array([[float(r[i]) for i, h in
                                     enumerate(header)
                                     if h.startswith("pred_")]
                                    for r in rows]),
            "test_total_BMag_ha_rmse": metrics["test"][
                "test_total_BMag_ha_rmse"]}
    tree, plain = results["sparse_xy_treeadd_eval"], results["sparse_xy"]
    if not tree["points_added_per_plot"] or \
            min(tree["points_added_per_plot"]) < 1 or \
            plain["points_added_per_plot"]:
        raise AssertionError(f"{what}: points added per plot "
                             f"{tree['points_added_per_plot']} (treeadd), "
                             f"{plain['points_added_per_plot']} (plain)")
    moved = np.abs(tree["test_preds"] - plain["test_preds"]).max() \
        / max(np.abs(plain["test_preds"]).max(), 1e-30)
    for r in krows:
        if r["kernels_phase"] == "sparse_l0" and r["dtype"] == "bfloat16" \
                and r["name"] in spec["forward"]:
            r.setdefault("launches_by_path", {})[what] = \
                tree["launches"][r["name"]]
    for res in results.values():
        del res["test_preds"]
    emit({"phase": what, "model": "SENet14", "trees": TREEDB_TREES,
          "processed_objects": len(objects), "object_keys": sorted(keys),
          "treedb_seconds": treedb_seconds, "plots": TREEADD_PLOTS,
          "train_main_seconds": train_seconds, "evals": results,
          "test_preds_moved_rel": float(moved), "card": smi})


# The transforms phase: SENet14's command (sparse level 0, bf16) on a
# preset that the phase passes through the root grammar: sparse_xy's chains
# with the transforms users put into their own presets, and a fifth input
# channel (data.features=[classification] and z_distance_to_top on x)
TRANSFORMS_PLOTS = 32
TRANSFORMS_BS = 4
TRANSFORMS_CLAMP = 12000    # points a batch of 4 may hold: drops samples
TRANSFORMS_CIN = 5


def augmented_preset(clamp_points: int = TRANSFORMS_CLAMP) -> dict:
    """sparse_xy's chains (conf/data/instance/NFI/transforms/
    sparse-xy.yaml, written out: the composer drops its anchors) with the
    z-outlier and density filters ahead of the NFI pre_transform, a
    lottery of crops and samplers, drawn parameters, a nested compose, an
    elastic distortion, xy centering and the points' ids in the train
    chain, z_distance_to_top (normalised) on x in both chains, and a point
    budget a batch. Lengths are in the plot's normalised frame (x, y in
    [0, 1], z from 0 in units of 40 m) after the prefix, in metres in the
    pre_transform. sparse_xy's AddRandomPoints is left out: it extends pos
    alone, so with x taken from the plot's columns it leaves x short and
    AddFeatsByKeys raises (in both packages)."""
    skip = "${data.skip_list}"
    hexagon = [[0.0, 0.5], [0.25, 0.9330127], [0.75, 0.9330127], [1.0, 0.5],
               [0.75, 0.0669873], [0.25, 0.0669873]]
    scale = {"transform": "ScalePos",
             "params": {"scale_x": "${data.x_scale}",
                        "scale_y": "${data.y_scale}",
                        "scale_z": "${data.z_scale}", "op": "div"}}
    move = {"transform": "MoveCenterPosPerSample",
            "params": {"center_x": "${data.x_center}",
                       "center_y": "${data.y_center}"}}
    aug_prefix = [
        {"transform": "RandomGroundRemoval",
         "params": {"min_v": 0.05, "max_v": 0.5, "p": 0.1,
                    "min_points": 500, "skip_list": skip}},
        {"transform": "RandomDropout",
         "params": {"dropout_ratio": 0.2, "dropout_application_ratio": 0.5,
                    "min_points": 500, "skip_list": skip}},
        scale, {"transform": "RandomNoise", "params": {"sigma": 0.0025}},
        {"transform": "Random3AxisRotation",
         "params": {"apply_rotation": True, "rot_x": 0, "rot_y": 0,
                    "rot_z": 180}},
        {"transform": "RandomShiftPos",
         "params": {"p": 0.5, "max_x": 0.01, "max_y": 0.01, "max_z": 0.0}},
        move, {"transform": "StartZFromZero"},
        {"transform": "CopyJitterRandomPoints",
         "params": {"n_max_points": 12000, "add_ratio_min": 0.01,
                    "add_ratio_max": 0.2, "p": 0.25, "sigma": 0.005,
                    "clip": 0.015}},
        {"transform": "RandomPolygon2dExtend",
         "params": {"polygons": [hexagon], "rotate": 180,
                    "skip_list": skip}}]
    det_prefix = [scale, move, {"transform": "StartZFromZero"},
                  {"transform": "Polygon2dExtend",
                   "params": {"polygon": hexagon, "skip_list": skip}}]
    feats = [
        {"transform": "MaxPoints", "params": {"num": 16000,
                                              "skip_list": skip}},
        {"transform": "MinPoints", "params": {"num": 500, "skip_list": skip}},
        {"transform": "XYZFeature",
         "params": {"add_x": False, "add_y": False, "add_z": True}},
        {"transform": "AddOnes"},
        {"transform": "AddXYDistanceToCenter",
         "params": {"center_x": "${data.x_center}",
                    "center_y": "${data.y_center}"}},
        {"transform": "AddFeatsByKeys",
         "params": {"list_add_to_x": [True, True, True],
                    "feat_names": ["ones", "pos_z", "xy_distance"],
                    "delete_feats": [True, True, True],
                    "input_nc_feats": [1, 1, 1]}}]
    quantize = [{"transform": "GridSampling3D",
                 "params": {"size": "${data.first_subsampling}",
                            "quantize_coords": True, "mode": "last"}}]
    voxel_aug = [{"transform": "RandomCoordsFlip",
                  "params": {"ignored_axis": "z", "p": 0.5}},
                 {"transform": "ShiftVoxels"}]
    x_feats = [
        {"transform": "AddZDistanceToTop"},
        {"transform": "NormalizeFeature",
         "params": {"feat_name": "z_distance_to_top", "mean": 0.1,
                    "std": 0.1}},
        {"transform": "AddFeatByKey",
         "params": {"add_to_x": True, "feat_name": "z_distance_to_top",
                    "input_nc_feat": 1}}]
    crops = [
        {"transform": "EllipsoidCrop",
         "params": {"a": 0.6, "b": 0.6, "c": 0.9, "rot_x": 0, "rot_y": 0,
                    "rot_z": 180}},
        {"transform": "CubeCrop",
         "params": {"c": 0.45, "rot_x": 0, "rot_y": 0, "rot_z": 180,
                    "grid_size_center": 0.05}},
        {"transform": "IrregularSampling",
         "params": {"d_half": 0.5, "p": 2, "grid_size_center": 0.05,
                    "skip_keys": skip}},
        {"transform": "PeriodicSampling",
         "params": {"period": 0.05, "prop": 0.8, "skip_keys": skip}}]
    return {
        "pre_transform": [
            {"transform": "StatZOutlierRemoval",
             "params": {"threshold": 4.0, "skip_list": skip}},
            {"transform": "OPTICSZOutlierRemoval",
             "params": {"eps": 1.0, "min_samples": 10, "skip_list": skip}},
            {"transform": "KernelDensityZOutlierRemoval",
             "params": {"bandwidth": 1.0, "p": 0.001, "skip_list": skip}},
            {"transform": "DensityFilter",
             "params": {"radius_nn": 1.5, "min_num": 1, "skip_keys": skip}},
            "${data.pre_transform}"],
        "train_transform": [
            *aug_prefix,
            {"transform": "LotteryTransform",
             "params": {"transform_options": crops}},
            {"transform": "RandomParamTransform",
             "params": {"transform_name": "RandomScaling",
                        "transform_params": {
                            "scales": {"value": [0.95, 1.05]}}}},
            {"transform": "ComposeTransform",
             "params": {"transform_options": [
                 {"transform": "RandomSymmetry",
                  "params": {"axis": [True, True, False]}},
                 {"transform": "RandomTranslation",
                  "params": {"delta_max": [0.01, 0.01, 0.0],
                             "delta_min": [-0.01, -0.01, 0.0]}}]}},
            {"transform": "ElasticDistortion",
             "params": {"granularity": [0.05, 0.2],
                        "magnitude": [0.002, 0.005], "p": 0.5}},
            {"transform": "CenterXYbyZ",
             "params": {"center_x": 0.5, "center_y": 0.5,
                        "z_thresh_min": 0.0, "z_thresh_max": 1.0}},
            {"transform": "SaveOriginalPosId"},
            *feats, *x_feats,
            {"transform": "Jitter", "params": {"sigma": 0.01, "p": 0.5}},
            *quantize, *voxel_aug],
        "test_transform": [
            *det_prefix,
            {"transform": "StatZOutlierRemoval",
             "params": {"threshold": 4.0, "skip_list": skip}},
            {"transform": "SaveOriginalPosId"},
            *feats, *x_feats, *quantize],
        "val_transform": "${data.sparse_xy_aug.test_transform}",
        "pre_batch_collate_transform": [
            {"transform": "ClampBatchSize",
             "params": {"num_points": clamp_points}}]}


def augmented_overrides(clamp_points: int = TRANSFORMS_CLAMP) -> list:
    """The preset and the input features as root-grammar overrides (the
    preset as one YAML flow value)."""
    return ["+data.sparse_xy_aug=" + json.dumps(augmented_preset(
        clamp_points)), "data.transform_type=sparse_xy_aug",
            "data.features=[classification]"]


# each of the 37 transforms of slice 16 timed on one full synthetic plot:
# (name, params, frame) with frame "m" (metres, z from the ground, as the
# pre_transform sees a plot) or "unit" (the normalised frame of the chains)
TIMED_TRANSFORMS = [
    ("StatZOutlierRemoval", {}, "m"),
    ("OPTICSZOutlierRemoval", {"eps": 1.0, "min_samples": 10}, "m"),
    ("KernelDensityZOutlierRemoval", {"bandwidth": 1.0, "p": 0.001}, "m"),
    ("DensityFilter", {"radius_nn": 1.5, "min_num": 1}, "m"),
    ("CenterPosPerSample", {"center": "quantile"}, "unit"),
    ("FixedCenterPosPerSample", {}, "unit"),
    ("CenterXYbyZ", {"center_x": 0.5, "center_y": 0.5}, "unit"),
    ("RandomScaling", {"scales": [0.95, 1.05]}, "unit"),
    ("RandomSymmetry", {"axis": [True, True, False]}, "unit"),
    ("RandomTranslation", {}, "unit"),
    ("AddGround", {"max_points": 100, "n_points": 64}, "unit"),
    ("CylinderExtend", {"radius": 0.45}, "unit"),
    ("RectangleExtend", {"e_x": 0.9, "e_y": 0.9, "e_z": 0.9}, "unit"),
    ("EllipsoidCrop", {"a": 0.6, "b": 0.6, "c": 0.9}, "unit"),
    ("CubeCrop", {"c": 0.45, "grid_size_center": 0.05}, "unit"),
    ("IrregularSampling", {"d_half": 0.5, "grid_size_center": 0.05},
     "unit"),
    ("PeriodicSampling", {"period": 0.05, "prop": 0.8}, "unit"),
    ("LotteryTransform", {"transform_options": [
        {"transform": "CubeCrop", "params": {"c": 0.45,
                                             "grid_size_center": 0.05}}]},
     "unit"),
    ("ComposeTransform", {"transform_options": [
        {"transform": "RandomSymmetry"}, {"transform": "RandomTranslation"}]},
     "unit"),
    ("RandomParamTransform", {"transform_name": "RandomScaling",
                              "transform_params": {
                                  "scales": {"value": [0.95, 1.05]}}},
     "unit"),
    ("ElasticDistortion", {"granularity": [0.05, 0.2],
                           "magnitude": [0.002, 0.005], "p": 1.0}, "unit"),
    ("SaveOriginalPosId", {}, "unit"),
    ("AddZDistanceToTop", {}, "unit"),
    ("AddFeatByKey", {"add_to_x": True, "feat_name": "rgb"}, "unit"),
    ("NormalizeFeature", {"feat_name": "x", "mean": 3.0, "std": 2.0},
     "unit"),
    ("NormalFeature", {}, "unit"),
    ("PCACompute", {}, "unit"),
    ("NormalizeRGB", {}, "unit"),
    ("ChromaticTranslation", {}, "unit"),
    ("ChromaticAutoContrast", {}, "unit"),
    ("ChromaticJitter", {}, "unit"),
    ("DropFeature", {"drop_proba": 1.0}, "unit"),
    ("Jitter", {"p": 1.0}, "unit"),
    ("PlanarityFilter", {}, "unit"),
    ("RandomFilter", {}, "unit"),
]


def transforms_host_ms(seed: int) -> list:
    """Each of the 37 on one full synthetic plot (the generator's density,
    15 m radius), on the host clock (median of 3 calls): its input and
    output points (or the bool of a sample filter). The plot gets the rgb
    and norm that NFI-like plots lack, for the feature augments and
    NormalFeature; FCompose composes two of the filters, ClampBatchSize
    takes a batch of 16 copies."""
    from dpcr_agb_tpu_torch.data.synthetic import generate_plot
    from dpcr_agb_tpu_torch.transforms import (TRANSFORM_REGISTRY,
                                               instantiate_transform)
    rng = np.random.default_rng(seed)
    pts, _, _ = generate_plot(rng)
    pts[:, 2] -= pts[:, 2].min()
    n = len(pts)
    norm = rng.normal(size=(n, 3))
    base = {"x": (2 + 3 * (pts[:, 2:3] > 0.3)).astype(np.float32),
            "rgb": rng.uniform(0, 255, (n, 3)).astype(np.float32),
            "norm": (norm / np.linalg.norm(norm, axis=1, keepdims=True))
            .astype(np.float32)}
    frames = {"m": pts,
              "unit": (pts / np.array([30, 30, 40], np.float32)
                       + np.array([0.5, 0.5, 0.0], np.float32))}
    calls = [(name, instantiate_transform({"transform": name,
                                           "params": params}), frame)
             for name, params, frame in TIMED_TRANSFORMS]
    calls.append(("FCompose", TRANSFORM_REGISTRY["FCompose"](
        [TRANSFORM_REGISTRY["RandomFilter"](0.9),
         TRANSFORM_REGISTRY["PlanarityFilter"](0.9)]), "unit"))
    clamp = TRANSFORM_REGISTRY["ClampBatchSize"](8 * n)
    out = []
    for name, t, frame in calls:
        sample = {"pos": frames[frame], **base}
        times, result = [], None
        for rep in range(3):
            t0 = time.perf_counter()
            result = t(np.random.default_rng(rep), dict(sample))
            times.append((time.perf_counter() - t0) * 1e3)
        row = {"name": name, "frame": frame, "points_in": n,
               "host_ms_per_plot": statistics.median(times)}
        if isinstance(result, (bool, np.bool_)):
            row["keeps_sample"] = bool(result)
        else:
            row["points_out"] = int(result["pos"].shape[0])
        out.append(row)
    batch = [{"pos": frames["unit"]}] * 16
    t0 = time.perf_counter()
    kept = clamp(batch)
    out.append({"name": "ClampBatchSize", "frame": "unit", "points_in": n,
                "host_ms_per_plot": (time.perf_counter() - t0) * 1e3 / 16,
                "batch_kept": f"{len(kept)} of 16"})
    names = {r["name"] for r in out}
    if len(names) != 37:
        raise AssertionError(f"transforms: timed {sorted(names)}")
    return out


def chain_points(dataset, split: str, seed: int, n_samples: int) -> list:
    """Points per sample after each transform of the split's chain, on its
    first samples (the pre_transform's output, as cached)."""
    chain = dataset.transform_for(split).transforms
    out = []
    for i in range(min(n_samples, len(dataset.datasets[split]))):
        rng = np.random.default_rng(seed + i)
        sample = dataset.datasets[split].get(i)
        steps = [("processed", int(sample["pos"].shape[0]))]
        for t in chain:
            sample = t(rng, sample)
            steps.append((type(t).__name__, int(sample["pos"].shape[0])))
        out.append(steps)
    return [{"transform": name, "points": [s[k][1] for s in out]}
            for k, (name, _) in enumerate(out[0])]


def phase_transforms(tmp: str, smi: str, krows: list, seed: int) -> None:
    """See the module docstring."""
    import torch
    from dpcr_agb_tpu_torch import eval as ev, kernels, train
    from dpcr_agb_tpu_torch.training.step import StepRunner
    from dpcr_agb_tpu_torch.transforms import TRANSFORM_REGISTRY
    what = "transforms"
    root = os.path.join(tmp, what)
    host = transforms_host_ms(seed)
    emit({"phase": what, "host_ms_per_plot": host, "card": smi})
    spec = TRAINERS["trainer"]
    overrides = [o for o in trainer_overrides(root, "trainer")
                 if not o.startswith(("data.synthetic_plots=",
                                      "training.epochs=",
                                      "training.batch_size=",
                                      "data.transform_type="))]
    overrides += [f"data.synthetic_plots={TRANSFORMS_PLOTS}",
                  "training.epochs=1", f"training.batch_size={TRANSFORMS_BS}",
                  *augmented_overrides()]
    clamp = TRANSFORM_REGISTRY["ClampBatchSize"]
    unwrapped, dropped = clamp.__call__, []
    unwrapped_step, step_losses = StepRunner.train, []

    def counting(self, samples):
        kept = unwrapped(self, samples)
        dropped.append(len(samples) - len(kept))
        return kept

    def train_step(runner, batch, *a, **k):
        out = unwrapped_step(runner, batch, *a, **k)
        step_losses.append(out["loss"].detach())
        return out

    clamp.__call__ = counting
    StepRunner.train = train_step
    try:
        kernels.reset_launches()
        with StepCounter() as counter:
            t0 = time.perf_counter()
            trainer = train.main(overrides)
            torch.cuda.synchronize()
            train_seconds = time.perf_counter() - t0
        train_launches = dict(kernels.LAUNCHES)
        train_drops = list(dropped)
        check_trainer_launches(f"{what}: train.main", train_launches,
                               counter, spec)
        cin = int(trainer.net.stem_conv.kernel.shape[1])
        if cin != TRANSFORMS_CIN:
            raise AssertionError(f"{what}: the stem's Cin is {cin}, not "
                                 f"{TRANSFORMS_CIN}")
        losses = [float(x) for x in step_losses]
        if len(losses) != counter.calls["train"] or len(losses) != 6 \
                or not np.isfinite(losses).all():
            raise AssertionError(f"{what}: train losses {losses}, "
                                 f"{counter.calls['train']} steps")
        if not sum(train_drops):
            raise AssertionError(f"{what}: ClampBatchSize "
                                 f"({TRANSFORMS_CLAMP} points) dropped no "
                                 f"sample: {train_drops}")
        stages = chain_points(trainer.dataset, "train", seed, 4)
        run_dir = os.path.join(root, "run")
        dropped.clear()
        kernels.reset_launches()
        with StepCounter() as count:
            t0 = time.perf_counter()
            metrics = ev.main([f"checkpoint_dir={run_dir}",
                               "model_name=SENet14", "weight_name=latest",
                               f"batch_size={TRANSFORMS_BS}",
                               f"run_dir={root}/eval", "pretty_print=False"])
            torch.cuda.synchronize()
            eval_seconds = time.perf_counter() - t0
    finally:
        clamp.__call__ = unwrapped
        StepRunner.train = unwrapped_step
    eval_launches = dict(kernels.LAUNCHES)
    check_trainer_launches(f"{what}: eval.main", eval_launches, count,
                           {"forward": spec["forward"], "step": {}})
    header, rows = read_pred_csv(os.path.join(root, "eval",
                                              "SYNTH_test_preds.csv"))
    preds = np.array([[float(r[i]) for i, h in enumerate(header)
                       if h.startswith("pred_")] for r in rows])
    if not len(preds) or not np.isfinite(preds).all():
        raise AssertionError(f"{what}: eval.main test predictions {preds}")
    for r in krows:
        if r["kernels_phase"] == "sparse_l0" and r["dtype"] == "bfloat16" \
                and r["name"] in {**spec["forward"], **spec["step"]}:
            r.setdefault("launches_by_path", {})[what] = \
                train_launches[r["name"]]
    emit({"phase": what, "model": "SENet14", "dtype": "bfloat16",
          "stem_cin": cin, "plots": TRANSFORMS_PLOTS,
          "batch_size": TRANSFORMS_BS, "clamp_points": TRANSFORMS_CLAMP,
          "train_samples_dropped_per_batch": train_drops,
          "eval_samples_dropped_per_batch": list(dropped),
          "train_losses": losses, "train_steps": counter.calls["train"],
          "train_launches": {k: train_launches[k] for k in
                             (*spec["forward"], *spec["step"])},
          "eval_forwards": count.forwards,
          "eval_launches": {k: eval_launches[k] for k in spec["forward"]},
          "points_per_sample_by_stage": stages,
          "test_predictions": len(preds),
          "test_total_BMag_ha_rmse": metrics["test"][
              "test_total_BMag_ha_rmse"],
          "train_main_seconds": train_seconds,
          "eval_main_seconds": eval_seconds, "card": smi})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of the serving "
                         "forward and of the train step")
    ap.add_argument("--out", default=None,
                    help="also write every phase's JSON to this file")
    ap.add_argument("--only", choices=sorted(MODELS) + sorted(TRAINERS)
                    + ["treeadd", "transforms"],
                    default=None,
                    help="run the phases of one path only (all the "
                         "kernels are built either way); 'trainer' and "
                         "'trainer-kpconv' run that trainer phase alone, "
                         "with no kernels rows")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from dpcr_agb_tpu_torch import predict, train  # noqa: F401
        from dpcr_agb_tpu_torch.kernels import LAUNCHES  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the dpcr_agb_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2
    from dpcr_agb_tpu_torch.device import pin_numerics
    pinned = pin_numerics()

    t_start = time.perf_counter()
    dev = phase_device(pinned)
    smi = dev["nvidia_smi"]
    krows = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        plot_dir = os.path.join(tmp, "plots")
        write_plots(plot_dir, N_PLOTS, args.seed, DENSITY)
        for key, spec in MODELS.items():
            if args.only in (None, key):
                t_model = time.perf_counter()
                with mode_env(spec["env"]):
                    if spec.get("map_mode"):
                        run_map_model(key, tmp, plot_dir, smi, args.seed)
                    else:
                        krows += run_model(key, tmp, plot_dir, smi,
                                           args.seed, args.profile, krows)
                emit({"phase": "model", "model": key,
                      "seconds": time.perf_counter() - t_model})
        for key in TRAINERS:
            if args.only in (None, key):
                t_model = time.perf_counter()
                with mode_env({}):
                    phase_trainer(tmp, smi, krows, key)
                emit({"phase": "model", "model": key,
                      "seconds": time.perf_counter() - t_model})
        if args.only in (None, "treeadd"):
            t_model = time.perf_counter()
            with mode_env({}):
                phase_treeadd(tmp, smi, krows)
            emit({"phase": "model", "model": "treeadd",
                  "seconds": time.perf_counter() - t_model})
        if args.only in (None, "transforms"):
            t_model = time.perf_counter()
            with mode_env({}):
                phase_transforms(tmp, smi, krows, args.seed)
            emit({"phase": "model", "model": "transforms",
                  "seconds": time.perf_counter() - t_model})
    missing = [f"{r['name']} {r['dtype']} {r.get('case') or ''}"
               for r in krows if not r["launches"]]
    if missing:
        raise AssertionError(f"kernels never launched on a main path: "
                             f"{missing}")
    drifted = [f"{r['model']} {r['dtype']}" for r in RECORD
               if r.get("phase") == "train"
               and MODELS[r["model"]].get("reproducible")
               and not r["train_reproducible"]]
    if drifted:
        raise AssertionError(f"two same-seed runs of train.main differ: "
                             f"{drifted}")
    summary = {"kernels": [{k: r.get(k) for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "dtype",
        "case", "max_abs_plain", "launches_by_path", "serial_steps",
        "device_ms",
        "plain_device_ms", "library_device_ms", "sub_kernels",
        "previous_route_ms", "previous_route_device_ms", "fill_device_ms",
        "index_build_device_ms", "pool_kernel_device_ms")}
        for r in krows]}
    total = {"phase": "total", "seconds": time.perf_counter() - t_start,
             "card": smi}
    emit(total)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(RECORD + [summary], f, indent=1)
    print(json.dumps(summary))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
