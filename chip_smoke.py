#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dpcr_agb_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--profile] [--out FILE]
                          [--only SENet14|KPConv|SENet14-denseL0|SENet50]

Phases, each printing one JSON line; any failure exits non-zero:
  device   the card's name and power limit, the float32 settings pinned by
           `device.pin_numerics` (TF32 off: what the entry points pin);
           builds the kernels from dpcr_agb_tpu_torch/kernels/csrc for
           sm_90a (build seconds)
Then for each configuration (`--only` keeps one of them): SENet14 with the
sparse level 0, KPConv, SENet14 with the dense level 0 (DPCR_L0=dense,
DPCR_STEM_MODE=zfold2d_firewall, DPCR_POOL_BWD=pallas, set around its entry
points as a user would) and SENet50 (bottleneck blocks, sparse level 0):
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
           gather_rows_bwd).
           SENet14: stem_sites and max_pool_k3s2 at the first serving
           batch's shapes, stem_sites_dw and max_pool_k3s2_bwd at the
           first train batch's (SENet50 runs the same four kernels at the
           same shapes: its rows are SENet14's unless it runs alone).
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
           max_pool_k3s2_bwd_vol on that of the train batch
  serve    the full-width model (f32, then bf16): 16 synthetic plots dense
           enough that MaxPoints binds (sparse-voxel nets: V bucket 16384;
           KPConv: N bucket 8192) served by
           `dpcr_agb_tpu_torch.predict.main` (started from PyTorch's
           default float32 settings: it must pin TF32 off itself) from a
           port checkpoint with seeded random weights; checks 16 finite
           prediction rows, the launches of that run (KPConv: 14
           kpconv_fused; dense level 0: firewall_copy 2, max_pool_k3s2 1,
           the row kernels 0), and that the raw outputs equal a run
           through the plain versions; prints plots/s (KPConv: and the
           neighbour search's share of the forward, after checking that
           two pyramids of the batch are bit-identical; dense level 0: and
           that the same checkpoint served through the sparse level 0
           agrees)
  train    the full-width model (f32, then bf16) trained by
           `dpcr_agb_tpu_torch.train.main` (it must pin TF32 off and
           record that in its checkpoint) for 6 steps at bs16 on the same
           plots and their targets: 6 finite losses, the launches of every
           step (KPConv: 14 kpconv_fused, 14 kpconv_fused_bwd and 4
           gather_rows_bwd; dense level 0: firewall_copy 3, max_pool_k3s2
           and max_pool_k3s2_bwd_vol 1, the row kernels 0); one step from
           one state through the kernels and through the plain versions
           (loss, every gradient, the updated parameters and BN running
           stats within stated tolerances); train_step_ms (median of 5
           steps on a device-resident batch), and again with
           cudnn.deterministic, plots/s and peak memory; then
           `predict.main` serves the trained checkpoint (16 finite rows);
           then train_reproducible: train.main a second time with the same
           seed, losses and final state compared bit for bit (KPConv must
           agree; elsewhere a differing run names the parameter where the
           difference starts and whether deterministic algorithms remove
           it)
Then the kernels summary line, the nvidia-smi name/power-limit line, and
last `{"ok": true, "device": {...}}`. Without CUDA (or without the rest of
the repository) it exits non-zero before printing any result."""
from __future__ import annotations

import argparse
import contextlib
import csv
import glob
import json
import os
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
N_PLOTS = 16     # one serving batch of bench.py's size, the train batch
DENSITY = 60.0   # points per m^2: MaxPoints binds (16000 and 6144)
TRAIN_STEPS = 6
# The execution modes of the sparse-voxel nets' level 0 (the JAX package's
# variables; the port reads them when a model is built). Every path runs
# with all five set or cleared, whatever the caller's environment holds.
MODE_VARS = ("DPCR_L0", "DPCR_STEM_MODE", "DPCR_POOL_BWD",
             "DPCR_SPARSE_POOL", "DPCR_POOL_FWD")
_SPARSE_L0 = {"env": {}, "kernels": "sparse_l0",
              "forward": ("stem_sites", "max_pool_k3s2"),
              "backward": ("stem_sites_dw", "max_pool_k3s2_bwd"),
              "exact": None}
_ROW_KERNELS = {"stem_sites": 0, "stem_sites_dw": 0, "max_pool_k3s2_bwd": 0}
# per path: the entry points' model_name, the mode variables, which
# kernels phase it gets, the kernels serving launches and the ones training
# adds, and where the count is fixed, the launches of each kernel in one
# forward and in one train step (KPCNN's 14 blocks hold one KPConv each
# and 4 strided shortcuts; the dense level 0 copies the stem's input, its
# output and the output's cotangent, and pools once each way); and whether
# two same-seed runs of train.main must agree bit for bit (every sum of
# the KPConv step runs in a fixed order; the sparse-voxel nets' f32 steps
# go through cuDNN's own choice of algorithms)
MODELS = {
    "SENet14": {"model_name": "SENet14", **_SPARSE_L0},
    "KPConv": {"model_name": "KPConv", "env": {}, "kernels": "kpconv",
               "forward": ("kpconv_fused",),
               "backward": ("kpconv_fused_bwd", "gather_rows_bwd"),
               "exact": {"forward": {"kpconv_fused": 14,
                                     "gather_rows_bwd": 0},
                         "step": {"kpconv_fused": 14,
                                  "kpconv_fused_bwd": 14,
                                  "gather_rows_bwd": 4}},
               "reproducible": True},
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
    convolution only)."""
    from dpcr_agb_tpu_torch import train
    return {"float32": train.model_option(model_name, bf16=False),
            "bfloat16": train.model_option(model_name, bf16=True)}


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


def kernel_ms(fn, reps: int = 5) -> dict:
    """Device ms per fn() of each of the port's kernels (namespace dpcr)
    that fn launches, from torch.profiler over reps calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and "dpcr::" in e.key:
            name = e.key.split("dpcr::", 1)[1].split("<")[0].split("(")[0]
            out[name] = out.get(name, 0.0) + e.self_device_time_total \
                / reps / 1e3
    return out


@contextlib.contextmanager
def plain_ops():
    """Route the models' nine kernel ops to their plain PyTorch versions
    (the reference runs of the serve and train phases); raises if a kernel
    launched inside, i.e. if the reference did not really take the plain
    path."""
    from dpcr_agb_tpu_torch import kernels
    from dpcr_agb_tpu_torch.ops import dense_stem, kpconv, pool, sparse_stem
    routes = [(sparse_stem, "stem_conv_sites", "stem_conv_sites_plain"),
              (sparse_stem, "stem_conv_sites_dw", "stem_conv_sites_dw_plain"),
              (pool, "masked_max_pool", "masked_max_pool_plain"),
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


def phase_device(pinned: dict) -> dict:
    import torch
    from dpcr_agb_tpu_torch.kernels import build
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    report = build.build(ptxas_verbose=True)
    seconds = time.perf_counter() - t0
    ptxas = {k: [ln for ln in v["log"].splitlines() if "ptxas" in ln][-6:]
             for k, v in report.items()}
    out = {"phase": "device", "name": torch.cuda.get_device_name(0),
           "nvidia_smi": smi, "count": torch.cuda.device_count(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "numerics": pinned,
           "build_seconds": round(seconds, 3),
           "built": {k: not v["cached"] for k, v in report.items()},
           "ptxas": ptxas}
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


def phase_kernels(bundles: dict, batch, train_batch, smi: str,
                  seed: int) -> list:
    """The forward kernels at the first serving batch's shapes and the
    backward kernels at the first train batch's, f32 and bf16."""
    import torch
    import torch.nn.functional as F
    from dpcr_agb_tpu_torch.ops.dense_grid import scatter_to_dense
    from dpcr_agb_tpu_torch.ops.sparse_stem import (stem_conv_sites,
                                                    stem_conv_sites_plain)
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
        n_sites = int(mask.sum())
        cin, cout = wts.shape[1], wts.shape[2]
        n_nonzero, n_reach = stem_work(vol, coords, mask)
        with torch.no_grad():
            got = stem_conv_sites(vol, coords, mask, wts, bias)
            want = stem_conv_sites_plain(vol, coords, mask, wts, bias)
            torch.cuda.synchronize()
            if dt == torch.float32:     # accumulation order only
                err = _check_close("stem_sites f32", got, want, 1e-4, 1e-4)
                tol = "rtol 1e-4, atol 1e-4"
            else:                       # compared in bf16
                scale = want.float().abs().max().item()
                err = _check_close("stem_sites bf16", got, want, 0.0,
                                   2e-2 * scale)
                tol = "atol 2e-2 * max|plain| (bf16)"
            ms = time_ms(lambda: stem_conv_sites(vol, coords, mask, wts,
                                                 bias))
            plain_ms = time_ms(lambda: stem_conv_sites_plain(
                vol, coords, mask, wts, bias))
            # yardstick: cuDNN's dense k7 conv of the NCDHW Cin volume,
            # whose values at the sites are the kernel's
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
            # what this data needs: the volume cells within reach of an
            # occupied site, and one product per non-zero neighbour value
            # and output channel (the kernel skips the zeros)
            esz = vol.element_size()
            nbytes = (n_reach * cin * esz + coords.numel() * 4 + mask.numel()
                      + wts.numel() * esz + bias.numel() * esz
                      + got.numel() * esz)
            flops = 2.0 * n_nonzero * cout
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = flops / PEAK_FLOPS[dtname] * 1e3
            rows.append({
                "name": "stem_sites", "dtype": dtname, "route": "cuda",
                "source": STEM_SRC, "replaces": STEM_REPLACES,
                "launches": None, "max_abs_err": err,
                "max_abs_plain": _amax(want), "tolerance": tol,
                "ms": ms, "plain_ms": plain_ms, **devs,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes > t_ops else "operations",
                "library_ms": lib_ms,
                "library": "F.conv3d k7 pad 3 on the NCDHW Cin volume",
                "library_max_abs_err_at_sites": lib_err,
                "shape": {"vol": list(vol.shape), "coords": list(coords.shape),
                          "weights": list(wts.shape),
                          "occupied_sites": n_sites,
                          "cells_in_reach": n_reach,
                          "nonzero_neighbour_values": n_nonzero,
                          "dense_flops": 2.0 * n_sites * 343 * cin * cout,
                          "needed_flops": flops, "needed_bytes": nbytes},
                "card": smi})

            # the pool input: the stem rows through BN + act, scattered to
            # the full-resolution volume, as on the main path
            h_rows = net.act(net.stem_norm(got, mask)) * mask[..., None].to(dt)
            x, occ = scatter_to_dense(coords, mask, h_rows, dims)
            rows.append(pool_forward_row(x, occ, dtname, smi))
            del x, occ, vol, got, want, h_rows
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
                "tolerance": "exact", "ms": ms, "plain_ms": plain_ms,
                **devs, "bound_ms": max(t_bytes, t_ops),
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
        y, occ_l = pooled_rows(coords, mask, h_rows, dims)
        ct = torch.randn(y.shape, generator=g, device=dev).to(dt)
        got = masked_max_pool_bwd_rows(coords, mask, h_rows, y, occ_l, ct,
                                       dims)
        want = masked_max_pool_bwd_rows_plain(coords, mask, h_rows, y, occ_l,
                                              ct, dims)
        torch.cuda.synchronize()
        err_p = _check_close(f"max_pool_k3s2_bwd {dtname}", got, want, 0.0,
                             0.0)
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
            "ms": ms_p, "plain_ms": plain_ms_p, **devs,
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
    pyr = net.device_pyramid(tb.pos, tb.mask)
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


def batch_facts(net, batch) -> dict:
    """The padded sizes of a host batch and what fills them."""
    n_valid = int(np.asarray(batch.mask).sum())
    if hasattr(net, "level0_dims"):          # the sparse-voxel nets
        return {"v_bucket": int(batch.coords.shape[1]),
                "zb": int(len(batch.aux["zcells"])),
                "dims": list(net.level0_dims(batch)),
                "occupied_voxels": n_valid}
    return {"n_bucket": int(batch.mask.shape[1]), "valid_points": n_valid,
            "level_caps": net.level_caps(int(batch.mask.shape[1]))}


def check_launches(what: str, key: str, launches: dict, part: str) -> None:
    """The launches of one forward (`part` "forward") or one train step
    ("step") of path `key`: each of its kernels at least once, and where
    the path fixes the counts, exactly those."""
    spec = MODELS[key]
    exact = spec["exact"]
    names = spec["forward"] + (spec["backward"] if part == "step" else ())
    if exact is None:
        bad = {k: launches[k] for k in names if launches[k] < 1}
        expected = "at least 1 of each"
    else:
        bad = {k: launches[k] for k, n in exact[part].items()
               if launches[k] != n}
        expected = exact[part]
    if bad:
        raise AssertionError(f"{what}: launches {bad} on the main path "
                             f"(expected {expected}): {launches}")


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
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t = time.perf_counter()
        predict.forward_raw(bundle, batch)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t)
    fwd = statistics.median(times)
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
        # the neighbour search runs in every forward: its share of it,
        # and that one cloud always gives one pyramid (no atomics in it)
        tb = batch.to(bundle.device)
        one, two = (bundle.net.device_pyramid(tb.pos, tb.mask)
                    for _ in range(2))
        moved = [k for k in one if not torch.equal(one[k], two[k])]
        if moved:
            raise AssertionError(f"{what}: two pyramids of one batch "
                                 f"differ in {moved}")
        del one, two
        pyramid_ms = time_ms(lambda: bundle.net.device_pyramid(
            tb.pos, tb.mask), n=5, warmup=1)
        extra = {"pyramid_ms": pyramid_ms,
                 "pyramid_share_of_forward": pyramid_ms / (fwd * 1e3),
                 "pyramid_reproducible": True}
        del tb
    profile = device_profile(lambda: predict.forward_raw(bundle, batch)) \
        if with_profile else None
    torch.cuda.reset_peak_memory_stats()
    predict.forward_raw(bundle, batch)
    torch.cuda.synchronize()
    out = {"phase": "serve", "model": key, "dtype": dtname,
           "plots": N_PLOTS, **batch_facts(bundle.net, batch),
           "launches": launches, "predict_main_seconds": main_seconds,
           "raw_max_abs_err_vs_plain": err,
           "raw_max_abs_plain": _amax(raw_plain), "tolerance": tol,
           "forward_ms": fwd * 1e3, "plots_per_s": N_PLOTS / fwd, **extra,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "numerics": pinned, "profile": profile, "card": smi}
    if key == "KPConv" and KP_SWEEP:
        out["kpconv_fused_14_layers_device_ms"] = \
            KP_SWEEP[dtname]["fwd_device_ms_sum"]
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


def compare_train_steps(run, batch, dtname: str, tols: dict,
                        conditioning: bool = False) -> dict:
    """One train step on one device batch from one state, through the
    kernels (run.runner) and through the plain versions (a copy of the
    runner); the errors of the kernel path against the plain one, each held
    to its tolerance. With `conditioning`, a third copy takes the plain
    step on the batch with its features moved by one f32 rounding
    (x * (1 + 6e-8 * normal noise)): its errors against the plain step say
    how far one rounding of the input moves each quantity, and a quantity
    may then miss its tolerance by up to 4 times that."""
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
    compared = compare_train_steps(
        run, batch, dtname, STEP_TOL, conditioning=key == "KPConv")

    # step time on the device-resident batch
    runner = run.runner
    times = []
    for i in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        runner.train(batch)
        torch.cuda.synchronize()
        if i >= 2:
            times.append(time.perf_counter() - t)
    step_s = statistics.median(times)
    # the same steps with cuDNN held to its deterministic algorithms (the
    # entry points leave that choice to cuDNN)
    torch.backends.cudnn.deterministic = True
    try:
        det_times = []
        for i in range(7):
            torch.cuda.synchronize()
            t = time.perf_counter()
            runner.train(batch)
            torch.cuda.synchronize()
            if i >= 2:
                det_times.append(time.perf_counter() - t)
    finally:
        torch.backends.cudnn.deterministic = pinned["cudnn_deterministic"]
    det_step_s = statistics.median(det_times)
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
           "peak_mem_gb": peak, "peak_reserved_gb": reserved,
           "served_trained_checkpoint": N_PLOTS, "numerics": pinned,
           **repro, "profile": profile, "card": smi}
    if key == "KPConv" and KP_SWEEP:
        out["kpconv_14_layers_device_ms"] = {
            k: KP_SWEEP[dtname][f"{k}_device_ms_sum"] for k in ("fwd", "bwd")}
    emit(out)
    return out


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


def device_profile(fn, reps: int = 3) -> dict:
    """torch.profiler over `reps` calls: device time by kernel (top 12, and
    every kernel of the port), and the device's busy share of the wall
    time."""
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
    return {"reps": reps, "wall_ms_per_rep": wall_us / reps / 1e3,
            "device_busy_ms_per_rep": busy_us / reps / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
            "top": [row(e) for e in top], "port_kernels": own,
            "port_kernels_ms_per_rep": sum(r["ms_per_rep"] for r in own)}


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
    shared = [r for r in have if r["kernels_phase"] == spec["kernels"]]
    if spec["kernels"] == "kpconv":
        krows = phase_kpconv_kernels(bundles["float32"], batch, smi, seed)
    elif shared:
        krows = []      # the same kernels at the same shapes: timed already
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
    for dtname in ckpts:
        record(phase_train(key, dtname, plot_dir, tmp, smi, seed,
                           with_profile), "train")
        torch.cuda.empty_cache()
    return krows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of the serving "
                         "forward and of the train step")
    ap.add_argument("--out", default=None,
                    help="also write every phase's JSON to this file")
    ap.add_argument("--only", choices=sorted(MODELS), default=None,
                    help="run the phases of one path only (all the "
                         "kernels are built either way)")
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
                    krows += run_model(key, tmp, plot_dir, smi, args.seed,
                                       args.profile, krows)
                emit({"phase": "model", "model": key,
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
        "case", "max_abs_plain", "launches_by_path", "device_ms",
        "plain_device_ms", "library_device_ms", "sub_kernels")}
        for r in krows]}
    RECORD.append({"total_seconds": time.perf_counter() - t_start})
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
