#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dpcr_agb_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--profile] [--out FILE]

Phases, each printing one JSON line; any failure exits non-zero:
  device   the card's name and power limit; builds the CUDA kernels from
           dpcr_agb_tpu_torch/kernels/csrc for sm_90a (build seconds)
  kernels  in f32 and bf16: stem_sites and max_pool_k3s2 at the first
           serving batch's shapes, stem_sites_dw and max_pool_k3s2_bwd at
           the first train batch's shapes; each held against its plain
           PyTorch version (stated tolerances), timed with CUDA events
           (median of 20 after warm-up) beside the plain version and one
           PyTorch call of the same function where there is one (cuDNN
           conv3d, its weight gradient, max_pool3d and its backward: time
           yardsticks the port never calls), and the least time the card
           could take (bound_ms, from what this run's data needs)
  serve    full-width SENet14 (f32, then the bf16 flagship): 16 synthetic
           plots dense enough that MaxPoints 16000 binds (V bucket 16384)
           served by `dpcr_agb_tpu_torch.predict.main` from a port
           checkpoint with seeded random weights; checks 16 finite
           prediction rows, that both forward kernels launched during that
           run, and that the raw outputs equal a run through the plain
           versions (f32: rtol 1e-3 with TF32 off); prints plots/s
  train    full-width SENet14 (f32 with TF32 off, then bf16) trained by
           `dpcr_agb_tpu_torch.train.main` for 6 steps at bs16 on the same
           plots and their targets: 6 finite losses, all four kernels
           launched in every step; one step from one state through the
           kernels and through the plain versions (loss, every gradient,
           the updated parameters and BN running stats within stated
           tolerances); train_step_ms (median of 5 steps on a device-
           resident batch), plots/s and peak memory; then `predict.main`
           serves the trained checkpoint (16 finite rows)
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

SENET14 = {  # conf/models/instance/minkowski_baseline.yaml: SENet14
    "class": "minkowski.MinkowskiBaselineModel", "conv_type": "SPARSE",
    "model_name": "SENet14", "D": 3, "activation": "gelu",
    "first_stride": 1, "dropout": 0.0, "drop_path": 0.01,
    "global_pool": "sum"}
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
N_PLOTS = 16     # one serving batch of bench.py's size, the train batch
DENSITY = 60.0   # points per m^2: MaxPoints 16000 binds, V bucket 16384
TRAIN_STEPS = 6
# the kernels serving launches; training launches these and the backward
# kernels
FORWARD_KERNELS = ("stem_sites", "max_pool_k3s2")
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

RECORD = []


def model_options() -> dict:
    """SENet14 at f32 and the bf16 flagship (extra_options.bf16)."""
    return {"float32": dict(SENET14),
            "bfloat16": {**SENET14, "extra_options": {"bf16": True}}}


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


@contextlib.contextmanager
def plain_ops():
    """Route the model's four kernel ops (two forward, two backward) to
    their plain PyTorch versions (the reference runs of the serve and
    train phases); raises if a kernel launched inside, i.e. if the
    reference did not really take the plain path."""
    from dpcr_agb_tpu_torch import kernels
    from dpcr_agb_tpu_torch.ops import pool, sparse_stem
    saved = (sparse_stem.stem_conv_sites, sparse_stem.stem_conv_sites_dw,
             pool.masked_max_pool, pool.masked_max_pool_bwd_rows)
    sparse_stem.stem_conv_sites = sparse_stem.stem_conv_sites_plain
    sparse_stem.stem_conv_sites_dw = sparse_stem.stem_conv_sites_dw_plain
    pool.masked_max_pool = pool.masked_max_pool_plain
    pool.masked_max_pool_bwd_rows = pool.masked_max_pool_bwd_rows_plain
    before = dict(kernels.LAUNCHES)
    try:
        yield
    finally:
        (sparse_stem.stem_conv_sites, sparse_stem.stem_conv_sites_dw,
         pool.masked_max_pool, pool.masked_max_pool_bwd_rows) = saved
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


def make_checkpoint(root: str, name: str, option: dict, seed: int) -> str:
    """A port checkpoint of SENet14 with seeded random weights and BN
    running stats drawn from the same generator."""
    import torch
    from dpcr_agb_tpu_torch.models.factory import build_model
    from dpcr_agb_tpu_torch.serving import (nfi_sparse_xy_data_cfg,
                                            save_checkpoint)
    g = torch.Generator().manual_seed(seed)
    net, _ = build_model(option, 2, 3, generator=g)
    with torch.no_grad():
        for key, buf in net.named_buffers():
            if key.endswith(".mean"):
                buf.normal_(0.0, 0.1, generator=g)
            else:
                buf.uniform_(0.5, 1.5, generator=g)
    ckpt = os.path.join(root, name)
    save_checkpoint(ckpt, "SENet14", net, option, 3, nfi_sparse_xy_data_cfg(),
                    {"scale": [60.0, 120.0], "center": [150.0, 300.0],
                     "weights": [0.5, 0.5]}, ["BMag_ha", "V_ha"])
    return ckpt


def phase_device() -> dict:
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
    from dpcr_agb_tpu_torch.ops.pool import (masked_max_pool,
                                             masked_max_pool_plain)
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
                "launches": None, "max_abs_err": err, "tolerance": tol,
                "ms": ms, "plain_ms": plain_ms,
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
            got_p = masked_max_pool(x, occ)
            want_p = masked_max_pool_plain(x, occ)
            torch.cuda.synchronize()
            err_p = _check_close(f"max_pool_k3s2 {dtname}", got_p, want_p,
                                 0.0, 0.0)
            ms_p = time_ms(lambda: masked_max_pool(x, occ))
            plain_ms_p = time_ms(lambda: masked_max_pool_plain(x, occ))
            filled = torch.where(occ > 0, x, torch.full((), float("-inf"),
                                                        dtype=dt,
                                                        device=x.device))
            ncdhw = filled.permute(0, 4, 1, 2, 3).contiguous()
            del filled
            lib_ms = time_ms(lambda: F.max_pool3d(ncdhw, 3, 2, 1))
            del ncdhw
            # what this data needs: the occupancy, x at the occupied cells
            # (the rest counts as -inf), all of y; one max per occupied
            # input value in each window that holds it
            n_occ, in_windows = pool_work(occ)
            esz = x.element_size()
            nbytes = (occ.numel() + n_occ * x.shape[-1] + got_p.numel()) * esz
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = (float(in_windows) * x.shape[-1]
                     / PEAK_FLOPS["float32"] * 1e3)
            rows.append({
                "name": "max_pool_k3s2", "dtype": dtname, "route": "cuda",
                "source": POOL_SRC, "replaces": POOL_REPLACES,
                "launches": None, "max_abs_err": err_p, "tolerance": "exact",
                "ms": ms_p, "plain_ms": plain_ms_p,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes > t_ops else "operations",
                "library_ms": lib_ms,
                "library": "F.max_pool3d k3 s2 p1 on the -inf-filled NCDHW "
                           "volume",
                "shape": {"x": list(x.shape), "y": list(got_p.shape),
                          "occupied_cells": n_occ,
                          "occupied_inputs_in_windows": in_windows,
                          "needed_bytes": nbytes},
                "card": smi})
            del x, occ, got_p, want_p, vol, got, want, h_rows
            torch.cuda.empty_cache()
            rows += backward_kernel_rows(net, train_batch.to(bundle.device),
                                         dtname, smi, seed)
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
        # f32 sums in both; the kernel's f32 atomics add in a varying order
        scale = want.abs().max().item()
        err = _check_close(f"stem_sites_dw {dtname}", got, want, 1e-4,
                           2e-5 * scale)
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
            "max_abs_err": err,
            "tolerance": "rtol 1e-4, atol 2e-5 * max|plain| (f32 atomics)",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
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
            "launches": None, "max_abs_err": err_p, "tolerance": "exact",
            "ms": ms_p, "plain_ms": plain_ms_p,
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


def phase_serve(dtname: str, ckpt: str, plot_dir: str, out_dir: str,
                smi: str, with_profile: bool = False) -> dict:
    import torch
    from dpcr_agb_tpu_torch import kernels, predict
    out_csv = os.path.join(out_dir, f"preds_{dtname}.csv")
    args = [f"checkpoint_dir={ckpt}", "model_name=SENet14",
            f"input={plot_dir}/*.npz", f"output={out_csv}",
            f"batch_size={N_PLOTS}"]
    kernels.reset_launches()
    t0 = time.perf_counter()
    predict.main(args)
    torch.cuda.synchronize()
    main_seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if min(launches["stem_sites"], launches["max_pool_k3s2"]) < 1:
        raise AssertionError(f"serve {dtname}: a kernel was not launched on "
                             f"the main path: {launches}")
    check_predictions(out_csv, f"serve {dtname}")

    # the same batch through the kernels and through the plain versions
    bundle = predict.load_serving_bundle(ckpt, "SENet14")
    files = sorted(glob.glob(os.path.join(plot_dir, "*.npz")))
    samples, _ = predict.load_samples(bundle, files)
    (batch, _), = predict.make_batches(bundle, samples, N_PLOTS)
    raw = predict.forward_raw(bundle, batch).float()
    with plain_ops():
        raw_plain = predict.forward_raw(bundle, batch).float()
    torch.cuda.synchronize()
    if dtname == "float32":
        err = _check_close("serve f32 raw output", raw, raw_plain, 1e-3,
                           1e-3 * raw_plain.abs().max().item())
        tol = "rtol 1e-3, atol 1e-3 * max|plain| (TF32 off)"
    else:
        err = _check_close("serve bf16 raw output", raw, raw_plain, 0.0,
                           5e-2 * raw_plain.abs().max().item())
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
    profile = device_profile(lambda: predict.forward_raw(bundle, batch)) \
        if with_profile else None
    torch.cuda.reset_peak_memory_stats()
    predict.forward_raw(bundle, batch)
    torch.cuda.synchronize()
    out = {"phase": "serve", "dtype": dtname, "plots": N_PLOTS,
           "v_bucket": int(batch.coords.shape[1]),
           "zb": int(len(batch.aux["zcells"])),
           "dims": list(bundle.net.level0_dims(batch)),
           "occupied_voxels": int(np.asarray(batch.mask).sum()),
           "launches": launches, "predict_main_seconds": main_seconds,
           "raw_max_abs_err_vs_plain": err, "tolerance": tol,
           "forward_ms": fwd * 1e3, "plots_per_s": N_PLOTS / fwd,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                    "matmul": torch.backends.cuda.matmul.allow_tf32},
           "profile": profile, "card": smi}
    emit(out)
    return out


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


def compare_train_steps(run, batch, dtname: str) -> dict:
    """One train step on one device batch from one state, through the
    kernels (run.runner) and through the plain versions (a copy of the
    runner); the errors of the kernel path against the plain one."""
    import copy
    import torch
    from dpcr_agb_tpu_torch import train
    plain = train.build_runner(copy.deepcopy(run.runner.net), run.stats,
                               seed=0)
    plain.generator.set_state(run.runner.generator.get_state())
    before = {n: p.detach().clone()
              for n, p in plain.net.named_parameters()}
    out_k = run.runner.train(batch)
    with plain_ops():
        out_p = plain.train(batch)
    torch.cuda.synchronize()
    lk, lp = float(out_k["loss"]), float(out_p["loss"])
    pk = dict(run.runner.net.named_parameters())
    pp = dict(plain.net.named_parameters())
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
    bk = dict(run.runner.net.named_buffers())
    stat = {n: _rel(bk[n], b) for n, b in plain.net.named_buffers()}
    errs = {"loss": abs(lk - lp) / max(abs(lp), 1e-30),
            "grads": _rel(flat(pk[n].grad for n in names), flat_p),
            "grad": max(grad.values()),
            "params": _rel(flat(pk[n].detach() for n in names),
                           flat(pp[n].detach() for n in names)),
            "update": max(update.values()), "stat": max(stat.values())}
    tol = STEP_TOL[dtname]
    bad = {k: v for k, v in errs.items() if not v <= tol[k]}
    if bad or not np.isfinite(lk):
        worst = sorted(grad.items(), key=lambda kv: -kv[1])[:3]
        raise AssertionError(f"train {dtname}: kernel step vs plain step "
                             f"out of tolerance {tol}: {errs}; loss {lk} vs "
                             f"{lp}; worst gradients {worst}")
    return {"loss_kernel": lk, "loss_plain": lp, "errors": errs,
            "worst_grads": sorted(grad.items(), key=lambda kv: -kv[1])[:3],
            "tolerance": tol}


def phase_train(dtname: str, plot_dir: str, out_dir: str, smi: str,
                seed: int, with_profile: bool = False) -> dict:
    import torch
    from dpcr_agb_tpu_torch import kernels, predict, train
    from dpcr_agb_tpu_torch.training.step import StepRunner
    bf16 = dtname == "bfloat16"
    ckpt = os.path.join(out_dir, f"trained_{dtname}")
    args = [f"input={plot_dir}/*.npz", f"checkpoint_dir={ckpt}",
            f"steps={TRAIN_STEPS}", f"batch_size={N_PLOTS}", f"seed={seed}",
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
        result = train.main(args)
        torch.cuda.synchronize()
        main_seconds = time.perf_counter() - t0
    finally:
        StepRunner.train = unwrapped
    launches = dict(kernels.LAUNCHES)
    losses = result["losses"]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"train {dtname}: losses {losses}")
    if len(per_step) != TRAIN_STEPS \
            or min(min(s.values()) for s in per_step) < 1:
        raise AssertionError(f"train {dtname}: a kernel was not launched in "
                             f"every step: {per_step}")

    # one step from one state through the kernels and the plain versions
    files = sorted(glob.glob(os.path.join(plot_dir, "*.npz")))
    run = train.setup(files, bf16=bf16, batch_size=N_PLOTS, seed=seed)
    batch = run.stream.next().to(run.runner.device)
    compared = compare_train_steps(run, batch, dtname)

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
    torch.cuda.reset_peak_memory_stats()
    runner.train(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    profile = device_profile(lambda: runner.train(batch)) \
        if with_profile else None
    del run, runner
    torch.cuda.empty_cache()

    out_csv = os.path.join(out_dir, f"preds_trained_{dtname}.csv")
    predict.main([f"checkpoint_dir={ckpt}", "model_name=SENet14",
                  f"input={plot_dir}/*.npz", f"output={out_csv}",
                  f"batch_size={N_PLOTS}"])
    check_predictions(out_csv, f"train {dtname}: serving the checkpoint")
    out = {"phase": "train", "dtype": dtname, "plots": N_PLOTS,
           "steps": TRAIN_STEPS, "losses": losses, "launches": launches,
           "launches_per_step": per_step,
           "train_main_seconds": main_seconds,
           "v_bucket": int(batch.coords.shape[1]),
           "zb": int(len(batch.aux["zcells"])),
           "occupied_voxels": int(batch.mask.sum()),
           "kernel_vs_plain_step": compared,
           "train_step_ms": step_s * 1e3, "plots_per_s": N_PLOTS / step_s,
           "peak_mem_gb": peak, "served_trained_checkpoint": N_PLOTS,
           "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                    "matmul": torch.backends.cuda.matmul.allow_tf32},
           "profile": profile, "card": smi}
    emit(out)
    return out


def device_profile(fn, reps: int = 3) -> dict:
    """torch.profiler over `reps` calls: device time by kernel (top 12) and
    the device's busy share of the wall time."""
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
    return {"reps": reps, "wall_ms_per_rep": wall_us / reps / 1e3,
            "device_busy_ms_per_rep": busy_us / reps / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
            "top": [{"name": e.key[:90],
                     "ms_per_rep": e.self_device_time_total / reps / 1e3,
                     "calls_per_rep": e.count / reps} for e in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of the serving "
                         "forward and of the train step")
    ap.add_argument("--out", default=None,
                    help="also write every phase's JSON to this file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from dpcr_agb_tpu_torch import predict, train
        from dpcr_agb_tpu_torch.kernels import LAUNCHES  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the dpcr_agb_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t_start = time.perf_counter()
    dev = phase_device()
    smi = dev["nvidia_smi"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        plot_dir = os.path.join(tmp, "plots")
        write_plots(plot_dir, N_PLOTS, args.seed, DENSITY)
        ckpts = {k: make_checkpoint(tmp, f"ckpt_{k}", o, args.seed)
                 for k, o in model_options().items()}
        bundles = {k: predict.load_serving_bundle(c, "SENet14")
                   for k, c in ckpts.items()}
        files = sorted(glob.glob(os.path.join(plot_dir, "*.npz")))
        samples, _ = predict.load_samples(bundles["float32"], files)
        (batch, _), = predict.make_batches(bundles["float32"], samples,
                                           N_PLOTS)
        emit({"phase": "data", "plots": N_PLOTS,
              "v_bucket": int(batch.coords.shape[1]),
              "zb": int(len(batch.aux["zcells"])),
              "raw_points_per_plot": [int(np.load(f)["pos"].shape[0])
                                      for f in files],
              "voxels_per_plot": [int(s["pos"].shape[0]) for s in samples],
              "occupied_voxels": int(np.asarray(batch.mask).sum())})
        # the first batch that train.main draws from these plots
        train_batch = train.setup(files, batch_size=N_PLOTS,
                                  seed=args.seed).stream.next()
        emit({"phase": "data", "train_batch": True,
              "v_bucket": int(train_batch.coords.shape[1]),
              "zb": int(len(train_batch.aux["zcells"])),
              "occupied_voxels": int(np.asarray(train_batch.mask).sum())})
        krows = phase_kernels(bundles, batch, train_batch, smi, args.seed)
        del bundles
        torch.cuda.empty_cache()
        # each kernel row reads its launches from the path it serves
        for dtname, ckpt in ckpts.items():
            s = phase_serve(dtname, ckpt, plot_dir, tmp, smi, args.profile)
            for r in krows:
                if r["dtype"] == dtname and r["name"] in FORWARD_KERNELS:
                    r["launches"] = s["launches"][r["name"]]
            torch.cuda.empty_cache()
        for dtname in ckpts:
            t = phase_train(dtname, plot_dir, tmp, smi, args.seed,
                            args.profile)
            for r in krows:
                if r["dtype"] == dtname and r["name"] not in FORWARD_KERNELS:
                    r["launches"] = t["launches"][r["name"]]
            torch.cuda.empty_cache()
    summary = {"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "dtype")}
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
