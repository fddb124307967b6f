#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dpcr_agb_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--profile] [--out FILE]

Phases, each printing one JSON line; any failure exits non-zero:
  device   the card's name and power limit; builds the CUDA kernels from
           dpcr_agb_tpu_torch/kernels/csrc for sm_90a (build seconds)
  kernels  stem_sites and max_pool_k3s2 at the main path's shapes (the
           first serving batch), in f32 and bf16: each held against its
           plain PyTorch version (stated tolerances), timed with CUDA events
           (median of 20 after warm-up) beside the plain version, the pool
           beside one F.max_pool3d call (a yardstick the port never calls),
           and the least time the card could take (bound_ms)
  serve    full-width SENet14 (f32, then the bf16 flagship): 16 synthetic
           plots dense enough that MaxPoints 16000 binds (V bucket 16384)
           served by `dpcr_agb_tpu_torch.predict.main` from a port
           checkpoint with seeded random weights; checks 16 finite
           prediction rows, that both kernels launched during that run, and
           that the raw outputs equal a run through the plain versions
           (f32: rtol 1e-3 with TF32 off); prints plots/s of the forward
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
STEM_REPLACES = "dpcr_agb_tpu/ops/pallas_stem.py:216"
POOL_REPLACES = "dpcr_agb_tpu/ops/pallas_pool.py:213"
N_PLOTS = 16     # one serving batch of bench.py's size
DENSITY = 60.0   # points per m^2: MaxPoints 16000 binds, V bucket 16384

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
    """Route the model's two kernel ops to their plain PyTorch versions
    (the reference run of the serve phase); raises if a kernel launched
    inside, i.e. if the reference did not really take the plain path."""
    from dpcr_agb_tpu_torch import kernels
    from dpcr_agb_tpu_torch.ops import pool, sparse_stem
    saved = (sparse_stem.stem_conv_sites, pool.masked_max_pool)
    sparse_stem.stem_conv_sites = sparse_stem.stem_conv_sites_plain
    pool.masked_max_pool = pool.masked_max_pool_plain
    before = dict(kernels.LAUNCHES)
    try:
        yield
    finally:
        sparse_stem.stem_conv_sites, pool.masked_max_pool = saved
    if kernels.LAUNCHES != before:
        raise AssertionError(f"the plain reference run launched kernels: "
                             f"{before} -> {kernels.LAUNCHES}")


def write_plots(root: str, n: int, seed: int, density: float) -> list:
    from dpcr_agb_tpu_torch.data.synthetic import generate_plot
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    files = []
    for i in range(n):
        pts, _, _ = generate_plot(rng, density=density)
        world = pts + np.array([5.1e5, 6.05e6, 150.0], np.float32)
        path = os.path.join(root, f"plot_{i:03d}.npz")
        np.savez(path, pos=world)
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


def phase_kernels(bundles: dict, batch, smi: str) -> list:
    """Both kernels at the first serving batch's shapes, f32 and bf16."""
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
                "library_ms": None,
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
                "shape": {"x": list(x.shape), "y": list(got_p.shape),
                          "occupied_cells": n_occ,
                          "occupied_inputs_in_windows": in_windows,
                          "needed_bytes": nbytes},
                "card": smi})
            del x, occ, got_p, want_p, vol, got, want, h_rows
            torch.cuda.empty_cache()
    for r in rows:
        emit({"phase": "kernels", **r})
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
    if min(launches.values()) < 1:
        raise AssertionError(f"serve {dtname}: a kernel was not launched on "
                             f"the main path: {launches}")
    with open(out_csv) as f:
        rows = list(csv.reader(f))[1:]
    preds = np.array([[float(v) for v in r[1:]] for r in rows])
    if preds.shape != (N_PLOTS, 2) or not np.isfinite(preds).all():
        raise AssertionError(f"serve {dtname}: predictions {preds.shape}, "
                             f"finite={np.isfinite(preds).all()}")

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
    # same time again
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
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
                    help="add a torch.profiler breakdown of the forward")
    ap.add_argument("--out", default=None,
                    help="also write every phase's JSON to this file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from dpcr_agb_tpu_torch import predict
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
        krows = phase_kernels(bundles, batch, smi)
        del bundles
        torch.cuda.empty_cache()
        for dtname, ckpt in ckpts.items():
            s = phase_serve(dtname, ckpt, plot_dir, tmp, smi, args.profile)
            for r in krows:
                if r["dtype"] == dtname:
                    r["launches"] = s["launches"][r["name"]]
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
