"""Launchers for the hand-written Hopper kernels (sources in `csrc/`).

Each launcher checks device, dtype, shape and contiguity, allocates its
output with `torch.empty`, launches on the current stream, raises on a
refused launch, and adds one to its entry in `LAUNCHES`. They take CUDA
tensors only; the CPU path of each op is its plain PyTorch version in
`dpcr_agb_tpu_torch.ops`."""
from __future__ import annotations

from typing import Optional

import torch

from . import build

LAUNCHES = {"stem_sites": 0, "max_pool_k3s2": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _require(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int,
             device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or t.dim() != ndim \
            or not t.is_contiguous():
        raise ValueError(
            f"{what}: expected a contiguous {ndim}-d {dtype} tensor on "
            f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        why = {-1: "unsupported dtype", -2: "unsupported shape"}.get(
            rc, f"CUDA error {rc}")
        raise RuntimeError(f"{name} kernel launch failed: {why}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def stem_sites(vol: torch.Tensor, coords: torch.Tensor, mask: torch.Tensor,
               weights: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k=7 stem conv at the sites: vol [B,D,H,W,Cin], coords [B,V,3] int32,
    mask [B,V] bool, weights [343,Cin,Cout] (z-fastest offsets), bias
    [Cout] -> [B,V,Cout] in vol's dtype (f32 accumulation)."""
    if not vol.is_cuda:
        raise ValueError("stem_sites takes CUDA tensors")
    dev, dt = vol.device, vol.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"stem_sites: unsupported dtype {dt}")
    b, d, h, w, cin = vol.shape
    v = coords.shape[1]
    _require(vol, "vol", dt, 5, dev)
    _require(coords, "coords", torch.int32, 3, dev)
    _require(mask, "mask", torch.bool, 2, dev)
    _require(weights, "weights", dt, 3, dev)
    if coords.shape != (b, v, 3) or mask.shape != (b, v) \
            or weights.shape[:2] != (343, cin) \
            or weights.shape[2] != 64:
        raise ValueError(
            f"stem_sites: shapes vol {tuple(vol.shape)}, coords "
            f"{tuple(coords.shape)}, mask {tuple(mask.shape)}, weights "
            f"{tuple(weights.shape)} (need [343,Cin,64])")
    cout = weights.shape[2]
    if bias is not None:
        _require(bias, "bias", dt, 1, dev)
        if bias.shape != (cout,):
            raise ValueError(f"stem_sites: bias {tuple(bias.shape)}")
    out = torch.empty((b, v, cout), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        rc = build.entry("stem_sites")(
            _DTYPE_CODE[dt], vol.data_ptr(), coords.data_ptr(),
            mask.data_ptr(), weights.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, d, h, w, v, cin, cout, _stream(dev))
    _check_rc(rc, "stem_sites")
    LAUNCHES["stem_sites"] += 1
    return out


def max_pool_k3s2(x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """Masked k3/s2 max pool: x [B,D,H,W,C], occ [B,D,H,W,1] (>0 =
    occupied) of x's dtype -> [B,ceil(D/2),ceil(H/2),ceil(W/2),C], zero
    where no child cell is occupied."""
    if not x.is_cuda:
        raise ValueError("max_pool_k3s2 takes CUDA tensors")
    dev, dt = x.device, x.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"max_pool_k3s2: unsupported dtype {dt}")
    _require(x, "x", dt, 5, dev)
    _require(occ, "occ", dt, 5, dev)
    b, d, h, w, c = x.shape
    if occ.shape != (b, d, h, w, 1):
        raise ValueError(f"max_pool_k3s2: occ {tuple(occ.shape)} for x "
                         f"{tuple(x.shape)}")
    if x.data_ptr() % 16 or (c * x.element_size()) % 16:
        raise ValueError("max_pool_k3s2: x must be 16-byte aligned with C a "
                         "whole number of 16-byte channel groups")
    y = torch.empty((b, -(-d // 2), -(-h // 2), -(-w // 2), c), dtype=dt,
                    device=dev)
    with torch.cuda.device(dev):
        rc = build.entry("max_pool")(
            _DTYPE_CODE[dt], x.data_ptr(), occ.data_ptr(), y.data_ptr(),
            b, d, h, w, c, _stream(dev))
    _check_rc(rc, "max_pool_k3s2")
    LAUNCHES["max_pool_k3s2"] += 1
    return y
