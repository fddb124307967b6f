"""Launchers for the hand-written Hopper kernels (sources in `csrc/`).

Each launcher checks device, dtype, shape and contiguity, allocates its
output with `torch.empty`, launches on the current stream, raises on a
refused launch, and adds one to its entry in `LAUNCHES`. They take CUDA
tensors only; the CPU path of each op is its plain PyTorch version in
`dpcr_agb_tpu_torch.ops`."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import build

LAUNCHES = {"stem_sites": 0, "max_pool_k3s2": 0, "stem_sites_dw": 0,
            "max_pool_k3s2_bwd": 0, "kpconv_fused": 0, "kpconv_fused_bwd": 0,
            "firewall_copy": 0, "max_pool_k3s2_bwd_vol": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INFLUENCE_CODE = {"linear": 0, "gaussian": 1, "constant": 2}


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


def stem_sites_dw(vol: torch.Tensor, coords: torch.Tensor, mask: torch.Tensor,
                  ct: torch.Tensor) -> torch.Tensor:
    """Weight gradient of `stem_sites`: vol [B,D,H,W,Cin], coords [B,V,3]
    int32, mask [B,V] bool, ct [B,V,64] of vol's dtype -> dW [343,Cin,64]
    float32, the sum over the masked-in sites of patch x ct (f32
    accumulation, f32 atomics: the order of the additions varies)."""
    if not vol.is_cuda:
        raise ValueError("stem_sites_dw takes CUDA tensors")
    dev, dt = vol.device, vol.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"stem_sites_dw: unsupported dtype {dt}")
    b, d, h, w, cin = vol.shape
    v = coords.shape[1]
    _require(vol, "vol", dt, 5, dev)
    _require(coords, "coords", torch.int32, 3, dev)
    _require(mask, "mask", torch.bool, 2, dev)
    _require(ct, "ct", dt, 3, dev)
    if coords.shape != (b, v, 3) or mask.shape != (b, v) \
            or ct.shape != (b, v, 64) or not 1 <= cin <= 18:
        raise ValueError(
            f"stem_sites_dw: shapes vol {tuple(vol.shape)}, coords "
            f"{tuple(coords.shape)}, mask {tuple(mask.shape)}, ct "
            f"{tuple(ct.shape)} (need ct [B,V,64] and 1 <= Cin <= 18)")
    dw = torch.zeros((343, cin, 64), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = build.entry("stem_dw")(
            _DTYPE_CODE[dt], vol.data_ptr(), coords.data_ptr(),
            mask.data_ptr(), ct.data_ptr(), dw.data_ptr(), b, d, h, w, v, cin,
            _stream(dev))
    _check_rc(rc, "stem_sites_dw")
    LAUNCHES["stem_sites_dw"] += 1
    return dw


def max_pool_k3s2_bwd(coords: torch.Tensor, mask: torch.Tensor,
                      h_rows: torch.Tensor, y: torch.Tensor,
                      occ_l: torch.Tensor, ct: torch.Tensor,
                      dims: Sequence[int]) -> torch.Tensor:
    """Row-form backward of the masked k3/s2 max pool: coords [B,V,3]
    int32, mask [B,V] bool, rows h_rows [B,V,C] scattered into the volume
    of `dims`, the pooled y, its occupancy occ_l [B,d1,h1,w1,1] and the
    cotangent ct [B,d1,h1,w1,C] (masked by occ_l inside the kernel) -> dx
    [B,V,C] in h_rows' dtype: each row gets the sum of ct over the parent
    cells whose y equals its value."""
    if not h_rows.is_cuda:
        raise ValueError("max_pool_k3s2_bwd takes CUDA tensors")
    dev, dt = h_rows.device, h_rows.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"max_pool_k3s2_bwd: unsupported dtype {dt}")
    b, v, c = h_rows.shape
    d, h, w = (int(n) for n in dims)
    l1 = (b, -(-d // 2), -(-h // 2), -(-w // 2))
    _require(coords, "coords", torch.int32, 3, dev)
    _require(mask, "mask", torch.bool, 2, dev)
    _require(h_rows, "h_rows", dt, 3, dev)
    for t, what in ((y, "y"), (occ_l, "occ_l"), (ct, "ct")):
        _require(t, what, dt, 5, dev)
    if coords.shape != (b, v, 3) or mask.shape != (b, v) \
            or y.shape != (*l1, c) or ct.shape != (*l1, c) \
            or occ_l.shape != (*l1, 1):
        raise ValueError(
            f"max_pool_k3s2_bwd: shapes coords {tuple(coords.shape)}, mask "
            f"{tuple(mask.shape)}, h_rows {tuple(h_rows.shape)}, y "
            f"{tuple(y.shape)}, occ_l {tuple(occ_l.shape)}, ct "
            f"{tuple(ct.shape)} for dims {tuple(dims)}")
    if any(t.data_ptr() % 16 for t in (h_rows, y, ct)) \
            or (c * h_rows.element_size()) % 16:
        raise ValueError("max_pool_k3s2_bwd: h_rows, y and ct must be "
                         "16-byte aligned with C a whole number of 16-byte "
                         "channel groups")
    dx = torch.empty_like(h_rows)
    with torch.cuda.device(dev):
        rc = build.entry("max_pool_bwd")(
            _DTYPE_CODE[dt], coords.data_ptr(), mask.data_ptr(),
            h_rows.data_ptr(), y.data_ptr(), occ_l.data_ptr(), ct.data_ptr(),
            dx.data_ptr(), b, v, d, h, w, c, _stream(dev))
    _check_rc(rc, "max_pool_k3s2_bwd")
    LAUNCHES["max_pool_k3s2_bwd"] += 1
    return dx


def max_pool_k3s2_bwd_vol(x: torch.Tensor, occ_in: torch.Tensor,
                          y: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """Volume-form backward of the masked k3/s2 max pool: x [B,D,H,W,C],
    its occupancy occ_in [B,D,H,W,1], the pooled y and the cotangent ct
    [B,d1,h1,w1,C] (zero at unoccupied outputs already), all of x's dtype
    -> dx [B,D,H,W,C]: each occupied input cell gets the f32 sum of ct over
    the covering outputs whose y equals its value, every other cell 0."""
    if not x.is_cuda:
        raise ValueError("max_pool_k3s2_bwd_vol takes CUDA tensors")
    dev, dt = x.device, x.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"max_pool_k3s2_bwd_vol: unsupported dtype {dt}")
    for t, what in ((x, "x"), (occ_in, "occ_in"), (y, "y"), (ct, "ct")):
        _require(t, what, dt, 5, dev)
    b, d, h, w, c = x.shape
    l1 = (b, -(-d // 2), -(-h // 2), -(-w // 2), c)
    if occ_in.shape != (b, d, h, w, 1) or y.shape != l1 or ct.shape != l1:
        raise ValueError(
            f"max_pool_k3s2_bwd_vol: shapes x {tuple(x.shape)}, occ_in "
            f"{tuple(occ_in.shape)}, y {tuple(y.shape)}, ct "
            f"{tuple(ct.shape)}")
    if any(t.data_ptr() % 16 for t in (x, y, ct)) \
            or (c * x.element_size()) % 16:
        raise ValueError("max_pool_k3s2_bwd_vol: x, y and ct must be 16-byte "
                         "aligned with C a whole number of 16-byte channel "
                         "groups")
    dx = torch.empty_like(x)
    with torch.cuda.device(dev):
        rc = build.entry("max_pool_bwd_vol")(
            _DTYPE_CODE[dt], x.data_ptr(), occ_in.data_ptr(), y.data_ptr(),
            ct.data_ptr(), dx.data_ptr(), b, d, h, w, c, _stream(dev))
    _check_rc(rc, "max_pool_k3s2_bwd_vol")
    LAUNCHES["max_pool_k3s2_bwd_vol"] += 1
    return dx


def firewall_copy(x: torch.Tensor) -> torch.Tensor:
    """A fresh tensor with x's values, contiguous in x's logical order,
    whatever x's strides: x of 1 to 5 dimensions and a 2- or 4-byte dtype.
    The kernel reads through the strides itself; nothing is made contiguous
    beforehand."""
    if not x.is_cuda:
        raise ValueError("firewall_copy takes CUDA tensors")
    if x.element_size() not in (2, 4) or x.is_complex():
        raise ValueError(f"firewall_copy: unsupported dtype {x.dtype} (2- "
                         f"and 4-byte element types)")
    if not 1 <= x.dim() <= 5:
        raise ValueError(f"firewall_copy: {x.dim()} dimensions (1 to 5)")
    if x.data_ptr() % x.element_size():
        raise ValueError("firewall_copy: x is not aligned to its element "
                         "size")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    pad = 5 - x.dim()
    sizes = [1] * pad + list(x.shape)
    strides = [0] * pad + list(x.stride())
    with torch.cuda.device(x.device):
        rc = build.entry("firewall_copy")(
            x.element_size(), x.data_ptr(), out.data_ptr(), *sizes, *strides,
            _stream(x.device))
    _check_rc(rc, "firewall_copy")
    LAUNCHES["firewall_copy"] += 1
    return out


def _kpconv_args(name: str, x, nbr, rel, weights, kernel_points,
                 influence: str, aggregation: str) -> tuple:
    """Checks the operands the two KPConv launchers share; returns
    (B, Nq, Ns, K, C, Cout, Kp)."""
    if not x.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors")
    dev, dt = x.device, x.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"{name}: unsupported dtype {dt}")
    if influence not in _INFLUENCE_CODE \
            or aggregation not in ("sum", "closest"):
        raise ValueError(f"{name}: influence {influence!r}, aggregation "
                         f"{aggregation!r}")
    _require(x, "x", dt, 3, dev)
    _require(nbr, "nbr", torch.int32, 3, dev)
    _require(rel, "rel", torch.float32, 4, dev)
    _require(weights, "weights", torch.float32, 3, dev)
    _require(kernel_points, "kernel_points", torch.float32, 2, dev)
    b, ns, c = x.shape
    nq, k = nbr.shape[1:]
    n_kp, cout = weights.shape[0], weights.shape[2]
    if nbr.shape[0] != b or rel.shape != (b, nq, k, 3) \
            or weights.shape[1] != c or kernel_points.shape != (n_kp, 3) \
            or not 1 <= cout <= 256 or ns < 1 or k < 1:
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)}, nbr {tuple(nbr.shape)}, rel "
            f"{tuple(rel.shape)}, weights {tuple(weights.shape)}, "
            f"kernel_points {tuple(kernel_points.shape)} (need Cout <= 256)")
    return b, nq, ns, k, c, cout, n_kp


def kpconv_fused(x: torch.Tensor, nbr: torch.Tensor, rel: torch.Tensor,
                 weights: torch.Tensor, kernel_points: torch.Tensor,
                 extent: float, influence: str = "linear",
                 aggregation: str = "sum") -> torch.Tensor:
    """Fused rigid KPConv forward: x [B,Ns,C] f32 or bf16 (the compute
    dtype), nbr [B,Nq,K] int32 (Ns = shadow), rel [B,Nq,K,3] f32, weights
    [Kp,C,Cout] f32, kernel_points [Kp,3] f32 -> [B,Nq,Cout] f32. The
    kernel gathers the rows of x itself and skips the shadow."""
    b, nq, ns, k, c, cout, n_kp = _kpconv_args(
        "kpconv_fused", x, nbr, rel, weights, kernel_points, influence,
        aggregation)
    out = torch.empty((b, nq, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = build.entry("kpconv_fwd")(
            _DTYPE_CODE[x.dtype], x.data_ptr(), nbr.data_ptr(),
            rel.data_ptr(), weights.data_ptr(), kernel_points.data_ptr(),
            out.data_ptr(), b, nq, ns, k, c, cout, n_kp, float(extent),
            _INFLUENCE_CODE[influence], int(aggregation == "closest"),
            _stream(x.device))
    _check_rc(rc, "kpconv_fused")
    LAUNCHES["kpconv_fused"] += 1
    return out


def kpconv_fused_bwd(x: torch.Tensor, nbr: torch.Tensor, rel: torch.Tensor,
                     weights: torch.Tensor, kernel_points: torch.Tensor,
                     g: torch.Tensor, extent: float,
                     influence: str = "linear", aggregation: str = "sum"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of `kpconv_fused` for the cotangent g [B,Nq,Cout] f32 ->
    (dx [B,Ns,C] f32, dW [Kp,C,Cout] f32), both summed with f32 atomics
    (the order of the additions varies). The shadow gets nothing."""
    b, nq, ns, k, c, cout, n_kp = _kpconv_args(
        "kpconv_fused_bwd", x, nbr, rel, weights, kernel_points, influence,
        aggregation)
    dev = x.device
    _require(g, "g", torch.float32, 3, dev)
    if g.shape != (b, nq, cout):
        raise ValueError(f"kpconv_fused_bwd: g {tuple(g.shape)} for an "
                         f"output {(b, nq, cout)}")
    dx = torch.zeros((b, ns, c), dtype=torch.float32, device=dev)
    dw = torch.zeros((n_kp, c, cout), dtype=torch.float32, device=dev)
    wt = torch.empty((n_kp, cout, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = build.entry("kpconv_bwd")(
            _DTYPE_CODE[x.dtype], x.data_ptr(), nbr.data_ptr(),
            rel.data_ptr(), weights.data_ptr(), kernel_points.data_ptr(),
            g.data_ptr(), wt.data_ptr(), dx.data_ptr(), dw.data_ptr(), b, nq,
            ns, k, c, cout, n_kp, float(extent), _INFLUENCE_CODE[influence],
            int(aggregation == "closest"), _stream(dev))
    _check_rc(rc, "kpconv_fused_bwd")
    LAUNCHES["kpconv_fused_bwd"] += 1
    return dx, dw
