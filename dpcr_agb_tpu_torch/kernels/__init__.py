"""Launchers for the hand-written Hopper kernels (sources in `csrc/`).

Each launcher checks device, dtype, shape and contiguity, allocates its
output with `torch.empty`, launches on the current stream, raises on a
refused launch, and adds one to its entry in `LAUNCHES`. They take CUDA
tensors only; the CPU path of each op is its plain PyTorch version in
`dpcr_agb_tpu_torch.ops`."""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Tuple

import torch

from . import build

LAUNCHES = {"stem_sites": 0, "max_pool_k3s2": 0, "stem_sites_dw": 0,
            "max_pool_k3s2_bwd": 0, "kpconv_fused": 0, "kpconv_fused_bwd": 0,
            "firewall_copy": 0, "max_pool_k3s2_bwd_vol": 0,
            "gather_rows_bwd": 0, "max_pool_k3s2_rows": 0, "fps": 0}

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


def _on_device(device: torch.device, fn, *args) -> int:
    """fn(*args, stream) with `device` current: the device context is
    entered only when another device is current (a launch goes to the
    current device)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return fn(*args, _stream(device))
    with torch.cuda.device(device):
        return fn(*args, _stream(device))


SMEM_PER_BLOCK = 232448     # bytes of shared memory a block may use (H100)
H100_SMS = 132
STEM_MAX_CIN = 4            # stem_sites keeps W in shared memory
STEM_LIST_CAP = 344         # a site's tap list (uint16, csrc/stem_sites.cu)
STEM_STAGE = 32             # neighbours a site stages at a time (16 or 32 B)
STEM_MAX_WARPS = 20         # a stem_sites block's warps, 4 sites each


def stem_sites_plan(b: int, d: int, h: int, w: int, v: int, cin: int,
                    bf16: bool, sms: int = H100_SMS) -> dict:
    """How `stem_sites` cuts its work (pure: shapes in, numbers out): W's
    share in shared memory, 32 words a (tap, input channel), which in f32
    is 32 of the 64 output channels (`parts` 2, each with its own blocks)
    and in bf16 all of them (`parts` 1); as many warps a block (at most 20,
    4 sites each) as the sites' staged neighbours (32 a site, 16 bytes
    each, 32 at Cin 4) and tap lists leave room for; one block an SM in
    all, never more blocks than the B*V sites fill; the occupancy bits'
    scratch (one int32 a 32 z-cells of a column). Raises for Cin outside
    1..4."""
    if not 1 <= cin <= STEM_MAX_CIN:
        raise ValueError(f"stem_sites: Cin {cin} (the kernel keeps W in "
                         f"shared memory: 1 <= Cin <= {STEM_MAX_CIN})")
    parts = 1 if bf16 else 2
    w_bytes = 343 * cin * 32 * 4
    per_warp = 4 * (STEM_STAGE * (16 if cin <= 3 else 32)
                    + STEM_LIST_CAP * 2)
    warps = min(STEM_MAX_WARPS, (SMEM_PER_BLOCK - w_bytes) // per_warp)
    blocks = max(1, min(sms // parts, -(-b * v // (4 * warps)), 65535))
    words = b * d * h * -(-w // 32)
    return {"parts": parts, "warps": warps, "blocks": blocks,
            "grid": (blocks, parts),
            "smem_bytes": w_bytes + warps * per_warp,
            "scratch_bytes": {"bits": 4 * words}}


def stem_sites(vol: torch.Tensor, coords: torch.Tensor, mask: torch.Tensor,
               weights: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k=7 stem conv at the sites: vol [B,D,H,W,Cin] (1 <= Cin <= 4),
    coords [B,V,3] int32, mask [B,V] bool, weights [343,Cin,64] (z-fastest
    offsets), bias [64] -> [B,V,64] in vol's dtype (f32 sums in tap order:
    the same bits from call to call)."""
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
    plan = stem_sites_plan(b, d, h, w, v, cin, dt == torch.bfloat16,
                           _sm_count(dev))
    bits = torch.empty(plan["scratch_bytes"]["bits"] // 4, dtype=torch.int32,
                       device=dev)
    out = torch.empty((b, v, cout), dtype=dt, device=dev)
    rc = _on_device(dev, build.entry("stem_sites"), _DTYPE_CODE[dt],
                    vol.data_ptr(), bits.data_ptr(), coords.data_ptr(),
                    mask.data_ptr(), weights.data_ptr(),
                    None if bias is None else bias.data_ptr(), out.data_ptr(),
                    b, d, h, w, v, cin, cout, plan["warps"], plan["blocks"])
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
    rc = _on_device(dev, build.entry("max_pool"), _DTYPE_CODE[dt],
                    x.data_ptr(), occ.data_ptr(), y.data_ptr(), b, d, h, w,
                    c)
    _check_rc(rc, "max_pool_k3s2")
    LAUNCHES["max_pool_k3s2"] += 1
    return y


def max_pool_k3s2_rows(coords: torch.Tensor, mask: torch.Tensor,
                       h_rows: torch.Tensor, dims: Sequence[int]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row form of the masked k3/s2 max pool: coords [B,V,3] int32, mask
    [B,V] bool, rows h_rows [B,V,C] in the volume of `dims` -> (y
    [B,d1,h1,w1,C], its occupancy occ_l [B,d1,h1,w1,1], both in h_rows'
    dtype): what scattering the rows into the volume (masked and
    out-of-volume rows dropped, duplicate cells summed), occupancy_pool and
    `max_pool_k3s2` give, with no C-wide volume. The kernel keeps an int32
    cell -> row index volume [B,D,H,W] (never cleared), an occupancy bit a
    cell and a slot a duplicated cell in scratch."""
    if not h_rows.is_cuda:
        raise ValueError("max_pool_k3s2_rows takes CUDA tensors")
    dev, dt = h_rows.device, h_rows.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"max_pool_k3s2_rows: unsupported dtype {dt}")
    _require(coords, "coords", torch.int32, 3, dev)
    _require(mask, "mask", torch.bool, 2, dev)
    _require(h_rows, "h_rows", dt, 3, dev)
    b, v, c = h_rows.shape
    d, h, w = (int(n) for n in dims)
    if coords.shape != (b, v, 3) or mask.shape != (b, v):
        raise ValueError(
            f"max_pool_k3s2_rows: shapes coords {tuple(coords.shape)}, mask "
            f"{tuple(mask.shape)}, h_rows {tuple(h_rows.shape)}")
    if h_rows.data_ptr() % 16 or (c * h_rows.element_size()) % 16:
        raise ValueError("max_pool_k3s2_rows: h_rows must be 16-byte aligned "
                         "with C a whole number of 16-byte channel groups")
    l1 = (b, -(-d // 2), -(-h // 2), -(-w // 2))
    y = torch.empty((*l1, c), dtype=dt, device=dev)
    occ_l = torch.empty((*l1, 1), dtype=dt, device=dev)
    slots = max(1, -(-b * v // 2))      # a duplicated cell holds 2 rows+
    bit_words = b * d * h * -(-w // 32)
    scratch = torch.empty(b * d * h * w + bit_words + 1 + 2 * slots,
                          dtype=torch.int32, device=dev)
    merged = torch.empty((slots, c), dtype=dt, device=dev)
    rc = _on_device(dev, build.entry("max_pool_rows"), _DTYPE_CODE[dt],
                    coords.data_ptr(), mask.data_ptr(), h_rows.data_ptr(),
                    scratch.data_ptr(), merged.data_ptr(), y.data_ptr(),
                    occ_l.data_ptr(), b, v, d, h, w, c, slots)
    _check_rc(rc, "max_pool_k3s2_rows")
    LAUNCHES["max_pool_k3s2_rows"] += 1
    return y, occ_l


STEM_DW_TILE_ROWS = 64      # rows of dW [343*Cin, 64] of a stem_sites_dw block


def _gemm_smem(bm: int, bn: int, bf16: bool) -> int:
    """Shared memory of a BlockGemm tile (csrc/gemm.cuh): bf16 [m][k] and
    [n][k] tiles of depth 32, rows padded by 8 values; f32 [k][m] and
    [k][n] of depth 16, rows padded by 4."""
    return (bm + bn) * (32 + 8) * 2 if bf16 else 16 * (bm + bn + 8) * 4


def stem_dw_plan(b: int, v: int, cin: int, bf16: bool,
                 sms: int = H100_SMS) -> dict:
    """How `stem_sites_dw` cuts its work (pure: shapes in, numbers out): dW
    [343*Cin, 64] in tiles of 64 rows, the B*V sites in `splits` ranges of
    equal length (about four blocks an SM in all, never more ranges than
    windows of 256 sites; from the card, not from the batch's occupancy),
    the block's shared memory and the partials' scratch in bytes."""
    sites = b * v
    m_tiles = -(-343 * cin // STEM_DW_TILE_ROWS)
    splits = max(1, min(-(-sites // 256), 4 * sms // m_tiles, 65535))
    return {"m_tiles": m_tiles, "splits": splits,
            "grid": (m_tiles, splits),
            "sites_per_split": -(-sites // splits),
            "smem_bytes": _gemm_smem(STEM_DW_TILE_ROWS, 64, bf16)
            + 256 * 4 + 256 * 16 + 8 * 4,
            "scratch_bytes": {"partial": splits * 343 * cin * 64 * 4}}


def stem_sites_dw(vol: torch.Tensor, coords: torch.Tensor, mask: torch.Tensor,
                  ct: torch.Tensor) -> torch.Tensor:
    """Weight gradient of `stem_sites`: vol [B,D,H,W,Cin], coords [B,V,3]
    int32, mask [B,V] bool, ct [B,V,64] of vol's dtype -> dW [343,Cin,64]
    float32, the sum over the masked-in sites of patch x ct (f32 sums in a
    fixed order: the same bits from run to run)."""
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
    plan = stem_dw_plan(b, v, cin, dt == torch.bfloat16, _sm_count(dev))
    dw = torch.empty((343, cin, 64), dtype=torch.float32, device=dev)
    partial = torch.empty((plan["splits"], 343 * cin, 64),
                          dtype=torch.float32, device=dev)
    rc = _on_device(dev, build.entry("stem_dw"), _DTYPE_CODE[dt],
                    vol.data_ptr(), coords.data_ptr(), mask.data_ptr(),
                    ct.data_ptr(), partial.data_ptr(), dw.data_ptr(), b, d, h,
                    w, v, cin, plan["splits"])
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
    rc = _on_device(x.device, build.entry("firewall_copy"), x.element_size(),
                    x.data_ptr(), out.data_ptr(), *(1,) * pad, *x.shape,
                    *(0,) * pad, *x.stride())
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


# rows of a tile of the KPConv kernels (tiles without a real neighbour are
# skipped), and the two products' output tiles by Cout: (largest Cout, BM,
# BN); the forward's BM runs over rows, dW's over Kp*C
KPCONV_ROWS = 64
_PRODUCT_TILES = ((16, 256, 16), (32, 128, 32), (256, 64, 64))


def _part_smem(k: int, n_kp: int) -> int:
    """Shared memory of the part kernel (csrc/kpconv_part.cuh): 16 rows'
    slots, each with 16 weights (padded to 20) and a source row, and the
    kernel points."""
    return 16 * k * 20 * 4 + 16 * k * 4 + n_kp * 12


def kpconv_fwd_plan(b: int, nq: int, ns: int, k: int, c: int, cout: int,
                    n_kp: int, bf16: bool) -> dict:
    """How `kpconv_fused` cuts its work (pure: shapes in, numbers out): row
    tiles of 64 (flags), the part kernel's blocks of 16 rows x 32 channels,
    the product's output tile by Cout (`tile` for the C entry point) and
    the ranges its depth Kp*C is cut into (`splits`: one per 480 from a
    depth of 2048, at most 8, so that the widest levels' few active tiles
    fill the card; a shallower product has blocks enough), each
    kernel's grid and shared memory, and the scratch in bytes (flags; part
    [tiles*64, Kp*C] in the compute dtype; the splits' f32 partials where
    there is more than one). Raises where the part kernel's slots do not
    fit a block's shared memory (K in the hundreds)."""
    m = b * nq
    tiles = -(-m // KPCONV_ROWS)
    tile = next(i for i, (most, _, _) in enumerate(_PRODUCT_TILES)
                if cout <= most)
    _, bm, bn = _PRODUCT_TILES[tile]
    part_smem = _part_smem(k, n_kp)
    if part_smem > SMEM_PER_BLOCK:
        raise ValueError(f"kpconv_fused: K {k} leaves no room in a block's "
                         f"shared memory ({part_smem} bytes)")
    splits = min(8, n_kp * c // 480) if n_kp * c >= 2048 else 1
    return {"tiles": tiles, "tile_rows": KPCONV_ROWS, "tile": tile,
            "product_tile": (bm, bn), "splits": splits,
            "grids": {"flags": (tiles, 1),
                      "part": (tiles * KPCONV_ROWS // 16, -(-c // 32)),
                      "product": (-(-m // bm), -(-cout // bn), splits),
                      "reduce": (-(-m * cout // 32) if splits > 1 else 0,
                                 1)},
            "smem_bytes": {"part": part_smem,
                           "product": _gemm_smem(bm, bn, bf16)},
            "scratch_bytes": {"flags": 4 * tiles,
                              "part": tiles * KPCONV_ROWS * n_kp * c
                              * (2 if bf16 else 4),
                              "partial": splits * m * cout * 4
                              if splits > 1 else 0}}


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
    dev = x.device
    plan = kpconv_fwd_plan(b, nq, ns, k, c, cout, n_kp,
                           x.dtype == torch.bfloat16)
    out = torch.empty((b, nq, cout), dtype=torch.float32, device=dev)
    flags = torch.empty(plan["tiles"], dtype=torch.int32, device=dev)
    part = torch.empty((plan["tiles"] * KPCONV_ROWS, n_kp * c),
                       dtype=x.dtype, device=dev)
    splits = plan["splits"]
    partial = torch.empty((splits, b * nq, cout) if splits > 1 else (0,),
                          dtype=torch.float32, device=dev)
    rc = _on_device(
        dev, build.entry("kpconv_fwd"), _DTYPE_CODE[x.dtype], x.data_ptr(),
        nbr.data_ptr(), rel.data_ptr(), weights.data_ptr(),
        kernel_points.data_ptr(), flags.data_ptr(), part.data_ptr(),
        partial.data_ptr(), out.data_ptr(), b, nq, ns, k, c, cout, n_kp,
        float(extent), _INFLUENCE_CODE[influence],
        int(aggregation == "closest"), plan["tile"], splits)
    _check_rc(rc, "kpconv_fused")
    LAUNCHES["kpconv_fused"] += 1
    return out




def kpconv_bwd_plan(b: int, nq: int, ns: int, k: int, c: int, cout: int,
                    n_kp: int, bf16: bool, sms: int = H100_SMS) -> dict:
    """How `kpconv_fused_bwd` cuts its work (pure: shapes in, numbers out):
    row tiles, the dW product's output tile and row splits (enough blocks
    for eight an SM), each kernel's grid and shared memory, and the scratch
    it needs in bytes. The C entry point takes dw_cfg and splits from
    here."""
    m = b * nq
    tiles = -(-m // KPCONV_ROWS)
    kc = n_kp * c
    dw_cfg = next(i for i, (most, _, _) in enumerate(_PRODUCT_TILES)
                  if cout <= most)
    _, bm, bn = _PRODUCT_TILES[dw_cfg]
    out_tiles = -(-kc // bm) * -(-cout // bn)
    splits = max(1, min(tiles, 8 * sms // out_tiles, 65535))
    # dx: rows of 16 channels or fewer (and Kp <= 64) take the narrow
    # kernel, a group of `lanes` lanes an edge, each warp's batch of
    # influences in shared memory
    narrow = c <= 16 and n_kp <= 64
    lanes = 4 if c <= 4 else 8 if c <= 8 else 16
    rows = tiles * KPCONV_ROWS
    return {"tiles": tiles, "tile_rows": KPCONV_ROWS, "dw_cfg": dw_cfg,
            "dw_tile": (bm, bn), "splits": splits,
            "grids": {"flags": (tiles, 1), "dpart": (tiles, -(-kc // 64)),
                      "dx": (-(-b * ns // 8), 1),
                      "edge": (tiles * KPCONV_ROWS // 16, -(-c // 32)),
                      "dw": (out_tiles, splits),
                      "reduce": (-(-kc * cout // 32), 1)},
            "smem_bytes": {"dpart": _gemm_smem(KPCONV_ROWS, 64, bf16),
                           "dx": n_kp * 12 + (8 * (32 // lanes) * (n_kp + 1)
                                              * 4 if narrow else 0),
                           "dw": _gemm_smem(bm, bn, bf16),
                           "edge": _part_smem(k, n_kp), "reduce": 8 * 32 * 4},
            # the reverse edge index (built by the caller, once per
            # neighbour list): perm and off, int32
            "scratch_bytes": {"flags": 4 * tiles,
                              "part": rows * kc * (2 if bf16 else 4),
                              "dpart": rows * kc * 4,
                              "partial": splits * kc * cout * 4,
                              "reverse_index": 4 * (m * k + b * (ns + 1)
                                                    + 1)}}


_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index]


def _check_reverse(name: str, rev, b: int, nq: int, ns: int, k: int,
                   device: torch.device) -> None:
    if rev is None:
        raise ValueError(f"{name}: needs nbr's reverse edge index "
                         f"(ops.kpconv.reverse_edges)")
    perm, off = rev
    _require(perm, "perm", torch.int32, 1, device)
    _require(off, "off", torch.int32, 1, device)
    if perm.shape != (b * nq * k,) or off.shape != (b * (ns + 1) + 1,):
        raise ValueError(f"{name}: reverse index perm {tuple(perm.shape)}, "
                         f"off {tuple(off.shape)} for nbr {(b, nq, k)} over "
                         f"{ns} rows")


def kpconv_fused_bwd(x: torch.Tensor, nbr: torch.Tensor, rel: torch.Tensor,
                     weights: torch.Tensor, kernel_points: torch.Tensor,
                     g: torch.Tensor, extent: float,
                     influence: str = "linear", aggregation: str = "sum",
                     rev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of `kpconv_fused` for the cotangent g [B,Nq,Cout] f32 ->
    (dx [B,Ns,C] f32, dW [Kp,C,Cout] f32), both summed in a fixed order:
    the same bits from run to run. dx has one owner per row of x, which
    walks the rows that name it in the order of `rev`, nbr's reverse edge
    index (`ops.kpconv.reverse_edges`; without it the wrapper raises).
    The shadow gets nothing."""
    b, nq, ns, k, c, cout, n_kp = _kpconv_args(
        "kpconv_fused_bwd", x, nbr, rel, weights, kernel_points, influence,
        aggregation)
    dev = x.device
    _require(g, "g", torch.float32, 3, dev)
    if g.shape != (b, nq, cout):
        raise ValueError(f"kpconv_fused_bwd: g {tuple(g.shape)} for an "
                         f"output {(b, nq, cout)}")
    plan = kpconv_bwd_plan(b, nq, ns, k, c, cout, n_kp,
                           x.dtype == torch.bfloat16, _sm_count(dev))
    rows, kc = plan["tiles"] * KPCONV_ROWS, n_kp * c
    _check_reverse("kpconv_fused_bwd", rev, b, nq, ns, k, dev)
    dx = torch.empty((b, ns, c), dtype=torch.float32, device=dev)
    dw = torch.empty((n_kp, c, cout), dtype=torch.float32, device=dev)
    flags = torch.empty(plan["tiles"], dtype=torch.int32, device=dev)
    part = torch.empty((rows, kc), dtype=x.dtype, device=dev)
    dpart = torch.empty((rows, kc), dtype=torch.float32, device=dev)
    partial = torch.empty((plan["splits"], kc, cout), dtype=torch.float32,
                          device=dev)
    rc = _on_device(
        dev, build.entry("kpconv_bwd"), _DTYPE_CODE[x.dtype], x.data_ptr(),
        nbr.data_ptr(), rel.data_ptr(), weights.data_ptr(),
        kernel_points.data_ptr(), g.data_ptr(), rev[0].data_ptr(),
        rev[1].data_ptr(), flags.data_ptr(), part.data_ptr(),
        dpart.data_ptr(), partial.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), b, nq, ns, k, c, cout, n_kp, float(extent),
        _INFLUENCE_CODE[influence], int(aggregation == "closest"),
        plan["dw_cfg"], plan["splits"])
    _check_rc(rc, "kpconv_fused_bwd")
    LAUNCHES["kpconv_fused_bwd"] += 1
    return dx, dw


def gather_rows_bwd(g: torch.Tensor, rev: Tuple[torch.Tensor, torch.Tensor],
                    b: int, ns: int) -> torch.Tensor:
    """Backward of the row gather of x [B,Ns,C] by a neighbour list nbr
    [B,Nq,K] (Ns = shadow): g [B,Nq,K,C] f32 or bf16, rev nbr's reverse
    edge index (`ops.kpconv.reverse_edges`) -> dx [B,Ns,C] of g's dtype,
    each row the f32 sum of the g rows that name it in rev's order (the
    same bits from run to run; the shadow's rows are dropped)."""
    if not g.is_cuda:
        raise ValueError("gather_rows_bwd takes CUDA tensors")
    dev, dt = g.device, g.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"gather_rows_bwd: unsupported dtype {dt}")
    _require(g, "g", dt, 4, dev)
    if g.shape[0] != b:
        raise ValueError(f"gather_rows_bwd: g {tuple(g.shape)} for B {b}")
    nq, k, c = g.shape[1:]
    _check_reverse("gather_rows_bwd", rev, b, nq, ns, k, dev)
    dx = torch.empty((b, ns, c), dtype=dt, device=dev)
    rc = _on_device(dev, build.entry("gather_rows_bwd"), _DTYPE_CODE[dt],
                    rev[0].data_ptr(), rev[1].data_ptr(), g.data_ptr(),
                    dx.data_ptr(), b, ns, c)
    _check_rc(rc, "gather_rows_bwd")
    LAUNCHES["gather_rows_bwd"] += 1
    return dx


FPS_CLUSTERS = (1, 2, 4, 8)    # csrc/fps.cu: portable cluster sizes
FPS_WIDTHS = (1, 2, 4, 6, 8, 12, 16, 24)   # its points a thread
FPS_MAX_SLOTS = 128            # cluster x warps: a warp's best a slot
FPS_CTA_POINTS = 512           # points a CTA the plan aims below
FPS_WARP_PER = 16              # a sample of up to 32 x 16 points: one warp
FPS_SMEM_BYTES = 2 * FPS_MAX_SLOTS * (16 + 4) + 16   # slot tables, mbarriers
# registers a thread of each width (`nvcc -Xptxas=-v`, CUDA 12.8, sm_90a,
# the CTA-cluster instance; chip_smoke.py's device line prints every
# instance and fails on a spill)
FPS_REGISTERS = {1: 56, 2: 58, 4: 64, 6: 72, 8: 80, 12: 114, 16: 150,
                 24: 225}


def fps_max_threads(per: int) -> int:
    """The most threads a CTA of `per` points a thread may have (the
    kernel's launch bounds: 128 registers a thread up to 12 points, 255
    beyond)."""
    return 512 if per <= 12 else 256


def _fps_cta_threads(cluster: int) -> int:
    # at most 32 slots (one a lane of the final reduction), 16 warps
    return 32 * min(16, 32 // cluster)


def _fps_cta_cap(cluster: int) -> int:
    t = _fps_cta_threads(cluster)
    return t * max(p for p in FPS_WIDTHS if fps_max_threads(p) >= t)


FPS_MAX_POINTS = max(c * _fps_cta_cap(c) for c in FPS_CLUSTERS)   # 24576


def fps_plan(n: int, b: int, sms: int = H100_SMS,
             cluster: Optional[int] = None) -> dict:
    """How `fps` spreads a batch of b samples of n points (pure): one
    cluster of `cluster` CTAs a sample, the sample's points in registers,
    `per` a thread. The cluster is the smallest that leaves a CTA at most
    FPS_CTA_POINTS points, or 8 (`cluster` forces one that holds n).
    Threads: one warp where a cluster of one holds at most 32 x
    FPS_WARP_PER points (the kernel's instance with no slots and no
    barrier), else at least 4 points a thread, at most 32 slots in the
    cluster (warps x cluster) and 16 warps; `per` the smallest template
    width that covers the CTA's points. `resident_clusters`: how many such
    clusters the card's `sms` SMs hold at once by registers, threads and
    the 32 CTAs an SM (cudaOccupancyMaxActiveClusters says it on the card;
    a GPC holds whole clusters only, so it may be fewer): the batch runs in
    one wave where b is at most that. Raises, naming n, past
    FPS_MAX_POINTS."""
    return dict(_fps_plan(n, b, sms, cluster))


@lru_cache(maxsize=256)
def _fps_plan(n: int, b: int, sms: int, cluster: Optional[int]) -> dict:
    # fps_plan's, cached: the wrapper reads it at every call
    if not 1 <= n <= FPS_MAX_POINTS:
        raise ValueError(f"fps: a sample of {n} points; the kernel holds "
                         f"1 to {FPS_MAX_POINTS} (a cluster of at most "
                         f"{FPS_CLUSTERS[-1]} CTAs, the points in "
                         f"registers)")
    need = min(c for c in FPS_CLUSTERS if n <= c * _fps_cta_cap(c))
    if cluster is None:
        cluster = min((c for c in FPS_CLUSTERS
                       if -(-n // c) <= FPS_CTA_POINTS),
                      default=FPS_CLUSTERS[-1])
    elif cluster not in FPS_CLUSTERS or cluster < need:
        raise ValueError(f"fps: a cluster of {cluster} for {n} points "
                         f"(one of {FPS_CLUSTERS}, at least {need})")
    points = -(-n // cluster)
    if cluster == 1 and points <= 32 * FPS_WARP_PER:
        threads = 32        # one warp: the kernel's barrier-free instance
    else:
        threads = min(_fps_cta_threads(cluster), 32 * -(-points // 128))
    per = min(p for p in FPS_WIDTHS
              if p * threads >= points and threads <= fps_max_threads(p))
    regs = -(-FPS_REGISTERS[per] // 8) * 8    # allocated 8 at a time
    per_sm = min(32, 2048 // threads, 65536 // (regs * threads))
    return {"cluster": cluster, "ctas": b * cluster, "threads": threads,
            "per": per, "points_per_cta": points,
            "smem_bytes": FPS_SMEM_BYTES,
            "resident_clusters": sms * per_sm // cluster}


def fps_active_clusters(plan: dict) -> int:
    """How many clusters of `plan`'s shape the current card holds at once
    (cudaOccupancyMaxActiveClusters): one wave if at least the batch."""
    got = build.entry("fps_occupancy")(plan["per"], plan["threads"],
                                       plan["cluster"])
    if got < 0:
        raise RuntimeError(f"fps occupancy query failed: {got} (-2: a shape "
                           f"the kernel does not take, else minus a CUDA "
                           f"error code)")
    return got


def fps(pos: torch.Tensor, mask: torch.Tensor, n_samples: int,
        start: int = 0, plan: Optional[dict] = None,
        smid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Farthest point sampling (`ops.neighbors.fps_plain`'s function and
    bits): pos [B,N,3] f32, mask [B,N] bool -> [B,n_samples] int64, one
    cluster of CTAs a sample (`fps_plan(N, B)` unless `plan` is given),
    one launch. `smid`, int32 [plan's ctas], takes each CTA's SM."""
    if not pos.is_cuda:
        raise ValueError("fps takes CUDA tensors")
    dev = pos.device
    _require(pos, "pos", torch.float32, 3, dev)
    _require(mask, "mask", torch.bool, 2, dev)
    b, n, c = pos.shape
    if c != 3 or mask.shape != (b, n):
        raise ValueError(f"fps: pos {tuple(pos.shape)}, mask "
                         f"{tuple(mask.shape)} (need [B,N,3] and [B,N])")
    if plan is None:
        plan = _fps_plan(n, b, _sm_count(dev), None)
    if n_samples < 1 or not 0 <= start < n:
        raise ValueError(f"fps: n_samples {n_samples}, start {start} for "
                         f"{n} points")
    out = torch.empty((b, n_samples), dtype=torch.int64, device=dev)
    if b == 0:
        return out
    if smid is not None:
        _require(smid, "smid", torch.int32, 1, dev)
        if smid.numel() != b * plan["cluster"]:
            raise ValueError(f"fps: smid {tuple(smid.shape)} for "
                             f"{b * plan['cluster']} CTAs")
    rc = _on_device(dev, build.entry("fps"), pos.data_ptr(),
                    mask.data_ptr(), out.data_ptr(),
                    None if smid is None else smid.data_ptr(), b, n,
                    n_samples, start, plan["cluster"], plan["threads"],
                    plan["per"])
    _check_rc(rc, "fps")
    LAUNCHES["fps"] += 1
    return out
