"""Pyramids built on the host (counterpart of
`dpcr_agb_tpu/ops/host_pyramid.py`), as numpy arrays that `batch.aux`
carries to the card. The loader builds them in its threads, so they
overlap the card's steps; `predict` builds them in `make_batches`.

The sparse-voxel nets' map mode (`dense_dims=None`): per sample, each
level's voxels (unique(floor(coords / 2)) of the level below, in key
order, the largest keys dropped beyond the level's cap) and the kernel
maps a `SparseResNet` forward reads: mask{l}, stem_map (343 offsets),
pool_map (27, stride 2), s1_map{lv} (27, stride 1) and down_k3_{si} /
down_k1_{si} (27 and 1, stride 2), each [K, V_out] int32 with the input
level's padded count as the shadow. The native route (`native.py`'s
`build_sorted_keys`, `key_kernel_map`, `downsample_coords`) is the one
the entry points take; the numpy route is its plain version, with the
same bits.

KPConv: per sample and level, the points (voxel barycentres), the conv
neighbour lists and the pool neighbour lists, from the native point ops
(`native.grid_subsample`, `native.radius_neighbors`). Level 0 keeps the
batch's row order (its lists index the batch's feature rows); padding
rows, and the padding queries of later levels, sit at 1e6; a list's
shadow index is its level's padded count."""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import native
from .voxel import COORD_OFFSET, SENTINEL_KEY, hypercube_offsets

# sparse_pyramid_host calls by route since the counts were last cleared
# (chip_smoke.py reads them to show which route the entry points took)
ROUTE_CALLS = {"native": 0, "numpy": 0}
_ROUTE_LOCK = threading.Lock()


def pack_keys_np(coords: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """`voxel.pack_keys` on the host, in int64: the sentinel where not
    valid."""
    c = np.clip(coords, -COORD_OFFSET, COORD_OFFSET - 1) + COORD_OFFSET
    key = (c[..., 0].astype(np.int64) << 20) | (c[..., 1] << 10) | c[..., 2]
    return np.where(valid, key, SENTINEL_KEY).astype(np.int64)


class HostGrid:
    """One level of one sample: coords [V,3] int32, mask [V] bool, the
    stably sorted keys (int64) and the rows in that order (int32)."""
    __slots__ = ("coords", "mask", "keys_sorted", "order")

    def __init__(self, coords: np.ndarray, mask: np.ndarray,
                 use_native: bool = True):
        self.coords = coords
        self.mask = mask
        if use_native:
            self.keys_sorted, self.order = native.build_sorted_keys(coords,
                                                                    mask)
        else:
            keys = pack_keys_np(coords, mask)
            self.order = np.argsort(keys, kind="stable").astype(np.int32)
            self.keys_sorted = keys[self.order]


def downsample_np(grid: HostGrid, stride: int, v_out: int,
                  use_native: bool = True) -> HostGrid:
    """unique(floor(coords / stride)) in key order, the largest keys
    dropped beyond v_out (`voxel.downsample`'s rule)."""
    if use_native:
        out = native.downsample_coords(grid.coords, grid.mask, stride, v_out)
        return HostGrid(out[0], out[1], True)
    down = np.floor_divide(grid.coords, stride)
    keys = pack_keys_np(down, grid.mask)
    order = np.argsort(keys, kind="stable")
    skeys = keys[order]
    sdown = down[order]
    valid = skeys != SENTINEL_KEY
    first = np.empty_like(valid)
    first[0] = valid[0]
    first[1:] = (skeys[1:] != skeys[:-1]) & valid[1:]
    uniq = sdown[first][:v_out]
    out_coords = np.zeros((v_out, 3), np.int32)
    out_coords[: len(uniq)] = uniq
    out_mask = np.zeros(v_out, bool)
    out_mask[: len(uniq)] = True
    return HostGrid(out_coords, out_mask, False)


def lookup_np(grid: HostGrid, probe_coords: np.ndarray,
              probe_valid: np.ndarray) -> np.ndarray:
    """`voxel.lookup` on the host: rows of grid at the probes, V where
    there is none."""
    v = grid.coords.shape[0]
    pk = pack_keys_np(probe_coords, probe_valid)
    pos = np.searchsorted(grid.keys_sorted, pk)
    pos_c = np.minimum(pos, v - 1)
    found = (grid.keys_sorted[pos_c] == pk) & (pk != SENTINEL_KEY)
    return np.where(found, grid.order[pos_c], v).astype(np.int32)


def kernel_map_np(in_grid: HostGrid, out_grid: HostGrid,
                  offsets: np.ndarray, stride: int,
                  use_native: bool = True) -> np.ndarray:
    """`voxel.kernel_map` on the host: [K, V_out] int32."""
    base = out_grid.coords * stride
    lo = base.min(initial=0) + offsets.min(initial=0)
    hi = base.max(initial=0) + offsets.max(initial=0)
    if -COORD_OFFSET <= lo and hi < COORD_OFFSET:
        # no probe is clipped, so a probe's key is its base key plus the
        # offset's key (added: an offset can be negative)
        base_keys = pack_keys_np(base, out_grid.mask)
        off_keys = (offsets[:, 0].astype(np.int64) * (1 << 20)
                    + offsets[:, 1].astype(np.int64) * (1 << 10)
                    + offsets[:, 2].astype(np.int64))
        if use_native:
            return native.key_kernel_map(in_grid.keys_sorted, in_grid.order,
                                         base_keys, off_keys)
        pk = np.where(out_grid.mask[None, :],
                      base_keys[None, :] + off_keys[:, None], SENTINEL_KEY)
        v = in_grid.coords.shape[0]
        pos = np.searchsorted(in_grid.keys_sorted, pk)
        pos_c = np.minimum(pos, v - 1)
        found = (in_grid.keys_sorted[pos_c] == pk) & (pk != SENTINEL_KEY)
        return np.where(found, in_grid.order[pos_c], v).astype(np.int32)
    probe = base[None, :, :] + offsets[:, None, :]
    return lookup_np(in_grid, probe, out_grid.mask[None, :])


def resnet_pyramid_plan(first_stride: int, strides: Sequence[int],
                        v0: int, fracs: Sequence[float],
                        caps: Optional[Sequence[int]] = None) -> dict:
    """The levels and maps of one `SparseResNet` map-mode forward on
    batches padded to v0 voxels: a level per stride-2 stage, the stem's
    pool and, at first_stride 2, the stem's own; each level's cap from
    `caps` or a fraction of v0, rounded up to 8 (at least 8)."""
    n_down = sum(1 for s in strides if s != 1) + 1
    if first_stride != 1:
        n_down += 1
    n_levels = n_down + 1
    if caps is None:
        caps = [max(8, -(-int(v0 * fracs[min(l, len(fracs) - 1)]) // 8) * 8)
                for l in range(n_levels)]
    return {"first_stride": first_stride, "strides": tuple(strides),
            "n_levels": n_levels, "caps": tuple(int(c) for c in caps)}


def sparse_pyramid_host(coords: np.ndarray, mask: np.ndarray, plan: dict,
                        use_native: bool = True) -> Dict[str, np.ndarray]:
    """One sample's levels and kernel maps for a `SparseResNet` map-mode
    forward (the keys of the module docstring)."""
    with _ROUTE_LOCK:
        ROUTE_CALLS["native" if use_native else "numpy"] += 1
    off343 = hypercube_offsets(7)
    off27 = hypercube_offsets(3)
    off1 = hypercube_offsets(1)
    caps = plan["caps"]

    def kmap(g_in, g_out, offsets, stride):
        return kernel_map_np(g_in, g_out, offsets, stride, use_native)

    grids: List[HostGrid] = [HostGrid(coords, mask, use_native)]
    for l in range(1, plan["n_levels"]):
        grids.append(downsample_np(grids[l - 1], 2, caps[l], use_native))

    out: Dict[str, np.ndarray] = {}
    for l, g in enumerate(grids):
        out[f"mask{l}"] = g.mask
    if plan["first_stride"] == 1:
        out["stem_map"] = kmap(grids[0], grids[0], off343, 1)
        stem_level = 0
    else:
        out["stem_map"] = kmap(grids[0], grids[1], off343, 2)
        stem_level = 1
    out["pool_map"] = kmap(grids[stem_level], grids[stem_level + 1], off27,
                           2)
    level = stem_level + 1
    for si, stride in enumerate(plan["strides"]):
        if stride != 1:
            out[f"down_k3_{si}"] = kmap(grids[level], grids[level + 1],
                                        off27, 2)
            out[f"down_k1_{si}"] = kmap(grids[level], grids[level + 1],
                                        off1, 2)
            level += 1
        if f"s1_map{level}" not in out:
            out[f"s1_map{level}"] = kmap(grids[level], grids[level], off27, 1)
    return out


def collate_sparse_aux(coords_b: np.ndarray, mask_b: np.ndarray, plan: dict,
                       use_native: bool = True) -> Dict[str, np.ndarray]:
    """Each sample's pyramid, stacked into batch arrays [B, ...]."""
    per = [sparse_pyramid_host(coords_b[i], mask_b[i], plan, use_native)
           for i in range(coords_b.shape[0])]
    aux = {}
    for k in per[0]:
        out = np.empty((len(per),) + per[0][k].shape, per[0][k].dtype)
        for i, p in enumerate(per):
            out[i] = p[k]
        aux[k] = out
    return aux


def make_sparse_post_collate(plan_fn, use_native: bool = True):
    """The loader's post_collate for a map-mode `SparseResNet`:
    plan_fn(v0) -> plan for a batch padded to v0 voxels; returns the batch
    with its pyramid in `aux`."""
    def post_collate(batch):
        plan = plan_fn(batch.coords.shape[1])
        aux = collate_sparse_aux(np.asarray(batch.coords),
                                 np.asarray(batch.mask), plan, use_native)
        return dataclasses.replace(batch, aux=aux)

    return post_collate


SHADOW_POS = 1e6
REV_KR_LADDER = (2, 3, 4, 6, 8)  # reverse-list width buckets, in units of K


def kpconv_pyramid_plan(first_subsampling_dl: float, conv_radius: float,
                        n_levels: int, v0: int, fracs: Sequence[float],
                        klims: Sequence[int],
                        deform_levels: Optional[Sequence[bool]] = None,
                        deform_scale: float = 1.0) -> dict:
    """The static shape of a batch padded to v0 points: each level's point
    cap (a fraction of v0, rounded up to 8, at least 16), its neighbour
    cap, and which levels search at the deformable radius."""
    caps = [max(16, -(-int(v0 * fracs[min(l, len(fracs) - 1)]) // 8) * 8)
            for l in range(n_levels)]
    return {"dl": first_subsampling_dl, "conv_radius": conv_radius,
            "n_levels": n_levels, "caps": tuple(caps),
            "klims": tuple(int(k) for k in klims),
            "deform_levels": tuple(deform_levels or [False] * n_levels),
            "deform_scale": float(deform_scale)}


def _edge_transpose(nbr: np.ndarray, ns: int):
    """(perm, off): perm sorts the flat edge list stably by support row;
    off[j] is the first sorted position of an edge naming support j
    (ns + 2 entries; the last segment holds the shadow's edges). Its slices
    are what `ops.kpconv.reverse_edges` builds on the card."""
    flat = nbr.reshape(-1)
    perm = np.argsort(flat, kind="stable").astype(np.int32)
    off = np.searchsorted(flat[perm], np.arange(ns + 2)).astype(np.int32)
    return perm, off


def _rev_cap(plan: dict, k: int, nbr: np.ndarray, ns: int) -> int:
    """The reverse list's width: plan['rev_kr'] when it is given, else the
    smallest bucket of REV_KR_LADDER * k that holds the sample's largest
    in-degree (or that in-degree, above the ladder)."""
    if "rev_kr" in plan:
        return int(plan["rev_kr"])
    md = max_in_degree(nbr, ns)
    for mult in REV_KR_LADDER:
        if mult * k >= md:
            return mult * k
    return max(md, REV_KR_LADDER[-1] * k)


def kpconv_pyramid_host(pos: np.ndarray, mask: np.ndarray,
                        plan: dict) -> Dict[str, np.ndarray]:
    """One sample's pyramid: pos [N,3], mask [N] with the valid rows first
    -> kp_pts{l} [N_l,3] f32, kp_mask{l} [N_l] bool, kp_conv{l} [N_l,K_l]
    int32 and, below the last level, kp_pool{l} [N_{l+1},K_l] int32 (the
    queries of level l+1 over the points of level l); with
    plan['reverse_dx'] the reverse lists kp_crev{l} / kp_prev{l}, with
    plan['edge_transpose'] kp_cperm{l}, kp_coff{l}, kp_pperm{l},
    kp_poff{l}. Raises unless the mask is prefix-packed."""
    n_levels = plan["n_levels"]
    caps, klims = plan["caps"], plan["klims"]
    r = plan["dl"] * plan["conv_radius"]
    out: Dict[str, np.ndarray] = {}

    # the radius searches run on the valid prefix only: the padding rows,
    # all at one far point, would share one grid cell
    padded = np.where(mask[:, None], pos, SHADOW_POS).astype(np.float32)
    m = mask.copy()
    n0 = int(m.sum())
    if n0 and not m[:n0].all():
        raise ValueError("host pyramid requires a prefix-packed mask "
                         "(valid rows first, as data/batch.py collates)")
    pts = pos[mask].astype(np.float32)

    for l in range(n_levels):
        cap = padded.shape[0]
        n = int(m.sum())
        out[f"kp_pts{l}"] = padded
        out[f"kp_mask{l}"] = m
        r_search = r * (plan["deform_scale"] if plan["deform_levels"][l]
                        else 1.0)
        nbr = np.full((cap, klims[l]), cap, np.int32)
        if n:
            nv = native.radius_neighbors(padded[:n], padded[:n], r_search,
                                         klims[l])
            # the library pads with n; the shadow is the padded count
            nbr[:n] = np.where(nv >= n, cap, nv)
        out[f"kp_conv{l}"] = nbr
        if plan.get("reverse_dx", False):
            out[f"kp_crev{l}"] = reverse_lists(
                nbr, cap, _rev_cap(plan, klims[l], nbr, cap))
        if plan.get("edge_transpose", False):
            out[f"kp_cperm{l}"], out[f"kp_coff{l}"] = \
                _edge_transpose(nbr, cap)
        if l < n_levels - 1:
            dl_next = 2 * r / plan["conv_radius"]
            sub, _ = native.grid_subsample(pts, dl_next)
            next_cap = caps[l + 1]
            sub = sub[:next_cap]
            q_pad = np.full((next_cap, 3), SHADOW_POS, np.float32)
            qm = np.zeros(next_cap, bool)
            q_pad[: len(sub)] = sub
            qm[: len(sub)] = True
            pool = np.full((next_cap, klims[l]), cap, np.int32)
            if len(sub) and n:
                pv = native.radius_neighbors(sub.astype(np.float32),
                                             padded[:n], r_search, klims[l])
                pool[: len(sub)] = np.where(pv >= n, cap, pv)
            out[f"kp_pool{l}"] = pool
            if plan.get("reverse_dx", False):
                out[f"kp_prev{l}"] = reverse_lists(
                    pool, cap, _rev_cap(plan, klims[l], pool, cap))
            if plan.get("edge_transpose", False):
                out[f"kp_pperm{l}"], out[f"kp_poff{l}"] = \
                    _edge_transpose(pool, cap)
            pts = sub
            padded, m = q_pad, qm
        r *= 2
    return out


def make_kpconv_post_collate(plan_fn, cache_bytes: Optional[int] = None):
    """The loader's post_collate for KPCNN: plan_fn(n0) -> plan for a batch
    padded to n0 points; returns the batch with each sample's pyramid
    stacked into `aux`.

    Pyramids are memoized by a hash of the sample's points and the plan (a
    deterministic eval chain gives the same points every epoch; random
    train chains miss), inserted until the budget is full and never
    evicted. Budget: cache_bytes, else DPCR_PYRAMID_CACHE_MB (default
    2048; 0 turns the cache off)."""
    if cache_bytes is None:
        cache_bytes = int(os.environ.get(
            "DPCR_PYRAMID_CACHE_MB", "2048")) * (1 << 20)
    cache: Dict[bytes, Dict[str, np.ndarray]] = {}
    cache_used = [0]
    lock = threading.Lock()  # the loader's threads share the cache

    def pyramid_for(pos_i, mask_i, plan):
        if cache_bytes <= 0:
            return kpconv_pyramid_host(pos_i, mask_i, plan)
        key = hashlib.blake2b(
            pos_i.tobytes() + repr(sorted(plan.items())).encode(),
            digest_size=16).digest()
        hit = cache.get(key)
        if hit is not None:
            return hit
        out = kpconv_pyramid_host(pos_i, mask_i, plan)
        with lock:
            if cache_used[0] < cache_bytes and key not in cache:
                cache[key] = out
                cache_used[0] += sum(a.nbytes for a in out.values())
        return out

    def post_collate(batch):
        plan = plan_fn(batch.pos.shape[1])
        pos_b = np.asarray(batch.pos)
        mask_b = np.asarray(batch.mask)
        per = [pyramid_for(pos_b[i], mask_b[i], plan)
               for i in range(pos_b.shape[0])]
        aux = {}
        for k in per[0]:
            arrs = [p[k] for p in per]
            if k.startswith(("kp_crev", "kp_prev")):
                # the reverse lists' widths differ by sample: pad to the
                # batch's widest with the sentinel edge id nq*K
                lvl = k[len("kp_crev"):]
                fwd = per[0]["kp_conv" + lvl if k.startswith("kp_crev")
                             else "kp_pool" + lvl]
                e = fwd.shape[0] * fwd.shape[1]
                kr = max(a.shape[1] for a in arrs)
                arrs = [np.pad(a, ((0, 0), (0, kr - a.shape[1])),
                               constant_values=e)
                        if a.shape[1] < kr else a for a in arrs]
            out = np.empty((len(arrs),) + arrs[0].shape, arrs[0].dtype)
            for i, a in enumerate(arrs):
                out[i] = a
            aux[k] = out
        return dataclasses.replace(batch, aux=aux)

    return post_collate


def reverse_lists(nbr: np.ndarray, ns: int, kr: int) -> np.ndarray:
    """rnbr [ns+1, kr] int32: row j holds the flat edge ids e = q*K + k
    with nbr[q, k] == j in edge order, padded with the sentinel Nq*K; row
    ns holds the shadow's edges (its tail dropped). Raises when a support's
    in-degree exceeds kr."""
    nq, k = nbr.shape
    e = nq * k
    flat = nbr.reshape(-1)
    order = np.argsort(flat, kind="stable").astype(np.int64)
    sorted_sup = flat[order]
    off = np.searchsorted(sorted_sup, np.arange(ns + 2))
    counts = np.diff(off)
    if counts[:-1].max(initial=0) > kr:
        raise ValueError(
            f"in-degree {int(counts[:-1].max())} exceeds kr={kr}")
    rnbr = np.full((ns + 1, kr), e, np.int32)
    rank = np.arange(e) - off[sorted_sup]
    keep = rank < kr  # only the shadow row can overflow
    rnbr[sorted_sup[keep], rank[keep]] = order[keep]
    return rnbr


def max_in_degree(nbr: np.ndarray, ns: int) -> int:
    """The most edges of nbr that name one support row below ns."""
    flat = nbr.reshape(-1)
    counts = np.bincount(flat[flat < ns], minlength=ns)
    return int(counts.max(initial=0))
