"""The port's host libraries, compiled with g++ at first use into
`build/torch_host/lib<name>-<hash of source and flags>.so` at the
repository root (listed in .gitignore) and bound with ctypes: the LASzip
codec `native/laszip.cpp` (a copy of the JAX package's
`native/laszip.cpp`), the KD-tree `native/kdtree.cpp`, whose radius
queries return points in scikit-learn's KDTree order, and the host ops of
the pyramids `native/pointops.cpp` (a copy of the JAX package's
`native/pointops.cpp`, built with the JAX package's flags, so that both
libraries give the same bits on one machine): the point ops of the KPConv
pyramid and the sorted keys, kernel maps and strided downsampling of the
sparse-voxel nets' map mode. The
build writes a temporary file and renames it into place, so processes
that build at once never load a half-written library, and threads of one
process build one at a time. There is no fallback: when a library cannot
be built, the call raises with g++'s error output; no committed binary is
ever loaded.

C interface (`laszip.cpp`): `laz_decompress` (a point blob, from its
chunk-table offset on, to raw records) and `laz_compress` (raw records to
a point blob), both over LASzip items given by type and size: POINT10 /
GPSTIME11 / RGB12 / BYTE v2 (compressor 2, formats 0-3) and POINT14 /
RGB14 / RGBNIR14 / BYTE14 v3 (compressor 3, formats 6-8)."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from functools import lru_cache
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "native" / "laszip.cpp"
KDTREE_SRC = SRC.with_name("kdtree.cpp")
POINTOPS_SRC = SRC.with_name("pointops.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_host"
# no FMA contraction: the KD-tree's distances must round as scikit-learn's
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off"]
# the flags the JAX package builds its pointops library with (its
# native.py), FMA contraction included: a radius test or a near-tie rounds
# as that library's does
POINTOPS_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
_BUILD_LOCK = threading.Lock()


def library_path(src: Path = None, flags=GXX_FLAGS) -> Path:
    """Where the library of this source (the codec by default) and these
    flags lives."""
    src = src or SRC
    tag = hashlib.blake2b(src.read_bytes() + " ".join(flags).encode(),
                          digest_size=6).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{tag}.so"


def build(src: Path = None, flags=GXX_FLAGS) -> Path:
    """The library's path, compiled first when it is missing."""
    src = src or SRC
    path = library_path(src, flags)
    with _BUILD_LOCK:
        if path.exists():
            return path
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ is not on PATH: {src.name} cannot be "
                               f"built into {path}")
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
        proc = subprocess.run([gxx, *flags, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {src} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    return path


@lru_cache(maxsize=None)
def laz_library() -> ctypes.CDLL:
    """The bound codec (built at the first call of a process)."""
    lib = ctypes.CDLL(str(build()))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.laz_decompress.restype = i64
    lib.laz_decompress.argtypes = [u8p, i64, u16p, u16p, i64, i64, i64, i64,
                                   u8p]
    lib.laz_compress.restype = i64
    lib.laz_compress.argtypes = [u8p, i64, u16p, u16p, i64, i64, u8p, i64]
    return lib


def laz_decompress(blob: bytes, item_types, item_sizes, n_points: int,
                   chunk_size: int, point_data_offset: int = 0
                   ) -> np.ndarray:
    """A LAZ point blob -> raw point records [n_points, record size] u8.
    Raises on unsupported items or a corrupt stream."""
    lib = laz_library()
    types = np.ascontiguousarray(item_types, np.uint16)
    sizes = np.ascontiguousarray(item_sizes, np.uint16)
    src = np.frombuffer(blob, np.uint8)
    out = np.zeros((n_points, int(sizes.sum())), np.uint8)
    rc = lib.laz_decompress(np.ascontiguousarray(src), len(src), types,
                            sizes, len(types), n_points, chunk_size,
                            point_data_offset, out.reshape(-1))
    if rc != 0:
        raise RuntimeError(f"laz_decompress failed (code {rc}): "
                           "unsupported LAZ variant or corrupt stream")
    return out


def laz_compress(records: np.ndarray, item_types, item_sizes,
                 chunk_size: int = 50000) -> bytes:
    """Raw point records [n, record size] u8 -> LAZ point blob (chunk-table
    offset, chunks, chunk table)."""
    lib = laz_library()
    types = np.ascontiguousarray(item_types, np.uint16)
    sizes = np.ascontiguousarray(item_sizes, np.uint16)
    records = np.ascontiguousarray(records, np.uint8)
    n = len(records)
    cap = records.size + 4096 + 8 * max(1, n // max(1, chunk_size))
    out = np.zeros(cap, np.uint8)
    rc = lib.laz_compress(records.reshape(-1), n, types, sizes, len(types),
                          chunk_size, out, cap)
    if rc < 0:
        raise RuntimeError(f"laz_compress failed (code {rc})")
    return out[:rc].tobytes()


@lru_cache(maxsize=None)
def kdtree_library() -> ctypes.CDLL:
    """The bound KD-tree (built at the first call of a process)."""
    lib = ctypes.CDLL(str(build(KDTREE_SRC)))
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64, f64 = ctypes.c_int64, ctypes.c_double
    lib.kd_node_count.restype = i64
    lib.kd_node_count.argtypes = [i64, i64]
    lib.kd_build.restype = i64
    lib.kd_build.argtypes = [f64p, i64, i64, i64p, i64p, i64p, u8p, f64p]
    lib.kd_query_radius.restype = i64
    lib.kd_query_radius.argtypes = [f64p, i64p, i64p, i64p, u8p, f64p, i64,
                                    f64, f64, f64, i64p]
    return lib


class KDTree2D:
    """A KD-tree over xy points [N, 2] (float64 as scikit-learn stores
    them), built once; `query_radius` returns what
    `sklearn.neighbors.KDTree(xy).query_radius([center], r)[0]` returns,
    the same indices in the same order."""

    LEAF_SIZE = 40

    def __init__(self, xy: np.ndarray):
        lib = kdtree_library()
        self.data = np.ascontiguousarray(np.asarray(xy)[:, :2],
                                         dtype=np.float64)
        n = len(self.data)
        if n == 0:
            raise ValueError("a KD-tree needs at least one point")
        m = lib.kd_node_count(n, self.LEAF_SIZE)
        self.idx = np.zeros(n, np.int64)
        self.start = np.zeros(m, np.int64)
        self.end = np.zeros(m, np.int64)
        self.leaf = np.zeros(m, np.uint8)
        self.bounds = np.zeros(m * 4, np.float64)
        self.n_nodes = lib.kd_build(self.data, n, self.LEAF_SIZE, self.idx,
                                    self.start, self.end, self.leaf,
                                    self.bounds)

    def query_radius(self, center, r: float) -> np.ndarray:
        cx, cy = (float(v) for v in np.asarray(center, np.float64)
                  .reshape(-1)[:2])
        out = np.empty(len(self.data), np.int64)
        count = kdtree_library().kd_query_radius(
            self.data, self.idx, self.start, self.end, self.leaf,
            self.bounds, self.n_nodes, cx, cy, float(r), out)
        return out[:count].copy()


def radius_query_2d(pos_xy: np.ndarray, center, r: float) -> np.ndarray:
    """Indices of the points within r of center, in scikit-learn's KDTree
    order (one tree built for one query; build a `KDTree2D` to query
    several centers)."""
    return KDTree2D(pos_xy).query_radius(center, r)


@lru_cache(maxsize=None)
def pointops_library() -> ctypes.CDLL:
    """The bound point ops (built at the first call of a process)."""
    lib = ctypes.CDLL(str(build(POINTOPS_SRC, POINTOPS_FLAGS)))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i64, f32 = ctypes.c_int64, ctypes.c_float
    lib.grid_subsample.restype = i64
    lib.grid_subsample.argtypes = [f32p, i64, ctypes.c_void_p, i64, f32,
                                   f32p, ctypes.c_void_p, i64]
    lib.radius_neighbors.restype = None
    lib.radius_neighbors.argtypes = [f32p, i64, f32p, i64, f32,
                                     ctypes.c_int32, i32p]
    lib.batch_grid_subsample.restype = None
    lib.batch_grid_subsample.argtypes = [f32p, i64p, i64, f32, f32p, i64p,
                                         i64]
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.build_sorted_keys.restype = None
    lib.build_sorted_keys.argtypes = [i32p, u8p, i64, i64p, i32p]
    lib.key_kernel_map.restype = None
    lib.key_kernel_map.argtypes = [i64p, i32p, i64, i64p, i64p, i64, i64,
                                   i32p]
    lib.downsample_coords.restype = i64
    lib.downsample_coords.argtypes = [i32p, u8p, i64, ctypes.c_int32, i64,
                                      i32p, u8p]
    return lib


def grid_subsample(points: np.ndarray, dl: float,
                   feats: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Voxel-barycentre subsampling of points [N,3] (and feats [N,C]) on
    cells of size dl: one point a cell, the f64 mean of its members, cells
    in the order of their first point -> (points [M,3] f32, feats [M,C]
    f32 or None)."""
    lib = pointops_library()
    points = np.ascontiguousarray(points, np.float32)
    n = len(points)
    out_p = np.empty((n, 3), np.float32)
    if feats is None:
        n_out = lib.grid_subsample(points, n, None, 0, dl, out_p, None, n)
        return out_p[:n_out], None
    feats = np.ascontiguousarray(feats, np.float32)
    if len(feats) != n:
        raise ValueError(f"grid_subsample: {n} points, {len(feats)} rows "
                         "of features")
    out_f = np.empty((n, feats.shape[1]), np.float32)
    n_out = lib.grid_subsample(
        points, n, feats.ctypes.data_as(ctypes.c_void_p), feats.shape[1], dl,
        out_p, out_f.ctypes.data_as(ctypes.c_void_p), n)
    return out_p[:n_out], out_f[:n_out]


def radius_neighbors(queries: np.ndarray, supports: np.ndarray,
                     radius: float, max_k: int) -> np.ndarray:
    """[Nq, max_k] int32: the supports within radius of each query (squared
    distance below radius^2), ascending by distance, padded with
    len(supports)."""
    lib = pointops_library()
    queries = np.ascontiguousarray(queries, np.float32).reshape(-1, 3)
    supports = np.ascontiguousarray(supports, np.float32).reshape(-1, 3)
    out = np.empty((len(queries), max_k), np.int32)
    lib.radius_neighbors(queries, len(queries), supports, len(supports),
                         radius, max_k, out)
    return out


def build_sorted_keys(coords: np.ndarray, mask: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The packed keys of coords [V,3] int32 (the sentinel 1 << 30 where
    mask [V] is False), stably sorted -> (keys_sorted int64 [V], order
    int32 [V]): keys_sorted[i] is the key of coords[order[i]]."""
    lib = pointops_library()
    coords = np.ascontiguousarray(coords, np.int32)
    v = len(coords)
    keys = np.empty(v, np.int64)
    order = np.empty(v, np.int32)
    lib.build_sorted_keys(coords, np.ascontiguousarray(mask, np.uint8), v,
                          keys, order)
    return keys, order


def key_kernel_map(keys_sorted: np.ndarray, order: np.ndarray,
                   base_keys: np.ndarray, off_keys: np.ndarray) -> np.ndarray:
    """[K, V_out] int32: for each offset key and output base key (the
    sentinel where the output voxel is not valid), the input row whose key
    is their sum (binary search in keys_sorted), else len(keys_sorted)."""
    lib = pointops_library()
    k, v_out = len(off_keys), len(base_keys)
    out = np.empty((k, v_out), np.int32)
    lib.key_kernel_map(np.ascontiguousarray(keys_sorted, np.int64),
                       np.ascontiguousarray(order, np.int32),
                       len(keys_sorted),
                       np.ascontiguousarray(base_keys, np.int64),
                       np.ascontiguousarray(off_keys, np.int64), k, v_out,
                       out)
    return out


def downsample_coords(coords: np.ndarray, mask: np.ndarray, stride: int,
                      v_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """unique(floor(coords / stride)) of the valid rows in ascending key
    order, the first v_out of them -> (out_coords [v_out,3] int32,
    out_mask [v_out] bool)."""
    lib = pointops_library()
    out_c = np.empty((v_out, 3), np.int32)
    out_m = np.empty(v_out, np.uint8)
    lib.downsample_coords(np.ascontiguousarray(coords, np.int32),
                          np.ascontiguousarray(mask, np.uint8), len(coords),
                          stride, v_out, out_c, out_m)
    return out_c, out_m.astype(bool)
