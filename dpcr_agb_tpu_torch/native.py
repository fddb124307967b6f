"""The port's host LASzip codec: `native/laszip.cpp` of this package (a copy
of the JAX package's `native/laszip.cpp`), compiled with g++ at first use
into `build/torch_host/liblaszip-<hash of source and flags>.so` at the
repository root (listed in .gitignore) and bound with ctypes. The build
writes a temporary file and renames it into place, so processes that build
at once never load a half-written library. There is no fallback: when the
library cannot be built, the call raises with g++'s error output; no
committed binary is ever loaded.

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
from functools import lru_cache
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "native" / "laszip.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_host"
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def library_path() -> Path:
    """Where the codec library of this source and these flags lives."""
    tag = hashlib.blake2b(SRC.read_bytes() + " ".join(GXX_FLAGS).encode(),
                          digest_size=6).hexdigest()
    return BUILD_DIR / f"liblaszip-{tag}.so"


def build() -> Path:
    """The codec library's path, compiled first when it is missing."""
    path = library_path()
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ is not on PATH: the LASzip codec ({SRC}) "
                           f"cannot be built into {path}")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SRC} "
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
