"""Point-file IO of the port (counterpart of `dpcr_agb_tpu/data/las_io.py`),
without pandas: numpy LAS reading and writing, the LASzip codec through the
port's own host library (`dpcr_agb_tpu_torch/native.py`), PLY, and the
`.npz`/`.npy`/`.csv` plots.

LAS 1.0-1.4, point data record formats 0-10 (the 64-bit point count of
1.4; XYZ, intensity, return number, classification, gps_time where the
format has it). LAZ: point formats 0-3 (compressor 2, pointwise chunked, v2
items) and the LAS 1.4 formats 6-8 (compressor 3, layered, v3 items
POINT14/RGB14/RGBNIR14/BYTE14); formats 9/10 (wave packets) raise. Writers
for LAS 1.2 format 1 (`write_las`), LAZ 1.2 format 1 (`write_laz`) and LAZ
1.4 format 6 (`write_laz14`).

`read_pt` returns LAS positions as float32, as the JAX package's does: at
UTM northings near 6e6 m a float32 step is 0.5 m, before `predict` centers
the plot. Kept for parity with the reference."""
from __future__ import annotations

import csv
import os
import struct
from typing import List, Optional, Tuple

import numpy as np


class LasReadError(Exception):
    pass


# offsets of xyz/int/cls/gps within each point record, per point format id
# (x,y,z are always the first 12 bytes as int32)
_GPS_OFFSET = {1: 20, 3: 20, 4: 20, 5: 20, 6: 22, 7: 22, 8: 22, 9: 22, 10: 22}
_CLS_OFFSET = {0: 15, 1: 15, 2: 15, 3: 15, 4: 15, 5: 15,
               6: 16, 7: 16, 8: 16, 9: 16, 10: 16}
_MIN_SIZE = {0: 20, 1: 28, 2: 26, 3: 34, 4: 57, 5: 63,
             6: 30, 7: 36, 8: 38, 9: 59, 10: 67}


def read_las(path: str, attributes: Tuple[str, ...] = ()
             ) -> Tuple[np.ndarray, dict]:
    """Read a .las or .laz file.

    Returns (pos [N,3] float64, extras dict with requested attribute arrays
    among {intensity, classification, gps_time, return_number}).
    """
    with open(path, "rb") as f:
        head = f.read(375)
        if head[:4] != b"LASF":
            raise LasReadError(f"{path}: not a LAS file")
        ver_major, ver_minor = head[24], head[25]
        header_size = struct.unpack_from("<H", head, 94)[0]
        offset_to_points = struct.unpack_from("<L", head, 96)[0]
        n_vlrs = struct.unpack_from("<L", head, 100)[0]
        raw_format = head[104]
        compressed = bool(raw_format & 0x80)
        point_format = raw_format & 0x3F  # strip LAZ compressor bits
        record_len = struct.unpack_from("<H", head, 105)[0]
        n_points = struct.unpack_from("<L", head, 107)[0]
        scales = struct.unpack_from("<3d", head, 131)
        offsets = struct.unpack_from("<3d", head, 155)
        if ver_major == 1 and ver_minor >= 4:
            n_points_64 = struct.unpack_from("<Q", head, 247)[0]
            if n_points_64:
                n_points = n_points_64
        if point_format not in _MIN_SIZE:
            raise LasReadError(
                f"{path}: unsupported point format {point_format}")
        if record_len < _MIN_SIZE[point_format]:
            raise LasReadError(f"{path}: record length {record_len} too small "
                               f"for format {point_format}")
        if compressed:
            laszip_vlr = _find_laszip_vlr(f, header_size, n_vlrs)
            if laszip_vlr is None:
                raise LasReadError(f"{path}: compressed flag set but no "
                                   "LASzip VLR found")
            f.seek(offset_to_points)
            blob = f.read()
            raw = _laz_decode(path, blob, laszip_vlr, n_points, record_len,
                              point_data_offset=offset_to_points)
        else:
            f.seek(offset_to_points)
            raw = np.frombuffer(f.read(n_points * record_len), dtype=np.uint8)
            raw = raw.reshape(n_points, record_len)

    xyz_int = raw[:, :12].copy().view("<i4").reshape(n_points, 3)
    pos = xyz_int.astype(np.float64) * np.asarray(scales) + np.asarray(offsets)

    extras = {}
    want = set(attributes)
    if "intensity" in want:
        extras["intensity"] = raw[:, 12:14].copy().view(
            "<u2").ravel().astype(np.float32)
    if "return_number" in want:
        flags = raw[:, 14]
        if point_format >= 6:
            extras["return_number"] = (flags & 0x0F).astype(np.float32)
        else:
            extras["return_number"] = (flags & 0x07).astype(np.float32)
    if "classification" in want:
        off = _CLS_OFFSET[point_format]
        cls = raw[:, off]
        if point_format < 6:
            cls = cls & 0x1F  # low 5 bits in legacy formats
        extras["classification"] = cls.astype(np.float32)
    if "gps_time" in want and point_format in _GPS_OFFSET:
        off = _GPS_OFFSET[point_format]
        extras["gps_time"] = raw[:, off:off + 8].copy().view("<f8").ravel()
    return pos, extras


# --- LAZ (LASzip) support ----------------------------------------------------

# LASzip VLR payload: compressor, coder, version x3, options, chunk_size,
# special-EVLR fields, then (type, size, version) item triples
_LASZIP_USER_ID = b"laszip encoded\x00\x00"
_LASZIP_RECORD_ID = 22204
# item schemas per point format (type ids: 6=POINT10, 7=GPSTIME11, 8=RGB12,
# 0=BYTE); extra bytes append a BYTE item
_LAZ_ITEMS = {0: [(6, 20)], 1: [(6, 20), (7, 8)], 2: [(6, 20), (8, 6)],
              3: [(6, 20), (7, 8), (8, 6)]}


def _find_laszip_vlr(f, header_size: int, n_vlrs: int) -> Optional[dict]:
    f.seek(header_size)
    for _ in range(n_vlrs):
        vlr_head = f.read(54)
        if len(vlr_head) < 54:
            return None
        user_id = vlr_head[2:18]
        record_id = struct.unpack_from("<H", vlr_head, 18)[0]
        length = struct.unpack_from("<H", vlr_head, 20)[0]
        payload = f.read(length)
        if user_id == _LASZIP_USER_ID and record_id == _LASZIP_RECORD_ID:
            compressor, coder = struct.unpack_from("<HH", payload, 0)
            chunk_size = struct.unpack_from("<L", payload, 12)[0]
            num_items = struct.unpack_from("<H", payload, 32)[0]
            items = []
            for i in range(num_items):
                t, s, v = struct.unpack_from("<HHH", payload, 34 + 6 * i)
                items.append((t, s, v))
            return {"compressor": compressor, "coder": coder,
                    "chunk_size": chunk_size, "items": items}
    return None


def _laz_decode(path: str, blob: bytes, vlr: dict, n_points: int,
                record_len: int, point_data_offset: int = 0) -> np.ndarray:
    from .. import native

    if vlr["compressor"] == 2:       # pointwise chunked, v2 items (fmt 0-3)
        for t, s, v in vlr["items"]:
            if t not in (0, 6, 7, 8) or v != 2:
                raise LasReadError(
                    f"{path}: LAZ item (type={t}, version={v}) unsupported")
    elif vlr["compressor"] == 3:     # layered chunked, v3 items (fmt 6-8)
        for t, s, v in vlr["items"]:
            if t == 13:
                raise LasReadError(
                    f"{path}: LAZ wavepacket items (formats 9/10) "
                    "unsupported; decompress to .las externally")
            if t not in (10, 11, 12, 14) or v not in (3, 4):
                raise LasReadError(
                    f"{path}: LAZ item (type={t}, version={v}) unsupported")
    else:
        raise LasReadError(
            f"{path}: LAZ compressor type {vlr['compressor']} unsupported "
            "(2 = pointwise-chunked formats 0-3, 3 = layered formats 6-8)")
    types = [t for t, s, v in vlr["items"]]
    sizes = [s for t, s, v in vlr["items"]]
    if sum(sizes) != record_len:
        raise LasReadError(f"{path}: LAZ item sizes {sizes} != record "
                           f"length {record_len}")
    return native.laz_decompress(blob, types, sizes, n_points,
                                 vlr["chunk_size"] or 50000,
                                 point_data_offset=point_data_offset)


def write_laz(path: str, pos: np.ndarray,
              classification: Optional[np.ndarray] = None,
              intensity: Optional[np.ndarray] = None,
              gps_time: Optional[np.ndarray] = None,
              scale: float = 0.001, chunk_size: int = 50000) -> None:
    """Write a LAZ-compressed LAS 1.2 point-format-1 file through the native
    LASzip codec (fixtures, prediction export, general interchange)."""
    from .. import native

    pos = np.asarray(pos, dtype=np.float64)
    n = len(pos)
    offsets = pos.min(axis=0) if n else np.zeros(3)
    record_len = 28
    header_size = 227
    vlr_payload = bytearray(34 + 6 * 2)
    struct.pack_into("<HH", vlr_payload, 0, 2, 0)       # compressor 2, coder 0
    struct.pack_into("<BBH", vlr_payload, 4, 2, 2, 0)   # version 2.2.0
    struct.pack_into("<L", vlr_payload, 8, 0)           # options
    struct.pack_into("<L", vlr_payload, 12, chunk_size)
    struct.pack_into("<qq", vlr_payload, 16, -1, -1)    # no special EVLRs
    struct.pack_into("<H", vlr_payload, 32, 2)          # num items
    struct.pack_into("<HHH", vlr_payload, 34, 6, 20, 2)  # POINT10 v2
    struct.pack_into("<HHH", vlr_payload, 40, 7, 8, 2)   # GPSTIME11 v2
    vlr = bytearray(54)
    struct.pack_into("<H", vlr, 0, 0)
    vlr[2:18] = _LASZIP_USER_ID
    struct.pack_into("<H", vlr, 18, _LASZIP_RECORD_ID)
    struct.pack_into("<H", vlr, 20, len(vlr_payload))
    struct.pack_into("<32s", vlr, 22, b"dpcr_agb_tpu laszip mini")

    offset_to_points = header_size + len(vlr) + len(vlr_payload)
    header = bytearray(header_size)
    header[0:4] = b"LASF"
    header[24] = 1
    header[25] = 2
    struct.pack_into("<31s", header, 26, b"dpcr_agb_tpu synthetic")
    struct.pack_into("<H", header, 94, header_size)
    struct.pack_into("<L", header, 96, offset_to_points)
    struct.pack_into("<L", header, 100, 1)              # one VLR (laszip)
    header[104] = 1 | 0x80                              # format 1, compressed
    struct.pack_into("<H", header, 105, record_len)
    struct.pack_into("<L", header, 107, n)
    struct.pack_into("<3d", header, 131, scale, scale, scale)
    struct.pack_into("<3d", header, 155, *offsets)
    mx, mn = (pos.max(axis=0), pos.min(axis=0)) if n else (np.zeros(3),) * 2
    struct.pack_into("<6d", header, 179, mx[0], mn[0], mx[1], mn[1],
                     mx[2], mn[2])

    rec = np.zeros((n, record_len), dtype=np.uint8)
    xyz_int = np.round((pos - offsets) / scale).astype("<i4")
    rec[:, :12] = xyz_int.view(np.uint8).reshape(n, 12)
    if intensity is not None:
        rec[:, 12:14] = np.asarray(intensity, dtype="<u2")[:, None].view(
            np.uint8).reshape(n, 2)
    rec[:, 14] = 0x09  # return 1 of 1
    if classification is not None:
        rec[:, 15] = np.asarray(classification, dtype=np.uint8)
    if gps_time is not None:
        rec[:, 20:28] = np.asarray(gps_time, dtype="<f8")[:, None].view(
            np.uint8).reshape(n, 8)

    blob = bytearray(native.laz_compress(rec, [6, 7], [20, 8], chunk_size))
    # patch the chunk-table offset from blob-relative to absolute file offset
    rel = struct.unpack_from("<q", blob, 0)[0]
    struct.pack_into("<q", blob, 0, rel + offset_to_points)
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(bytes(vlr))
        f.write(bytes(vlr_payload))
        f.write(bytes(blob))


def write_laz14(path: str, pos: np.ndarray,
                classification: Optional[np.ndarray] = None,
                intensity: Optional[np.ndarray] = None,
                gps_time: Optional[np.ndarray] = None,
                scanner_channel: Optional[np.ndarray] = None,
                scale: float = 0.001, chunk_size: int = 50000) -> None:
    """Write a LAZ-compressed LAS 1.4 point-format-6 file (compressor 3,
    layered POINT14 v3 item) through the native codec — the modern national-
    ALS-campaign format the reference ingests via laspy+lazrs."""
    from .. import native

    pos = np.asarray(pos, dtype=np.float64)
    n = len(pos)
    offsets = pos.min(axis=0) if n else np.zeros(3)
    record_len = 30
    header_size = 375
    vlr_payload = bytearray(34 + 6)
    struct.pack_into("<HH", vlr_payload, 0, 3, 0)        # compressor 3
    struct.pack_into("<BBH", vlr_payload, 4, 3, 4, 0)    # version 3.4.0
    struct.pack_into("<L", vlr_payload, 8, 0)            # options
    struct.pack_into("<L", vlr_payload, 12, chunk_size)
    struct.pack_into("<qq", vlr_payload, 16, -1, -1)     # no special EVLRs
    struct.pack_into("<H", vlr_payload, 32, 1)           # num items
    struct.pack_into("<HHH", vlr_payload, 34, 10, 30, 3)  # POINT14 v3
    vlr = bytearray(54)
    vlr[2:18] = _LASZIP_USER_ID
    struct.pack_into("<H", vlr, 18, _LASZIP_RECORD_ID)
    struct.pack_into("<H", vlr, 20, len(vlr_payload))
    struct.pack_into("<32s", vlr, 22, b"dpcr_agb_tpu laszip mini")

    offset_to_points = header_size + len(vlr) + len(vlr_payload)
    header = bytearray(header_size)
    header[0:4] = b"LASF"
    header[24] = 1
    header[25] = 4
    struct.pack_into("<31s", header, 26, b"dpcr_agb_tpu synthetic")
    struct.pack_into("<H", header, 94, header_size)
    struct.pack_into("<L", header, 96, offset_to_points)
    struct.pack_into("<L", header, 100, 1)               # one VLR (laszip)
    header[104] = 6 | 0x80                               # format 6, compressed
    struct.pack_into("<H", header, 105, record_len)
    struct.pack_into("<L", header, 107, 0)               # legacy count: 0
    struct.pack_into("<3d", header, 131, scale, scale, scale)
    struct.pack_into("<3d", header, 155, *offsets)
    mx, mn = (pos.max(axis=0), pos.min(axis=0)) if n else (np.zeros(3),) * 2
    struct.pack_into("<6d", header, 179, mx[0], mn[0], mx[1], mn[1],
                     mx[2], mn[2])
    struct.pack_into("<Q", header, 247, n)               # LAS 1.4 u64 count

    rec = np.zeros((n, record_len), dtype=np.uint8)
    xyz_int = np.round((pos - offsets) / scale).astype("<i4")
    rec[:, :12] = xyz_int.view(np.uint8).reshape(n, 12)
    if intensity is not None:
        rec[:, 12:14] = np.asarray(intensity, dtype="<u2")[:, None].view(
            np.uint8).reshape(n, 2)
    rec[:, 14] = 0x11  # return 1 of 1 (4-bit fields)
    chan = (np.zeros(n, np.uint8) if scanner_channel is None
            else np.asarray(scanner_channel, np.uint8) & 3)
    rec[:, 15] = chan << 4
    if classification is not None:
        rec[:, 16] = np.asarray(classification, dtype=np.uint8)
    if gps_time is not None:
        rec[:, 22:30] = np.asarray(gps_time, dtype="<f8")[:, None].view(
            np.uint8).reshape(n, 8)

    blob = bytearray(native.laz_compress(rec, [10], [30], chunk_size))
    rel = struct.unpack_from("<q", blob, 0)[0]
    struct.pack_into("<q", blob, 0, rel + offset_to_points)
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(bytes(vlr))
        f.write(bytes(vlr_payload))
        f.write(bytes(blob))


def write_las(path: str, pos: np.ndarray,
              classification: Optional[np.ndarray] = None,
              intensity: Optional[np.ndarray] = None,
              scale: float = 0.001) -> None:
    """Write a minimal LAS 1.2, point-format-1 file."""
    pos = np.asarray(pos, dtype=np.float64)
    n = len(pos)
    offsets = pos.min(axis=0) if n else np.zeros(3)
    record_len = 28
    header_size = 227
    header = bytearray(header_size)
    header[0:4] = b"LASF"
    header[24] = 1  # version major
    header[25] = 2  # version minor
    struct.pack_into("<31s", header, 26, b"dpcr_agb_tpu synthetic")
    struct.pack_into("<H", header, 94, header_size)
    struct.pack_into("<L", header, 96, header_size)   # offset to point data
    struct.pack_into("<L", header, 100, 0)            # n VLRs
    header[104] = 1                                    # point format
    struct.pack_into("<H", header, 105, record_len)
    struct.pack_into("<L", header, 107, n)
    struct.pack_into("<3d", header, 131, scale, scale, scale)
    struct.pack_into("<3d", header, 155, *offsets)
    mx, mn = (pos.max(axis=0), pos.min(axis=0)) if n else (np.zeros(3),) * 2
    struct.pack_into("<6d", header, 179, mx[0], mn[0], mx[1], mn[1],
                     mx[2], mn[2])

    rec = np.zeros((n, record_len), dtype=np.uint8)
    xyz_int = np.round((pos - offsets) / scale).astype("<i4")
    rec[:, :12] = xyz_int.view(np.uint8).reshape(n, 12)
    if intensity is not None:
        rec[:, 12:14] = np.asarray(intensity, dtype="<u2")[:, None].view(
            np.uint8).reshape(n, 2)
    rec[:, 14] = 0x09  # return 1 of 1
    if classification is not None:
        rec[:, 15] = np.asarray(classification, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(rec.tobytes())


def read_pt(path: str, feature_cols: List[str] = (),
            delimiter: str = ","
            ) -> Tuple[np.ndarray, Optional[np.ndarray], None]:
    """Read a point file: .las/.laz, .csv/.txt/.xyz, .ply, .npz, .npy.

    Returns (pos [N,3] float, features [N,F] or None, crs placeholder None) —
    the same contract as the reference read_pt (las_dataset.py:32-71).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext in (".las", ".laz"):
        pos, extras = read_las(path, attributes=tuple(feature_cols))
        feats = None
        if feature_cols:
            feats = np.stack([extras[c] for c in feature_cols], axis=1)
        # float32 as the JAX package returns it (0.5 m steps at 6e6 m)
        return pos.astype(np.float32), feats, None
    if ext in (".csv", ".txt", ".xyz"):
        with open(path, newline="") as f:
            rows = list(csv.reader(f, delimiter=delimiter))
        header, body = rows[0], rows[1:]
        cols = {c.strip().lower(): i for i, c in enumerate(header)}
        table = np.asarray(body, dtype=np.float64).reshape(len(body), -1)
        pos = table[:, [cols["x"], cols["y"], cols["z"]]].astype(np.float32)
        feats = None
        if feature_cols:
            by_name = {c.strip(): i for i, c in enumerate(header)}
            feats = table[:, [by_name[c] for c in feature_cols]].astype(
                np.float32)
        return pos, feats, None
    if ext == ".ply":
        props = read_ply(path)
        pos = np.stack([props["x"], props["y"], props["z"]],
                       axis=1).astype(np.float32)
        feats = (np.stack([props[c] for c in feature_cols],
                          axis=1).astype(np.float32) if feature_cols else None)
        return pos, feats, None
    if ext == ".npz":
        with np.load(path) as z:
            feats = (z["features"].astype(np.float32)
                     if "features" in z else None)
            return z["pos"].astype(np.float32), feats, None
    if ext == ".npy":
        return np.load(path).astype(np.float32), None, None
    raise LasReadError(f"Unsupported point file extension: {path}")


# --- PLY (reference read_pt handles .ply via plyfile; minimal reader/writer
# for binary_little_endian and ascii vertex elements) -------------------------

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> dict:
    """Vertex properties of a PLY file -> {name: 1-D array}."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        n_vertex = 0
        props = []
        in_vertex = False
        while True:
            line = f.readline().strip().decode()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n_vertex = int(count)
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                if parts[1] == "list":
                    raise ValueError("list properties unsupported")
                props.append((parts[2], _PLY_TYPES[parts[1]]))
            elif line == "end_header":
                break
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n_vertex, ndmin=2)
            return {name: data[:, i].astype(dt)
                    for i, (name, dt) in enumerate(props)}
        endian = "<" if fmt == "binary_little_endian" else ">"
        dtype = np.dtype([(n, endian + d) for n, d in props])
        arr = np.frombuffer(f.read(dtype.itemsize * n_vertex), dtype=dtype,
                            count=n_vertex)
        return {n: np.ascontiguousarray(arr[n]) for n, _ in props}


def write_ply(path: str, pos: np.ndarray, **extra_props) -> None:
    """Binary little-endian PLY with xyz + named scalar properties."""
    pos = np.asarray(pos, np.float32)
    names = ["x", "y", "z"] + list(extra_props)
    cols = [pos[:, 0], pos[:, 1], pos[:, 2]] + [
        np.asarray(v) for v in extra_props.values()]
    dtype = np.dtype([(n, "<" + (c.dtype.str[1:] if c.dtype.str[1:] in
                                 ("f4", "f8", "i4", "u1", "i2", "u2", "u4",
                                  "i1") else "f4"))
                      for n, c in zip(names, cols)])
    rec = np.empty(len(pos), dtype=dtype)
    for n, c in zip(names, cols):
        rec[n] = c.astype(rec.dtype[n])
    ply_type = {"f4": "float", "f8": "double", "i4": "int", "u1": "uchar",
                "i1": "char", "i2": "short", "u2": "ushort", "u4": "uint"}
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(pos)}\n".encode())
        for n in names:
            kind = ply_type[rec.dtype[n].str[1:]]
            f.write(f"property {kind} {n}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())
