"""msgpack without the msgpack package: the encoding of the JAX package's
`.ckpt` files (counterpart of `flax.serialization.msgpack_serialize` and
`msgpack_restore`, which `dpcr_agb_tpu/training/state.py` writes and reads
them with), in the standard library and numpy.

`unpackb` reads every msgpack type: nil, bool, the integers (fixint, int
and uint 8-64), float 32/64, str, bin, array, map and ext. Arrays come back
as lists, map keys as str. flax's ext codes carry numbers:
  1  an ndarray; its payload is itself msgpack, `(shape, dtype name,
     C-order bytes)`
  2  a Python complex; payload `(real, imag)`
  3  a numpy scalar; payload as code 1; returned as a 0-d array
Other ext codes come back as `Ext(code, data)`, equal to msgpack's
`ExtType`. An array is cut out of the input by `np.frombuffer` on a
memoryview and copied once; a `bfloat16` array (numpy has none) is read as
int16 and returned as a `torch.bfloat16` tensor. flax splits an array of
over MAX_CHUNK_SIZE bytes that is a map value into a map
`{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks": {"0":
..}}`; `unpackb` joins the chunks into one array (still one copy: the
chunks are read as views and concatenated).

`packb` writes flax's ext codes for numpy arrays, numpy scalars, torch
tensors and complex numbers, and chunks arrays where flax does (map values
and the top level), so `flax.serialization.msgpack_restore` reads its
bytes back. Map keys must be str; tuples are written as arrays."""
from __future__ import annotations

import struct
from typing import Any, List, NamedTuple, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30   # flax.serialization.MAX_CHUNK_SIZE


class Ext(NamedTuple):
    """An ext value of a code that is not flax's."""
    code: int
    data: bytes


class _View(NamedTuple):
    """An array chunk still in the input's bytes (bf16 as int16)."""
    array: np.ndarray
    bf16: bool


_B, _H, _I, _Q = (struct.Struct(f">{c}") for c in "BHIQ")
_b, _h, _i, _q = (struct.Struct(f">{c}") for c in "bhiq")
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")
# fixext1..16: payload length; ext8/16/32: the struct of the length
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_EXT_LEN = {0xc7: _B, 0xc8: _H, 0xc9: _I}
_INTS = {0xcc: _B, 0xcd: _H, 0xce: _I, 0xcf: _Q,
         0xd0: _b, 0xd1: _h, 0xd2: _i, 0xd3: _q}
_LEN = {0xc4: _B, 0xc5: _H, 0xc6: _I,          # bin
        0xd9: _B, 0xda: _H, 0xdb: _I,          # str
        0xdc: _H, 0xdd: _I,                    # array
        0xde: _H, 0xdf: _I}                    # map


def unpackb(data) -> Any:
    """Decode one msgpack object (bytes-like) that fills `data`."""
    buf = memoryview(data).cast("B")
    obj, end = _read(buf, 0, False)
    if end != len(buf):
        raise ValueError(f"msgpack: {len(buf) - end} bytes after the object")
    return obj


def _read(buf: memoryview, pos: int, views: bool) -> Tuple[Any, int]:
    """(object, next position). `views`: inside a chunked array's map,
    arrays come back as uncopied `_View`s and bin as memoryviews."""
    t = buf[pos]
    pos += 1
    if t <= 0x7f:
        return t, pos
    if t >= 0xe0:
        return t - 0x100, pos
    if t <= 0x8f:
        return _read_map(buf, pos, t & 0x0f, views)
    if t <= 0x9f:
        return _read_list(buf, pos, t & 0x0f, views)
    if t <= 0xbf:
        n = t & 0x1f
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if t == 0xc0:
        return None, pos
    if t in (0xc2, 0xc3):
        return t == 0xc3, pos
    if t in _INTS:
        s = _INTS[t]
        return s.unpack_from(buf, pos)[0], pos + s.size
    if t == 0xca:
        return _F32.unpack_from(buf, pos)[0], pos + 4
    if t == 0xcb:
        return _F64.unpack_from(buf, pos)[0], pos + 8
    if t in _FIXEXT or t in _EXT_LEN:
        if t in _FIXEXT:
            n = _FIXEXT[t]
        else:
            n = _EXT_LEN[t].unpack_from(buf, pos)[0]
            pos += _EXT_LEN[t].size
        code = _b.unpack_from(buf, pos)[0]
        pos += 1
        return _ext(code, buf[pos:pos + n], views), pos + n
    if t not in _LEN:
        raise ValueError(f"msgpack: byte 0x{t:02x} at {pos - 1} starts no "
                         "object")
    s = _LEN[t]
    n = s.unpack_from(buf, pos)[0]
    pos += s.size
    if t <= 0xc6:
        raw = buf[pos:pos + n]
        return (raw if views else bytes(raw)), pos + n
    if t <= 0xdb:
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if t <= 0xdd:
        return _read_list(buf, pos, n, views)
    return _read_map(buf, pos, n, views)


def _read_list(buf, pos, n, views):
    out = []
    for _ in range(n):
        v, pos = _read(buf, pos, views)
        out.append(v)
    return out, pos


def _read_map(buf, pos, n, views):
    out = {}
    for i in range(n):
        k, pos = _read(buf, pos, False)
        if not isinstance(k, str):
            raise ValueError(f"msgpack: map key {k!r} is not a str")
        views = views or (i == 0 and k == CHUNKED)
        out[k], pos = _read(buf, pos, views)
    if CHUNKED in out:
        return _unchunk(out), pos
    return out, pos


def _ext(code: int, payload: memoryview, views: bool):
    if code in (EXT_NDARRAY, EXT_NPSCALAR):
        (shape, name, raw), _ = _read(payload, 0, True)
        bf16 = name == "bfloat16"
        arr = np.frombuffer(raw, np.int16 if bf16 else np.dtype(name))
        arr = arr.reshape(shape)
        if views and code == EXT_NDARRAY:
            return _View(arr, bf16)
        return _finish(arr.copy(), bf16)
    if code == EXT_COMPLEX:
        (re, im), _ = _read(payload, 0, False)
        return complex(re, im)
    return Ext(code, bytes(payload))


def _finish(arr: np.ndarray, bf16: bool):
    return torch.from_numpy(arr).view(torch.bfloat16) if bf16 else arr


def _unchunk(d: dict):
    """flax's `_unchunk`: the chunks of one array joined and reshaped (one
    copy: flax writes the marker first, so they were read as views)."""
    shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if not all(isinstance(c, _View) for c in chunks):
        raise ValueError(f"msgpack: a chunked array whose map does not "
                         f"start with {CHUNKED!r}")
    flat = np.concatenate([c.array.reshape(-1) for c in chunks])
    return _finish(flat.reshape(shape), chunks[0].bf16)


def packb(obj) -> bytes:
    """Encode `obj` (dict with str keys, list, tuple, str, bytes, int,
    float, bool, None, complex, numpy array or scalar, torch tensor)."""
    out: List[bytes] = []
    _write(_chunked(obj), out)
    return b"".join(out)


def _chunked(obj):
    """An array over MAX_CHUNK_SIZE bytes as flax's chunk map."""
    if not isinstance(obj, (np.ndarray, torch.Tensor)):
        return obj
    itemsize = obj.element_size() if isinstance(obj, torch.Tensor) \
        else obj.itemsize
    if itemsize * int(np.prod(obj.shape)) <= MAX_CHUNK_SIZE:
        return obj
    step = max(1, MAX_CHUNK_SIZE // itemsize)
    flat = obj.reshape(-1)
    chunks = [flat[i:i + step] for i in range(0, flat.shape[0], step)]
    return {CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(obj.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _header(out: List[bytes], n: int, fix: int, fix_max: int,
            codes: Tuple[int, ...]) -> None:
    """The type and length bytes of a str, bin, array or map of n items:
    the fix form below fix_max, else the 8-, 16- or 32-bit length form
    (`codes`, one code per width, the 8-bit one left out where the type has
    none)."""
    if fix is not None and n < fix_max:
        out.append(_B.pack(fix | n))
        return
    widths = ((0xff, _B), (0xffff, _H), (0xffffffff, _I))[3 - len(codes):]
    for (limit, s), code in zip(widths, codes):
        if n <= limit:
            out.append(_B.pack(code) + s.pack(n))
            return
    raise ValueError(f"msgpack: length {n} over 2**32 - 1")


def _write_ext(out: List[bytes], code: int, payload) -> None:
    n = len(payload)
    fix = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}.get(n)
    if fix is not None:
        out.append(_B.pack(fix))
    elif n <= 0xff:
        out.append(_B.pack(0xc7) + _B.pack(n))
    elif n <= 0xffff:
        out.append(_B.pack(0xc8) + _H.pack(n))
    elif n <= 0xffffffff:
        out.append(_B.pack(0xc9) + _I.pack(n))
    else:
        raise ValueError(f"msgpack: ext payload of {n} bytes")
    out.append(_b.pack(code))
    out.append(payload)


def _array_payload(arr) -> bytes:
    """flax's `_ndarray_to_bytes`: msgpack of (shape, dtype name, bytes)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            name, raw = "bfloat16", t.view(torch.int16).numpy()
        else:
            raw = t.numpy()
            name = raw.dtype.name
    else:
        # ascontiguousarray alone would make a 0-d array 1-d
        raw = np.ascontiguousarray(arr).reshape(np.shape(arr))
        if raw.dtype.hasobject or raw.dtype.fields is not None:
            raise ValueError("msgpack: object and structured arrays are "
                             "not supported")
        name = raw.dtype.name
    out: List[bytes] = []
    _write([list(raw.shape), name, memoryview(raw.reshape(-1).view(np.uint8))],
           out)
    return b"".join(out)


def _write(obj, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.generic):
        # before int and float: np.float64 is a float (flax's msgpack
        # writes every numpy scalar as code 3)
        _write_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _write_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _header(out, len(raw), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        _header(out, n, None, 0, (0xc4, 0xc5, 0xc6))
        out.append(obj)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, (0xde, 0xdf))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack: map key {k!r} is not a str")
            _write(k, out)
            _write(_chunked(v), out)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, (0xdc, 0xdd))
        for v in obj:
            _write(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _write_ext(out, EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, complex):
        inner: List[bytes] = []
        _write([obj.real, obj.imag], inner)
        _write_ext(out, EXT_COMPLEX, b"".join(inner))
    else:
        raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


def _write_int(v: int, out: List[bytes]) -> None:
    if 0 <= v <= 0x7f or -32 <= v < 0:
        out.append(_b.pack(v) if v < 0 else _B.pack(v))
        return
    if v > 0:
        for code, s, limit in ((0xcc, _B, 0xff), (0xcd, _H, 0xffff),
                               (0xce, _I, 0xffffffff),
                               (0xcf, _Q, 0xffffffffffffffff)):
            if v <= limit:
                out.append(_B.pack(code) + s.pack(v))
                return
    else:
        for code, s, limit in ((0xd0, _b, 0x80), (0xd1, _h, 0x8000),
                               (0xd2, _i, 0x80000000),
                               (0xd3, _q, 0x8000000000000000)):
            if -v <= limit:
                out.append(_B.pack(code) + s.pack(v))
                return
    raise OverflowError(f"msgpack: integer {v} out of the 64-bit range")
