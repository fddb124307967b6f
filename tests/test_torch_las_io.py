"""The port's point-file IO (`dpcr_agb_tpu_torch/data/las_io.py`) and host
LASzip codec (`dpcr_agb_tpu_torch/native.py`, built from the port's copy
of `laszip.cpp`) against the JAX package's on the CPU:

- `read_las` equals `dpcr_agb_tpu.data.las_io.read_las` exactly
  (positions and every attribute) on files written by the JAX package's
  `write_las`, `write_laz` (one and several chunks) and `write_laz14`, and
  on uncompressed LAS 1.0-1.4 files of every point format 0-10 (the 64-bit
  count of 1.4, records longer than their format);
- the port's codec decodes streams that the independent oracle
  `tests/laz_oracle.py` encoded and encodes streams the oracle decodes
  (v2 pointwise and v3 layered items), and whole oracle-written `.laz`
  files read as the JAX package reads them;
- the port's `write_las`, `write_laz` and `write_laz14` are read back equal
  by the JAX reader;
- `read_ply`/`write_ply` both ways (binary and ascii) and `read_pt` for
  every extension agree with the JAX package's;
- no fallback: with no built library and g++ off PATH the codec raises,
  and no library is opened (never the JAX package's
  `native/liblaszip_mini*.so`)."""
import ctypes
import os
import struct

import numpy as np
import pytest

import laz_oracle
from dpcr_agb_tpu.data import las_io as jlas
from dpcr_agb_tpu_torch import native
from dpcr_agb_tpu_torch.data import las_io

ATTRS = ("intensity", "return_number", "classification", "gps_time")
# the LAS version each uncompressed point format is written under
FORMAT_VERSION = {0: 0, 1: 1, 2: 2, 3: 3, 4: 3, 5: 3, 6: 4, 7: 4, 8: 4,
                  9: 4, 10: 4}


def _cloud(rng, n=3000):
    pos = np.cumsum(rng.normal(0, 0.4, (n, 3)), axis=0) \
        + np.array([5e5, 6e6, 50.0])
    return (pos, rng.integers(1, 6, n), rng.integers(0, 3000, n),
            1e8 + np.cumsum(rng.random(n) * 1e-5))


def _same_read(path, attrs=ATTRS):
    """The port's read_las equals the JAX package's, bit for bit."""
    pos, extras = las_io.read_las(path, attributes=attrs)
    jpos, jextras = jlas.read_las(path, attributes=attrs)
    np.testing.assert_array_equal(pos, jpos)
    assert pos.dtype == jpos.dtype == np.float64
    assert extras.keys() == jextras.keys()
    for k in jextras:
        assert extras[k].dtype == jextras[k].dtype, k
        np.testing.assert_array_equal(extras[k], jextras[k], err_msg=k)
    return pos, extras


@pytest.mark.parametrize("kind", ["las", "laz", "laz_chunked", "laz14"])
def test_read_las_equals_jax_on_jax_written_files(tmp_path, kind):
    rng = np.random.default_rng(0)
    pos, cls, inten, gps = _cloud(rng)
    path = str(tmp_path / f"p.{kind[:3]}")
    if kind == "las":
        jlas.write_las(path, pos, classification=cls, intensity=inten)
    elif kind == "laz14":
        jlas.write_laz14(path, pos, classification=cls, intensity=inten,
                         gps_time=gps, scanner_channel=rng.integers(0, 3,
                                                                   len(pos)),
                         chunk_size=1100)
    else:
        jlas.write_laz(path, pos, classification=cls, intensity=inten,
                       gps_time=gps,
                       chunk_size=700 if kind == "laz_chunked" else 50000)
    got, extras = _same_read(path, ATTRS if kind != "las" else ATTRS[:3])
    np.testing.assert_allclose(got, pos, atol=1e-3)
    np.testing.assert_array_equal(extras["classification"], cls)
    np.testing.assert_array_equal(extras["intensity"], inten)
    if kind != "las":
        np.testing.assert_array_equal(extras["gps_time"], gps)


def _raw_las(path, rng, fmt, n=257):
    """An uncompressed LAS 1.<minor> file of point format `fmt`: random
    records two bytes longer than the format's, a VLR, and for 1.4 the
    64-bit count with the legacy count 0."""
    minor = FORMAT_VERSION[fmt]
    header_size = {0: 227, 1: 227, 2: 227, 3: 235, 4: 375}[minor]
    record_len = las_io._MIN_SIZE[fmt] + 2
    vlr = struct.pack("<H16sHH32s", 0, b"someone\x00" * 2, 7, 4,
                      b"test vlr") + b"abcd"
    offset = header_size + len(vlr)
    head = bytearray(header_size)
    head[0:4] = b"LASF"
    head[24], head[25] = 1, minor
    struct.pack_into("<H", head, 94, header_size)
    struct.pack_into("<L", head, 96, offset)
    struct.pack_into("<L", head, 100, 1)
    head[104] = fmt
    struct.pack_into("<H", head, 105, record_len)
    struct.pack_into("<L", head, 107, 0 if minor == 4 else n)
    struct.pack_into("<3d", head, 131, 0.01, 0.02, 0.005)
    struct.pack_into("<3d", head, 155, 4.9e5, 6.1e6, -20.0)
    if minor == 4:
        struct.pack_into("<Q", head, 247, n)
    recs = rng.integers(0, 256, (n, record_len)).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(bytes(head) + vlr + recs.tobytes())


@pytest.mark.parametrize("fmt", range(11))
def test_read_las_equals_jax_on_every_point_format(tmp_path, fmt):
    path = str(tmp_path / f"f{fmt}.las")
    _raw_las(path, np.random.default_rng(fmt), fmt)
    pos, extras = _same_read(path)
    assert pos.shape == (257, 3)
    assert ("gps_time" in extras) == (fmt in las_io._GPS_OFFSET)


def test_codec_against_the_oracle_both_ways():
    """v2 (POINT10 + GPSTIME11 + RGB12 + BYTE, chunks of 128) and v3
    (POINT14 + RGBNIR14 + BYTE14, chunks of 256, 4 scanner channels):
    oracle-encoded streams decode to their records, and the oracle decodes
    the port's encoding."""
    rng = np.random.default_rng(1)
    n = 500
    xyz = np.cumsum(rng.integers(-2000, 2000, (n, 3)), axis=0)
    rn = rng.integers(1, 4, n)
    flags = (rn | (np.maximum(rn, rng.integers(1, 4, n)) << 3)).astype(int)
    gps = np.cumsum(rng.random(n) * 1e-4) + 3e5
    gps[300:] += 1e7
    recs = [struct.pack(
        "<iiiHBBbBHdHHHB", *map(int, xyz[i]), int(rng.integers(0, 3000)),
        int(flags[i]), int(rng.choice([1, 2, 4, 5])),
        int(rng.integers(-30, 30)), int(rng.integers(0, 3)),
        int(rng.integers(0, 5)), float(gps[i]),
        *(int(v) for v in rng.integers(0, 65536, 3)),
        int(rng.integers(0, 256))) for i in range(n)]
    recs14 = []
    for i in range(n):
        nret = int(rng.integers(1, 6))
        recs14.append(struct.pack(
            "<iiiHBBBBhHd", *map(int, xyz[i]), int(rng.integers(0, 5000)),
            int(rng.integers(1, nret + 1)) | (nret << 4),
            int(rng.integers(0, 4)) | (int(rng.integers(0, 4)) << 4),
            int(rng.integers(0, 32)), int(rng.integers(0, 5)),
            int(rng.integers(-6000, 6000)), int(rng.integers(50, 54)),
            float(gps[i]))
            + struct.pack("<4H", *(int(v) for v in rng.integers(0, 65536, 4)))
            + bytes(int(v) for v in rng.integers(0, 256, 2)))
    for records, types, sizes, chunk, encode, decode in (
            (recs, [6, 7, 8, 0], [20, 8, 6, 1], 128,
             laz_oracle.encode_blob,
             lambda b: laz_oracle.decode_blob(b, [6, 7, 8, 0],
                                              [20, 8, 6, 1], n, 128)),
            (recs14, [10, 12, 14], [30, 8, 2], 256,
             laz_oracle.encode_blob_layered,
             lambda b: laz_oracle.decode_blob_layered(b, [10, 12, 14],
                                                      [30, 8, 2], n))):
        want = b"".join(records)
        blob = encode(records, types, sizes, chunk_size=chunk)
        assert native.laz_decompress(blob, types, sizes, n,
                                     chunk).tobytes() == want
        arr = np.frombuffer(want, np.uint8).reshape(n, sum(sizes))
        assert decode(native.laz_compress(arr, types, sizes,
                                          chunk_size=chunk)) == want


@pytest.mark.parametrize("writer", ["write_laz", "write_laz14"])
def test_oracle_written_files_read_as_jax_reads_them(tmp_path, writer):
    rng = np.random.default_rng(2)
    pos, cls, inten, gps = _cloud(rng, 700)
    path = str(tmp_path / "foreign.laz")
    getattr(laz_oracle, writer)(path, pos, classification=cls,
                                intensity=inten, gps_time=gps,
                                chunk_size=256)
    got, extras = _same_read(path)
    np.testing.assert_allclose(got, pos, atol=1e-3)
    np.testing.assert_array_equal(extras["gps_time"], gps)


@pytest.mark.parametrize("writer", ["write_las", "write_laz", "write_laz14"])
def test_port_writers_read_back_by_jax(tmp_path, writer):
    rng = np.random.default_rng(3)
    pos, cls, inten, gps = _cloud(rng, 2000)
    path = str(tmp_path / ("p.las" if writer == "write_las" else "p.laz"))
    kw = {} if writer == "write_las" else {"gps_time": gps,
                                           "chunk_size": 600}
    getattr(las_io, writer)(path, pos, classification=cls, intensity=inten,
                            **kw)
    jpath = str(tmp_path / ("j" + os.path.basename(path)))
    getattr(jlas, writer)(jpath, pos, classification=cls, intensity=inten,
                          **kw)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()          # the same bytes as JAX's
    jpos, jextras = jlas.read_las(path, attributes=ATTRS[:3] + (
        () if writer == "write_las" else ("gps_time",)))
    np.testing.assert_allclose(jpos, pos, atol=1e-3)
    np.testing.assert_array_equal(jextras["classification"], cls)
    np.testing.assert_array_equal(jextras["intensity"], inten)


def test_ply_both_ways_binary_and_ascii(tmp_path):
    rng = np.random.default_rng(4)
    pos = rng.normal(size=(50, 3)).astype(np.float32) * 10
    extra = {"intensity": rng.integers(0, 60000, 50).astype(np.uint16),
             "h": rng.normal(size=50)}
    las_io.write_ply(str(tmp_path / "a.ply"), pos, **extra)
    jlas.write_ply(str(tmp_path / "b.ply"), pos, **extra)
    assert (tmp_path / "a.ply").read_bytes() == \
        (tmp_path / "b.ply").read_bytes()
    ascii_ply = ("ply\nformat ascii 1.0\nelement vertex 3\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "property uchar c\nend_header\n"
                 "1.5 2 3 7\n4 5.25 6 8\n-1 0 2 9\n")
    (tmp_path / "c.ply").write_text(ascii_ply)
    for name in ("a.ply", "c.ply"):
        got = las_io.read_ply(str(tmp_path / name))
        want = jlas.read_ply(str(tmp_path / name))
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("ext", [".las", ".laz", ".ply", ".npz", ".npy",
                                 ".csv", ".txt", ".xyz"])
def test_read_pt_equals_jax_for_every_extension(tmp_path, ext):
    rng = np.random.default_rng(5)
    pos, cls, inten, _ = _cloud(rng, 400)
    path = str(tmp_path / f"plot{ext}")
    feats = []
    if ext == ".las":
        jlas.write_las(path, pos, classification=cls, intensity=inten)
        feats = ["classification", "intensity"]
    elif ext == ".laz":
        jlas.write_laz14(path, pos, classification=cls, intensity=inten)
        feats = ["intensity"]
    elif ext == ".ply":
        jlas.write_ply(path, pos, intensity=inten.astype(np.uint16))
        feats = ["intensity"]
    elif ext == ".npz":
        np.savez(path, pos=pos, features=np.stack([cls, inten], 1))
    elif ext == ".npy":
        np.save(path, pos)
    else:
        with open(path, "w") as f:
            f.write("X,y,Z,intensity\n")
            for p, i in zip(pos, inten):
                f.write(f"{p[0]:.3f},{p[1]:.3f},{p[2]:.3f},{i}\n")
        feats = ["intensity"]
    got = las_io.read_pt(path, feats)
    want = jlas.read_pt(path, feats)
    assert got[2] is want[2] is None
    assert got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    if want[1] is None:
        assert got[1] is None
    else:
        assert got[1].dtype == want[1].dtype
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(las_io.LasReadError, match="Unsupported"):
        las_io.read_pt(str(tmp_path / "plot.e57"))


def test_codec_never_falls_back(tmp_path, monkeypatch):
    """No built library and no g++: the codec raises, naming g++, and
    opens no library at all; the library it would load lives under the
    build directory, built from the port's own copy of laszip.cpp."""
    rng = np.random.default_rng(6)
    path = str(tmp_path / "p.laz")
    jlas.write_laz14(path, _cloud(rng, 100)[0])
    opened = []
    monkeypatch.setattr(ctypes, "CDLL",
                        lambda p, *a, **k: opened.append(str(p)))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    native.laz_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            las_io.read_las(path)
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            las_io.write_laz(str(tmp_path / "q.laz"), np.zeros((5, 3)))
    finally:
        native.laz_library.cache_clear()
    assert opened == []
    lib = native.library_path()
    assert lib.parent == tmp_path / "build" and not lib.exists()
    assert lib.name.startswith("liblaszip-") and "mini" not in lib.name
    assert native.SRC.parent.parent.name == "dpcr_agb_tpu_torch"
    with open(native.SRC, "rb") as a, open(os.path.join(
            os.path.dirname(__file__), "..", "native", "laszip.cpp"),
            "rb") as b:
        assert a.read() == b.read()
