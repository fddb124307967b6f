"""Minimal GeoPackage (.gpkg) point-layer reader and writer on the
standard library's sqlite3 (counterpart of
`dpcr_agb_tpu/visualization/gpkg.py`), over the port's column table
(`data/table.Table`) instead of a DataFrame.

POINT feature tables with scalar attribute columns, standard
GeoPackageBinary headers and the gpkg_contents / gpkg_geometry_columns /
gpkg_spatial_ref_sys metadata tables. `read_gpkg` gives the columns the
dtypes pandas' read_sql_query gives (int64, float64 where an int column has
a gap, str columns with NaN for the missing), the layer's `fid` included,
with the geometry as `x` and `y` at the end.
"""
from __future__ import annotations

import os
import sqlite3
import struct
from datetime import datetime, timezone
from typing import Optional

import numpy as np

from ..data.table import Table, isna


def _point_to_gpb(x: float, y: float, srs_id: int = 0) -> bytes:
    """GeoPackageBinary blob for a 2D point (no envelope)."""
    header = struct.pack("<2sBBi", b"GP", 0, 0b00000001, srs_id)
    if np.isnan(x) or np.isnan(y):
        header = struct.pack("<2sBBi", b"GP", 0, 0b00010001, srs_id)  # empty
        wkb = struct.pack("<BI2d", 1, 1, float("nan"), float("nan"))
        return header + wkb
    wkb = struct.pack("<BI2d", 1, 1, x, y)
    return header + wkb


def _gpb_to_point(blob: bytes):
    if blob is None or len(blob) < 8 or blob[:2] != b"GP":
        return (np.nan, np.nan)
    flags = blob[3]
    endian = "<" if flags & 1 else ">"
    env_code = (flags >> 1) & 0b111
    env_len = {0: 0, 1: 32, 2: 48, 3: 48, 4: 64}.get(env_code, 0)
    wkb = blob[8 + env_len:]
    if len(wkb) < 21:
        return (np.nan, np.nan)
    wkb_endian = "<" if wkb[0] == 1 else ">"
    geom_type = struct.unpack(wkb_endian + "I", wkb[1:5])[0]
    if geom_type % 1000 != 1:  # not a point
        return (np.nan, np.nan)
    x, y = struct.unpack(wkb_endian + "2d", wkb[5:21])
    return (x, y)


_SRS_ROWS = [
    ("Undefined cartesian SRS", -1, "NONE", -1, "undefined", "undefined"),
    ("Undefined geographic SRS", 0, "NONE", 0, "undefined", "undefined"),
    ("WGS 84 geodetic", 4326, "EPSG", 4326,
     'GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",6378137,'
     '298.257223563]],PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433]]',
     "longitude/latitude"),
]


def _ensure_meta(con: sqlite3.Connection) -> None:
    con.executescript("""
    PRAGMA application_id = 1196444487;  -- "GPKG"
    PRAGMA user_version = 10300;
    CREATE TABLE IF NOT EXISTS gpkg_spatial_ref_sys (
      srs_name TEXT NOT NULL, srs_id INTEGER PRIMARY KEY,
      organization TEXT NOT NULL, organization_coordsys_id INTEGER NOT NULL,
      definition TEXT NOT NULL, description TEXT);
    CREATE TABLE IF NOT EXISTS gpkg_contents (
      table_name TEXT PRIMARY KEY, data_type TEXT NOT NULL,
      identifier TEXT UNIQUE, description TEXT DEFAULT '',
      last_change DATETIME NOT NULL DEFAULT
        (strftime('%Y-%m-%dT%H:%M:%fZ','now')),
      min_x DOUBLE, min_y DOUBLE, max_x DOUBLE, max_y DOUBLE,
      srs_id INTEGER);
    CREATE TABLE IF NOT EXISTS gpkg_geometry_columns (
      table_name TEXT NOT NULL, column_name TEXT NOT NULL,
      geometry_type_name TEXT NOT NULL, srs_id INTEGER NOT NULL,
      z TINYINT NOT NULL, m TINYINT NOT NULL,
      CONSTRAINT pk_geom_cols PRIMARY KEY (table_name, column_name));
    """)
    for row in _SRS_ROWS:
        con.execute(
            "INSERT OR IGNORE INTO gpkg_spatial_ref_sys VALUES (?,?,?,?,?,?)", row)


def _sql_type(dtype) -> str:
    if dtype.kind in "iub":
        return "INTEGER"
    if dtype.kind == "f":
        return "REAL"
    return "TEXT"


def write_gpkg(path: str, df: Table, layer: str = "layer",
               x_col: str = "x", y_col: str = "y", srs_id: int = 0,
               append: bool = False) -> None:
    """Write (or append to) a point layer; x/y columns become the geometry."""
    con = sqlite3.connect(path)
    try:
        _ensure_meta(con)
        attr_cols = [c for c in df.columns if c not in (x_col, y_col, "geom")]
        exists = con.execute(
            "SELECT 1 FROM sqlite_master WHERE type='table' AND name=?",
            (layer,)).fetchone()
        if exists and not append:
            con.execute(f'DROP TABLE "{layer}"')
            exists = None
        if not exists:
            cols_sql = ", ".join(
                f'"{c}" {_sql_type(df[c].dtype)}' for c in attr_cols)
            con.execute(
                f'CREATE TABLE "{layer}" (fid INTEGER PRIMARY KEY AUTOINCREMENT,'
                f' geom BLOB{", " + cols_sql if cols_sql else ""})')
            con.execute(
                "INSERT OR REPLACE INTO gpkg_geometry_columns VALUES (?,?,?,?,0,0)",
                (layer, "geom", "POINT", srs_id))
            con.execute(
                "INSERT OR REPLACE INTO gpkg_contents "
                "(table_name, data_type, identifier, srs_id, last_change) "
                "VALUES (?,?,?,?,?)",
                (layer, "features", layer, srs_id,
                 datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")))
        xs = df[x_col] if x_col in df else np.full(len(df), np.nan)
        ys = df[y_col] if y_col in df else np.full(len(df), np.nan)
        cols = [(df[c], isna(df[c])) for c in attr_cols]
        rows = []
        for i in range(len(df)):
            vals = [None if miss[i] else
                    (v[i].item() if isinstance(v[i], np.generic) else v[i])
                    for v, miss in cols]
            rows.append([_point_to_gpb(float(xs[i]), float(ys[i]), srs_id)] + vals)
        placeholders = ",".join("?" * (1 + len(attr_cols)))
        col_names = ", ".join(['geom'] + [f'"{c}"' for c in attr_cols])
        con.executemany(
            f'INSERT INTO "{layer}" ({col_names}) VALUES ({placeholders})', rows)
        con.commit()
    finally:
        con.close()


def list_layers(path: str):
    con = sqlite3.connect(path)
    try:
        return [r[0] for r in con.execute(
            "SELECT table_name FROM gpkg_contents WHERE data_type='features'")]
    finally:
        con.close()


def read_gpkg(path: str, layer: Optional[str] = None) -> Table:
    """Read a point layer into a Table with x/y columns for the geometry."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    con = sqlite3.connect(path)
    try:
        if layer is None:
            layers = [r[0] for r in con.execute(
                "SELECT table_name FROM gpkg_contents "
                "WHERE data_type='features'")]
            if not layers:
                raise ValueError(f"No feature layers in {path}")
            layer = layers[0]
        geom_col = con.execute(
            "SELECT column_name FROM gpkg_geometry_columns WHERE table_name=?",
            (layer,)).fetchone()
        geom_col = geom_col[0] if geom_col else "geom"
        cur = con.execute(f'SELECT * FROM "{layer}"')
        names = [d[0] for d in cur.description]
        records = cur.fetchall()
        cols = {n: [r[j] for r in records] for j, n in enumerate(names)}
        geom = cols.pop(geom_col, None)
        df = Table(cols, np.arange(len(records), dtype=np.int64))
        if geom is not None:
            pts = np.array([_gpb_to_point(b) for b in geom],
                           dtype=np.float64).reshape(-1, 2)
            df["x"] = pts[:, 0]
            df["y"] = pts[:, 1]
        return df
    finally:
        con.close()
