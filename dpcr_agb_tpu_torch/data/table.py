"""A small column table: ordered columns of numpy arrays over a row index,
with the operations that label tables, the dataset and the prediction
writers need (the GPU machine has no pandas).

Columns hold int64, float64, bool or object arrays; an object column holds
str values with float NaN where a value is missing, as pandas' string
columns read back. The row index is an int64 array of labels (pandas'
index): selecting, dropping and concatenating keep the labels, and
`reset_index` numbers the rows 0..n-1."""
from __future__ import annotations

import csv
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

# pandas' default missing-value strings of read_csv
NA_STRINGS = {"", "-1.#IND", "1.#QNAN", "1.#IND", "-1.#QNAN", "#N/A N/A",
              "#N/A", "N/A", "n/a", "NA", "<NA>", "#NA", "NULL", "null",
              "NaN", "-NaN", "nan", "-nan", "None"}


def isna(values: np.ndarray) -> np.ndarray:
    """Missing entries: NaN in float columns, None or NaN in object ones."""
    values = np.asarray(values)
    if values.dtype.kind == "f":
        return np.isnan(values)
    if values.dtype.kind == "O":
        return np.array([v is None or (isinstance(v, float) and v != v)
                         for v in values], dtype=bool)
    return np.zeros(values.shape, dtype=bool)


def infer_column(values: Sequence) -> np.ndarray:
    """One column of Python values as pandas infers it from records: ints
    -> int64, ints or floats with None -> float64, bools -> bool, and
    anything else an object column (None kept where every value is None,
    else NaN for the missing)."""
    vals = list(values)
    present = [v for v in vals if v is not None
               and not (isinstance(v, float) and v != v)]
    if not present:
        if vals and all(isinstance(v, float) for v in vals):
            return np.full(len(vals), np.nan)
        return np.array(vals + [None], dtype=object)[:-1]
    if all(isinstance(v, bool) for v in present) and len(present) == len(vals):
        return np.array(vals, dtype=bool)
    numeric = all(isinstance(v, (int, float)) and not isinstance(v, bool)
                  for v in present)
    if numeric:
        if len(present) == len(vals) and all(isinstance(v, int)
                                             for v in present):
            return np.array(vals, dtype=np.int64)
        return np.array([np.nan if v is None else float(v) for v in vals],
                        dtype=np.float64)
    return np.array([np.nan if v is None else v for v in vals] + [None],
                    dtype=object)[:-1]


_POW10 = [float(f"1e{i}") for i in range(309)]


def parse_float(text: str) -> float:
    """A decimal string as pandas' read_csv parses it (its default C
    parser, `precise_xstrtod`): up to 17 significant digits accumulated in
    a double, then scaled by a power of ten. It is not always correctly
    rounded, so it differs from float() in the last bit for some values;
    label tables must read as pandas reads them. ValueError when the text
    is not a number."""
    p, n = 0, len(text)
    while p < n and text[p] in " \t\n\r\f\v":
        p += 1
    neg = False
    if p < n and text[p] in "+-":
        neg = text[p] == "-"
        p += 1
    number, exponent, digits, decimals = 0.0, 0, 0, 0
    while p < n and "0" <= text[p] <= "9":
        if digits < 17:
            number = number * 10.0 + (ord(text[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and text[p] == ".":
        p += 1
        while digits < 17 and p < n and "0" <= text[p] <= "9":
            number = number * 10.0 + (ord(text[p]) - 48)
            p += 1
            digits += 1
            decimals += 1
        while p < n and "0" <= text[p] <= "9":
            p += 1
        exponent -= decimals
    if digits == 0:
        raise ValueError(text)
    if neg:
        number = -number
    if p < n and text[p] in "eE":
        q, eneg, k, e = p + 1, False, 0, 0
        if q < n and text[q] in "+-":
            eneg = text[q] == "-"
            q += 1
        while k < 17 and q < n and "0" <= text[q] <= "9":
            e = e * 10 + (ord(text[q]) - 48)
            k += 1
            q += 1
        if k:
            exponent += -e if eneg else e
            p = q
    while p < n and text[p] in " \t":
        p += 1
    if p != n:
        raise ValueError(text)
    if exponent > 308:
        return -np.inf if neg else np.inf
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _parse_csv_column(cells: List[str]) -> np.ndarray:
    """read_csv's inference for one column: int64, float64 (ints with a
    gap, floats, empty cells as NaN), bool (True/False without a gap), else
    str with NaN for the missing."""
    missing = [c in NA_STRINGS for c in cells]
    present = [c for c, m in zip(cells, missing) if not m]
    if not present:
        return np.full(len(cells), np.nan)
    try:
        ints = [int(c) for c in present]
        if not any(missing):
            return np.array(ints, dtype=np.int64)
        it = iter(ints)
        return np.array([np.nan if m else float(next(it)) for m in missing])
    except ValueError:
        pass
    try:
        floats = iter([parse_float(c) for c in present])
        return np.array([np.nan if m else next(floats) for m in missing])
    except ValueError:
        pass
    if not any(missing) and all(c in ("True", "False", "TRUE", "FALSE",
                                      "true", "false") for c in present):
        return np.array([c.lower() == "true" for c in present], dtype=bool)
    return np.array([np.nan if m else c for c, m in zip(cells, missing)]
                    + [None], dtype=object)[:-1]


class Table:
    """Ordered named columns of equal length, and a row index."""

    def __init__(self, columns: Optional[Dict[str, Sequence]] = None,
                 index: Optional[Sequence[int]] = None):
        self._cols: Dict[str, np.ndarray] = {}
        n = None
        for name, values in (columns or {}).items():
            arr = values if isinstance(values, np.ndarray) \
                else infer_column(values)
            if n is not None and len(arr) != n:
                raise ValueError(f"column {name!r} has {len(arr)} rows, "
                                 f"not {n}")
            n = len(arr)
            self._cols[str(name)] = arr
        n = n if n is not None else (0 if index is None else len(index))
        self.index = (np.arange(n, dtype=np.int64) if index is None
                      else np.asarray(index, dtype=np.int64))
        if len(self.index) != n:
            raise ValueError("index length differs from the columns'")

    # -- reading -----------------------------------------------------------
    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return len(self.index)

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def row(self, i: int) -> dict:
        """Row at position i as {column: value}."""
        return {k: v[i] for k, v in self._cols.items()}

    def values(self, names: Sequence[str]) -> np.ndarray:
        """[rows, len(names)] float64 of the named columns."""
        if not names:
            return np.zeros((len(self), 0))
        return np.stack([np.asarray(self._cols[n], dtype=np.float64)
                         for n in names], axis=1)

    # -- building ----------------------------------------------------------
    def copy(self) -> "Table":
        return Table({k: v.copy() for k, v in self._cols.items()},
                     self.index.copy())

    def __setitem__(self, name: str, values) -> None:
        if np.isscalar(values) or values is None:
            if isinstance(values, float) or values is None:
                arr = np.full(len(self), np.nan if values is None
                              else values, dtype=np.float64)
            elif isinstance(values, (bool, np.bool_)):
                arr = np.full(len(self), values, dtype=bool)
            elif isinstance(values, (int, np.integer)):
                arr = np.full(len(self), values, dtype=np.int64)
            else:
                arr = np.array([values] * len(self) + [None],
                               dtype=object)[:-1]
        else:
            arr = np.asarray(values)
            if arr.dtype.kind in "US":
                arr = arr.astype(object)
            if len(arr) != len(self):
                raise ValueError(f"column {name!r}: {len(arr)} rows, not "
                                 f"{len(self)}")
        self._cols[name] = arr

    def set_at(self, labels: Iterable[int], name: str, value) -> None:
        """Set column `name` to `value` at the rows with these index labels
        (pandas' .loc[labels, name] = value; a new column starts missing)."""
        if name not in self._cols:
            self._cols[name] = np.array([np.nan] * len(self) + [None],
                                        dtype=object)[:-1]
        col = self._cols[name]
        if col.dtype.kind != "O" and not isinstance(value, (int, float)):
            col = col.astype(object)
            self._cols[name] = col
        pos = {int(l): i for i, l in enumerate(self.index)}
        for label in labels:
            col[pos[int(label)]] = value

    def select(self, mask) -> "Table":
        mask = np.asarray(mask, dtype=bool)
        return Table({k: v[mask] for k, v in self._cols.items()},
                     self.index[mask])

    def drop_index(self, labels) -> "Table":
        """Without the rows whose index label is in `labels`."""
        return self.select(~np.isin(self.index, np.asarray(labels,
                                                           dtype=np.int64)))

    def reset_index(self) -> "Table":
        return Table(dict(self._cols), np.arange(len(self), dtype=np.int64))

    def map(self, name: str, fn: Callable) -> np.ndarray:
        """fn over column `name`, inferred as one column."""
        return infer_column([fn(v) for v in self._cols[name].tolist()])

    def isna(self, names: Sequence[str]) -> np.ndarray:
        """[rows, len(names)] bool of missing entries."""
        if not names:
            return np.zeros((len(self), 0), dtype=bool)
        return np.stack([isna(self._cols[n]) for n in names], axis=1)

    @staticmethod
    def concat(tables: Sequence["Table"]) -> "Table":
        """Rows of every table in turn; a column missing from a table is
        missing in its rows (int and bool columns then become float64 and
        object, as pandas makes them)."""
        tables = [t for t in tables]
        names: List[str] = []
        for t in tables:
            names.extend(c for c in t.columns if c not in names)
        cols = {}
        for name in names:
            parts = [t._cols.get(name) for t in tables]
            kinds = {p.dtype.kind for p in parts if p is not None}
            gap = any(p is None for p in parts)
            if kinds <= {"i"} and not gap:
                cols[name] = np.concatenate(parts).astype(np.int64)
            elif kinds <= {"b"} and not gap:
                cols[name] = np.concatenate(parts)
            elif kinds <= {"i", "f"} and kinds:
                cols[name] = np.concatenate([
                    np.full(len(t), np.nan) if p is None
                    else p.astype(np.float64) for t, p in zip(tables, parts)])
            else:
                vals: List = []
                for t, p in zip(tables, parts):
                    vals.extend([np.nan] * len(t) if p is None
                                else p.tolist())
                cols[name] = np.array(vals + [None], dtype=object)[:-1]
        index = np.concatenate([t.index for t in tables]) if tables \
            else np.zeros(0, np.int64)
        return Table(cols, index)

    # -- files -------------------------------------------------------------
    @classmethod
    def read_csv(cls, path: str) -> "Table":
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        if not rows:
            return cls()
        header, body = rows[0], rows[1:]
        cols = {}
        for j, name in enumerate(header):
            cols[name] = _parse_csv_column([r[j] if j < len(r) else ""
                                            for r in body])
        return cls(cols)

    def write_csv(self, path: str, append: bool = False,
                  header: bool = True) -> None:
        """Write as pandas' to_csv(index=False) writes: floats in their
        shortest repr, missing values as empty cells."""
        with open(path, "a" if append else "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            if header:
                w.writerow(self.columns)
            cols = [self._cols[c] for c in self.columns]
            for i in range(len(self)):
                w.writerow([_cell(c[i]) for c in cols])


def _cell(v) -> str:
    if v is None:
        return ""
    if isinstance(v, (float, np.floating)):
        return "" if v != v else repr(float(v))
    if isinstance(v, (np.integer, np.bool_)):
        return str(v.item())
    return str(v)
