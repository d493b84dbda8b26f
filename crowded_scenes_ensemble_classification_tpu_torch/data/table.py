"""A small column table for clip lists: the port's stand-in for the pandas
DataFrames of the JAX data layer.

The card's machine has no pandas, so the clip table, the fold and split CSVs
and the pipelines' row lists live in `ClipTable`: ordered columns of numpy
arrays (int64 for whole numbers, object arrays of `str` otherwise), with the
few operations `data/` needs: column access (`table["class"]`, as
`train.engine.fit` reads it) and assignment (`table[name] = values`, as
offline augmentation adds its path columns), rows by position that carry
their position as `row.name` (what pandas gives after
`reset_index(drop=True)`, which the JAX callers always apply), filtering,
sorting and concatenation.  Every derived table is indexed 0..n-1 again.

CSV files are read with the `csv` module (a column of whole numbers becomes
int64, every other column stays strings, empty cells "") and written by
`ensemble.probability_store.write_csv`, byte for byte what pandas'
`to_csv(index=False)` writes for the same table: `\\n` line ends, minimal
quoting, ints as ints, an empty string as an empty cell.
"""

from __future__ import annotations

import csv
import re
from typing import Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

from ..ensemble.probability_store import write_csv

_INT_RE = re.compile(r"^[+-]?\d+$")


def _column(values) -> np.ndarray:
    """A column's values → int64 when all are whole numbers, else an object
    array of the values."""
    if isinstance(values, np.ndarray) and values.dtype.kind in "iu":
        return values.astype(np.int64)
    values = list(values)
    if values and all(isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_)) for v in values):
        return np.asarray(values, np.int64)
    out = np.empty(len(values), object)
    out[:] = values
    return out


class Row(dict):
    """One row, column → value; `name` is its position in its table (the
    `row.name` of a pandas row after `reset_index(drop=True)`)."""

    __slots__ = ("name",)

    def __init__(self, values: Mapping, name: int):
        super().__init__(values)
        self.name = name


class ClipTable:
    """Ordered named columns of equal length, rows indexed by position."""

    def __init__(self, columns: Optional[Mapping[str, Sequence]] = None):
        self._cols: Dict[str, np.ndarray] = {}
        n = None
        for name, values in (columns or {}).items():
            col = _column(values)
            if n is not None and len(col) != n:
                raise ValueError(f"column {name!r} has {len(col)} rows, the others {n}")
            n = len(col)
            self._cols[name] = col
        self._n = n or 0

    @classmethod
    def from_records(cls, records: Sequence[Mapping], columns: Sequence[str]) -> "ClipTable":
        """Rows given as mappings, with these columns in this order."""
        return cls({c: [r[c] for r in records] for c in columns})

    @classmethod
    def read_csv(cls, path: str) -> "ClipTable":
        """A CSV with a header row; a column whose cells are all whole
        numbers becomes int64, any other stays strings ("" where empty)."""
        with open(path, newline="", encoding="utf-8") as f:
            reader = csv.reader(f)
            header = next(reader, [])
            rows = list(reader)
        cols = {}
        for j, name in enumerate(header):
            cells = [r[j] if j < len(r) else "" for r in rows]
            if cells and all(_INT_RE.match(c) for c in cells):
                cols[name] = [int(c) for c in cells]
            else:
                cols[name] = cells
        return cls(cols)

    def to_csv(self, path: str) -> str:
        """pandas `to_csv(path, index=False)` of this table, byte for byte."""
        cols = [v.tolist() for v in self._cols.values()]
        return write_csv(path, list(self._cols), [[str(col[i]) for col in cols] for i in range(self._n)])

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return self._n

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __setitem__(self, name: str, values: Sequence) -> None:
        """Set a column: a new one goes last, an existing one keeps its
        place (pandas `df[name] = values`)."""
        col = _column(values)
        if self._cols and len(col) != self._n:
            raise ValueError(f"column {name!r} has {len(col)} rows, the table {self._n}")
        if not self._cols:
            self._n = len(col)
        self._cols[name] = col

    def __repr__(self) -> str:
        return f"ClipTable({self._n} rows, columns {self.columns})"

    def row(self, i: int) -> Row:
        i = int(i)
        if not -self._n <= i < self._n:
            raise IndexError(f"row {i} of a table of {self._n}")
        i %= max(self._n, 1)
        return Row({c: v[i].item() if isinstance(v[i], np.generic) else v[i] for c, v in self._cols.items()}, i)

    def rows(self) -> Iterator[Row]:
        return (self.row(i) for i in range(self._n))

    def records(self) -> List[Dict]:
        return [dict(r) for r in self.rows()]

    def take(self, indices) -> "ClipTable":
        """The rows at these positions, in this order."""
        idx = np.asarray(indices, np.int64).reshape(-1)
        return ClipTable({c: v[idx] for c, v in self._cols.items()})

    def filter(self, mask) -> "ClipTable":
        """The rows where `mask` is true."""
        mask = np.asarray(mask, bool)
        if mask.shape != (self._n,):
            raise ValueError(f"mask of shape {mask.shape} for {self._n} rows")
        return self.take(np.flatnonzero(mask))

    def isin(self, name: str, values) -> np.ndarray:
        """Boolean mask: the rows whose `name` is one of `values`."""
        wanted = set(values)
        return np.fromiter((v in wanted for v in self._cols[name]), bool, self._n)

    def sort_values(self, name: str) -> "ClipTable":
        """Rows sorted by one column, ties kept in order."""
        col = self._cols[name]
        return self.take(sorted(range(self._n), key=lambda i: col[i]))

    def select(self, names: Sequence[str]) -> "ClipTable":
        """These columns, in this order."""
        return ClipTable({c: self._cols[c] for c in names})

    def rename(self, mapping: Mapping[str, str]) -> "ClipTable":
        return ClipTable({mapping.get(c, c): v for c, v in self._cols.items()})


def concat(tables: Sequence[ClipTable]) -> ClipTable:
    """Rows of every table in order (pandas `concat(..., ignore_index=True)`
    of tables with the same columns)."""
    tables = list(tables)
    if not tables:
        return ClipTable()
    columns = tables[0].columns
    for t in tables[1:]:
        if t.columns != columns:
            raise ValueError(f"concat: columns {t.columns} against {columns}")
    return ClipTable({c: [v for t in tables for v in t[c]] for c in columns})
