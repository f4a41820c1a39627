"""``ResultTable``: the port's result format where the JAX package returns
a pandas DataFrame (the card's machine has no pandas).

A table holds named numpy columns of equal length, in order, and an
optional row index: one array per index level, with the level names.
``to_dataframe()`` builds the DataFrame the JAX function returns, index
included, and ``to_series()`` the Series of a one-column table; pandas is
imported at the call.  ``concat_tables`` stacks tables as
``pd.concat({key: frame, ...}, axis=0)`` does, with the keys as the outer
index level.  ``read_csv`` reads a delimited text file with a header row
into a table, as the subset of ``pandas.read_csv`` that the data loaders
use.
"""

from __future__ import annotations

import csv

import numpy as np

__all__ = ["ResultTable", "concat_tables", "read_csv", "NA_VALUES"]

#: the strings ``pandas.read_csv`` reads as missing by default
NA_VALUES = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))


class ResultTable:
    """A small table of named numpy columns of equal length, in order.
    ``table[name]`` is a column, ``table.columns`` the names,
    ``len(table)`` the rows, ``table.index`` the index levels (a list of
    arrays; one ``arange`` when none was given); ``join`` puts two tables
    side by side; ``to_dataframe()`` builds the pandas DataFrame (pandas is
    imported at the call)."""

    def __init__(self, columns=None, index=None, index_names=None):
        self._cols = {}
        for name, col in (columns or {}).items():
            col = np.asarray(col)
            if self._cols and len(col) != len(self):
                raise ValueError(f"column {name!r} has {len(col)} rows, the "
                                 f"table {len(self)}")
            self._cols[name] = col
        self._index = None if index is None else [np.asarray(a)
                                                  for a in index]
        if self._index is not None and any(len(a) != len(self)
                                           for a in self._index):
            raise ValueError("every index level needs one entry per row")
        n_levels = 1 if index is None else len(self._index)
        self._index_names = (tuple(index_names) if index_names is not None
                             else (None,) * n_levels)
        if len(self._index_names) != n_levels:
            raise ValueError(f"{len(self._index_names)} index names for "
                             f"{n_levels} index levels")

    @property
    def columns(self):
        return list(self._cols)

    @property
    def index(self):
        if self._index is None:
            return [np.arange(len(self))]
        return list(self._index)

    @property
    def index_names(self):
        return self._index_names

    def __len__(self):
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __getitem__(self, name):
        return self._cols[name]

    def to_dict(self):
        return dict(self._cols)

    def take(self, rows):
        """The rows ``rows`` (a boolean mask or positions) with their
        index entries, as ``df[mask]``/``df.iloc[rows]`` keeps the labels
        (a table without an index gets the positions as its index)."""
        return ResultTable({c: v[rows] for c, v in self._cols.items()},
                           [a[rows] for a in self.index], self._index_names)

    def to_numpy(self):
        """The columns side by side, (rows, columns), as
        ``DataFrame.to_numpy()``."""
        return np.column_stack([self._cols[c] for c in self._cols]) \
            if self._cols else np.empty((0, 0))

    def join(self, other):
        """The columns of ``self`` then those of ``other`` (row by row;
        names must differ); the index is ``self``'s."""
        if len(self) != len(other) and self._cols and other.columns:
            raise ValueError("join needs tables of equal length")
        clash = set(self.columns) & set(other.columns)
        if clash:
            raise ValueError(f"columns in both tables: {sorted(clash)}")
        return ResultTable({**self._cols, **other.to_dict()}, self._index,
                           self._index_names)

    def to_dataframe(self):
        """The pandas DataFrame of the table, with its index (raises
        ``ImportError`` naming pandas where it is not installed)."""
        try:
            import pandas as pd
        except ImportError as exc:
            raise ImportError(
                "ResultTable.to_dataframe() needs pandas, which is not "
                "installed") from exc
        df = pd.DataFrame(self._cols)
        if self._index is None:
            df.index.name = self._index_names[0]
        elif len(self._index) == 1:
            df.index = pd.Index(self._index[0], name=self._index_names[0])
        else:
            df.index = pd.MultiIndex.from_arrays(
                self._index, names=list(self._index_names))
        return df

    def to_series(self):
        """The pandas Series of a one-column table, named by the column,
        with the table's index."""
        if len(self._cols) != 1:
            raise ValueError("to_series() needs a table of one column")
        import pandas as pd

        (name, col), = self._cols.items()
        df = self.to_dataframe()
        return pd.Series(col, index=df.index, name=name)

    def __repr__(self):
        return f"ResultTable({len(self)} rows, columns={self.columns})"


def concat_tables(tables):
    """Stack the tables of a dict ``{key: table}`` (one set of columns) by
    rows, as ``pd.concat(tables, axis=0)`` does: the keys become the outer
    index level, each table's own index the inner levels."""
    keys = list(tables)
    if not keys:
        raise ValueError("concat_tables needs at least one table")
    first = tables[keys[0]]
    cols = first.columns
    if any(t.columns != cols for t in tables.values()):
        raise ValueError("concat_tables needs tables of one set of columns")
    outer = np.concatenate([np.full(len(tables[k]), k) for k in keys])
    inner = [np.concatenate([tables[k].index[j] for k in keys])
             for j in range(len(first.index))]
    return ResultTable(
        {c: np.concatenate([tables[k][c] for k in keys]) for c in cols},
        index=[outer, *inner], index_names=(None, *first.index_names))


def _parse_column(fields):
    """One column of strings as ``pandas.read_csv`` types it: int64 where
    every field is an integer, float64 where every field is a number or
    missing (NaN), bool where every field is True/False, else an object
    array of strings with None where missing."""
    missing = [f in NA_VALUES for f in fields]
    present = [f for f, m in zip(fields, missing) if not m]
    # python's int()/float() read "1_000"; pandas does not
    if all("_" not in f for f in present):
        if present and not any(missing):
            try:
                return np.array([int(f) for f in present], dtype=np.int64)
            except ValueError:
                pass
        try:
            return np.array([np.nan if m else float(f)
                             for f, m in zip(fields, missing)],
                            dtype=np.float64)
        except ValueError:
            pass
    bools = {"true": True, "false": False}
    if present and not any(missing) and all(f.lower() in bools
                                            for f in present):
        return np.array([bools[f.lower()] for f in present], dtype=bool)
    return np.array([None if m else f for f, m in zip(fields, missing)],
                    dtype=object)


def read_csv(path, sep=","):
    """A delimited text file with a header row as a ``ResultTable``, its
    columns typed as ``pandas.read_csv`` types them (``_parse_column``)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter=sep))
    if not rows:
        raise ValueError(f"{path} is empty (no header row)")
    header, body = rows[0], rows[1:]
    width = len(header)
    body = [r + [""] * (width - len(r)) for r in body if r]
    if any(len(r) > width for r in body):
        raise ValueError(f"{path}: a row has more fields than the header")
    return ResultTable({name: _parse_column([r[j] for r in body])
                        for j, name in enumerate(header)})


def _bins_to_codes(x, bins, include_lowest):
    """pandas' ``_bins_to_cuts`` with ``labels=False``: the 0-based
    right-closed bin of each value, NaN outside the edges or where the
    value is NaN (float then; int64 where no value is NaN)."""
    x = np.asarray(x, dtype=float)
    bins = np.asarray(bins, dtype=float)
    ids = np.searchsorted(bins, x, side="left")
    if include_lowest:
        ids[x == bins[0]] = 1
    na = np.isnan(x) | (ids == len(bins)) | (ids == 0)
    codes = ids - 1
    if na.any():
        codes = codes.astype(np.float64)
        codes[na] = np.nan
    return codes


def cut_codes(x, bins):
    """``pandas.cut(x, bins, labels=False)`` for increasing edges
    ``bins``: right-closed bins, values at or below the first edge NaN."""
    bins = np.asarray(bins, dtype=float)
    if np.any(np.diff(bins) < 0):
        raise ValueError("bins must increase monotonically.")
    return _bins_to_codes(x, bins, include_lowest=False)


def qcut_codes(x, q):
    """``pandas.qcut(x, q, labels=False)`` for an integer ``q``: the
    edges are the non-NaN values' quantiles at ``linspace(0, 1, q + 1)``
    (each rounded up where not exact in base 2; linear, as
    ``Series.quantile``), the first bin closed on the left;
    duplicate edges raise, as pandas' default ``duplicates='raise'``."""
    x = np.asarray(x, dtype=float)
    finite = x[~np.isnan(x)]
    quantiles = np.linspace(0, 1, q + 1)
    # pandas rounds a quantile up where it is not exact in base 2
    np.putmask(quantiles, q * quantiles != np.arange(q + 1),
               np.nextafter(quantiles, 1))
    bins = np.quantile(finite, quantiles) \
        if finite.size else np.full(q + 1, np.nan)
    if len(np.unique(bins)) < len(bins):
        raise ValueError(f"Bin edges must be unique: {bins!r}.\nYou can "
                         "drop duplicate edges by setting the 'duplicates' "
                         "kwarg")
    return _bins_to_codes(x, bins, include_lowest=True)
