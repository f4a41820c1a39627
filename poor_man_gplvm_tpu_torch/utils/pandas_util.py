"""Declarative table filtering: spec-tree -> (mask, pandas query string).

The port's own copy of ``poor_man_gplvm_tpu/utils/pandas_util.py``: logic
nodes (``all``/``any``/``not`` as dicts or tagged lists), leaf conditions
``[col, op, value?, opts?]`` with comparator / membership / between / null
/ string operators, and an implicit-AND list form.  ``_parse`` normalises
every accepted spec form into a ``(tag, children)`` tree and ``_Compiler``
evaluates it, leaf by leaf through ``_OP_HANDLERS``, interning the query's
``@``-parameters as it goes.

The masks are computed in numpy on the table's columns, so the function
needs no pandas: it takes a ``utils.table.ResultTable`` (the port's
results) or a pandas DataFrame.  For a table it returns the table's rows
(their index kept) and the mask as a one-column ``ResultTable``
(``to_series()`` gives the JAX mask); for a DataFrame, ``df[mask]`` and
the mask as a boolean Series, as the JAX function does.  The query string
and its environment are the JAX function's.  One difference: where the
JAX mask of a string operator is pandas' nullable ``boolean`` dtype, the
port's is numpy ``bool``.
"""

from __future__ import annotations

import operator
import re
from typing import Any, Dict, List, Tuple, Union

import numpy as np

from poor_man_gplvm_tpu_torch.utils.table import ResultTable

Spec = Union[List[Any], Tuple[Any, ...], Dict[str, Any]]

__all__ = ["filter_df_with_spec"]

_BRANCH_TAGS = frozenset({"all", "any", "not"})


# ---------------------------------------------------------------------------
# stage 1: normalize the accepted spec forms into a uniform tagged tree
# ---------------------------------------------------------------------------
# Node shapes after parsing:
#   ("all"|"any", [child, ...])
#   ("not", [child])
#   ("leaf", (col, op, value, opts))


def _branch_tag_of(node):
    """The logic tag a list/dict node carries, or None for leaves."""
    if isinstance(node, dict):
        for tag in ("not", "all", "any"):
            if tag in node:
                return tag
        return None
    if (
        isinstance(node, (list, tuple))
        and node
        and isinstance(node[0], str)
        and node[0].lower() in _BRANCH_TAGS
    ):
        return node[0].lower()
    return None


def _parse(spec):
    tag = _branch_tag_of(spec)
    if tag is not None:
        if isinstance(spec, dict):
            body = spec[tag]
            kids = (
                list(body)
                if tag != "not" and isinstance(body, (list, tuple))
                else [body]
            )
        else:  # tagged list form: ['all'|'any'|'not', child, ...]
            kids = list(spec[1:])
            if tag == "not" and len(kids) != 1:
                raise ValueError("['not', spec] expects exactly one child.")
        return tag, [_parse(k) for k in kids]

    if isinstance(spec, (list, tuple)):
        if not spec:
            raise ValueError("Empty spec list.")
        if len(spec) >= 2 and isinstance(spec[0], str):
            # bare leaf: [col, op, value?, opts?]
            col, op = spec[0], str(spec[1]).lower()
            value = spec[2] if len(spec) > 2 else None
            opts = (
                spec[3]
                if len(spec) > 3 and isinstance(spec[3], dict)
                else {}
            )
            return "leaf", (col, op, value, opts)
        # implicit AND over a bare list of nodes
        return "all", [_parse(k) for k in spec]

    raise ValueError("Invalid spec structure.")


# ---------------------------------------------------------------------------
# numpy counterparts of the pandas element operations
# ---------------------------------------------------------------------------


def _is_missing(x):
    """pandas' ``isna`` of one element: None, NaN, pd.NA, NaT."""
    if x is None:
        return True
    if isinstance(x, (float, np.floating)):
        return bool(np.isnan(x))
    return type(x).__name__ in ("NAType", "NaTType")


def _isna(col):
    if col.dtype.kind in "fc":
        return np.isnan(col)
    if col.dtype.kind == "O":
        return np.fromiter((_is_missing(x) for x in col), bool, len(col))
    return np.zeros(len(col), dtype=bool)


def _as_text(col):
    """The column as ``astype("string")`` gives it: each element's text,
    None where it is missing."""
    def text(x):
        if _is_missing(x):
            return None
        return str(x.item() if isinstance(x, np.generic) else x)

    return [text(x) for x in col]


def _isin(col, values):
    """``Series.isin``: element membership, a NaN matching a NaN."""
    nan_in = any(_is_missing(v) for v in values)
    present = [v for v in values if not _is_missing(v)]
    try:
        lookup = set(present)
    except TypeError:  # unhashable values: compare one by one
        lookup = None
    out = np.zeros(len(col), dtype=bool)
    for i, x in enumerate(col):
        if _is_missing(x):
            out[i] = nan_in
        elif lookup is not None:
            try:
                out[i] = x in lookup
            except TypeError:
                out[i] = any(x == v for v in present)
        else:
            out[i] = any(x == v for v in present)
    return out


# ---------------------------------------------------------------------------
# stage 2: evaluate the tagged tree against a table
# ---------------------------------------------------------------------------

_CMP_OPS = {
    "==": operator.eq, "!=": operator.ne,
    "<": operator.lt, ">": operator.gt,
    "<=": operator.le, ">=": operator.ge,
}

#: (lower-bound op, upper-bound op) per pandas `inclusive` flavor, for the
#: query-string rendering of `between` (legacy bool values included)
_BETWEEN_BOUNDS = {
    "both": ("<=", "<="), "neither": ("<", "<"),
    "left": ("<=", "<"), "right": ("<", "<="),
    True: ("<=", "<="), False: ("<", "<"),
}

_BETWEEN_OPS = {"both": (operator.ge, operator.le),
                "neither": (operator.gt, operator.lt),
                "left": (operator.ge, operator.lt),
                "right": (operator.gt, operator.le)}


class _Compiler:
    """Walks a parsed spec tree, producing a boolean mask (with the name
    pandas gives it: the column of a leaf, none for ``all``/``any``) and
    an equivalent ``df.query`` string whose ``@``-parameters it interns
    into ``self.env``."""

    def __init__(self, columns, n_rows):
        self.columns = columns
        self.n_rows = n_rows
        self.env: Dict[str, Any] = {}

    def intern(self, value):
        """Bind ``value`` to a fresh env name; return its ``@``-reference."""
        ref = f"v{len(self.env)}"
        self.env[ref] = value
        return f"@{ref}"

    def column(self, name):
        if name not in self.columns:
            raise KeyError(f"Column '{name}' not in DataFrame.")
        # backtick-quote anything that isn't a plain identifier
        quoted = name if re.fullmatch(r"\w+", name) else f"`{name}`"
        return self.columns[name](), quoted

    def run(self, node):
        """(mask, its name, query snippet) of a parsed node."""
        tag, body = node
        if tag == "leaf":
            col, op, value, opts = body
            values, colref = self.column(col)
            handler = _OP_HANDLERS.get(op)
            if handler is None:
                raise ValueError(f"Unsupported op: {op}")
            mask, q = handler(self, values, colref, op, value, opts)
            return np.asarray(mask, dtype=bool), col, q
        if tag == "not":
            mask, name, q = self.run(body[0])
            return ~mask, name, f"not ({q})"
        # all / any
        parts = [self.run(kid) for kid in body]
        masks = [m for m, _, _ in parts]
        if tag == "all":
            combined = np.logical_and.reduce(masks) if parts else np.ones(
                self.n_rows, dtype=bool
            )
            glue = " and "
        else:
            combined = np.logical_or.reduce(masks) if parts else np.zeros(
                self.n_rows, dtype=bool
            )
            glue = " or "
        q = glue.join(f"({snippet})" for _, _, snippet in parts)
        return np.asarray(combined, dtype=bool), None, (f"({q})" if q
                                                        else "")


# --- leaf op handlers (each returns (mask, query-snippet)) -----------------


def _op_compare(c, col, colref, op, value, opts):
    return _CMP_OPS[op](col, value), f"{colref} {op} {c.intern(value)}"


def _op_membership(c, col, colref, op, value, opts):
    if not isinstance(value, (list, tuple, set, np.ndarray)) and not (
            type(value).__name__ == "Index"):
        value = [value]
    ref = c.intern(list(value))
    mask = _isin(col, c.env[ref[1:]])
    if op == "not in":
        return ~mask, f"{colref} not in {ref}"
    return mask, f"{colref} in {ref}"


def _op_between(c, col, colref, op, value, opts):
    if not (isinstance(value, (list, tuple)) and len(value) == 2):
        raise ValueError("between expects value=(low, high).")
    lo, hi = value
    inclusive = opts.get("inclusive", "both")
    lo_op, hi_op = _BETWEEN_BOUNDS.get(inclusive, ("<=", "<="))
    q = (
        f"({c.intern(lo)} {lo_op} {colref})"
        f" and ({colref} {hi_op} {c.intern(hi)})"
    )
    if not isinstance(inclusive, str) or inclusive not in _BETWEEN_OPS:
        raise ValueError("Inclusive has to be either string of 'both',"
                         "'left', 'right', or 'neither'.")
    ge, le = _BETWEEN_OPS[inclusive]
    return ge(col, lo) & le(col, hi), q


def _op_null(c, col, colref, op, value, opts):
    if op in ("isna", "isnull"):
        return _isna(col), f"{colref}.isnull()"
    return ~_isna(col), f"{colref}.notnull()"


def _op_string(c, col, colref, op, value, opts):
    pattern = str(value)
    na = opts.get("na", False)
    text = _as_text(col)
    ref = c.intern(pattern)
    if op in ("contains", "regex"):
        case = bool(opts.get("case", True))
        use_regex = True if op == "regex" else bool(opts.get("regex", True))
        if use_regex:
            pat = re.compile(pattern, flags=0 if case else re.IGNORECASE)
            hit = lambda x: pat.search(x) is not None  # noqa: E731
        elif case:
            hit = lambda x: pattern in x  # noqa: E731
        else:
            upper = pattern.upper()
            hit = lambda x: upper in x.upper()  # noqa: E731
        mask = [na if x is None else hit(x) for x in text]
        q = (
            f"{colref}.str.contains({ref}, case={case}, na={na},"
            f" regex={use_regex})"
        )
        return mask, q
    mask = [na if x is None else getattr(x, op)(pattern) for x in text]
    return mask, f"{colref}.str.{op}({ref}, na={na})"


_OP_HANDLERS = {}
for _op in _CMP_OPS:
    _OP_HANDLERS[_op] = _op_compare
for _op in ("in", "not in"):
    _OP_HANDLERS[_op] = _op_membership
_OP_HANDLERS["between"] = _op_between
for _op in ("isna", "isnull", "notna", "notnull"):
    _OP_HANDLERS[_op] = _op_null
for _op in ("contains", "regex", "startswith", "endswith"):
    _OP_HANDLERS[_op] = _op_string
del _op


def filter_df_with_spec(df, spec, *, return_query=True):
    """Filter a ``ResultTable`` or a DataFrame with a spec tree.

    Returns {'df': the rows kept, 'mask': the boolean mask} (a table's
    rows and a one-column ``ResultTable``; a DataFrame's rows and a
    boolean Series) plus, when ``return_query``, the equivalent pandas
    query string and its @-variable environment."""
    if isinstance(df, ResultTable):
        columns = {name: (lambda name=name: df[name]) for name in df.columns}
    else:
        columns = {name: (lambda name=name: df[name].to_numpy())
                   for name in df.columns}
    compiler = _Compiler(columns, len(df))
    mask, name, query = compiler.run(_parse(spec))
    if isinstance(df, ResultTable):
        out = {"df": df.take(mask),
               "mask": ResultTable({name: mask}, index=df.index,
                                   index_names=df.index_names)}
    else:
        import pandas as pd

        series = pd.Series(mask, index=df.index, name=name)
        out = {"df": df[series], "mask": series}
    if return_query:
        out["query"] = query
        out["env"] = compiler.env
    return out
