"""Trial-structure helpers.

The port's own copy of ``poor_man_gplvm_tpu/analysis/trial.py``:
``get_event_phase_in_trial`` returns a ``ResultTable`` (its
``to_dataframe()`` is the JAX function's DataFrame, with the trials'
index), and ``plot_event_range`` imports seaborn at the call.  ``trials``
may be a DataFrame, a ``ResultTable`` or a dict of columns.
"""

from __future__ import annotations

import numpy as np

from poor_man_gplvm_tpu_torch.utils.table import ResultTable

__all__ = ["get_event_phase_in_trial", "plot_event_range"]


def _row_index(trials):
    """The trials' row index as ``ResultTable`` index levels, or None."""
    index = getattr(trials, "index", None)
    if index is None:
        return None, None
    if isinstance(index, list):  # a ResultTable's levels
        return index, trials.index_names
    levels = getattr(index, "nlevels", 1)
    if levels > 1:
        return ([np.asarray(index.get_level_values(i))
                 for i in range(levels)], tuple(index.names))
    return [np.asarray(index)], (index.name,)


def get_event_phase_in_trial(trials, event_key_l=(), span_key=("start", "end")):
    """Per-trial phase of each event within the [start, end] span."""
    start = np.asarray(trials[span_key[0]])
    end = np.asarray(trials[span_key[1]])
    out = {key: (np.asarray(trials[key]) - start) / (end - start)
           for key in event_key_l}
    index, names = _row_index(trials)
    if not out:
        index, names = None, None
    return ResultTable(out, index=index, index_names=names)


def plot_event_range(event_phase_df, xs=None, event_key_l=None, ax=None,
                     quantile_range=(0.25, 0.75), alpha=0.5, palette="Set1"):
    """Shaded spans for each event's quantile range (NaN-skipping linear
    quantiles, as pandas' ``Series.quantile``)."""
    import seaborn as sns

    if event_key_l is None:
        event_key_l = list(event_phase_df.columns)
    if xs is None:
        xs = (0, 1)
    colors = sns.color_palette(palette, len(event_key_l))
    for i, event_key in enumerate(event_key_l):
        col = np.asarray(event_phase_df[event_key], dtype=float)
        left_ = np.nanquantile(col, quantile_range[0])
        right_ = np.nanquantile(col, quantile_range[1])
        left = (xs[-1] - xs[0]) * left_ + xs[0]
        right = (xs[-1] - xs[0]) * right_ + xs[0]
        ax.axvspan(left, right, color=colors[i], alpha=alpha)
    return ax
