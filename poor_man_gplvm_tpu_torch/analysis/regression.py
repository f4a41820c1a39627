"""Pre/post-event regression with interaction.

The port's own copy of ``poor_man_gplvm_tpu/analysis/regression.py``
(``fit_time_prepost_interaction``): OLS of ``y ~ time_within * C(is_post)``
with time z-scored within the pre/post sides, cluster-robust (by repeat) or
HC1 standard errors, on ``utils.stats`` (no statsmodels, no pandas).
``df_wide`` may be a DataFrame or a ``ResultTable`` (the port's peri-event
tables); the frames and series of the JAX result come back as
``ResultTable``s (``to_dataframe()``, or ``to_series()`` for ``params``,
``bse`` and ``pvalues``).
"""

from __future__ import annotations

import numpy as np

from poor_man_gplvm_tpu_torch.utils.stats import ols_fit
from poor_man_gplvm_tpu_torch.utils.table import ResultTable

__all__ = ["fit_time_prepost_interaction"]


def _wide(df_wide):
    """(values (n_repeat, n_time), column labels, row labels) of a
    DataFrame or a ``ResultTable``."""
    columns = list(df_wide.columns)
    if isinstance(df_wide, ResultTable):
        values = np.column_stack([df_wide[c] for c in columns])
        rows = df_wide.index[0]
    else:
        values = np.asarray(df_wide)
        rows = np.asarray(df_wide.index)
    return values, columns, rows


def _z_by_side(x):
    s = x.std()
    return (x - x.mean()) / s if s > 0 else x * 0.0


def _series(values, names):
    return ResultTable({None: values}, index=[np.asarray(names)])


def fit_time_prepost_interaction(
    df_wide, time=None, repeat_name="repeat", response_name="y", cov="cluster",
):
    """Fit ``response ~ time_within * C(is_post)``.

    df_wide: (n_repeat, n_time) table; columns are times (or pass
    ``time``).  time_within is z-scored separately within pre (<0) and post
    (>=0).  Returns the JAX function's result dict: summary_df with
    slope/intercept pre/post/diff rows, params, bse, pvalues, conf_int,
    rsquared(_adj), f_pvalue, nobs, cov_type, coef_pre/post, p_interaction,
    p_intercept_diff, model, data_long."""
    values, columns, rows = _wide(df_wide)
    if time is None:
        try:
            t = np.asarray(columns, dtype=float)
        except (TypeError, ValueError) as e:
            raise ValueError(
                "Cannot parse df_wide.columns as numeric times; pass `time` "
                "explicitly."
            ) from e
    else:
        t = np.asarray(time, dtype=float)
        if len(t) != values.shape[1]:
            raise ValueError(
                "`time` length must match number of columns in df_wide."
            )

    # long form, row-major over (repeat, time), as DataFrame.stack() gives
    n_rep, n_time = values.shape
    long = {
        repeat_name: np.repeat(rows, n_time),
        "time": np.tile(t, n_rep),
        response_name: values.reshape(-1),
    }
    if not ((long["time"] < 0).any() and (long["time"] >= 0).any()):
        raise ValueError(
            "Time grid must include both pre (<0) and post (>=0) samples."
        )

    long["is_post"] = (long["time"] >= 0).astype(np.int64)
    tw = np.empty(len(long["time"]))
    for side in np.unique(long["is_post"]):
        sel = long["is_post"] == side
        tw[sel] = _z_by_side(long["time"][sel])
    long["time_within"] = tw

    # design: [1, time_within, is_post, time_within*is_post]
    y = long[response_name].astype(float)
    ip = long["is_post"].astype(float)
    X = np.column_stack([np.ones(len(y)), tw, ip, tw * ip])
    names = ["Intercept", "time_within", "C(is_post)[T.1]",
             "time_within:C(is_post)[T.1]"]

    if cov == "cluster":
        res = ols_fit(X, y, cov_type="cluster", groups=long[repeat_name],
                      param_names=names)
    elif cov == "HC1":
        res = ols_fit(X, y, cov_type="HC1", param_names=names)
    else:
        raise ValueError("cov must be 'cluster' or 'HC1'.")

    contrasts = {
        "slope_pre": [0, 1, 0, 0], "slope_post": [0, 1, 0, 1],
        "slope_diff": [0, 0, 0, 1], "intercept_pre": [1, 0, 0, 0],
        "intercept_post": [1, 0, 1, 0], "intercept_diff": [0, 0, 1, 0],
    }
    tests = {row: res.t_test(np.array(c)) for row, c in contrasts.items()}
    summary_df = ResultTable(
        {key: np.array([tests[row][key] for row in contrasts])
         for key in ("estimate", "std_value", "pvalue", "ci_low", "ci_high")},
        index=[np.array(list(contrasts))])

    ci = res.conf_int()
    ci_full = ResultTable({"low": ci[:, 0], "high": ci[:, 1]},
                          index=[np.array(names)])
    beta0, beta1, beta2, beta3 = res.params

    coef_pre = {
        "intercept": beta0, "slope": beta1,
        "p_slope": tests["slope_pre"]["pvalue"],
    }
    coef_post = {
        "intercept": beta0 + beta2, "slope": beta1 + beta3,
        "p_slope": tests["slope_post"]["pvalue"],
    }

    return {
        "summary_df": summary_df,
        "params": _series(res.params, names),
        "bse": _series(res.bse, names),
        "pvalues": _series(res.pvalues, names),
        "conf_int": ci_full,
        "rsquared": res.rsquared,
        "rsquared_adj": res.rsquared_adj,
        "f_pvalue": res.f_pvalue,
        "nobs": int(res.nobs),
        "cov_type": res.cov_type,
        "coef_pre": coef_pre,
        "coef_post": coef_post,
        "p_interaction": tests["slope_diff"]["pvalue"],
        "p_intercept_diff": tests["intercept_diff"]["pvalue"],
        "model": res,
        "data_long": ResultTable(long),
    }
