"""Ordinary least squares with robust covariance estimators.

The port's own copy of ``poor_man_gplvm_tpu/utils/stats.py`` (numpy and
scipy, no statsmodels): OLS fit, R-squared, HC1 (heteroskedasticity-robust)
and cluster-robust standard errors, and t-tests of linear contrasts, for
the post-fit regressions of ``analysis.regression`` and
``analysis.distance``.
"""

from __future__ import annotations

import numpy as np
from scipy import stats as sstats

__all__ = ["OLSResult", "ols_fit", "add_constant"]


def add_constant(X):
    """Prepend an intercept column of ones."""
    X = np.asarray(X, dtype=float)
    if X.ndim == 1:
        X = X[:, None]
    return np.column_stack([np.ones(len(X)), X])


class OLSResult:
    """Fitted OLS model with a chosen covariance estimator.

    Attributes: params, bse, tvalues, pvalues, cov_params, rsquared,
    rsquared_adj, nobs, df_resid, cov_type.
    """

    def __init__(self, X, y, cov_type="nonrobust", groups=None,
                 param_names=None):
        X = np.asarray(X, dtype=float)
        y = np.asarray(y, dtype=float)
        n, k = X.shape
        XtX_inv = np.linalg.pinv(X.T @ X)
        beta = XtX_inv @ (X.T @ y)
        resid = y - X @ beta
        ss_res = float(resid @ resid)
        ss_tot = float(np.sum((y - y.mean()) ** 2))

        self.params = beta
        self.resid = resid
        self.nobs = n
        self.rsquared = 1.0 - ss_res / ss_tot if ss_tot > 0 else np.nan
        self.rsquared_adj = (
            1.0 - (1.0 - self.rsquared) * (n - 1) / (n - k)
            if n > k else np.nan
        )
        self.cov_type = cov_type
        self.param_names = param_names or [f"x{i}" for i in range(k)]

        if cov_type == "nonrobust":
            sigma2 = ss_res / (n - k)
            self.cov_params = sigma2 * XtX_inv
            self.df_resid = n - k
        elif cov_type == "HC1":
            meat = (X * (resid**2)[:, None]).T @ X
            self.cov_params = XtX_inv @ meat @ XtX_inv * (n / (n - k))
            self.df_resid = n - k
        elif cov_type == "cluster":
            if groups is None:
                raise ValueError("cluster cov requires groups")
            groups = np.asarray(groups)
            uniq = np.unique(groups)
            G = len(uniq)
            meat = np.zeros((k, k))
            for g in uniq:
                Xg = X[groups == g]
                ug = resid[groups == g]
                sg = Xg.T @ ug
                meat += np.outer(sg, sg)
            # CR1 small-sample correction (statsmodels' default scaling)
            c = (G / (G - 1)) * ((n - 1) / (n - k))
            self.cov_params = XtX_inv @ meat @ XtX_inv * c
            self.df_resid = G - 1
        else:
            raise ValueError(f"Unknown cov_type: {cov_type}")

        self.bse = np.sqrt(np.diag(self.cov_params))
        with np.errstate(divide="ignore", invalid="ignore"):
            self.tvalues = self.params / self.bse
        self.pvalues = 2 * sstats.t.sf(np.abs(self.tvalues), self.df_resid)

    def t_test(self, contrast):
        """Test c'beta = 0 for a contrast vector c.

        Returns dict(estimate, std_value (t), pvalue, ci_low, ci_high)."""
        c = np.asarray(contrast, dtype=float)
        est = float(c @ self.params)
        se = float(np.sqrt(c @ self.cov_params @ c))
        tval = est / se if se > 0 else np.nan
        pval = 2 * sstats.t.sf(abs(tval), self.df_resid)
        tcrit = sstats.t.ppf(0.975, self.df_resid)
        return {
            "estimate": est,
            "std_value": tval,
            "pvalue": float(pval),
            "ci_low": est - tcrit * se,
            "ci_high": est + tcrit * se,
        }

    def conf_int(self, alpha=0.05):
        tcrit = sstats.t.ppf(1 - alpha / 2, self.df_resid)
        return np.column_stack(
            [self.params - tcrit * self.bse, self.params + tcrit * self.bse]
        )

    @property
    def f_pvalue(self):
        """Overall F test (all non-intercept coefficients zero), nonrobust."""
        k = len(self.params)
        n = self.nobs
        if k <= 1 or not np.isfinite(self.rsquared):
            return np.nan
        r2 = self.rsquared
        f = (r2 / (k - 1)) / ((1 - r2) / (n - k))
        return float(sstats.f.sf(f, k - 1, n - k))


def ols_fit(X, y, cov_type="nonrobust", groups=None, param_names=None):
    return OLSResult(X, y, cov_type=cov_type, groups=groups,
                     param_names=param_names)
