"""Baseline naive-Bayes decoders over discrete position bins, on the card.

Counterpart of ``poor_man_gplvm_tpu/data/decoders.py``
(``GaussianBayesDecoder``, ``PoissonBayesDecoder``): the fork's baseline
decoders, fitted by per-class sums and applied as one (K, N) @ (N, T)
product over the whole session.  They compute in torch float64 on
``device`` (the card by default, as every entry point of the port; without
a card that raises, and ``device="cpu"`` runs on the CPU), the statistics
and products in float64 as numpy gives them, so that ``predict`` makes the
JAX package's decisions.  The class sums accumulate in time order
(``index_add_``, on the CPU in ``np.add.at``'s order); the products are
``torch.matmul`` (the JAX package computes them in numpy, outside any
Pallas kernel).  Inputs may be numpy arrays or tensors; the fitted
attributes (``mu_``, ``var_``, ``rate_``, ``log_rate_``, ``log_prior_``)
and the results are float64 tensors on ``device`` (``predict``: int64).
``convert.bayes_decoder_from_jax`` carries a fitted JAX decoder across.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.models.base import resolve_device

__all__ = ["GaussianBayesDecoder", "PoissonBayesDecoder"]


def _f64(x, device):
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def _fit_inputs(X, Y, device):
    X = _f64(X, device)
    Y = Y.to(device) if torch.is_tensor(Y) else torch.as_tensor(
        np.asarray(Y), device=device)
    if X.ndim != 2 or Y.ndim != 1 or X.shape[1] != Y.shape[0]:
        raise ValueError(
            "X must be (N, T) and Y must be (T,) with matching timepoints."
        )
    return X, Y.to(torch.int64)


def _check_labels(Y, K):
    if Y.numel() and bool(((Y < 0) | (Y >= K)).any()):
        raise ValueError("Y contains labels outside [0, n_bins-1].")


def _class_sums(X, Y, K, squares=True):
    """Per-class count and per-feature sums in time order: (counts (K,),
    sums (N, K), sq_sums (N, K) or None)."""
    counts = torch.bincount(Y, minlength=K).to(torch.float64)
    sums = torch.zeros((X.shape[0], K), dtype=torch.float64, device=X.device)
    sums.index_add_(1, Y, X)
    if not squares:
        return counts, sums, None
    sq_sums = torch.zeros_like(sums)
    sq_sums.index_add_(1, Y, X**2)
    return counts, sums, sq_sums


def _log_prior(counts, K, uniform_prior):
    if uniform_prior:
        return torch.full((K,), -math.log(K), dtype=torch.float64,
                          device=counts.device)
    probs = (counts + 1) / (counts.sum() + K)  # Laplace smoothing
    return torch.log(probs)


def _shifted(log_probs):
    return log_probs - log_probs.amax(dim=0, keepdim=True)


class GaussianBayesDecoder:
    """Gaussian naive-Bayes decoder for discrete states from continuous
    observations."""

    def __init__(self, n_bins, var_floor=1e-4, uniform_prior=False,
                 device="cuda"):
        self.n_bins = n_bins
        self.var_floor = var_floor
        self.uniform_prior = uniform_prior
        self.device = resolve_device(device)
        self.mu_ = None
        self.var_ = None
        self.log_prior_ = None

    def fit(self, X, Y):
        X, Y = _fit_inputs(X, Y, self.device)
        K = self.n_bins
        _check_labels(Y, K)
        counts, sums, sq_sums = _class_sums(X, Y, K)
        safe = torch.clamp(counts, min=1.0)
        mean = sums / safe
        self.mu_ = torch.where(counts > 0, mean, 0.0)
        var = torch.where(counts > 0, sq_sums / safe - mean**2,
                          self.var_floor)
        self.var_ = torch.clamp(var, min=self.var_floor)
        self.log_prior_ = _log_prior(counts, K, self.uniform_prior)
        return self

    def predict_log_probabilities(self, X):
        """log p(y=k | x) up to a per-timepoint constant, max-shifted to 0.
        Returns (K, T)."""
        if self.mu_ is None:
            raise RuntimeError(
                "Model must be fitted before calling "
                "predict_log_probabilities()."
            )
        X = _f64(X, self.device)
        const = -0.5 * torch.sum(torch.log(2 * np.pi * self.var_), dim=0)
        # quad[k, t] = -0.5 sum_n (x - mu)^2 / var, expanded into products
        inv_var = 1.0 / self.var_
        quad = -0.5 * (
            inv_var.T @ (X**2)
            - 2.0 * (self.mu_ * inv_var).T @ X
            + torch.sum(self.mu_**2 * inv_var, dim=0)[:, None]
        )
        return _shifted(quad + const[:, None] + self.log_prior_[:, None])

    def predict(self, X):
        return torch.argmax(self.predict_log_probabilities(X), dim=0)


class PoissonBayesDecoder:
    """Poisson naive-Bayes decoder for discrete states from count
    observations: per-class mean rates with a floor, Laplace-smoothed
    priors, max-shifted log posteriors (the -log(x!) term, constant in k,
    is dropped)."""

    def __init__(self, n_bins, rate_floor=1e-4, uniform_prior=False,
                 device="cuda"):
        self.n_bins = n_bins
        self.rate_floor = rate_floor
        self.uniform_prior = uniform_prior
        self.device = resolve_device(device)
        self.rate_ = None
        self.log_rate_ = None
        self.log_prior_ = None

    def fit(self, X, Y):
        X, Y = _fit_inputs(X, Y, self.device)
        K = self.n_bins
        _check_labels(Y, K)
        counts, sums, _ = _class_sums(X, Y, K, squares=False)
        safe = torch.clamp(counts, min=1.0)
        lam = torch.where(counts > 0, sums / safe, self.rate_floor)
        self.rate_ = torch.clamp(lam, min=self.rate_floor)
        self.log_rate_ = torch.log(self.rate_)
        self.log_prior_ = _log_prior(counts, K, self.uniform_prior)
        return self

    def predict_log_probabilities(self, X):
        """(K, T) log posteriors up to a per-timepoint constant, max-shifted
        to 0: one (K, N) @ (N, T) product."""
        if self.rate_ is None:
            raise RuntimeError(
                "Model must be fitted before calling "
                "predict_log_probabilities()."
            )
        X = _f64(X, self.device)
        if X.ndim != 2:
            raise ValueError("X must be 2D with shape (N, T).")
        if X.shape[0] != self.rate_.shape[0]:
            raise ValueError(
                f"X has {X.shape[0]} features, but model was fitted with "
                f"{self.rate_.shape[0]} features."
            )
        log_probs = (
            self.log_rate_.T @ X
            - self.rate_.sum(dim=0)[:, None]
            + self.log_prior_[:, None]
        )
        return _shifted(log_probs)

    def predict(self, X):
        return torch.argmax(self.predict_log_probabilities(X), dim=0)
