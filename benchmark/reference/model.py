"""The model's tables worked out from a configuration, in plain PyTorch.

The tuning basis, the initial weights, the transition matrices, the tuning
links and the emission log-likelihoods of the 1-D jump GPLVM, as the JAX
package defines them.  Nothing here imports the measured program: the
benchmark's reference recomputes every table the program derives.

A ``Prec`` says how the reference computes: float64 (the reference) or
float32 with its matrix products rounded to TF32 (the control, the nearest
precision below the float32 the configurations state).
"""

from __future__ import annotations

import dataclasses
import math

import torch

#: the softplus link's rate floor in the Poisson emission and objective
RATE_FLOOR = 1e-20
OBJ_FLOOR = 1e-20


def tf32_round(x):
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest.  The
    gradient passes through as the identity's, as a TF32 product's does."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach() if x.requires_grad else r


@dataclasses.dataclass(frozen=True)
class Prec:
    """How a reference computation runs: ``name`` 'float64' or 'tf32'."""

    name: str = "float64"

    @property
    def dtype(self):
        return torch.float64 if self.name == "float64" else torch.float32

    def mm(self, a, b):
        """``a @ b`` in this precision."""
        if self.name == "float64":
            return a @ b
        return tf32_round(a.float()) @ tf32_round(b.float())

    def __call__(self, x):
        return x.to(self.dtype)


F64 = Prec("float64")
TF32 = Prec("tf32")


def rbf_gram_f32(L, lengthscale):
    """(L, L) ``exp(-(i - j)^2 / ls^2)`` in float32 on the CPU."""
    pts = torch.arange(L, dtype=torch.float32)
    diff = pts[:, None] - pts[None, :]
    return torch.exp(-(diff * diff) / (lengthscale ** 2))


def tuning_basis(L, lengthscale, threshold=0.999):
    """(L, n_basis) basis: a bias column, then the leading singular vectors
    of the RBF Gram matrix scaled by the fourth root of their singular
    values, as many as ``cumsum(s / s.sum()) < threshold`` counts, plus
    one.  The SVD runs in float32 on the CPU, the definition's precision,
    so that the columns' signs are LAPACK's; returned in float64."""
    u, s, _ = torch.linalg.svd(rbf_gram_f32(L, lengthscale))
    frac = torch.cumsum(s.double() / s.double().sum(), 0)
    n = int((frac < threshold).sum()) + 1
    cols = u[:, :n] * torch.sqrt(torch.sqrt(s[:n]))[None, :]
    return torch.cat([torch.ones((L, 1)), cols], dim=1).double()


def initial_params(n_basis, n_neuron, seed=123, variance=1.0, mean=0.0):
    """(n_basis, N) float64 initial weights: standard normal draws from a
    CPU generator seeded with ``seed`` (the models' ``rng_init_int``)."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((n_basis, n_neuron), generator=g)
    return (w * math.sqrt(variance) + mean).double()


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def tuning(params, basis, link, prec=F64):
    """(L, N) tuning curves: ``softplus(B @ W)`` or ``B @ W``."""
    x = prec.mm(prec(basis), prec(params))
    return softplus(x) if link == "softplus" else x


@dataclasses.dataclass
class Transition:
    """Dynamics (n_dyn, n_dyn) and the continuous channel's (L, L) latent
    transition; the jump channel is uniform (1 / L).  Tdyn[d, e] = p(e|d),
    Tcont[i, j] = p(j | i, continuous)."""

    Tdyn: torch.Tensor
    Tcont: torch.Tensor

    @property
    def L(self):
        return self.Tcont.shape[0]


def transition(L, movement_variance, p_move_to_jump, p_jump_to_move,
               device, prec=F64):
    """The jump model's transitions: the continuous channel a row-normalised
    ``exp(-(i - j)^2 / movement_variance^2)`` (the JAX package uses
    ``movement_variance`` as the RBF's lengthscale), the jump channel
    uniform, and the 2x2 dynamics matrix."""
    pts = torch.arange(L, dtype=torch.float64, device=device)
    diff = pts[:, None] - pts[None, :]
    k = torch.exp(-(diff * diff) / movement_variance ** 2)
    tcont = k / k.sum(dim=1, keepdim=True)
    tdyn = torch.tensor([[1.0 - p_move_to_jump, p_move_to_jump],
                         [p_jump_to_move, 1.0 - p_jump_to_move]],
                        dtype=torch.float64, device=device)
    return Transition(prec(tdyn), prec(tcont))


def loglik(y, tun, family, noise_std=None, prec=F64, rows=100_000):
    """(T, L) emission log-likelihoods of observations ``y`` (T, N) under
    tuning curves ``tun`` (L, N): Poisson with rates ``tun + RATE_FLOOR``,
    or Gaussian with means ``tun`` and standard deviation ``noise_std``.
    Computed in blocks of ``rows``."""
    T = y.shape[0]
    tun = prec(tun)
    out = torch.empty((T, tun.shape[0]), dtype=prec.dtype, device=y.device)
    if family == "poisson":
        lam = tun + RATE_FLOOR
        log_lam_t = torch.log(lam).T.contiguous()
        lam_sum = lam.sum(dim=1)
    else:
        var = float(noise_std) ** 2
        mu_t = tun.T.contiguous()
        mu_sq = (tun * tun).sum(dim=1)
        const = y.shape[1] * (math.log(noise_std)
                              + 0.5 * math.log(2 * math.pi))
    for a in range(0, T, rows):
        yb = prec(y[a:a + rows])
        if family == "poisson":
            out[a:a + rows] = (prec.mm(yb, log_lam_t) - lam_sum[None, :]
                               - torch.lgamma(yb + 1.0).sum(dim=1)[:, None])
        else:
            sq = (yb * yb).sum(dim=1)[:, None]
            out[a:a + rows] = -0.5 * (sq - 2.0 * prec.mm(yb, mu_t)
                                      + mu_sq[None, :]) / var - const
    return out
