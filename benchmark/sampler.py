"""The benchmark's inputs, drawn on the device from the seed.

A recording follows the configuration's generative model: a dynamics path
that switches from moving to jumping with ``p_move_to_jump`` and back with
``p_jump_to_move`` (geometric stays), a latent path that steps by the
continuous channel's kernel ``exp(-d^2 / movement_variance^2)`` while
moving (reflected at the track's ends) and is drawn uniformly at every
jumping step, tuning curves ``softplus(B @ W)`` on the configuration's
basis B with standard normal weights W, scaled so that the mean count is
``mean_count`` a bin, and Poisson counts or the tuning plus
N(0, noise_std^2) noise.  Every draw comes from one generator on the
device, in a few large calls.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import model as rm


def _latent_path(T, cfg, g, dev):
    L = cfg.n_latent
    p = (cfg.p_move_to_jump, cfg.p_jump_to_move)
    d0 = int(torch.randint(2, (1,), generator=g, device=dev))
    # alternating geometric stays, enough to cover T steps
    n = int(T * max(p) * 2) + 64
    stays = torch.empty((n, 2), dtype=torch.float64, device=dev)
    stays[:, 0].geometric_(p[d0], generator=g)
    stays[:, 1].geometric_(p[1 - d0], generator=g)
    ends = torch.cumsum(stays.reshape(-1), 0)
    if float(ends[-1]) < T:
        raise RuntimeError("sampler: dynamics stays do not cover T")
    t = torch.arange(T, dtype=torch.float64, device=dev)
    seg = torch.searchsorted(ends, t, right=True)
    dyn = (seg + d0) % 2  # 0 moving, 1 jumping

    # steps of the moving channel by inverse CDF over |d| <= 6 ls
    w = int(math.ceil(6 * cfg.movement_variance))
    d = torch.arange(-w, w + 1, dtype=torch.float64, device=dev)
    cdf = torch.cumsum(torch.exp(-(d * d) / cfg.movement_variance ** 2), 0)
    u = torch.rand((T, 2), dtype=torch.float64, generator=g, device=dev)
    step = d[torch.searchsorted(cdf / cdf[-1], u[:, 0].contiguous()).clamp(
        max=2 * w)]
    start = (dyn == 1) | (t == 0)
    fresh = torch.floor(u[:, 1] * L).clamp(max=L - 1)
    step = torch.where(start, torch.zeros_like(step), step)
    csum = torch.cumsum(step, 0)
    idx = torch.where(start, torch.arange(T, device=dev),
                      torch.zeros(T, dtype=torch.long, device=dev))
    first = torch.cummax(idx, 0).values
    x = fresh[first] + csum - csum[first]
    period = 2 * (L - 1)
    x = torch.remainder(x, period)
    lat = torch.where(x <= L - 1, x, period - x).long()
    return dyn.long(), lat


def sample(cfg, T, seed, device):
    """A recording of ``T`` bins: dict with ``y`` (T, N) float32,
    ``tuning`` (L, N) float32, ``latent`` and ``dynamics`` (T,) int64, all
    on ``device``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    basis = cfg.basis().to(dev)
    w = torch.randn((basis.shape[1], cfg.n_neuron), dtype=torch.float64,
                    generator=g, device=dev)
    tun = rm.softplus(basis @ w)
    tun = (tun * (cfg.mean_count / tun.mean())).float()
    dyn, lat = _latent_path(T, cfg, g, dev)
    rate = tun[lat]
    if cfg.family == "poisson":
        y = torch.poisson(rate, generator=g)
    else:
        y = rate + float(cfg.noise_std) * torch.randn(
            rate.shape, generator=g, device=dev)
    return {"y": y, "tuning": tun, "latent": lat, "dynamics": dyn}
