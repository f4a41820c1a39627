"""Batched hyperparameter sweeps: the whole grid of runs at once.

Counterpart of ``poor_man_gplvm_tpu/parallel/sweep.py``.  The JAX package
runs the (config x chain) grid as one vmapped program per bucket of equal
shapes, scanning with the probability-space scans under ``vmap``.  Here a
bucket is B runs of one latent size L and basis rank ``n_basis``, and
each EM iteration is:

* the M-step of all B runs at once (the statistics as one batched
  product, then the model class's ``m_step_batch``: the batched Adam
  runner, whose runs each stop at their own iteration, or the batched
  ridge solve);
* each run's emission log-likelihoods, formed as ``fit_em`` forms them;
* ONE launch of K1 and ONE of K2 for all B runs (``hmm._scan_batch`` with
  a configuration index: each run's sequence under its own transition,
  the stack of the bucket's distinct transitions, their bands padded to
  the widest);
* the latent marginal, in log space, which the next M-step reads.

On CPU tensors the kernels' wrappers run their plain versions.

Traced (``utils/profiling.py``), ``sweep_fit_poisson_jump`` records the
span ``sweep`` (top-level: the counters' deltas over the call) and inside
it ``sweep.init`` (a bucket's draws) and, each EM iteration,
``sweep.statistics``, ``sweep.m_step`` (the batched Adam runner or the
ridge solve, and the tuning), ``sweep.emissions`` (``_runs_loglik``) and
``sweep.e_step`` (the K1 and K2 launches and the posterior's log).

What a family is (its defaults, transition, link, emission keys, M-step
and initial posterior) the model class answers (``models/``); the entry
points take the JAX package's class name and resolve it once.

``tuning_lengthscale`` changes the basis rank (an SVD threshold), so it is
swept by bucketing: one batched EM per distinct rank, with the basis per
run where two lengthscales share a rank.  The random draws of a run (its
initial posterior, drawn on the device, and, for
``sweep_fit_poisson_jump``, its initial weights) come from its own
``torch.Generator`` in ``draw_run_init`` / ``draw_poisson_jump_init``,
and the constructor's weights from ``ctor_params``: one place each, so that a test can put the JAX package's
draws in their place.

``mesh=`` (a ``parallel.spmd.Mesh``) is pure data parallelism: each
bucket's runs are padded to a multiple of the mesh's devices (repeating
its last run) and split over them in order, each device runs its share as
a bucket of its own, and the pads are dropped.  A run's results then come
from a batch of another shape than without a mesh, so they agree with the
unsharded ones to the tolerances of the emission and Adam products, not
bit for bit.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.models import (
    PoissonGPLVMJump1D,
    resolve_model_class,
)
from poor_man_gplvm_tpu_torch.models.base import (
    _log_posterior_init,
    resolve_device,
)
from poor_man_gplvm_tpu_torch.ops import hmm
from poor_man_gplvm_tpu_torch.ops import mstep
from poor_man_gplvm_tpu_torch.ops.basis import generate_basis
from poor_man_gplvm_tpu_torch.ops.emissions import (
    MASK_NEG,
    get_loglikelihood_ma_all,
    poisson_lgamma_term,
)
from poor_man_gplvm_tpu_torch.utils import profiling

__all__ = [
    "expand_grid",
    "sweep_fit_poisson_jump",
    "sweep_fit_model_class",
    "sweep_eval_model_class",
]

#: device memory for the masked filters of one norm-only K1 launch (their
#: log-likelihoods and weights, 2 T L f32 each)
MASKED_BATCH_BYTES = 4e9

_SWEEPABLE_CTOR_KEYS = frozenset({
    "n_latent_bin", "tuning_lengthscale", "movement_variance",
    "p_move_to_jump", "p_jump_to_move", "param_prior_std", "noise_std",
    "explained_variance_threshold_basis",
})
#: the ctor keys that change shapes or the basis: not per-run hyperparameters
_SHAPE_KEYS = ("n_latent_bin", "tuning_lengthscale",
               "explained_variance_threshold_basis")


def expand_grid(hyperparam_ranges, n_repeat=1, defaults=None):
    """Cartesian grid -> flat per-run arrays (each config repeated
    ``n_repeat`` times for independent chains).

    Returns (dict of (B,) float32 numpy arrays over swept and default
    params, config_index (B,), chain_index (B,))."""
    defaults = {
        "movement_variance": 1.0,
        "p_move_to_jump": 0.01,
        "p_jump_to_move": 0.01,
        "param_prior_std": 1.0,
        "tuning_lengthscale": 1.0,
        **(defaults or {}),
    }
    keys = list(hyperparam_ranges.keys())
    unsupported = set(keys) - set(defaults)
    if unsupported:
        raise ValueError(
            f"sweep_fit_poisson_jump cannot sweep {sorted(unsupported)}"
        )
    combos = list(itertools.product(*[hyperparam_ranges[k] for k in keys]))
    n_cfg = len(combos)
    out = {}
    for name, default in defaults.items():
        if name in keys:
            col = np.array(
                [combo[keys.index(name)] for combo in combos],
                dtype=np.float32)
        else:
            col = np.full(n_cfg, default, dtype=np.float32)
        out[name] = np.repeat(col, n_repeat)
    config_index = np.repeat(np.arange(n_cfg), n_repeat)
    chain_index = np.tile(np.arange(n_repeat), n_cfg)
    return out, config_index, chain_index


# ---------------------------------------------------------------------------
# the random draws, one place each
# ---------------------------------------------------------------------------


def split_generator(generator, n):
    """``n`` new CPU generators seeded from ``generator`` (one draw of n
    seeds): the port's counterpart of ``jax.random.split``."""
    seeds = torch.randint(0, 2**62, (n,), generator=generator)
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def device_generator(generator, device):
    """A generator on ``device`` seeded by one draw from the CPU
    ``generator``: a run's large draws are made where they are used."""
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


def draw_run_init(model_class, T, n_latent_bin, generator,
                  random_scale=0.1, device="cpu"):
    """A run's initial log posterior (T, L) on ``device``: the model
    class's ``init_latent_posterior`` (noise, plus the uniform floor where
    its ``init_plus_uniform`` says), drawn on the device from a generator
    seeded by the run's (``device_generator``)."""
    g = device_generator(generator, device)
    u = torch.rand((T, n_latent_bin), generator=g, device=device) \
        * random_scale
    if model_class.init_plus_uniform:
        u = 1.0 / n_latent_bin + u
    return _log_posterior_init(u / u.sum(dim=1, keepdim=True), device)[0]


def ctor_params(n_basis, n_neuron, rng_init_int=123, w_init_variance=1.0,
                w_init_mean=0.0):
    """The weights (n_basis, N) a model constructor draws on the CPU
    (``_GPLVMCommon.initialize_params`` from ``rng_init_int``)."""
    g = torch.Generator().manual_seed(rng_init_int)
    return (torch.randn((n_basis, n_neuron), generator=g)
            * float(np.sqrt(w_init_variance)) + w_init_mean)


def draw_poisson_jump_init(T, n_latent_bin, n_basis, n_neuron, generator,
                           device="cpu"):
    """``sweep_fit_poisson_jump``'s own draws for one run, from its
    generator: (initial log posterior (T, L) on ``device``, weights
    (n_basis, N) on the CPU)."""
    params0 = torch.randn((n_basis, n_neuron), generator=generator)
    return (draw_run_init(PoissonGPLVMJump1D, T, n_latent_bin, generator,
                          device=device), params0)


# ---------------------------------------------------------------------------
# one bucket's batched EM
# ---------------------------------------------------------------------------


def _runs_stack(model_class, hps, n_latent_bin, device):
    """(``TransitionStack`` of the distinct transitions of the runs' hps,
    cfg (B,) int32 on ``device``): one configuration per distinct
    transition (by the class's ``_TRANSITION_HYPER_KEYS``), in order of
    first appearance."""
    index, trans_l, cfg = {}, [], []
    for hp in hps:
        k = tuple(float(hp[n]) for n in model_class._TRANSITION_HYPER_KEYS)
        if k not in index:
            index[k] = len(trans_l)
            trans_l.append(model_class.transition_of(hp, n_latent_bin,
                                                     device)[0])
        cfg.append(index[k])
    return (hmm.stack_transitions(trans_l),
            torch.tensor(cfg, dtype=torch.int32, device=device))


def _runs_loglik(y, tunings, hps, model_class, lgamma_term=None):
    """(B, T, L) log-likelihoods, each run's formed on its own as
    ``fit_em`` and ``decode_latent`` form them (the (N,) neuron mask of
    ones broadcast to (T, N), every latent bin kept)."""
    T = y.shape[0]
    B, L, _ = tunings.shape
    ma = torch.ones_like(y)
    keep = torch.ones(L, device=y.device)
    ll = torch.empty((B, T, L), dtype=torch.float32, device=y.device)
    for b in range(B):
        ll[b] = get_loglikelihood_ma_all(
            y, tunings[b],
            {k: hps[b][k] for k in model_class._EMISSION_HYPER_KEYS}, ma,
            keep, observation_model=model_class.observation_model,
            lgamma_term=lgamma_term)
    return ll


def _lgamma_term(y, model_class):
    """The Poisson emissions' lgamma term of y, formed once for every run
    (None for another observation model)."""
    if model_class.observation_model != "poisson":
        return None
    return poisson_lgamma_term(y, torch.ones_like(y))


def _e_step(ll, stack, cfg, likelihood_scale, want_dyn=False, n_chunk=None):
    """One K1 and one K2 launch over the runs' log-likelihoods ll (B, T,
    L), run b under configuration cfg[b] of ``stack``.  Returns (log
    marginals (B,), summed over chunks of ``n_chunk`` (default T) rows as a
    decode sums them, latent marginal (B, T, L) in probability space, K1's
    ratios (B, T), and with ``want_dyn`` the dynamics marginal (B, T,
    n_dyn))."""
    B, T, L = ll.shape
    lengths = torch.full((B,), T, dtype=torch.int32, device=ll.device)
    post, ratios, smooth, _r, last = hmm._scan_batch(
        ll, stack, lengths, likelihood_scale, cfg=cfg)
    del post, _r
    lml = hmm.sequence_lml(ratios, n_chunk or T)
    lat = torch.empty((B, T, L), dtype=torch.float32, device=ll.device)
    torch.sum(smooth, dim=2, out=lat[:, :-1])
    lat[:, -1] = last.sum(dim=1)
    dyn = None
    if want_dyn:
        dyn = torch.cat([smooth.sum(dim=3), last.sum(dim=2)[:, None]], dim=1)
    return lml, lat, ratios, dyn


def _bucket_em(y, basis, params0, log_post, hps, model_class, n_iter,
               n_latent_bin, m_step_size, m_maxiter, m_tol, likelihood_scale,
               want_posterior=False):
    """The EM of one bucket of B runs.  basis (L, n_basis) shared or (B,
    L, n_basis); params0 (B, n_basis, N); log_post (B, T, L) initial log
    posteriors; hps one dict of hyperparameters per run.  Returns the
    per-run dict entries stacked along B: params, tuning,
    log_marginal_l (B, n_iter), m_step_final_loss_l (B, n_iter) and, with
    ``want_posterior``, log_posterior_latent (B, T, L)."""
    dev = y.device
    hp_runs = {k: torch.tensor([float(hp[k]) for hp in hps],
                               dtype=torch.float32, device=dev)
               for k in hps[0]}
    stack, cfg = _runs_stack(model_class, hps, n_latent_bin, dev)
    lg = _lgamma_term(y, model_class)
    params = params0
    m_step = model_class.m_step_batch(params0, hp_runs, basis, m_step_size,
                                      m_maxiter, m_tol)
    lml_l, loss_l = [], []
    for _ in range(n_iter):
        with profiling.span("sweep.statistics"):
            y_w, t_w = mstep.get_statistics_batch(log_post, y)
            del log_post
        with profiling.span("sweep.m_step"):
            params, loss = m_step(params, y_w, t_w)
            loss_l.append(loss)
            tuning = model_class.tuning_link(params, basis)
        with profiling.span("sweep.emissions"):
            ll = _runs_loglik(y, tuning, hps, model_class, lg)
        with profiling.span("sweep.e_step"):
            lml, lat, _, _ = _e_step(ll, stack, cfg, likelihood_scale)
            del ll
            log_post = hmm.prob_to_log(lat)
            del lat
        lml_l.append(lml)
    out = {"params": params, "tuning": tuning,
           "log_marginal_l": torch.stack(lml_l, dim=1),
           "m_step_final_loss_l": torch.stack(loss_l, dim=1)}
    if want_posterior:
        out["log_posterior_latent"] = log_post
    return out


def _run_shards(n, mesh, device):
    """[(device, positions)] of a bucket of n runs: all of them (positions
    None) on ``device`` without a mesh; with one, the positions padded to
    a multiple of the mesh's devices by repeating the last, in contiguous
    groups, one per device (a repeated position is a pad)."""
    if mesh is None:
        return [(device, None)]
    from poor_man_gplvm_tpu_torch.parallel import spmd

    devs = list(spmd.check_mesh(mesh).devices.reshape(-1))
    pos = list(range(n)) + [n - 1] * ((-n) % len(devs))
    per = len(pos) // len(devs)
    return [(d, pos[g * per:(g + 1) * per]) for g, d in enumerate(devs)]


def _take(x, pos, device):
    """Rows ``pos`` of the batched tensor x on ``device`` (x itself for
    positions None)."""
    if pos is None:
        return x
    return x[torch.as_tensor(pos, device=x.device)].to(device)


def _scatter(per_run, idxs, pos, res, device):
    """Write each run's row of a shard's results ``res`` into per_run,
    skipping the pads, on ``device``."""
    pos = range(len(idxs)) if pos is None else pos
    for j, p in enumerate(pos):
        if per_run[idxs[p]] is None:
            per_run[idxs[p]] = {k: v[j].to(device) for k, v in res.items()}


def _stack_rows(per_run, B):
    """Per-run dicts -> one dict: stacked where shapes agree, else a list
    of per-run tensors (``params`` across basis ranks)."""
    results = {}
    for k in per_run[0]:
        vals = [per_run[i][k] for i in range(B)]
        if len({tuple(v.shape) for v in vals}) == 1:
            results[k] = torch.stack(vals)
        else:
            results[k] = vals
    return results


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def sweep_fit_poisson_jump(
    y,
    hyperparam_ranges,
    n_repeat=1,
    n_iter=10,
    n_latent_bin=100,
    tuning_lengthscale=1.0,
    generator=None,
    mesh=None,
    m_step_size=0.01,
    m_maxiter=100,
    m_tol=1e-6,
    likelihood_scale=1.0,
    device="cuda",
):
    """Fit the whole (config x chain) grid of PoissonGPLVMJump1D models,
    one batched EM per basis rank (see the module docstring).

    ``generator`` (a CPU ``torch.Generator``, seed 0 when None) takes the
    place of the JAX ``key``: each run draws its initial posterior and
    weights from its own generator (``split_generator``).  Returns a dict
    with batched results (leading axis = runs, grid order): ``params``
    (a list of per-run tensors when ranks differ), ``tuning``,
    ``log_marginal_l`` (B, n_iter), ``m_step_final_loss_l``,
    ``log_posterior_latent`` (B, T, L), plus ``config_index``,
    ``chain_index`` and ``grid`` (the per-run hyperparameter arrays).
    ``mesh``: each bucket's runs split over its devices (module
    docstring)."""
    with profiling.span("sweep", n_iter=n_iter) as top:
        device = resolve_device(device)
        generator = torch.Generator().manual_seed(0) if generator is None \
            else generator
        y = torch.as_tensor(y, dtype=torch.float32, device=device)
        T, n_neuron = y.shape
        grid, config_index, chain_index = expand_grid(
            hyperparam_ranges, n_repeat=n_repeat,
            defaults={"tuning_lengthscale": tuning_lengthscale},
        )
        B = len(config_index)
        if top is not None:
            top.attrs["n_runs"] = B
        gens = split_generator(generator, B)
        ls_arr = grid["tuning_lengthscale"].astype(np.float64)
        bases = {float(ls): generate_basis(float(ls), n_latent_bin)
                 for ls in np.unique(ls_arr)}
        buckets = {}
        for i in range(B):
            buckets.setdefault(bases[float(ls_arr[i])].shape[1],
                               []).append(i)

        per_run = [None] * B
        for nb, idxs in sorted(buckets.items()):
            basis = torch.stack([bases[float(ls_arr[i])]
                                 for i in idxs]).to(device)
            hps = [{k: float(v[i]) for k, v in grid.items()} for i in idxs]
            with profiling.span("sweep.init"):
                draws = [draw_poisson_jump_init(T, n_latent_bin, nb,
                                                n_neuron, gens[i],
                                                device=device)
                         for i in idxs]
                params0 = torch.stack([d[1] for d in draws]).to(
                    device, torch.float32)
                # handed over whole, so that the EM frees it after its
                # first use
                log_post0 = [torch.stack([d[0] for d in draws]).to(
                    device, torch.float32)]
                del draws
            for dev, pos in _run_shards(len(idxs), mesh, device):
                res = _bucket_em(
                    y.to(dev), _take(basis, pos, dev),
                    _take(params0, pos, dev),
                    log_post0.pop() if pos is None
                    else _take(log_post0[0], pos, dev),
                    hps if pos is None else [hps[p] for p in pos],
                    PoissonGPLVMJump1D, n_iter, n_latent_bin, m_step_size,
                    m_maxiter,
                    m_tol, likelihood_scale, want_posterior=True)
                _scatter(per_run, idxs, pos, res, device)
        results = _stack_rows(per_run, B)
        results["config_index"] = config_index
        results["chain_index"] = chain_index
        results["grid"] = grid
    return results


def _full_configs(config_l, model_class):
    defaults = model_class.ctor_defaults(_SWEEPABLE_CTOR_KEYS)
    for cfg in config_l:
        unsupported = set(cfg) - _SWEEPABLE_CTOR_KEYS
        if unsupported:
            raise ValueError(
                f"batched sweep cannot handle ctor kwargs {sorted(unsupported)}"
            )
    hp_names = sorted(k for k in defaults if k not in _SHAPE_KEYS)
    return [{**defaults, **cfg} for cfg in config_l], hp_names


def _basis_key(cfg):
    return tuple(cfg[k] for k in _SHAPE_KEYS)


def sweep_fit_model_class(
    y, config_l, generator_l, model_class_str, n_iter=20,
    likelihood_scale=1.0, random_scale=0.1, m_step_size=0.01,
    m_maxiter=1000, m_tol=1e-6, mesh=None, device="cuda",
):
    """Fit every (config, chain) run of a model class, bucketed by
    (n_latent_bin, n_basis), as the serial ``selection.fit_model_one_config``
    fits each: the constructor's weights (``ctor_params``), the class's
    initial posterior from the run's generator (``draw_run_init``), the
    same Adam rule with its state threaded across iterations (or the
    ridge solve), and each E-step through one K1 and one K2 launch for the
    bucket.

    ``config_l``: one ctor-kwargs dict PER RUN (configs repeated per
    chain); ``generator_l``: one CPU ``torch.Generator`` per run, in the
    place of the JAX ``key_l``.  Returns a list of per-run dicts
    (params / tuning / log_marginal_l / m_step_final_loss_l).  ``mesh``:
    each bucket's runs split over its devices (module docstring)."""
    model_class = resolve_model_class(model_class_str)
    device = resolve_device(device)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    T, n_neuron = y.shape
    B = len(config_l)
    full_cfg, hp_names = _full_configs(config_l, model_class)
    bases = {}
    for cfg in full_cfg:
        bk = _basis_key(cfg)
        if bk not in bases:
            bases[bk] = generate_basis(
                cfg["tuning_lengthscale"], cfg["n_latent_bin"],
                cfg["explained_variance_threshold_basis"], include_bias=True)
    params0, buckets = {}, {}
    for i, cfg in enumerate(full_cfg):
        nb = bases[_basis_key(cfg)].shape[1]
        if nb not in params0:
            params0[nb] = ctor_params(nb, n_neuron)
        buckets.setdefault((cfg["n_latent_bin"], nb), []).append(i)

    per_run = [None] * B
    for (L, nb), idxs in sorted(buckets.items()):
        bks = [_basis_key(full_cfg[i]) for i in idxs]
        same_basis = all(b == bks[0] for b in bks)
        if same_basis:
            basis = bases[bks[0]].to(device)
        else:  # two lengthscales share a rank: the basis rides the batch
            basis = torch.stack([bases[b] for b in bks]).to(device)
        hps = [{k: full_cfg[i][k] for k in hp_names} for i in idxs]
        # each run's initial posterior from its own generator, handed over
        # whole, so that the EM frees it after its first use
        log_post0 = [torch.stack([draw_run_init(
            model_class, T, L, generator_l[i], random_scale,
            device=device) for i in idxs]).to(device, torch.float32)]
        for dev, pos in _run_shards(len(idxs), mesh, device):
            n_runs = len(idxs) if pos is None else len(pos)
            res = _bucket_em(
                y.to(dev),
                basis.to(dev) if same_basis else _take(basis, pos, dev),
                params0[nb].to(dev, torch.float32)[None]
                .expand(n_runs, -1, -1).contiguous(),
                log_post0.pop() if pos is None
                else _take(log_post0[0], pos, dev),
                hps if pos is None else [hps[p] for p in pos],
                model_class, n_iter, L, m_step_size, m_maxiter, m_tol,
                likelihood_scale)
            _scatter(per_run, idxs, pos, res, device)
    return per_run


def sweep_eval_model_class(
    y_test, per_run, config_l, model_class_str, masks_per_run,
    likelihood_scale=1.0, mesh=None,
):
    """Batched evaluation (reference model_selection_helper.py:62-143,
    :243-260 semantics), bucketed by n_latent_bin: every run's test decode
    through one K1 and one K2 launch (its log marginal, one-step
    predictive ratios and dynamics marginal), and every (run x frac x
    mask) downsampled LML through the norm-only K1, in launches of at most
    ``MASKED_BATCH_BYTES`` of log-likelihoods and weights.  The runs'
    tunings give the device of the results.  ``mesh``: each bucket's runs
    split over its devices (module docstring).

    ``masks_per_run``: {frac: list of (n_mask, L_i) masks, one per run}.
    Returns (decode metrics per run: dicts of ``log_marginal_final``,
    ``ratios`` (T,), ``posterior_dynamics_marg`` (T, n_dyn), zeros (T, 1)
    for a latent-only class; {frac: list of (n_mask,) LMLs per run})."""
    model_class = resolve_model_class(model_class_str)
    device = per_run[0]["tuning"].device
    y_test = torch.as_tensor(y_test, dtype=torch.float32, device=device)
    B = len(config_l)
    full_cfg, hp_names = _full_configs(config_l, model_class)
    buckets = {}
    for i, cfg in enumerate(full_cfg):
        buckets.setdefault(cfg["n_latent_bin"], []).append(i)

    dec_per_run = [None] * B
    masked_per_run = {frac: [None] * B for frac in masks_per_run}
    for L, idxs in sorted(buckets.items()):
        for dev, pos in _run_shards(len(idxs), mesh, device):
            runs = idxs if pos is None else [idxs[p] for p in pos]
            y_d = y_test.to(dev)
            dec, masked = _eval_bucket(
                y_d, _lgamma_term(y_d, model_class), per_run, runs, full_cfg,
                hp_names, model_class,
                masks_per_run, L, likelihood_scale)
            for j, i in enumerate(runs):
                if dec_per_run[i] is None:
                    dec_per_run[i] = {k: v.to(device)
                                      for k, v in dec[j].items()}
                    for frac in masks_per_run:
                        masked_per_run[frac][i] = masked[frac][j].to(device)
    return dec_per_run, masked_per_run


def _eval_bucket(y_test, lg, per_run, runs, full_cfg, hp_names,
                 model_class, masks_per_run, L, likelihood_scale):
    """``sweep_eval_model_class`` on the runs ``runs`` of one bucket of
    latent size L, on y_test's device: (a decode-metrics dict per run,
    {frac: (n_mask,) LMLs per run})."""
    device = y_test.device
    T = y_test.shape[0]
    hps = [{k: full_cfg[i][k] for k in hp_names} for i in runs]
    stack, cfg = _runs_stack(model_class, hps, L, device)
    tunings = torch.stack([per_run[i]["tuning"].to(device) for i in runs])
    ll = _runs_loglik(y_test, tunings, hps, model_class, lg)
    # the decode sums its ratios chunk by chunk
    n_chunk = hmm.auto_chunk_size(T, stack.n_dyn * L, L, device)
    lml, _lat, ratios, dyn = _e_step(ll, stack, cfg, likelihood_scale,
                                     want_dyn=model_class.has_dynamics,
                                     n_chunk=n_chunk)
    del _lat
    dec = [{"log_marginal_final": lml[j], "ratios": ratios[j],
            "posterior_dynamics_marg": dyn[j] if dyn is not None
            else torch.zeros((T, 1), dtype=torch.float32, device=device)}
           for j in range(len(runs))]
    masked = {}
    for frac, masks_l in masks_per_run.items():
        masks = torch.stack([torch.as_tensor(masks_l[i], device=device)
                             .bool() for i in runs])  # (Bb, n_mask, L)
        n_mask = masks.shape[1]
        run_of = torch.arange(len(runs), device=device).repeat_interleave(
            n_mask)
        flat = masks.reshape(-1, L)
        per = max(1, int(MASKED_BATCH_BYTES // (2 * T * L * 4)))
        out = []
        for s0 in range(0, flat.shape[0], per):
            sel = run_of[s0:s0 + per]
            ll_m = torch.where(flat[s0:s0 + per, None, :], ll[sel], MASK_NEG)
            out.append(hmm.filter_lml_batch(
                ll_m, stack, likelihood_scale, cfg=cfg[sel].contiguous(),
                n_time_per_chunk=n_chunk))
            del ll_m
        masked[frac] = torch.cat(out).reshape(len(runs), n_mask)
    del ll
    return dec, masked
