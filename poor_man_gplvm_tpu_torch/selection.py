"""Model selection: hyperparameter grids, multi-chain fitting, evaluation.

Counterpart of ``poor_man_gplvm_tpu/selection.py`` (reference
poor_man_gplvm/model_selection_helper.py), with the same names, metric
definitions and dict contracts, in PyTorch:

* ``torch.Generator`` takes the place of ``key=``: ``generator=`` (a CPU
  generator; the JAX package's default seed when None), split into one
  generator per config and chain by ``parallel.sweep.split_generator``;
* every entry point that builds models takes ``device`` (the card by
  default, ``'cpu'`` on request);
* the JAX functions return pandas DataFrames, and the card's machine has
  no pandas: the port returns a ``ResultTable`` (``utils/table.py``:
  ordered numpy columns, ``.columns``, ``len``, column access, ``.join``),
  whose ``to_dataframe()`` imports pandas at the call.

``model_selection_one_split(backend='batched')`` runs the whole tree as
``parallel.sweep``'s batched programs: each bucket's EM with one K1 and
one K2 launch per iteration, the test decodes with one of each, and every
downsampled LML through the norm-only K1.  The random draws come from one
place each (``sweep.draw_run_init``, ``sweep.ctor_params``,
``_downsample_masks``, ``_consensus_shifts``), which both backends use.
"""

from __future__ import annotations

import copy
import itertools

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.models import (
    model_class_dict,
    resolve_model_class,
)
from poor_man_gplvm_tpu_torch.models.base import resolve_device
from poor_man_gplvm_tpu_torch.ops import emissions, hmm
from poor_man_gplvm_tpu_torch.parallel import spmd as _spmd
from poor_man_gplvm_tpu_torch.parallel import sweep as _sweep
from poor_man_gplvm_tpu_torch.utils.table import ResultTable

__all__ = [
    "ResultTable",
    "model_class_dict",
    "default_fit_kwargs",
    "generate_hyperparam_grid",
    "fit_model_one_config",
    "evaluate_model_one_config",
    "model_selection_one_split",
    "get_downsampled_lml",
    "get_jump_consensus",
    "get_jump_consensus_shuffle",
    "get_lml_test_history",
]

default_fit_kwargs = {
    "n_iter": 20,
    "log_posterior_init": None,
    "n_time_per_chunk": None,
    "dt": 1.0,
    "likelihood_scale": 1.0,
    "save_every": None,
    "posterior_init_kwargs": {"random_scale": 0.1},
}

#: the Adam settings of fit_em, which the ridge classes' fit_em does not take
_ADAM_FIT_KWARGS = ("m_step_step_size", "m_step_maxiter", "m_step_tol")


def generate_hyperparam_grid(hyperparam_ranges):
    """Dict of lists -> list of all combinations + ``ResultTable``
    (reference model_selection_helper.py:18-33)."""
    keys = list(hyperparam_ranges.keys())
    combos = itertools.product(*[hyperparam_ranges[k] for k in keys])
    hyper_grid_l = [dict(zip(keys, combo)) for combo in combos]
    grid = ResultTable({k: [c[k] for c in hyper_grid_l] for k in keys})
    return hyper_grid_l, grid


def _seeded(generator, seed):
    return torch.Generator().manual_seed(seed) if generator is None \
        else generator


def _same_state(generator):
    """A new generator in ``generator``'s state (the JAX package reuses
    one key for several draws; a torch generator advances)."""
    g = torch.Generator()
    g.set_state(generator.get_state())
    return g


def _use_ctor_params(model):
    """Set the model's weights from ``sweep.ctor_params`` (what its
    constructor drew), so that both backends take them from one place."""
    params = _sweep.ctor_params(model.n_basis, model.n_neuron,
                                model.rng_init_int, model.w_init_variance,
                                model.w_init_mean).to(model.device,
                                                      torch.float32)
    model.params = params
    model.tuning = model.get_tuning(params, {}, model.tuning_basis)


def fit_model_one_config(
    config, y_train, generator=None, fit_kwargs=default_fit_kwargs,
    model_class_str="poisson", n_repeat=1, device="cuda",
):
    """Fit ``n_repeat`` chains of one configuration
    (reference model_selection_helper.py:35-60).  ``generator``: one CPU
    generator (split into one per chain) or a list of them, in the place
    of the JAX ``key``; each chain's initial posterior comes from
    ``sweep.draw_run_init`` on its generator, with
    ``fit_kwargs['posterior_init_kwargs']``, unless ``fit_kwargs`` gives
    ``log_posterior_init``.  The ridge classes drop the Adam settings of
    ``fit_kwargs`` (their fit has no Adam loop; the JAX ``fit_em`` ignores
    them)."""
    generator = _seeded(generator, 0)
    model_class = resolve_model_class(model_class_str)
    gens = generator if isinstance(generator, list) \
        else _sweep.split_generator(generator, n_repeat)
    model_fit_l, em_res_l = [], []
    for g in gens:
        model_fit = model_class(n_neuron=y_train.shape[1], device=device,
                                **config)
        _use_ctor_params(model_fit)
        fk = dict(fit_kwargs)
        init_kw = fk.pop("posterior_init_kwargs", None) or {}
        if fk.get("log_posterior_init") is None:
            fk["log_posterior_init"] = _sweep.draw_run_init(
                model_class, y_train.shape[0], model_fit.n_latent_bin, g,
                **init_kw, device=model_fit.device)
        if model_fit.observation_model == "gaussian":
            for k in _ADAM_FIT_KWARGS:
                fk.pop(k, None)
        em_res = model_fit.fit_em(y_train, hyperparam={}, generator=g, **fk)
        em_res_l.append(em_res)
        model_fit_l.append(model_fit)
    return model_fit_l, em_res_l


def evaluate_model_one_config(
    model_fit_l,
    y_test,
    generator=None,
    n_time_per_chunk=None,
    latent_downsample_frac=(0.2, 0.4, 0.6, 0.8),
    downsample_n_repeat=10,
    metric_type_l=(
        "log_marginal_test",
        "log_one_step_predictive_marginal_test",
        "downsampled_lml",
        "jump_consensus",
    ),
    jump_dynamics_index=1,
    jump_consensus_window_size=5,
    jump_consensus_jump_p_thresh=0.4,
    jump_consensus_consensus_thresh=0.8,
):
    """Per-chain evaluation metrics + best chain per metric
    (reference model_selection_helper.py:62-143).  Every chain and
    fraction draws its masks from ``generator``'s state (as the JAX
    package reuses its key).  The overall metric is the mean of the
    downsampled-LML metrics (reference model_selection_helper.py:130-138)."""
    generator = _seeded(generator, 1)
    latent_downsample_frac = list(latent_downsample_frac)
    metric_type_l = list(metric_type_l)

    decoding_res_l = [
        m.decode_latent(y_test, n_time_per_chunk=n_time_per_chunk)
        for m in model_fit_l
    ]
    lml_test = [float(d["log_marginal_final"]) for d in decoding_res_l]
    one_step_sum = [
        float(d["log_one_step_predictive_marginals_all"].sum())
        for d in decoding_res_l
    ]
    dyn_marg_l = (
        [d["posterior_dynamics_marg"].cpu().numpy() for d in decoding_res_l]
        if "jump_consensus" in metric_type_l
        else None
    )
    masked_lml_per_frac = {}
    if "downsampled_lml" in metric_type_l:
        for frac in latent_downsample_frac:
            masked_lml_per_frac[frac] = [
                np.array([get_downsampled_lml(
                    m, y_test, downsample_frac=frac,
                    n_repeat=downsample_n_repeat,
                    generator=_same_state(generator))["value"]])
                for m in model_fit_l
            ]
    return _assemble_eval_from_parts(
        lml_test, one_step_sum, dyn_marg_l, masked_lml_per_frac,
        metric_type_l, latent_downsample_frac, jump_dynamics_index,
        jump_consensus_window_size, jump_consensus_jump_p_thresh,
        jump_consensus_consensus_thresh,
    )


#: fit_em kwargs the batched backend honors (all other keys force the
#: serial path; n_time_per_chunk/save_every only change memory/em_res
#: retention, not results; chunking is exact)
_BATCHED_FIT_KWARGS = frozenset({
    "n_iter", "log_posterior_init", "n_time_per_chunk", "dt",
    "likelihood_scale", "save_every", "posterior_init_kwargs", "verboase",
    "verbose", "m_step_step_size", "m_step_maxiter", "m_step_tol",
})


def _batched_backend_applicable(hyperparam_dict, fit_kwargs, model_class_str,
                                n_configs, n_repeat):
    if n_configs * n_repeat <= 1:
        return False
    # this family's ctor keys, not the all-family union: e.g. noise_std on
    # a poisson class falls through to the serial path, whose TypeError
    # surfaces before any device work
    if set(hyperparam_dict) - set(model_class_dict[
            model_class_str].ctor_defaults(_sweep._SWEEPABLE_CTOR_KEYS)):
        return False
    if set(fit_kwargs) - _BATCHED_FIT_KWARGS:
        return False
    if fit_kwargs.get("log_posterior_init") is not None:
        return False
    # the batched init reads only random_scale; unknown init kwargs take
    # the serial path, which raises TypeError like the reference
    if set(fit_kwargs.get("posterior_init_kwargs") or {}) - {"random_scale"}:
        return False
    if float(fit_kwargs.get("dt", 1.0)) != 1.0:
        return False
    return True


def _config_generators(generator, n_cfg):
    """(fit, eval) generators of each config, in order: the one derivation
    both backends use."""
    gens = _sweep.split_generator(generator, 2 * n_cfg)
    return gens[0::2], gens[1::2]


def _split_indices(T, train_index, test_index, test_frac):
    if train_index is None:
        train_index = slice(0, int(T * (1 - test_frac)))
    if test_index is None:
        test_index = slice(int(T * (1 - test_frac)), T)
    return train_index, test_index


def _as_numpy(y):
    return y.detach().cpu().numpy() if torch.is_tensor(y) else np.asarray(y)


class _Selector:
    """The running best of the per-config loop and the results table, the
    same for both backends."""

    def __init__(self, model_to_return_type):
        self.kind = model_to_return_type
        self.table = {}
        self.best = -np.inf
        self.best_model = self.best_model_l = self.best_config = None
        self.to_return = []

    def add(self, param_dict, model_fit_l, model_eval_result):
        if not self.table:
            for k in model_eval_result:
                self.table[k + "_best_value"] = []
                self.table[k + "_best_index"] = []
        for k in model_eval_result:
            self.table[k + "_best_value"].append(
                model_eval_result[k]["best_value"])
            self.table[k + "_best_index"].append(
                model_eval_result[k]["best_index"])
        overall = model_eval_result["metric_overall"]
        if overall["best_value"] > self.best:
            self.best = overall["best_value"]
            self.best_model = model_fit_l[overall["best_index"]]
            self.best_model_l = model_fit_l
            self.best_config = param_dict
        if self.kind == "best_per_config":
            self.to_return.append(model_fit_l[overall["best_index"]])
        elif self.kind == "all":
            self.to_return.append(model_fit_l)

    def result(self, grid):
        if self.kind == "best_overall":
            self.to_return = [self.best_model]
        elif self.kind == "best_config":
            self.to_return = [self.best_model_l]
        return {
            "model_to_return_l": self.to_return,
            "best_config": self.best_config,
            "best_model": self.best_model,
            "best_model_l": self.best_model_l,
            "model_eval_result_all_configs": ResultTable(self.table).join(
                grid),
            "hyperparam_grid_df": grid,
            "hyperparam_tosweep_keys": grid.columns,
        }


def model_selection_one_split(
    y,
    hyperparam_dict,
    train_index=None,
    test_index=None,
    test_frac=0.2,
    generator=None,
    model_to_return_type="best_overall",
    fit_kwargs=default_fit_kwargs,
    model_class_str="poisson",
    n_repeat=5,
    latent_downsample_frac=(0.2, 0.4, 0.6, 0.8),
    downsample_n_repeat=10,
    metric_type_l=(
        "log_marginal_test",
        "log_one_step_predictive_marginal_test",
        "downsampled_lml",
        "jump_consensus",
    ),
    jump_dynamics_index=1,
    jump_consensus_window_size=5,
    jump_consensus_jump_p_thresh=0.4,
    jump_consensus_consensus_thresh=0.8,
    verbose=True,
    backend="auto",
    mesh=None,
    device="cuda",
):
    """Fit + evaluate all grid configs on one contiguous train/test split
    (reference model_selection_helper.py:145-239).

    ``backend``: ``'serial'``, the reference's host loop over configs x
    chains (one ``fit_em`` and one decode per chain); ``'batched'``, the
    whole (config x chain) tree through ``parallel.sweep`` (bucketed
    batched EMs, the test decodes, every downsampled-LML filter),
    matching the serial path; ``'auto'`` (default), 'batched' whenever
    ``_batched_backend_applicable`` and more than one run is asked for.

    ``generator`` takes the place of ``key`` (see the module docstring);
    ``device`` is where the models live.  ``model_eval_result_all_configs``
    and ``hyperparam_grid_df`` are ``ResultTable``s and
    ``hyperparam_tosweep_keys`` a list of names, where the JAX package
    returns DataFrames and their columns.

    ``mesh`` (a ``parallel.spmd.Mesh``): the batched backend splits each
    bucket's runs over the mesh's devices (pure data parallelism,
    ``parallel.sweep``); it requires the batched backend, and
    ``backend='serial'`` raises."""
    device = resolve_device(device)
    generator = _seeded(generator, 0)
    if backend not in ("auto", "serial", "batched"):
        raise ValueError(f"unknown backend {backend!r}")
    model_class = resolve_model_class(model_class_str)
    if mesh is not None:
        _spmd.check_mesh(mesh)
        if backend == "serial":
            raise ValueError(
                "mesh= requires the batched backend (the serial host loop "
                "fits one model after another)")
    y = _as_numpy(y)
    T = y.shape[0]
    metric_type_l = list(metric_type_l)
    if not model_class.has_dynamics:
        metric_type_l = [m for m in metric_type_l if "jump" not in m]
    train_index, test_index = _split_indices(T, train_index, test_index,
                                             test_frac)
    y_train, y_test = y[train_index], y[test_index]
    hyperparam_grid_l, grid = generate_hyperparam_grid(hyperparam_dict)
    n_cfg = len(hyperparam_grid_l)
    gens_fit, gens_eval = _config_generators(generator, n_cfg)
    eval_kw = dict(
        latent_downsample_frac=latent_downsample_frac,
        downsample_n_repeat=downsample_n_repeat, metric_type_l=metric_type_l,
        jump_dynamics_index=jump_dynamics_index,
        jump_consensus_window_size=jump_consensus_window_size,
        jump_consensus_jump_p_thresh=jump_consensus_jump_p_thresh,
        jump_consensus_consensus_thresh=jump_consensus_consensus_thresh,
    )
    if backend != "serial":
        applicable = _batched_backend_applicable(
            hyperparam_dict, fit_kwargs, model_class_str, n_cfg, n_repeat)
        if (backend == "batched" or mesh is not None) and not applicable:
            raise ValueError(
                "backend='batched' cannot handle this grid/fit_kwargs "
                "combination (shape-incompatible or unsupported keys): "
                "use backend='serial'"
            )
        if applicable:
            return _one_split_batched(
                y_train, y_test, hyperparam_grid_l, grid, gens_fit, gens_eval,
                model_to_return_type, fit_kwargs, model_class_str, n_repeat,
                eval_kw, verbose, device, mesh)

    fit_kwargs = dict(fit_kwargs)
    if fit_kwargs.get("log_posterior_init") is not None:
        fit_kwargs["log_posterior_init"] = fit_kwargs["log_posterior_init"][
            train_index]
    sel = _Selector(model_to_return_type)
    for ii, param_dict in enumerate(hyperparam_grid_l):
        if verbose:
            print(f"== Config {ii + 1} of {n_cfg} ==")
        model_fit_l, _ = fit_model_one_config(
            param_dict, y_train, generator=gens_fit[ii],
            fit_kwargs=fit_kwargs, model_class_str=model_class_str,
            n_repeat=n_repeat, device=device)
        model_eval_result = evaluate_model_one_config(
            model_fit_l, y_test, generator=gens_eval[ii], **eval_kw)
        sel.add(param_dict, model_fit_l, model_eval_result)
    return sel.result(grid)


def _downsample_masks(generator, n_latent_bin, downsample_frac, n_repeat):
    """(n_repeat, L) float32 latent masks keeping ``int(L * frac)`` bins
    each, drawn without replacement from ``generator`` (the one place
    both backends draw them)."""
    n_sel = int(n_latent_bin * downsample_frac)
    masks = torch.zeros((n_repeat, n_latent_bin), dtype=torch.float32)
    for i in range(n_repeat):
        chosen = torch.randperm(n_latent_bin, generator=generator)[:n_sel]
        masks[i, chosen] = 1.0
    return masks


def _one_split_batched(
    y_train, y_test, hyperparam_grid_l, grid, gens_fit, gens_eval,
    model_to_return_type, fit_kwargs, model_class_str, n_repeat, eval_kw,
    verbose, device, mesh=None,
):
    """backend='batched': the serial tree (fit chains -> decode -> masked
    decodes -> consensus) as ``parallel.sweep``'s batched programs, with
    the serial path's generators, so the results match."""
    n_cfg = len(hyperparam_grid_l)
    n_neuron = y_train.shape[1]
    fk = dict(default_fit_kwargs)
    fk.update(fit_kwargs or {})
    random_scale = float(
        (fk.get("posterior_init_kwargs") or {}).get("random_scale", 0.1))
    config_l, run_gens = [], []
    for ii, cfg in enumerate(hyperparam_grid_l):
        config_l.extend(dict(cfg) for _ in range(n_repeat))
        run_gens.extend(_sweep.split_generator(gens_fit[ii], n_repeat))
    B = len(config_l)
    if verbose:
        print(f"== batched model selection: {n_cfg} configs x {n_repeat} "
              f"chains = {B} runs ==")
    per_run = _sweep.sweep_fit_model_class(
        y_train, config_l, run_gens, model_class_str, n_iter=fk["n_iter"],
        likelihood_scale=float(fk.get("likelihood_scale", 1.0)),
        random_scale=random_scale,
        m_step_size=float(fk.get("m_step_step_size", 0.01)),
        m_maxiter=int(fk.get("m_step_maxiter", 1000)),
        m_tol=float(fk.get("m_step_tol", 1e-6)), mesh=mesh, device=device)

    metric_type_l = eval_kw["metric_type_l"]
    model_class = model_class_dict[model_class_str]
    L_default = model_class.ctor_defaults(("n_latent_bin",))["n_latent_bin"]
    masks_per_run = {}
    if "downsampled_lml" in metric_type_l:
        for frac in eval_kw["latent_downsample_frac"]:
            masks_l = []
            for ii, cfg in enumerate(hyperparam_grid_l):
                masks = _downsample_masks(
                    _same_state(gens_eval[ii]),
                    cfg.get("n_latent_bin", L_default), frac,
                    eval_kw["downsample_n_repeat"])
                masks_l.extend([masks] * n_repeat)
            masks_per_run[frac] = masks_l
    dec_per_run, masked_per_run = _sweep.sweep_eval_model_class(
        y_test, per_run, config_l, model_class_str, masks_per_run,
        likelihood_scale=1.0, mesh=mesh)

    # one constructor per config (its basis SVD), copied per chain
    templates = [model_class(n_neuron=n_neuron, device=device, **cfg)
                 for cfg in hyperparam_grid_l]
    sel = _Selector(model_to_return_type)
    for ii, param_dict in enumerate(hyperparam_grid_l):
        runs = range(ii * n_repeat, (ii + 1) * n_repeat)
        model_fit_l = []
        for i in runs:
            m = copy.copy(templates[ii])
            m.params = per_run[i]["params"]
            m.tuning = per_run[i]["tuning"]
            model_fit_l.append(m)
        dyn = torch.stack([dec_per_run[i]["posterior_dynamics_marg"]
                           for i in runs]).cpu().numpy()
        model_eval_result = _assemble_eval_from_parts(
            [float(dec_per_run[i]["log_marginal_final"]) for i in runs],
            [float(dec_per_run[i]["ratios"].sum()) for i in runs],
            list(dyn),
            {frac: [masked_per_run[frac][i].cpu().numpy() for i in runs]
             for frac in masks_per_run},
            metric_type_l, eval_kw["latent_downsample_frac"],
            eval_kw["jump_dynamics_index"],
            eval_kw["jump_consensus_window_size"],
            eval_kw["jump_consensus_jump_p_thresh"],
            eval_kw["jump_consensus_consensus_thresh"])
        sel.add(param_dict, model_fit_l, model_eval_result)
    return sel.result(grid)


def _assemble_eval_from_parts(
    lml_test, one_step_sum, dyn_marg_l, masked_lml_per_frac, metric_type_l,
    latent_downsample_frac, jump_dynamics_index, jump_consensus_window_size,
    jump_consensus_jump_p_thresh, jump_consensus_consensus_thresh,
):
    """Shared metric assembly for ONE config's chains (reference
    model_selection_helper.py:62-143), for both backends.
    ``masked_lml_per_frac[frac][chain]`` is an array of masked LMLs (one
    per mask, or the 1-element pre-averaged value of the serial path);
    ``dyn_marg_l`` may be None when no jump metric is requested."""
    n_chain = len(lml_test)
    model_eval_result = {}
    if "log_marginal_test" in metric_type_l:
        model_eval_result["log_marginal_test"] = {
            "value_per_fit": np.asarray(lml_test, dtype=np.float64),
            "best_value": None, "best_index": None,
        }
    if "log_one_step_predictive_marginal_test" in metric_type_l:
        model_eval_result["log_one_step_predictive_marginal_test"] = {
            "value_per_fit": np.asarray(one_step_sum, dtype=np.float64),
            "best_value": None, "best_index": None,
        }
    if "downsampled_lml" in metric_type_l:
        for frac in latent_downsample_frac:
            vals = np.array([
                float(np.mean(masked_lml_per_frac[frac][c]))
                for c in range(n_chain)
            ])
            model_eval_result[f"downsampled_lml_{frac}"] = {
                "value_per_fit": vals, "best_value": None, "best_index": None,
            }
    if "jump_consensus" in metric_type_l and dyn_marg_l is not None:
        window_sizes = (
            [jump_consensus_window_size]
            if isinstance(jump_consensus_window_size, int)
            else list(jump_consensus_window_size)
        )
        jump_p_all_chain = np.array([
            np.asarray(d)[:, jump_dynamics_index] for d in dyn_marg_l
        ]).T
        for ws in window_sizes:
            name = (
                "jump_consensus"
                if isinstance(jump_consensus_window_size, int)
                else f"jump_consensus_{ws}"
            )
            vals = []
            for jump_p in jump_p_all_chain.T:
                frac_consensus, _, _ = get_jump_consensus(
                    jump_p, jump_p_all_chain, window_size=ws,
                    jump_p_thresh=jump_consensus_jump_p_thresh,
                    consensus_thresh=jump_consensus_consensus_thresh,
                )
                vals.append(frac_consensus)
            model_eval_result[name] = {
                "value_per_fit": np.array(vals),
                "best_value": None, "best_index": None,
            }
    # overall = mean of the downsampled-LML metrics when computed, else the
    # first available metric (the reference raises KeyError here,
    # model_selection_helper.py:135-138; the JAX package's fix)
    ds_keys = [
        f"downsampled_lml_{frac}"
        for frac in latent_downsample_frac
        if f"downsampled_lml_{frac}" in model_eval_result
    ]
    if ds_keys:
        value_per_fit = np.zeros(n_chain)
        for k in ds_keys:
            value_per_fit += model_eval_result[k]["value_per_fit"]
        value_per_fit /= len(ds_keys)
    elif model_eval_result:
        first = next(iter(model_eval_result))
        value_per_fit = np.asarray(
            model_eval_result[first]["value_per_fit"], dtype=np.float64
        ).copy()
    else:
        value_per_fit = np.zeros(n_chain)
    model_eval_result["metric_overall"] = {
        "value_per_fit": value_per_fit, "best_value": None, "best_index": None,
    }
    for k in model_eval_result:
        vals = model_eval_result[k]["value_per_fit"]
        model_eval_result[k]["best_value"] = np.max(vals)
        model_eval_result[k]["best_index"] = int(np.argmax(vals))
    return model_eval_result


def _emission_hyper(model):
    """The emission hyperparameters a decode of ``model`` reads."""
    return model._emission_hyper({})


def get_downsampled_lml(
    model_fit, y_test, downsample_frac=0.2, n_repeat=10, generator=None,
    **kwargs
):
    """Held-out LML under random latent masks keeping ``frac * L`` bins, a
    complexity-penalty metric (reference model_selection_helper.py:243-260).

    The mask decodes run as ONE launch of the norm-only K1 over the masks
    (the smoother does not change ``log_marginal_final``; each value
    equals ``decode_latent(y_test, ma_latent=mask)['log_marginal_final']``
    on the sequential engine), unless extra decode kwargs force the
    per-mask ``decode_latent``."""
    generator = _seeded(generator, 4)
    L = model_fit.n_latent_bin
    masks = _downsample_masks(generator, L, downsample_frac, n_repeat)
    if not kwargs:
        hyper = _emission_hyper(model_fit)
        trans, _ = model_fit._make_transition(hyper)
        lml_l = hmm.filter_lmls(
            _as_numpy(y_test), [model_fit.tuning], hyper, trans,
            model_fit.ma_neuron_default, model_fit.ma_latent_default,
            observation_model=model_fit.observation_model,
            latent_masks=masks).cpu().numpy()
    else:
        lml_l = np.array([
            model_fit.decode_latent(y_test, ma_latent=masks[i], **kwargs)[
                "log_marginal_final"]
            for i in range(n_repeat)
        ])
    return {"value": float(np.mean(lml_l)), "std": float(np.std(lml_l))}


def get_jump_consensus(
    jump_p, jump_p_all_chain, window_size=5, jump_p_thresh=0.4,
    consensus_thresh=0.8,
):
    """Fraction of one chain's detected jumps corroborated (within a +/-
    window) by at least ``consensus_thresh`` of all chains
    (reference model_selection_helper.py:264-299)."""
    jump_p = np.asarray(jump_p)
    jump_p_all_chain = np.asarray(jump_p_all_chain)
    jump_time_index = np.nonzero(jump_p >= jump_p_thresh)[0]

    jump_time_index_consensus = []
    whether_consensus_ma = []
    for jti in jump_time_index:
        # the raw (possibly negative-start) slice is the reference's metric
        # (model_selection_helper.py:285-286): for jti < window_size the
        # slice is empty, so an early jump never counts as consensus
        window = jump_p_all_chain[jti - window_size: jti + window_size, :]
        whether = (window > jump_p_thresh).any(axis=0).mean() >= \
            consensus_thresh
        whether_consensus_ma.append(whether)
        if whether:
            jump_time_index_consensus.append(jti)
    jump_time_index_consensus = np.array(jump_time_index_consensus, dtype=int)
    whether_consensus_ma = np.array(whether_consensus_ma)

    frac_consensus = (
        whether_consensus_ma.mean() if len(whether_consensus_ma) else np.nan
    )
    is_jump_filtered = np.zeros(len(jump_p))
    if len(jump_time_index_consensus) > 0:
        is_jump_filtered[jump_time_index_consensus] = 1
    return frac_consensus, is_jump_filtered, whether_consensus_ma


def _consensus_shifts(generator, n_shuffle, n_other, n_time):
    """(n_shuffle, n_other) int64 circular shifts in [0, n_time), the one
    place ``get_jump_consensus_shuffle`` draws them."""
    return torch.randint(0, n_time, (n_shuffle, n_other), generator=generator)


def get_jump_consensus_shuffle(
    jump_p, jump_p_all_chain, chain_index, n_shuffle=1000, window_size=5,
    jump_p_thresh=0.4, consensus_thresh=0.8, generator=None, device="cuda",
):
    """Circular-shift null distribution for the jump-consensus metric
    (reference model_selection_helper.py:302-420), on tensors on
    ``device``: every shuffle and every jump at once, each jump's window
    [jti - window_size, jti + window_size] clipped to the recording, as in
    the JAX package."""
    device = resolve_device(device)
    generator = _seeded(generator, 42)
    jump_p = torch.as_tensor(np.asarray(jump_p), dtype=torch.float32,
                             device=device)
    all_chain = torch.as_tensor(np.asarray(jump_p_all_chain),
                                dtype=torch.float32, device=device)
    n_time, n_total = all_chain.shape
    other = torch.arange(n_total, device=device) != chain_index
    n_other = int(other.sum())
    shifts = _consensus_shifts(generator, n_shuffle, n_other, n_time).to(
        device)
    t = torch.arange(n_time, device=device)
    idx = (t[None, None, :] - shifts[:, :, None]) % n_time  # (S, O, T)
    shuffled_other = all_chain[:, other].T[
        torch.arange(n_other, device=device)[None, :, None], idx]
    shuffled = torch.empty((n_shuffle, n_total, n_time), dtype=torch.float32,
                           device=device)
    shuffled[:, chain_index] = jump_p
    shuffled[:, other] = shuffled_other
    jumps = torch.nonzero(jump_p >= jump_p_thresh)[:, 0]
    if len(jumps) == 0:
        dist = torch.zeros(n_shuffle)
    else:
        # exceedances per window as a difference of prefix counts
        exceed = torch.nn.functional.pad(
            (shuffled > jump_p_thresh).to(torch.int32).cumsum(dim=2), (1, 0))
        start = torch.clamp(jumps - window_size, min=0)
        end = torch.clamp(jumps + window_size + 1, max=n_time)
        has = (exceed[:, :, end] - exceed[:, :, start]) > 0  # (S, C, J)
        consensus = has.to(torch.float32).mean(dim=1) >= consensus_thresh
        dist = consensus.to(torch.float32).mean(dim=1)
    dist = dist.cpu().numpy()
    return {
        "frac_consensus_distribution": dist,
        "percentile_2_5": float(np.percentile(dist, 2.5)),
        "percentile_97_5": float(np.percentile(dist, 97.5)),
        "mean": float(dist.mean()),
        "std": float(dist.std()),
    }


def get_lml_test_history(y_test, model, tuning_saved, do_nb=True,
                         ma_temporal=None, batched=True):
    """Held-out LML for each saved tuning snapshot
    (reference model_selection_helper.py:424-445).

    ``batched`` (default): ``do_nb=False`` runs every snapshot's filter in
    one launch of the norm-only K1 (each snapshot's log-likelihoods formed
    as the decode forms them; the smoother does not change
    ``log_marginal_final``); ``do_nb=True`` evaluates
    ``emissions.get_naive_bayes_ma`` per snapshot.  ``batched=False``
    keeps the per-snapshot decode loop."""
    dev = model.device
    y_test = torch.as_tensor(_as_numpy(y_test), dtype=torch.float32,
                             device=dev)
    if ma_temporal is not None:
        ma_neuron = torch.ones(y_test.shape[1], device=dev)[None, :] * \
            torch.as_tensor(np.asarray(ma_temporal), dtype=torch.float32,
                            device=dev)[:, None]
    else:
        ma_neuron = None

    if not batched:
        out = []
        for tun_ in tuning_saved:
            if do_nb:
                res = model.decode_latent_naive_bayes(
                    y_test, tuning=tun_, ma_neuron=ma_neuron)
                out.append(res["log_marginal_total"])
            else:
                res = model.decode_latent(y_test, tuning=tun_,
                                          ma_neuron=ma_neuron)
                out.append(res["log_marginal_final"])
        return np.array(out)
    if len(tuning_saved) == 0:
        return np.array([])
    if ma_neuron is None:
        ma_neuron = model.ma_neuron_default
    hyper = _emission_hyper(model)
    obs = model.observation_model
    tunings = [torch.as_tensor(t, dtype=torch.float32, device=dev)
               for t in tuning_saved]
    if do_nb:
        return np.array([float(emissions.get_naive_bayes_ma(
            y_test, tun, hyper, ma_neuron, model.ma_latent_default,
            observation_model=obs)[2]) for tun in tunings])
    trans, _ = model._make_transition(hyper)
    return hmm.filter_lmls(y_test, tunings, hyper, trans, ma_neuron,
                           model.ma_latent_default,
                           observation_model=obs).cpu().numpy()
