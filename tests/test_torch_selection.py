"""``poor_man_gplvm_tpu_torch.selection`` against
``poor_man_gplvm_tpu/selection.py``.

The same numpy spikes go through both packages on the CPU (the kernels'
wrappers run their plain versions).  The port draws its initial
posteriors (``sweep.draw_run_init``), constructor weights
(``sweep.ctor_params``), downsampling masks (``selection.
_downsample_masks``) and consensus shifts (``selection._consensus_shifts``)
each in one place; the tests put there the JAX package's draws, made with
its own ``jax.random`` calls for the keys its key evolution gives each
config and chain.  ``model_selection_one_split`` is then compared end to
end, both backends of the port against the JAX serial path: every column
of the results table within rtol 1e-4 and atol 1e-6 and the same
``best_config`` (the JAX package's own contract between its backends),
on the grids of its ``test_one_split_batched_equals_serial``.  Masked LMLs
1e-5 relative; the LML history 1e-5.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.random as jr  # noqa: E402

import poor_man_gplvm_tpu as jpmg  # noqa: E402
from poor_man_gplvm_tpu import selection as jsel  # noqa: E402
from poor_man_gplvm_tpu.models.jump1d import _init_posterior_random  # noqa: E402
from poor_man_gplvm_tpu.models.latent1d import (  # noqa: E402
    _init_posterior_uniform_noise,
)
import poor_man_gplvm_tpu_torch as pmt  # noqa: E402
from poor_man_gplvm_tpu_torch import convert, selection  # noqa: E402
from poor_man_gplvm_tpu_torch.parallel import spmd, sweep  # noqa: E402

torch.set_num_threads(1)

T, N, L = 200, 10, 12
FAST_FIT = {
    "n_iter": 2,
    "log_posterior_init": None,
    "n_time_per_chunk": 10000,
    "dt": 1.0,
    "likelihood_scale": 1.0,
    "save_every": None,
    "posterior_init_kwargs": {"random_scale": 0.1},
    "verboase": False,
}
RTOL, ATOL = 1e-4, 1e-6
TOL_LML = 1e-5


@pytest.fixture(scope="module")
def data():
    model = jpmg.PoissonGPLVMJump1D(N, n_latent_bin=L, tuning_lengthscale=3.0)
    _, y = model.sample(T, key=jr.PRNGKey(0))
    return np.asarray(y)


def _state(g):
    return bytes(g.get_state().numpy())


def _jax_draws(monkeypatch, key, seed, n_cfg, n_repeat):
    """Put the JAX serial path's draws in place of the port's, for the
    port's generators of ``torch.Generator().manual_seed(seed)``: each
    chain's and each config's evaluation generator, by its state, maps to
    the JAX key of that chain or config."""
    key_fit, key_eval = [], []
    for _ in range(n_cfg):
        key, _unused = jr.split(key)
        kf, ke = jr.split(key)
        key_fit.append(kf)
        key_eval.append(ke)
    gens_fit, gens_eval = selection._config_generators(
        torch.Generator().manual_seed(seed), n_cfg)
    run_key, eval_key = {}, {}
    for ii in range(n_cfg):
        chain_keys = jr.split(key_fit[ii], n_repeat)
        for c, g in enumerate(sweep.split_generator(gens_fit[ii], n_repeat)):
            run_key[_state(g)] = chain_keys[c]
        eval_key[_state(gens_eval[ii])] = key_eval[ii]

    def draw(model_class, T_, L_, g, random_scale=0.1, device="cpu"):
        f = (_init_posterior_uniform_noise if model_class.init_plus_uniform
             else _init_posterior_random)
        return torch.as_tensor(np.array(
            f(T_, L_, run_key[_state(g)], random_scale)[0]))

    def params(nb, n, rng_init_int=123, w_init_variance=1.0,
               w_init_mean=0.0):
        return torch.as_tensor(np.array(
            jax.random.normal(jr.PRNGKey(rng_init_int), (nb, n)))
            * np.float32(np.sqrt(w_init_variance)) + w_init_mean)

    def masks(g, L_, frac, n_rep):
        return torch.as_tensor(np.array(jsel._downsample_masks(
            eval_key[_state(g)], L_, frac, n_rep)))

    monkeypatch.setattr(sweep, "draw_run_init", draw)
    monkeypatch.setattr(sweep, "ctor_params", params)
    monkeypatch.setattr(selection, "_downsample_masks", masks)


def _assert_tables_match(got, want):
    assert got.columns == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        np.testing.assert_allclose(np.asarray(got[col], dtype=float),
                                   want[col].to_numpy(dtype=float),
                                   rtol=RTOL, atol=ATOL, err_msg=col)


def test_generate_hyperparam_grid_and_result_table(monkeypatch):
    ranges = {"tuning_lengthscale": [1.0, 2.0],
              "movement_variance": [0.5, 1.0, 2.0]}
    grid_l, table = selection.generate_hyperparam_grid(ranges)
    want_l, want_df = jsel.generate_hyperparam_grid(ranges)
    assert grid_l == want_l and len(table) == 6
    assert table.columns == list(want_df.columns)
    df = table.to_dataframe()
    assert df.equals(want_df)
    other = selection.ResultTable({"x": np.arange(6)})
    joined = other.join(table)
    assert joined.columns == ["x", "tuning_lengthscale", "movement_variance"]
    np.testing.assert_array_equal(joined["movement_variance"],
                                  want_df["movement_variance"].to_numpy())
    with pytest.raises(ValueError):
        joined.join(other)  # a column in both
    with pytest.raises(ValueError):
        selection.ResultTable({"a": [1, 2], "b": [1]})
    import sys

    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="pandas"):
        table.to_dataframe()


@pytest.mark.parametrize("model_class_str, grid", [
    # the grids of the JAX package's test_one_split_batched_equals_serial:
    # the dynamics axis and the L axis, then the rank-changing lengthscale
    ("poisson", {"movement_variance": [0.5, 2.0], "n_latent_bin": [10, 14]}),
    ("gaussian_latentonly",
     {"n_latent_bin": [10, 14], "tuning_lengthscale": [2.0, 5.0]}),
])
def test_one_split_matches_jax_on_both_backends(data, monkeypatch,
                                                model_class_str, grid):
    n_repeat = 2
    fk = dict(FAST_FIT, n_iter=3, m_step_maxiter=25)
    common = dict(hyperparam_dict=grid, fit_kwargs=fk,
                  model_class_str=model_class_str, n_repeat=n_repeat,
                  downsample_n_repeat=3, latent_downsample_frac=(0.2, 0.5),
                  verbose=False)
    key = jr.PRNGKey(7)
    n_cfg = int(np.prod([len(v) for v in grid.values()]))
    _jax_draws(monkeypatch, key, 0, n_cfg, n_repeat)
    want = jsel.model_selection_one_split(data, backend="serial", key=key,
                                          **common)
    for backend in ("serial", "batched"):
        got = selection.model_selection_one_split(
            data, backend=backend, generator=torch.Generator().manual_seed(0),
            device="cpu", **common)
        _assert_tables_match(got["model_eval_result_all_configs"],
                             want["model_eval_result_all_configs"])
        assert got["best_config"] == want["best_config"], backend
        assert got["hyperparam_tosweep_keys"] == list(
            want["hyperparam_tosweep_keys"])
        dec = got["best_model"].decode_latent(data[:60])
        assert np.isfinite(dec["log_marginal_final"])


def test_batched_gate_matches_jax(data):
    cases = [
        ({"noise_std": [0.3, 0.5]}, FAST_FIT, "poisson", 2, 2),
        ({"p_move_to_jump": [0.01, 0.02]}, FAST_FIT, "poisson_latentonly",
         2, 2),
        ({"movement_variance": [0.5, 1.0]},
         dict(FAST_FIT, posterior_init_kwargs={"randm_scale": 0.5}),
         "poisson", 2, 2),
        ({"movement_variance": [0.5, 1.0]}, FAST_FIT, "poisson", 2, 2),
        ({"movement_variance": [0.5]}, FAST_FIT, "poisson", 1, 1),
        ({"movement_variance": [0.5, 1.0]}, dict(FAST_FIT, dt=0.5),
         "poisson", 2, 1),
        ({"rng_init_int": [1, 2]}, FAST_FIT, "poisson", 2, 1),
    ]
    for case in cases:
        assert selection._batched_backend_applicable(*case) == \
            jsel._batched_backend_applicable(*case), case
    with pytest.raises(TypeError, match="noise_std"):
        selection.model_selection_one_split(
            data, {"noise_std": [0.3, 0.5]}, fit_kwargs=FAST_FIT,
            n_repeat=2, verbose=False, device="cpu")


def test_one_split_fallbacks_and_metric_subsets(data):
    # unsupported swept key -> auto falls back to serial silently
    res = selection.model_selection_one_split(
        data, {"rng_init_int": [1, 2]}, test_frac=0.3, fit_kwargs=FAST_FIT,
        n_repeat=1, latent_downsample_frac=[0.5], downsample_n_repeat=2,
        verbose=False, device="cpu")
    assert len(res["model_eval_result_all_configs"]) == 2
    with pytest.raises(ValueError, match="batched"):
        selection.model_selection_one_split(
            data, {"rng_init_int": [1, 2]}, fit_kwargs=FAST_FIT, n_repeat=1,
            verbose=False, backend="batched", device="cpu")
    for backend in ("serial", "batched"):
        out = selection.model_selection_one_split(
            data, {"movement_variance": [0.5, 2.0]}, test_frac=0.3,
            fit_kwargs=FAST_FIT, n_repeat=1,
            metric_type_l=("log_marginal_test",), verbose=False,
            backend=backend, device="cpu")
        table = out["model_eval_result_all_configs"]
        np.testing.assert_array_equal(table["metric_overall_best_value"],
                                      table["log_marginal_test_best_value"])
    res = selection.model_selection_one_split(
        data, {"movement_variance": [1.0]}, test_frac=0.3,
        fit_kwargs=FAST_FIT, model_class_str="poisson_latentonly",
        n_repeat=2, latent_downsample_frac=[0.5], downsample_n_repeat=2,
        verbose=False, device="cpu", model_to_return_type="all")
    assert not any("jump" in c for c in
                   res["model_eval_result_all_configs"].columns)
    assert len(res["model_to_return_l"]) == 1
    assert len(res["model_to_return_l"][0]) == 2
    # mesh= takes a spmd.Mesh and the batched backend: a real one runs,
    # any other object raises, and so does the serial backend
    with pytest.raises(TypeError, match="Mesh"):
        selection.model_selection_one_split(
            data, {"movement_variance": [1.0]}, mesh=object(), device="cpu")
    mesh = spmd.make_mesh(devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="batched"):
        selection.model_selection_one_split(
            data, {"movement_variance": [1.0]}, mesh=mesh, backend="serial",
            device="cpu")
    out = selection.model_selection_one_split(
        data, {"movement_variance": [0.5, 2.0]}, test_frac=0.3,
        fit_kwargs=FAST_FIT, n_repeat=1, metric_type_l=("log_marginal_test",),
        verbose=False, mesh=mesh, device="cpu")
    assert len(out["model_eval_result_all_configs"]) == 2


def _port_model(jm, name="PoissonGPLVMJump1D", **kw):
    pm = getattr(pmt, name)(N, device="cpu", **kw)
    return convert.load_jax_state(pm, jm.params, jm.tuning_basis)


def test_downsampled_lml_matches_jax_and_each_masked_decode(data,
                                                            monkeypatch):
    kw = dict(n_latent_bin=L, tuning_lengthscale=3.0)
    jm = jpmg.PoissonGPLVMJump1D(N, **kw)
    pm = _port_model(jm, **kw)
    key = jr.PRNGKey(4)
    masks = np.array(jsel._downsample_masks(key, L, 0.5, 4))
    monkeypatch.setattr(selection, "_downsample_masks",
                        lambda g, L_, frac, n: torch.as_tensor(masks))
    want = jsel.get_downsampled_lml(jm, data[:80], downsample_frac=0.5,
                                    n_repeat=4, key=key)
    got = selection.get_downsampled_lml(pm, data[:80], downsample_frac=0.5,
                                        n_repeat=4)
    np.testing.assert_allclose(got["value"], want["value"], rtol=TOL_LML)
    np.testing.assert_allclose(got["std"], want["std"], rtol=1e-3,
                               atol=1e-3)
    # each masked filter is the decode's log-marginal under that mask
    per_mask = selection.get_downsampled_lml(
        pm, data[:80], downsample_frac=0.5, n_repeat=4,
        n_time_per_chunk=30)
    np.testing.assert_allclose(per_mask["value"], got["value"],
                               rtol=TOL_LML)


def test_jump_consensus_and_shuffle_match_jax(monkeypatch):
    n_time = 100
    jump_p = np.zeros(n_time)
    jump_p[[3, 20, 60]] = 0.9
    all_chain = np.zeros((n_time, 4))
    all_chain[18:23, :] = 0.9
    all_chain[60, 0] = 0.9
    for ws in (2, 5):
        got = selection.get_jump_consensus(jump_p, all_chain, window_size=ws)
        want = jsel.get_jump_consensus(jump_p, all_chain, window_size=ws)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    rng = np.random.default_rng(0)
    n_time, n_shuffle, chain = 80, 50, 1
    jump_p = (rng.random(n_time) > 0.9).astype(float)
    all_chain = (rng.random((n_time, 4)) > 0.9).astype(float)
    all_chain[:, chain] = jump_p
    key = jr.PRNGKey(42)
    shuffle_keys = jr.split(key, n_shuffle)
    shifts = np.array(jax.vmap(lambda k: jax.vmap(
        lambda kk: jr.randint(kk, shape=(), minval=0, maxval=n_time))(
            jr.split(k, 3)))(shuffle_keys))
    monkeypatch.setattr(selection, "_consensus_shifts",
                        lambda g, s, o, t: torch.as_tensor(shifts[:s]))
    for ws in (3, 5):
        want = jsel.get_jump_consensus_shuffle(
            jump_p, all_chain, chain_index=chain, n_shuffle=n_shuffle,
            window_size=ws, key=key)
        got = selection.get_jump_consensus_shuffle(
            jump_p, all_chain, chain_index=chain, n_shuffle=n_shuffle,
            window_size=ws, device="cpu")
        np.testing.assert_allclose(got["frac_consensus_distribution"],
                                   want["frac_consensus_distribution"],
                                   rtol=1e-6)
        for k in ("percentile_2_5", "percentile_97_5", "mean", "std"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    none = selection.get_jump_consensus_shuffle(
        np.zeros(n_time), all_chain, chain_index=chain, n_shuffle=7,
        device="cpu")
    assert none["frac_consensus_distribution"].shape == (7,)
    assert none["mean"] == 0.0


@pytest.mark.parametrize("name", ["PoissonGPLVMJump1D", "GaussianGPLVM1D"])
def test_lml_test_history_matches_jax(data, name):
    kw = dict(n_latent_bin=L, tuning_lengthscale=3.0)
    if name.startswith("Gaussian"):
        kw["noise_std"] = 1.0
    jm = getattr(jpmg, name)(N, **kw)
    pm = _port_model(jm, name, **kw)
    y = data if name.startswith("Poisson") else data - 1.0
    rng = np.random.default_rng(1)
    tunings = [np.asarray(jm.tuning) * s + rng.random((L, N)).astype(
        np.float32) * 0.1 for s in (0.5, 1.0, 1.5)]
    ma_t = np.ones(50)
    ma_t[:10] = 0.0
    for do_nb, ma in itertools.product((True, False), (None, ma_t)):
        want = jsel.get_lml_test_history(y[:50], jm, tunings, do_nb=do_nb,
                                         ma_temporal=ma)
        got = selection.get_lml_test_history(
            y[:50], pm, [torch.as_tensor(t) for t in tunings], do_nb=do_nb,
            ma_temporal=ma)
        serial = selection.get_lml_test_history(
            y[:50], pm, [torch.as_tensor(t) for t in tunings], do_nb=do_nb,
            ma_temporal=ma, batched=False)
        np.testing.assert_allclose(got, want, rtol=TOL_LML)
        np.testing.assert_allclose(serial, got, rtol=TOL_LML)
    assert selection.get_lml_test_history(y[:50], pm, []).shape == (0,)
