"""``poor_man_gplvm_tpu_torch.parallel.sweep`` (and the configuration axis
of K1/K2 under it) against ``poor_man_gplvm_tpu/parallel/sweep.py``.

The same numpy spikes go through both packages on the CPU, where the
kernels' wrappers run their plain versions.  ``jax.random`` cannot be
reproduced in torch, so each test puts the JAX package's draws in place of
the port's (the port takes each kind of draw from one function:
``sweep.draw_poisson_jump_init``, ``draw_run_init``, ``ctor_params``),
reproduced with the JAX package's own ``jax.random`` calls.  Tolerances:
``log_marginal_l`` 1e-5 relative with ``m_maxiter`` capped as the JAX
tests cap it (the Adam stop flips under 1-ulp loss differences), tuning
1e-4, decode log-marginals and masked LMLs 1e-5 relative, the dynamics
marginal 1e-4; the config-indexed plain K1/K2 against JAX's
``_forward_scan_prob``/``_backward_scan_prob`` per configuration to the
scan tolerances.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import poor_man_gplvm_tpu as jpmg  # noqa: E402
from poor_man_gplvm_tpu.models.jump1d import _init_posterior_random  # noqa: E402
from poor_man_gplvm_tpu.models.latent1d import (  # noqa: E402
    _init_posterior_uniform_noise,
)
from poor_man_gplvm_tpu.ops import hmm as jhmm  # noqa: E402
from poor_man_gplvm_tpu.parallel import sweep as jsw  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import hmm  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk  # noqa: E402
from poor_man_gplvm_tpu_torch.parallel import spmd, sweep  # noqa: E402
from poor_man_gplvm_tpu_torch.testing import (  # noqa: E402
    SCAN_TOLERANCES,
    config_batch_vs_single,
    config_stack,
)

torch.set_num_threads(1)

T, N, L = 120, 8, 10
TOL_LML = 1e-5
TOL_TUNING = 1e-4
TOL_DYN = 1e-4


@pytest.fixture(scope="module")
def y():
    model = jpmg.PoissonGPLVMJump1D(N, n_latent_bin=L, tuning_lengthscale=3.0)
    _, spk = model.sample(T, key=jr.PRNGKey(0))
    return np.asarray(spk, dtype=np.float32)


def _state(g):
    return bytes(g.get_state().numpy())


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _jax_model_class_draws(monkeypatch, run_keys):
    """Put the JAX draws of ``sweep_fit_model_class`` in place of the
    port's: each run generator's (fresh) state -> its JAX key."""
    def draw(model_class_str, T_, L_, g, random_scale=0.1, device="cpu"):
        f = (_init_posterior_uniform_noise if "latentonly" in model_class_str
             else _init_posterior_random)
        return torch.as_tensor(np.asarray(
            f(T_, L_, run_keys[_state(g)], random_scale)[0]))

    def params(nb, n, rng_init_int=123, w_init_variance=1.0,
               w_init_mean=0.0):
        return torch.as_tensor(np.asarray(
            jax.random.normal(jr.PRNGKey(rng_init_int), (nb, n)))
            * np.float32(np.sqrt(w_init_variance)) + w_init_mean)

    monkeypatch.setattr(sweep, "draw_run_init", draw)
    monkeypatch.setattr(sweep, "ctor_params", params)


def test_expand_grid_matches_jax():
    ranges = {"movement_variance": [0.5, 2.0], "p_move_to_jump": [0.01, 0.1]}
    want = jsw.expand_grid(ranges, n_repeat=3)
    got = sweep.expand_grid(ranges, n_repeat=3)
    assert set(got[0]) == set(want[0])
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], np.asarray(want[0][k]))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    with pytest.raises(ValueError):
        sweep.expand_grid({"not_a_param": [1.0]})


@pytest.mark.parametrize("n_dyn", [1, 2])
def test_config_indexed_plain_scans_match_jax_per_configuration(n_dyn):
    """K1/K2's plain versions with a configuration per sequence against the
    JAX package's probability-space scans under each configuration."""
    Lc, Tc = 16, 23
    rng = np.random.default_rng(5)
    movement = (0.5, 1.0, 3.0)
    if n_dyn == 2:
        tlat, tdyn = config_stack(Lc, "cpu", movement=movement,
                                  p_move_to_jump=(0.01, 0.05, 0.2))
    else:
        from poor_man_gplvm_tpu_torch.ops import kernels as gpk

        tlat = torch.stack([gpk.create_transition_prob_latent_1d(
            torch.arange(Lc), mv)[0][None] for mv in movement])
        tdyn = torch.ones((3, 1, 1))
    E = 5
    cfg = torch.tensor([2, 0, 1, 2, 0], dtype=torch.int32)
    ll = torch.as_tensor((rng.normal(size=(E, Tc, Lc)) * 3 - 20).astype(
        np.float32))
    flags = sk._detect_uniform_rows(tlat[0])
    p0 = torch.full((E, n_dyn, Lc), 1.0 / (n_dyn * Lc))
    lengths = torch.full((E,), Tc, dtype=torch.int32)
    post, prior, ratios = sk.filter_chunk_batch(
        ll, tlat, tdyn, p0, lengths, 1.0, uniform_rows=flags, cfg=cfg)
    last = post[:, -1].contiguous()
    smooth, _ = sk.smoother_chunk_batch(post[:, :-1], prior[:, 1:], tlat,
                                        tdyn, last, lengths - 1,
                                        uniform_rows=flags, cfg=cfg)
    for e in range(E):
        g = int(cfg[e])
        lat = jnp.asarray(_np(tlat[g]))
        if n_dyn == 2:
            trans = jhmm.JointTransition(jnp.asarray(_np(tdyn[g])), lat,
                                         jnp.log(_np(tdyn[g])), jnp.log(lat))
            carry = (jnp.full((2, Lc), 1.0 / (2 * Lc)), jnp.float32(0.0))
        else:
            trans = jhmm.LatentTransition(lat[0], jnp.log(lat[0]))
            carry = (jnp.full((Lc,), 1.0 / Lc), jnp.float32(0.0))
        jpost, jprior, jratio, _ = jhmm._forward_scan_prob(
            jnp.asarray(_np(ll[e])), trans, carry, 1.0)
        jsmooth, _ = jhmm._backward_scan_prob(jpost[:-1], jprior[1:], trans,
                                              jpost[-1])
        shape = (Tc, n_dyn, Lc)
        np.testing.assert_allclose(
            _np(post[e]), np.asarray(jpost).reshape(shape),
            atol=SCAN_TOLERANCES["post_abs"])
        np.testing.assert_allclose(
            _np(smooth[e]), np.asarray(jsmooth).reshape((Tc - 1, n_dyn, Lc)),
            atol=SCAN_TOLERANCES["smooth_abs"])
        np.testing.assert_allclose(
            float(ratios[e].sum()), float(np.asarray(jratio).sum()),
            rtol=SCAN_TOLERANCES["log_ratio_sum_rel"])


def test_config_batch_checks_on_the_cpu():
    """The checks the card runs on the config-indexed and norm-only K1/K2
    (``testing.config_batch_vs_single``), through the plain versions: the
    configuration index, the per-configuration bands and the norm-only
    path are wired alike on both devices."""
    err = config_batch_vs_single("cpu", L=30, lengths=(41, 7, 41, 2, 39, 1))
    assert err["equal_single"] and err["norm_only_equal"], err
    assert err["shared_equal"] and err["finite"], err
    assert err["W_single"] == [11, 21, 30, 30], err


def test_stacked_band_pads_each_configuration_to_the_widest():
    from poor_man_gplvm_tpu_torch.ops import band as bd

    tlat, _ = config_stack(200, "cpu")
    flags = sk._detect_uniform_rows(tlat[0])
    tlat_t = tlat.transpose(-1, -2).contiguous()
    stacked = bd.transition_band(tlat, tlat_t, flags)
    assert stacked.W == 81 and stacked.mats.shape == (4, 2, 1, 81, 200)
    bd.check_band(stacked, flags, 200, torch.device("cpu"), n_config=4)
    for g in range(4):
        alone = bd.transition_band(tlat[g], tlat_t[g], flags)
        # the padded band holds the same nonzeros, and exact zeros besides
        assert float(stacked.mats[g].sum()) == pytest.approx(
            float(alone.mats.sum()), rel=1e-6)
        rows = stacked.start[g].long()[..., None, :] + torch.arange(81)[
            :, None]
        dense = torch.stack([tlat[g][~torch.tensor(flags)],
                             tlat_t[g][~torch.tensor(flags)]])
        assert torch.equal(dense.gather(2, rows), stacked.mats[g])
    with pytest.raises(ValueError):
        sk.filter_scan_batch(
            torch.ones((2, 3, 200)), tlat, torch.ones((4, 2, 2)) / 2,
            torch.ones((2, 2, 200)), torch.full((2,), 3, dtype=torch.int32),
            flags, band=bd.transition_band(tlat[0], tlat_t[0], flags),
            cfg=torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("grid, n_repeat", [
    ({"movement_variance": [0.5, 2.0]}, 2),
    ({"tuning_lengthscale": [3.0, 5.0, 20.0]}, 1),  # three basis ranks
])
def test_sweep_fit_poisson_jump_matches_jax(y, monkeypatch, grid, n_repeat):
    key = jr.PRNGKey(11)
    kw = dict(n_repeat=n_repeat, n_iter=3, n_latent_bin=L,
              tuning_lengthscale=3.0, m_maxiter=20)
    want = jsw.sweep_fit_poisson_jump(y, grid, key=key, **kw)
    B = len(want["config_index"])
    gen = torch.Generator().manual_seed(0)
    run_keys = {_state(g): k for g, k in zip(
        sweep.split_generator(torch.Generator().manual_seed(0), B),
        jr.split(key, B))}

    def draw(T_, L_, nb, n, g, device="cpu"):
        _, k_init, k_params = jr.split(run_keys[_state(g)], 3)
        lp, _ = _init_posterior_random(T_, L_, k_init, 0.1)
        return (torch.as_tensor(np.asarray(lp)),
                torch.as_tensor(np.asarray(jr.normal(k_params, (nb, n)))))

    monkeypatch.setattr(sweep, "draw_poisson_jump_init", draw)
    got = sweep.sweep_fit_poisson_jump(y, grid, generator=gen, device="cpu",
                                       **kw)
    np.testing.assert_allclose(_np(got["log_marginal_l"]),
                               np.asarray(want["log_marginal_l"]),
                               rtol=TOL_LML)
    np.testing.assert_allclose(_np(got["tuning"]), np.asarray(want["tuning"]),
                               atol=TOL_TUNING, rtol=TOL_TUNING)
    np.testing.assert_allclose(
        np.exp(_np(got["log_posterior_latent"])),
        np.exp(np.asarray(want["log_posterior_latent"])), atol=1e-4)
    assert isinstance(got["params"], list) == isinstance(want["params"],
                                                         list)
    if isinstance(got["params"], list):
        assert [p.shape[0] for p in got["params"]] == [
            p.shape[0] for p in want["params"]]
    for k in ("config_index", "chain_index"):
        np.testing.assert_array_equal(got[k], want[k])
    assert set(got["grid"]) == set(want["grid"])


@pytest.mark.parametrize("model_class_str, grid", [
    ("poisson", {"movement_variance": [0.5, 2.0], "n_latent_bin": [10, 14]}),
    ("gaussian_latentonly",
     {"n_latent_bin": [10, 14], "tuning_lengthscale": [2.0, 5.0]}),
    ("gaussian", {"p_move_to_jump": [0.01, 0.1], "noise_std": [1.0]}),
])
def test_sweep_fit_and_eval_model_class_match_jax(y, monkeypatch,
                                                  model_class_str, grid):
    import itertools

    n_repeat = 2
    configs = [dict(zip(grid, c)) for c in itertools.product(*grid.values())]
    config_l = [dict(c) for c in configs for _ in range(n_repeat)]
    B = len(config_l)
    keys = jr.split(jr.PRNGKey(3), B)
    gens = sweep.split_generator(torch.Generator().manual_seed(1), B)
    run_keys = {_state(g): k for g, k in zip(
        sweep.split_generator(torch.Generator().manual_seed(1), B), keys)}
    _jax_model_class_draws(monkeypatch, run_keys)
    kw = dict(n_iter=3, m_maxiter=25)
    want = jsw.sweep_fit_model_class(y, config_l, list(keys),
                                     model_class_str, **kw)
    got = sweep.sweep_fit_model_class(y, config_l, gens, model_class_str,
                                      device="cpu", **kw)
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(g["log_marginal_l"]),
                                   np.asarray(w["log_marginal_l"]),
                                   rtol=TOL_LML)
        np.testing.assert_allclose(_np(g["tuning"]), np.asarray(w["tuning"]),
                                   atol=TOL_TUNING, rtol=TOL_TUNING)
        np.testing.assert_allclose(_np(g["m_step_final_loss_l"]),
                                   np.asarray(w["m_step_final_loss_l"]),
                                   rtol=TOL_LML)

    # evaluation on held-out spikes with the JAX fit's tunings, two masks
    # per run and fraction
    y_test = y[:60]
    rng = np.random.default_rng(2)
    masks = {}
    for frac in (0.5,):
        masks[frac] = []
        for cfg in config_l:
            Lr = cfg.get("n_latent_bin", 100)
            m = np.zeros((2, Lr), dtype=np.float32)
            for r in range(2):
                m[r, rng.choice(Lr, int(Lr * frac), replace=False)] = 1
            masks[frac].append(m)
    dec_w, masked_w = jsw.sweep_eval_model_class(
        y_test, want, config_l, model_class_str, masks)
    per_run = [{"tuning": torch.as_tensor(np.asarray(w["tuning"]))}
               for w in want]
    dec_g, masked_g = sweep.sweep_eval_model_class(
        y_test, per_run, config_l, model_class_str, masks)
    for w, g in zip(dec_w, dec_g):
        np.testing.assert_allclose(float(g["log_marginal_final"]),
                                   float(w["log_marginal_final"]),
                                   rtol=TOL_LML)
        np.testing.assert_allclose(float(g["ratios"].sum()),
                                   float(np.asarray(w["ratios"]).sum()),
                                   rtol=TOL_LML)
        np.testing.assert_allclose(_np(g["posterior_dynamics_marg"]),
                                   np.asarray(w["posterior_dynamics_marg"]),
                                   atol=TOL_DYN)
    for frac in masks:
        for w, g in zip(masked_w[frac], masked_g[frac]):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=TOL_LML)


def test_forward_filter_lml_matches_jax_and_the_decode(y):
    jm = jpmg.PoissonGPLVMJump1D(N, n_latent_bin=L, tuning_lengthscale=3.0)
    import poor_man_gplvm_tpu_torch as pmt
    from poor_man_gplvm_tpu_torch import convert

    pm = pmt.PoissonGPLVMJump1D(N, n_latent_bin=L, tuning_lengthscale=3.0,
                                device="cpu")
    convert.load_jax_state(pm, jm.params, jm.tuning_basis)
    mask = np.zeros(L, dtype=np.float32)
    mask[[1, 2, 5, 8]] = 1
    trans_j, _ = jm._make_transition({})
    want = float(jhmm.forward_filter_lml(
        jnp.asarray(y), jm.tuning, {}, trans_j, jnp.ones(N),
        jnp.asarray(mask)))
    trans, _ = pm._make_transition({})
    got = float(hmm.forward_filter_lml(y, pm.tuning, {}, trans, torch.ones(N),
                                       torch.as_tensor(mask)))
    np.testing.assert_allclose(got, want, rtol=TOL_LML)
    dec = pm.decode_latent(y, ma_latent=torch.as_tensor(mask))
    np.testing.assert_allclose(got, dec["log_marginal_final"], rtol=TOL_LML)


def test_sweep_inputs_that_raise(y):
    # mesh= takes a spmd.Mesh: a real one splits the runs, any other
    # object raises
    with pytest.raises(TypeError, match="Mesh"):
        sweep.sweep_fit_poisson_jump(y, {"movement_variance": [1.0]},
                                     mesh=object(), device="cpu")
    res = sweep.sweep_fit_poisson_jump(
        y[:200], {"movement_variance": [1.0]}, n_iter=1, n_latent_bin=L,
        m_maxiter=6, mesh=spmd.make_mesh(devices=["cpu"] * 2), device="cpu")
    assert res["log_marginal_l"].shape == (1, 1)
    assert np.isfinite(res["log_marginal_l"].numpy()).all()
    with pytest.raises(ValueError, match="cannot handle"):
        sweep.sweep_fit_model_class(y, [{"rng_init_int": 3}],
                                    [torch.Generator()], "poisson",
                                    device="cpu")
    # a stack needs one class and one set of constant-channel flags
    t1 = sweep._make_trans("poisson", {"movement_variance": 1.0,
                                       "p_move_to_jump": 0.01,
                                       "p_jump_to_move": 0.01}, L, "cpu")
    t2 = sweep._make_trans("poisson_latentonly", {"movement_variance": 1.0},
                           L, "cpu")
    with pytest.raises(ValueError, match="share"):
        hmm.stack_transitions([t1, t2])


@pytest.mark.parametrize("model_class_str", ["poisson",
                                             "gaussian_latentonly"])
def test_run_draws_come_from_the_run_generator_on_its_device(
        model_class_str):
    """The port's own initial posterior: one seed from the run's CPU
    generator, the (T, L) draw made on the device from it; the rows are
    normalised, one generator state gives one draw, and a latent-only
    row keeps the uniform floor."""
    def draw(seed):
        return sweep.draw_run_init(model_class_str, T, L,
                                   torch.Generator().manual_seed(seed),
                                   0.1, device="cpu")

    lp = draw(4)
    assert lp.shape == (T, L) and lp.device.type == "cpu"
    np.testing.assert_allclose(torch.exp(lp).sum(dim=1).numpy(), 1.0,
                               rtol=1e-5)
    assert torch.equal(lp, draw(4)) and not torch.equal(lp, draw(5))
    if "latentonly" in model_class_str:
        # 1/L + u over a row sum of at most 1 + 0.1 L
        assert float(torch.exp(lp).min()) >= (1.0 / L) / (1 + 0.1 * L) \
            * (1 - 1e-6)
    lp0, w0 = sweep.draw_poisson_jump_init(
        T, L, 5, N, torch.Generator().manual_seed(4), device="cpu")
    g = torch.Generator().manual_seed(4)
    assert torch.equal(w0, torch.randn((5, N), generator=g))
    assert torch.equal(lp0, sweep.draw_run_init("poisson", T, L, g,
                                                device="cpu"))


def test_batched_runs_equal_the_serial_fits_on_the_port_draws(y):
    """With the port's own draws (no JAX draws put in their place) the
    batched sweep and the serial ``fit_model_one_config`` start every run
    from the same posterior and weights, and agree."""
    from poor_man_gplvm_tpu_torch import selection

    configs = [{"n_latent_bin": L, "tuning_lengthscale": 3.0,
                "movement_variance": mv} for mv in (0.5, 2.0)]
    kw = dict(n_iter=3, m_maxiter=20)
    gens = sweep.split_generator(torch.Generator().manual_seed(7), 2)
    states = [g.get_state() for g in gens]
    got = sweep.sweep_fit_model_class(y, configs, gens, "poisson",
                                      device="cpu", **kw)
    fit_kwargs = dict(selection.default_fit_kwargs, n_iter=3,
                      m_step_maxiter=20, verboase=False)
    for cfg, state, run in zip(configs, states, got):
        g = torch.Generator()
        g.set_state(state)
        _, em = selection.fit_model_one_config(
            cfg, y, generator=[g], fit_kwargs=fit_kwargs,
            model_class_str="poisson", device="cpu")
        np.testing.assert_allclose(_np(run["log_marginal_l"]),
                                   _np(em[0]["log_marginal_l"]),
                                   rtol=TOL_LML)
