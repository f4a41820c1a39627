"""The port's ``parallel/spmd.py`` against the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices the Tier-1 conftest forces,
with the parallel-scan passes in their pure-JAX reference form (what
``tests/test_spmd.py`` runs off the TPU); the port runs on a mesh of the
same shape whose every device is ``torch.device("cpu")``, where the K1-K4
wrappers run their plain versions.  The cases, sizes (B = 2, T = 48, N = 8,
L = 6), seeds and tolerances are ``tests/test_spmd.py``'s; the log marginal
is held to 1e-5 relative (PARITY.json).  Also here: the plain K3/K4 with a
validity bound n_valid other than T against JAX's reference passes, a
(1, 1, 1) mesh against the unsharded port, and ``mesh=`` on the sweeps,
model selection and the gain model against their unsharded results.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402
import optax  # noqa: E402

import poor_man_gplvm_tpu as jpmg  # noqa: E402
from poor_man_gplvm_tpu.experimental.gain import (  # noqa: E402
    PoissonGPLVMGain1D_gain as JGain,
)
from poor_man_gplvm_tpu.ops import hmm as jhmm  # noqa: E402
from poor_man_gplvm_tpu.ops import kernels as jgpk  # noqa: E402
from poor_man_gplvm_tpu.ops import mstep as jfth  # noqa: E402
from poor_man_gplvm_tpu.ops.pallas import parallel_scan as jps  # noqa: E402
from poor_man_gplvm_tpu.parallel import spmd as jspmd  # noqa: E402
import poor_man_gplvm_tpu_torch as pmt  # noqa: E402
from poor_man_gplvm_tpu_torch import convert, experimental  # noqa: E402
from poor_man_gplvm_tpu_torch import selection, testing  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import hmm  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk  # noqa: E402
from poor_man_gplvm_tpu_torch.parallel import spmd, sweep  # noqa: E402

torch.set_num_threads(1)

B, T, N, L, RANK = 2, 48, 8, 6, 3
N_DYN = 2
TOL_LML = 1e-5
CPU = torch.device("cpu")


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _mesh(n=8, **kw):
    """The JAX mesh over n virtual devices and the port's of the same
    shape over the CPU."""
    jm = jspmd.make_mesh(n, **kw)
    return jm, spmd.make_mesh(n, devices=[CPU] * n, **kw)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    y = rng.poisson(1.2, size=(B, T, N)).astype(np.float32)
    basis = rng.normal(size=(L, RANK)).astype(np.float32)
    params = (rng.normal(size=(B, RANK, N)) * 0.3).astype(np.float32)
    post0 = rng.dirichlet(np.ones(L), size=(B, T)).astype(np.float32)
    lat_l, log_lat_l, dyn, log_dyn = jgpk.create_transition_prob_1d(
        jnp.arange(L), jnp.arange(N_DYN), movement_variance=1.0,
        p_move_to_jump=0.02, p_jump_to_move=0.03,
    )
    jtrans = jhmm.JointTransition(dyn, lat_l, log_dyn, log_lat_l)
    ttrans = hmm.JointTransition(_t(dyn), _t(lat_l), _t(log_dyn),
                                 _t(log_lat_l))
    return y, basis, params, np.log(post0), jtrans, ttrans


def _latent_trans():
    lat, log_lat = jgpk.create_transition_prob_latent_1d(
        jnp.arange(L), movement_variance=1.0)
    return (jhmm.LatentTransition(lat, log_lat),
            hmm.LatentTransition(_t(lat), _t(log_lat)))


def _hold_smooth(got, want):
    """test_spmd.py's tolerances, port against JAX."""
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=TOL_LML)
    np.testing.assert_allclose(np.exp(_np(got[0])), np.exp(_np(want[0])),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(np.exp(_np(got[2])), np.exp(_np(want[2])),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_np(got[3]), _np(want[3]), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(np.exp(_np(got[4])), np.exp(_np(want[4])),
                               rtol=1e-3, atol=1e-6)
    assert got[5] is None


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,batch,n_neuron,n_time", [
    (8, 2, None, None), (4, 1, None, None), (2, 1, None, None),
    (1, 1, None, None), (2, 4, None, None), (8, 4, None, 8),
    (8, 4, None, 2), (8, 2, 2, 2), (8, 1, 8, None), (6, 1, None, None),
    (16, 4, None, None)])
def test_mesh_factorization(n, batch, n_neuron, n_time):
    want = jspmd.factorize_devices(n, batch, n_neuron=n_neuron,
                                   n_time=n_time)
    assert spmd.factorize_devices(n, batch, n_neuron=n_neuron,
                                  n_time=n_time) == want
    mesh = spmd.make_mesh(n, batch=batch, devices=["cpu"] * n,
                          n_neuron=n_neuron, n_time=n_time)
    assert tuple(mesh.shape.values()) == want
    assert list(mesh.shape) == ["data", "time", "neuron"]
    assert mesh.axis_names == ("data", "time", "neuron")
    assert mesh.devices.shape == want
    assert all(d == CPU for d in mesh.devices.reshape(-1))


def test_mesh_raises():
    with pytest.raises(ValueError):
        spmd.factorize_devices(8, n_time=3)
    with pytest.raises(ValueError):
        spmd.make_mesh(4, devices=["cpu"] * 4, shape=(1, 3, 1))
    with pytest.raises(ValueError):
        spmd.make_mesh(4, devices=["cpu"] * 2)
    if not torch.cuda.is_available():  # never a quiet fall back to the CPU
        with pytest.raises(RuntimeError, match="CUDA card"):
            spmd.make_mesh()
    with pytest.raises(TypeError, match="Mesh"):
        spmd.sharded_smooth(object(), np.ones((4, 2)), torch.ones(3, 2), {},
                            None, torch.ones(2))


def test_collectives():
    devs = [CPU] * 3
    xs = [torch.full((2,), float(i + 1)) for i in range(3)]
    fwd = spmd.ppermute(xs, devs)
    assert [float(x[0]) for x in fwd] == [0.0, 1.0, 2.0]
    bwd = spmd.ppermute(xs, devs, shift=-1)
    assert [float(x[0]) for x in bwd] == [2.0, 3.0, 0.0]
    assert [float(x[0]) for x in spmd.psum(xs, devs)] == [6.0] * 3
    assert [float(x[0]) for x in spmd.pmax(xs, devs)] == [3.0] * 3
    assert [float(x[0]) for x in spmd.broadcast_last(xs, devs)] == [3.0] * 3


# ---------------------------------------------------------------------------
# K3/K4 with a validity bound other than T, against JAX's reference passes
# ---------------------------------------------------------------------------

PASS_T, PASS_C = 29, 4  # tc = 8: the last chunk holds 5 rows


def _pass_inputs(n_dyn, seed):
    rng = np.random.default_rng(seed)
    tc = -(-PASS_T // PASS_C)
    ll = rng.normal(size=(PASS_T, L)).astype(np.float32)
    w = np.exp(ll - ll.max(axis=1, keepdims=True)).astype(np.float32)
    if n_dyn == 1:
        lat, _ = jgpk.create_transition_prob_latent_1d(
            jnp.arange(L), movement_variance=1.0)
        tlat, tdyn = np.asarray(lat, np.float32)[None], np.ones((1, 1),
                                                                np.float32)
    else:
        lat, _, dyn, _ = jgpk.create_transition_prob_1d(
            jnp.arange(L), jnp.arange(n_dyn), movement_variance=1.0,
            p_move_to_jump=0.02, p_jump_to_move=0.03)
        tlat, tdyn = np.asarray(lat, np.float32), np.asarray(dyn,
                                                             np.float32)
    ins = rng.dirichlet(np.ones(n_dyn * L), size=PASS_C).astype(
        np.float32).reshape(PASS_C, n_dyn, L)
    post = rng.dirichlet(np.ones(n_dyn * L), size=PASS_T).astype(
        np.float32).reshape(PASS_T, n_dyn, L)
    return tc, w, tlat, tdyn, ins, post


def _chunk(x, tc):
    """(T, ...) -> JAX's (tc, [...,] C, L) chunk layout."""
    pad = np.zeros((PASS_C * tc,) + x.shape[1:], np.float32)
    pad[:PASS_T] = x
    xc = pad.reshape((PASS_C, tc) + x.shape[1:])
    return jnp.asarray(np.moveaxis(xc, 0, -2))


@pytest.mark.parametrize("n_dyn", [1, 2])
@pytest.mark.parametrize("nv", [0, 1, PASS_T - 3, PASS_T])
def test_plain_k3_n_valid_matches_jax_reference(n_dyn, nv):
    tc, w, tlat, tdyn, ins, _ = _pass_inputs(n_dyn, 10 + nv)
    flags = sk._detect_uniform_rows(torch.tensor(tlat))
    post, norm, fin = ps.pfilter_pass_plain(
        torch.tensor(w), torch.tensor(tlat), torch.tensor(tdyn),
        torch.tensor(ins), tc, flags, True, n_valid=nv)
    jpost, jsv, jfin = jps._pfilter_pass_ref(
        _chunk(w, tc), jnp.asarray(tlat), jnp.asarray(tdyn),
        jnp.asarray(np.moveaxis(ins, 0, 1)), C=PASS_C, block_t=tc,
        tc_eff=tc, n_valid=nv, uniform_rows=flags, finals_only=False)
    want_post = _np(jps._chunk_to_flat(jpost, tc, PASS_T))
    want_norm = _np(jsv).T.reshape(-1)[:PASS_T]
    np.testing.assert_allclose(_np(post), want_post, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(norm), want_norm, rtol=1e-5)
    np.testing.assert_allclose(_np(fin), np.moveaxis(_np(jfin), 0, 1),
                               rtol=1e-5, atol=1e-7)
    # the rows past n_valid pass the carry through, with norm 1
    rows = np.arange(PASS_T)
    prev = np.where((rows % tc == 0)[:, None, None], ins[rows // tc],
                    _np(post)[np.maximum(rows - 1, 0)])
    past = rows >= nv
    assert np.array_equal(_np(post)[past], prev[past])
    assert np.all(_np(norm)[past] == 1.0)


@pytest.mark.parametrize("n_dyn", [1, 2])
@pytest.mark.parametrize("nv", [0, 1, PASS_T - 3, PASS_T, PASS_T + 1])
def test_plain_k4_n_valid_matches_jax_reference(n_dyn, nv):
    tc, _, tlat, tdyn, ins, post = _pass_inputs(n_dyn, 20 + nv)
    flags = sk._detect_uniform_rows(torch.tensor(tlat))
    tl = torch.tensor(tlat)
    sm, r, fin = ps.psmooth_pass_plain(
        torch.tensor(post), tl, tl.transpose(-1, -2).contiguous(),
        torch.tensor(tdyn), torch.tensor(ins), tc, flags, "full",
        n_valid=nv)
    jsm, jr_, jfin = jps._psmooth_pass_ref(
        _chunk(post, tc), jnp.asarray(tlat),
        jnp.asarray(np.swapaxes(tlat, -1, -2)), jnp.asarray(tdyn),
        jnp.asarray(np.moveaxis(ins, 0, 1)), C=PASS_C, block_t=tc,
        tc_eff=tc, n_valid=nv, uniform_rows=flags, marginal=False,
        finals_only=False)
    np.testing.assert_allclose(
        _np(sm), _np(jps._chunk_to_flat(jsm, tc, PASS_T)), rtol=1e-5,
        atol=1e-7)
    np.testing.assert_allclose(
        _np(r), _np(jps._chunk_to_flat(jr_, tc, PASS_T)), rtol=1e-5,
        atol=1e-7)
    np.testing.assert_allclose(_np(fin), np.moveaxis(_np(jfin), 0, 1),
                               rtol=1e-5, atol=1e-7)
    # the rows from n_valid - 1 on pass the carry through, with r = 0
    rows = np.arange(PASS_T)
    nxt = np.where((rows % tc == tc - 1)[:, None, None], ins[rows // tc],
                   _np(sm)[np.minimum(rows + 1, PASS_T - 1)])
    nxt[PASS_T - 1] = ins[(PASS_T - 1) // tc]  # the last row's own carry
    past = rows >= nv - 1
    assert np.array_equal(_np(sm)[past], nxt[past])
    assert np.all(_np(r)[past] == 0.0)
    # the default is n_valid = T
    if nv == PASS_T:
        same = ps.psmooth_pass_plain(
            torch.tensor(post), tl, tl.transpose(-1, -2).contiguous(),
            torch.tensor(tdyn), torch.tensor(ins), tc, flags, "full")
        assert all(torch.equal(a, b) for a, b in zip(same, (sm, r, fin)))


@pytest.mark.parametrize("nv", [0, 1, 298, 301, 302])
def test_nvalid_check_and_its_control(nv):
    """``testing.pscan_nvalid_vs_plain``, what the card holds K3/K4 at
    n_valid with, passes the plain versions against themselves (the
    pass-through rows bit for bit) and fails a plain version run at
    another bound."""
    case = testing.scan_case(3, 301, 20, 2, "masked")
    err = testing.pscan_nvalid_vs_plain(case, CPU, nv)
    assert not testing.pscan_nvalid_failures(err, "highest"), err
    ctl = testing.pscan_nvalid_vs_plain(case, CPU, nv,
                                        plain_n_valid=150 if nv > 150 else 301)
    assert testing.pscan_nvalid_failures(ctl, "highest"), ctl


def test_n_valid_range_raises():
    tc, w, tlat, tdyn, ins, post = _pass_inputs(2, 0)
    flags = sk._detect_uniform_rows(torch.tensor(tlat))
    args = (torch.tensor(w), torch.tensor(tlat), torch.tensor(tdyn),
            torch.tensor(ins), tc, flags, False)
    for nv in (-1, PASS_T + 1):
        with pytest.raises(ValueError, match="n_valid"):
            ps.pfilter_pass(*args, n_valid=nv)
    tl = torch.tensor(tlat)
    args = (torch.tensor(post), tl, tl.transpose(-1, -2).contiguous(),
            torch.tensor(tdyn), torch.tensor(ins), tc, flags, "finals")
    for nv in (-1, PASS_T + 2):
        with pytest.raises(ValueError, match="n_valid"):
            ps.psmooth_pass(*args, n_valid=nv)


# ---------------------------------------------------------------------------
# the sharded smoother
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("time_engine", ["pipeline", "pscan"])
@pytest.mark.parametrize("T_odd", [T, T - 5])
@pytest.mark.parametrize("observation_model", ["poisson", "gaussian"])
def test_sharded_smooth_joint(setup, T_odd, observation_model, time_engine):
    """The joint model, both emissions, a T that does not divide the time
    axis and a masked latent bin, both time engines, on the (1, 4, 2)
    mesh."""
    y, basis, params, _, jtrans, ttrans = setup
    jmesh, tmesh = _mesh(8, batch=1)
    assert tmesh.shape == {"data": 1, "time": 4, "neuron": 2}
    tuning = np.asarray(jfth.get_tuning_softplus(jnp.asarray(params[0]),
                                                 jnp.asarray(basis)))
    hyper = {"noise_std": 0.7}
    y_b = y[0][:T_odd]
    ma_latent = np.ones(L, np.float32)
    ma_latent[2] = 0.0
    want = jspmd.sharded_smooth(
        jmesh, jnp.asarray(y_b), jnp.asarray(tuning), hyper, jtrans,
        jnp.ones(N), jnp.asarray(ma_latent),
        observation_model=observation_model, time_engine=time_engine)
    diag = []
    got = spmd.sharded_smooth(
        tmesh, y_b, torch.tensor(tuning), hyper, ttrans, torch.ones(N),
        torch.tensor(ma_latent), observation_model=observation_model,
        time_engine=time_engine, diag_out=diag)
    _hold_smooth(got, want)
    assert got[0].shape == (T_odd, N_DYN, L)
    assert bool((np.exp(_np(got[0]))[:, :, 2] == 0).all())
    if time_engine == "pscan":  # a shard boundary is one more chunk's
        assert len(diag) == 1 and 1 <= diag[0][0] <= 4 * 3


@pytest.mark.parametrize("time_engine", ["pipeline", "pscan"])
def test_sharded_smooth_latentonly(setup, time_engine):
    y, basis, params, *_ = setup
    jmesh, tmesh = _mesh(8, batch=1)
    jtrans, ttrans = _latent_trans()
    tuning = np.asarray(jfth.get_tuning_softplus(jnp.asarray(params[0]),
                                                 jnp.asarray(basis)))
    want = jspmd.sharded_smooth(
        jmesh, jnp.asarray(y[0]), jnp.asarray(tuning), {}, jtrans,
        jnp.ones(N), jnp.ones(L), time_engine=time_engine)
    got = spmd.sharded_smooth(
        tmesh, y[0], torch.tensor(tuning), {}, ttrans, torch.ones(N),
        torch.ones(L), time_engine=time_engine)
    _hold_smooth(got, want)
    assert got[0].shape == (T, L) and got[4].shape == (L, L)


@pytest.mark.parametrize("time_engine", ["pipeline", "pscan"])
def test_one_device_mesh_equals_unsharded(time_engine):
    """A (1, 1, 1) mesh gives the unsharded port: bit for bit on the
    'pscan' engine, whose one shard is ``smooth_parallel`` on the same
    chunks (emissions with a 2-D mask, the same guess and passes), and to
    PARITY's tolerances on the 'pipeline' engine, whose smoother takes
    push(post) where the sequential engine takes K1's stored priors."""
    rng = np.random.default_rng(5)
    T1, N1, L1 = 300, 9, 12
    pm = pmt.PoissonGPLVMJump1D(N1, n_latent_bin=L1, tuning_lengthscale=4.0,
                                device="cpu")
    y1 = rng.poisson(1.0, size=(T1, N1)).astype(np.float32)
    trans, _ = pm._make_transition({})
    mesh = spmd.make_mesh(1, devices=["cpu"])
    got = spmd.sharded_smooth(mesh, y1, pm.tuning, {}, trans, torch.ones(N1),
                              time_engine=time_engine)
    engine = "cuda_parallel" if time_engine == "pscan" else "cuda"
    want = hmm.smooth_combined_chunked(
        torch.tensor(y1), pm.tuning, {}, trans, torch.ones(N1),
        engine=engine)
    if time_engine == "pscan":
        for k in range(5):
            assert torch.equal(got[k], want[k]), k
    else:
        np.testing.assert_allclose(float(got[1]), float(want[1]),
                                   rtol=TOL_LML)
        np.testing.assert_allclose(np.exp(_np(got[0])),
                                   np.exp(_np(want[0])), atol=1e-4)
        np.testing.assert_allclose(np.exp(_np(got[4])),
                                   np.exp(_np(want[4])), rtol=1e-3,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the sharded EM steps
# ---------------------------------------------------------------------------


def test_sharded_poisson_em_step_matches_jax(setup):
    y, basis, params, log_post, jtrans, ttrans = setup
    jmesh, tmesh = _mesh(8, batch=2)
    assert tmesh.shape == {"data": 2, "time": 2, "neuron": 2}
    jopt = jax.vmap(optax.adam(0.01).init)(jnp.asarray(params))
    jstep = jspmd.make_sharded_poisson_em_step(jmesh, jnp.asarray(basis),
                                               jtrans, m_maxiter=10)
    want = jstep(jnp.asarray(params), jopt, jnp.asarray(log_post),
                 jnp.asarray(y))
    topt = convert.adam_state_from_jax(jopt, device="cpu")
    assert topt.count.shape == (B,) and topt.mu.shape == params.shape
    tstep = spmd.make_sharded_poisson_em_step(tmesh, torch.tensor(basis),
                                              ttrans, m_maxiter=10)
    got = tstep(torch.tensor(params), topt, torch.tensor(log_post),
                torch.tensor(y))
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=2e-4,
                               atol=2e-5)
    for k in ("count", "mu", "nu"):
        np.testing.assert_allclose(_np(getattr(got[1], k)),
                                   _np(getattr(want[1][0], k)), rtol=2e-4,
                                   atol=2e-5)
    np.testing.assert_allclose(np.exp(_np(got[2])), np.exp(_np(want[2])),
                               rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(_np(got[3]), _np(want[3]), rtol=TOL_LML)
    np.testing.assert_allclose(_np(got[4]), _np(want[4]), rtol=TOL_LML)
    # and against the JAX single-device iteration (test_spmd.py's check)
    for b in range(B):
        y_w, t_w = jfth.get_statistics(jnp.asarray(log_post[b]),
                                       jnp.asarray(y[b]))
        run, init = jfth.make_adam_runner(
            jfth.poisson_m_step_objective, step_size=0.01, maxiter=10,
            tol=1e-6)
        p_ref = run(jnp.asarray(params[b]), init(jnp.asarray(params[b])),
                    {"param_prior_std": 1.0}, jnp.asarray(basis), y_w,
                    t_w)["params"]
        np.testing.assert_allclose(_np(got[0][b]), _np(p_ref), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("latent_only", [False, True])
def test_sharded_gaussian_em_step_matches_jax(setup, latent_only):
    y, basis, params, log_post, jtrans, ttrans = setup
    if latent_only:
        jtrans, ttrans = _latent_trans()
    jmesh, tmesh = _mesh(8, batch=2)
    jstep = jspmd.make_sharded_em_step(jmesh, jnp.asarray(basis), jtrans,
                                       emission="gaussian", noise_std=0.7)
    want = jstep(jnp.asarray(params), (), jnp.asarray(log_post),
                 jnp.asarray(y))
    tstep = spmd.make_sharded_em_step(tmesh, torch.tensor(basis), ttrans,
                                      emission="gaussian", noise_std=0.7)
    got = tstep(torch.tensor(params), (), torch.tensor(log_post),
                torch.tensor(y))
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=2e-4,
                               atol=2e-5)
    assert got[1] == ()
    np.testing.assert_allclose(np.exp(_np(got[2])), np.exp(_np(want[2])),
                               rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(_np(got[3]), _np(want[3]), rtol=TOL_LML)
    assert np.all(_np(got[4]) == 0.0)
    with pytest.raises(ValueError, match="divide"):
        tstep(torch.tensor(params), (), torch.tensor(log_post[:, :47]),
              torch.tensor(y[:, :47]))


# ---------------------------------------------------------------------------
# mesh= on the entry points
# ---------------------------------------------------------------------------


def test_model_fit_em_and_decode_with_mesh():
    """``fit_em(mesh=)``/``decode_latent(mesh=)`` at T = 83, N = 10, L = 12
    (none divides the mesh) against the JAX package's with its mesh, the
    Adam loop capped as in test_spmd.py."""
    jmesh, tmesh = _mesh(8, batch=1)
    T_odd, N_m, L_m = 83, 10, 12
    y = np.random.default_rng(1).poisson(1.0, size=(T_odd, N_m)).astype(
        np.float32)
    kw = dict(n_latent_bin=L_m, movement_variance=1.0,
              tuning_lengthscale=5.0, inference_engine="prob")
    jm = jpmg.PoissonGPLVMJump1D(N_m, **kw)
    log_post_init, _ = jm.init_latent_posterior(T_odd, jr.PRNGKey(7))
    pm = convert.load_jax_state(pmt.PoissonGPLVMJump1D(N_m, device="cpu",
                                                       **kw),
                                jm.params, jm.tuning_basis)
    em_j = jm.fit_em(y, key=jr.PRNGKey(3), n_iter=3, verboase=False,
                     log_posterior_init=log_post_init, m_step_maxiter=20,
                     mesh=jmesh)
    em_p = pm.fit_em(y, n_iter=3, verboase=False,
                     log_posterior_init=np.asarray(log_post_init),
                     m_step_maxiter=20, mesh=tmesh)
    np.testing.assert_allclose(_np(torch.stack(em_p["log_marginal_l"])),
                               np.asarray(em_j["log_marginal_l"]),
                               rtol=TOL_LML)
    np.testing.assert_allclose(_np(em_p["posterior"]),
                               np.asarray(em_j["posterior"]), rtol=2e-3,
                               atol=1e-5)
    tuning = np.asarray(em_j["tuning"])
    dec_j = jm.decode_latent(y, tuning=jnp.asarray(tuning), mesh=jmesh)
    dec_p = pm.decode_latent(y, tuning=torch.tensor(tuning), mesh=tmesh)
    np.testing.assert_allclose(dec_p["log_marginal_final"],
                               dec_j["log_marginal_final"], rtol=TOL_LML)
    for k, rtol in (("posterior_all", 2e-3), ("p_transition_latent", 1e-3)):
        np.testing.assert_allclose(_np(dec_p[k]), np.asarray(dec_j[k]),
                                   rtol=rtol, atol=1e-5)
    # and against the unsharded port
    dec_1 = pm.decode_latent(y, tuning=torch.tensor(tuning))
    np.testing.assert_allclose(dec_p["log_marginal_final"],
                               dec_1["log_marginal_final"], rtol=TOL_LML)


def test_gaussian_latentonly_fit_em_with_mesh():
    jmesh, tmesh = _mesh(8, batch=1)
    T_m, N_m, L_m = 64, 9, 10
    y = np.random.default_rng(2).normal(1.0, 1.0, size=(T_m, N_m)).astype(
        np.float32)
    kw = dict(n_latent_bin=L_m, noise_std=0.7, tuning_lengthscale=5.0,
              inference_engine="prob")
    jm = jpmg.GaussianGPLVM1D(N_m, **kw)
    log_post_init, _ = jm.init_latent_posterior(T_m, jr.PRNGKey(7))
    pm = convert.load_jax_state(pmt.GaussianGPLVM1D(N_m, device="cpu", **kw),
                                jm.params, jm.tuning_basis)
    em_j = jm.fit_em(y, key=jr.PRNGKey(3), n_iter=3, verboase=False,
                     log_posterior_init=log_post_init, mesh=jmesh)
    em_p = pm.fit_em(y, n_iter=3, verboase=False,
                     log_posterior_init=np.asarray(log_post_init),
                     mesh=tmesh, output_mode="lean")
    np.testing.assert_allclose(_np(torch.stack(em_p["log_marginal_l"])),
                               np.asarray(em_j["log_marginal_l"]),
                               rtol=TOL_LML)
    tuning = np.asarray(em_j["tuning"])
    dec_j = jm.decode_latent(y, tuning=jnp.asarray(tuning), mesh=jmesh)
    dec_p = pm.decode_latent(y, tuning=torch.tensor(tuning), mesh=tmesh)
    np.testing.assert_allclose(dec_p["log_marginal_final"],
                               dec_j["log_marginal_final"], rtol=TOL_LML)


def test_gain_decode_and_fit_with_mesh():
    """The gain model's smoother over a mesh (the gain rides the per-time
    dt), T and N not divisible, against the JAX package's and the
    unsharded port."""
    jmesh, tmesh = _mesh(8, batch=1)
    T_g, N_g, L_g = 90, 7, 10
    gain = np.exp(np.random.default_rng(4).normal(0, 0.3, T_g)).astype(
        np.float32)
    jm = JGain(N_g, n_latent_bin=L_g, tuning_lengthscale=5.0,
               inference_engine="prob")
    _, y = jm.sample(T_g, key=jr.PRNGKey(0), gain=jnp.asarray(gain))
    y = np.asarray(y, dtype=np.float32)
    pm = convert.load_jax_state(
        experimental.PoissonGPLVMGain1D_gain(
            N_g, n_latent_bin=L_g, tuning_lengthscale=5.0,
            inference_engine="prob", device="cpu"),
        jm.params, jm.tuning_basis)
    _, log_lat, _, log_dyn = jgpk.create_transition_prob_1d(
        jnp.arange(L_g), jnp.arange(2), 1.0, 0.01, 0.01)
    args = (jm.tuning, {}, log_lat, log_dyn)
    want = jm._decode_latent(y, *args, jnp.ones(N_g), gain=gain, mesh=jmesh)
    got = pm._decode_latent(y, pm.tuning, {}, np.asarray(log_lat),
                            np.asarray(log_dyn), torch.ones(N_g),
                            gain=torch.tensor(gain), mesh=tmesh)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=TOL_LML)
    np.testing.assert_allclose(np.exp(_np(got[0])), np.exp(_np(want[0])),
                               rtol=1e-3, atol=1e-6)
    log_post_init = np.asarray(jm.init_latent_posterior(
        T_g, jr.PRNGKey(7))[0])
    em_kw = dict(n_iter=2, verboase=False, m_step_maxiter=20,
                 log_posterior_init=log_post_init)
    em_1 = pm.fit_em(y, **em_kw)
    pm2 = convert.load_jax_state(
        experimental.PoissonGPLVMGain1D_gain(
            N_g, n_latent_bin=L_g, tuning_lengthscale=5.0,
            inference_engine="prob", device="cpu"),
        jm.params, jm.tuning_basis)
    em_m = pm2.fit_em(y, mesh=tmesh, **em_kw)
    np.testing.assert_allclose(_np(torch.stack(em_m["log_marginal_l"])),
                               _np(torch.stack(em_1["log_marginal_l"])),
                               rtol=TOL_LML)


@pytest.fixture(scope="module")
def y_sweep():
    model = jpmg.PoissonGPLVMJump1D(N, n_latent_bin=L, tuning_lengthscale=3.0)
    _, spk = model.sample(200, key=jr.PRNGKey(0))
    return np.asarray(spk, dtype=np.float32)


@pytest.mark.parametrize("n_repeat", [2, 3])
def test_sweep_with_mesh_matches_unsharded(y_sweep, n_repeat):
    """Each bucket's runs split over the 8 devices (3 x 1 runs pad to 8):
    every run agrees with the unsharded sweep to PARITY's tolerances, as
    tests/test_sweep.py holds the JAX package's."""
    mesh = spmd.make_mesh(8, devices=["cpu"] * 8, batch=8)
    grid = {"movement_variance": [0.5, 2.0]} if n_repeat == 2 \
        else {"movement_variance": [1.0]}
    kw = dict(n_repeat=n_repeat, n_iter=2, n_latent_bin=L,
              tuning_lengthscale=3.0, m_maxiter=20, device="cpu")
    local = sweep.sweep_fit_poisson_jump(
        y_sweep, grid, generator=torch.Generator().manual_seed(7), **kw)
    sharded = sweep.sweep_fit_poisson_jump(
        y_sweep, grid, generator=torch.Generator().manual_seed(7),
        mesh=mesh, **kw)
    assert sharded["log_marginal_l"].shape == local["log_marginal_l"].shape
    np.testing.assert_allclose(_np(sharded["log_marginal_l"]),
                               _np(local["log_marginal_l"]), rtol=TOL_LML)
    np.testing.assert_allclose(_np(sharded["params"]), _np(local["params"]),
                               rtol=1e-4, atol=1e-5)


def test_selection_with_mesh_matches_unsharded(y_sweep):
    mesh = spmd.make_mesh(4, devices=["cpu"] * 4)
    kw = dict(test_frac=0.3, n_repeat=2, latent_downsample_frac=[0.5],
              downsample_n_repeat=2, verbose=False, device="cpu",
              fit_kwargs={"n_iter": 2, "m_step_maxiter": 25})
    grid = {"movement_variance": [0.5, 2.0]}
    local = selection.model_selection_one_split(y_sweep, grid,
                                                backend="batched", **kw)
    sharded = selection.model_selection_one_split(y_sweep, grid, mesh=mesh,
                                                  **kw)
    ta = local["model_eval_result_all_configs"]
    tb = sharded["model_eval_result_all_configs"]
    cols = [c for c in ta.columns if c.endswith("_best_value")
            and "consensus" not in c and "overall" not in c]
    assert len(cols) == 3 and cols == [c for c in tb.columns if c in cols]
    for col in cols:
        np.testing.assert_allclose(np.asarray(tb[col], np.float64),
                                   np.asarray(ta[col], np.float64),
                                   rtol=TOL_LML)
