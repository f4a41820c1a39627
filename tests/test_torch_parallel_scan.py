"""The parallel-in-time engine of the port against the JAX package.

``ops/parallel_scan.py`` (the K3/K4 wrappers' plain versions, which CPU
tensors take, and the fixed-point driver ``smooth_parallel``) and the
``'cuda_parallel'`` engine of ``smooth_combined_chunked`` are held against
the JAX package's ``parallel_scan`` and ``'pallas_parallel'`` engine, which
off the TPU run their pure-JAX reference passes (``_pfilter_pass_ref``,
``_psmooth_pass_ref``).  Inputs are made with numpy from a seed.
Tolerances: log-marginals 1e-5 relative; posteriors, smoothed posteriors
and boundary carries 1e-4 absolute; per-step log ratios 1e-5 relative;
the pairwise joint 1e-4 of its largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from poor_man_gplvm_tpu.ops import hmm as jhmm  # noqa: E402
from poor_man_gplvm_tpu.ops import kernels as jgpk  # noqa: E402
from poor_man_gplvm_tpu.ops.pallas import parallel_scan as jps  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import hmm, kernels  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk  # noqa: E402
from poor_man_gplvm_tpu_torch.ops.emissions import MASK_NEG  # noqa: E402
from poor_man_gplvm_tpu_torch.testing import (  # noqa: E402
    subnormal_prior_smoothers,
)

torch.set_num_threads(1)

N = 6
TOL_LML = 1e-5
TOL_POST = 1e-4


def _trans_mats(L, n_dyn, mv=1.3, pmj=0.05, pjm=0.08):
    lat, _, dyn, _ = kernels.create_transition_prob_1d(
        torch.arange(L), torch.arange(2), mv, pmj, pjm)
    if n_dyn == 1:
        return lat[:1].contiguous(), torch.ones((1, 1))
    return lat, dyn


def _ll(seed, T, L, masked=(), spread=3.0):
    rng = np.random.default_rng(seed)
    ll = (rng.normal(size=(T, L)) * spread - 20.0).astype(np.float32)
    ll[:, list(masked)] = MASK_NEG
    return ll


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("T,L,n_dyn", [
    (30, 100, 2), (1_000_000, 500, 2), (2048, 100, 2), (100_000, 100, 2),
    (20_001, 500, 1), (997, 30, 2), (63, 10, 1), (64, 10, 1), (33, 300, 2),
])
def test_choose_parallel_config_matches_jax(T, L, n_dyn):
    assert ps.choose_parallel_config(T, L, n_dyn) == \
        jps.choose_parallel_config(T, L, n_dyn)


def test_carry_spec():
    C = ps.choose_parallel_config(2048, 100, 2)[0]
    assert ps.carry_spec(2048, 100, 2) == (C, 2, 100)
    assert ps.carry_spec(30, 100, 2) is None


def _chunk_major(x, C, tc):
    """(T, ...) global rows -> the JAX passes' (tc, ..., C, L) layout."""
    xc = ps._chunked(torch.as_tensor(x), C, tc).numpy()  # (C, tc, ..., L)
    return np.moveaxis(xc, 0, -2)


def _global(xc, T):
    """(tc, ..., C, L) -> (T, ..., L)."""
    x = np.moveaxis(np.asarray(xc), -2, 0)
    return x.reshape((-1,) + x.shape[2:])[:T]


@pytest.mark.parametrize("n_dyn", [1, 2])
def test_pass_plain_versions_match_jax_refs(n_dyn):
    """K3 and K4 plain versions against the JAX reference passes on the
    same boundary carries, odd T (ragged last chunk, T-1 mid-chunk)."""
    T, L, C = 1001, 12, 8
    tc = -(-T // C)
    tlat, tdyn = _trans_mats(L, n_dyn)
    flags = sk._detect_uniform_rows(tlat)
    ll = torch.as_tensor(_ll(3, T, L, masked=(4,)))
    w = torch.exp(ll - ll.amax(dim=1, keepdim=True))
    rng = np.random.default_rng(4)
    ins = torch.as_tensor(rng.dirichlet(np.ones(n_dyn * L), C)
                          .reshape(C, n_dyn, L).astype(np.float32))

    post, norm, fin = ps.pfilter_pass(w, tlat, tdyn, ins, tc, flags, True)
    jpost, jnorm, jfin = jps._pfilter_pass_ref(
        jnp.asarray(_chunk_major(w, C, tc)), jnp.asarray(tlat.numpy()),
        jnp.asarray(tdyn.numpy()), jnp.asarray(ins.transpose(0, 1).numpy()),
        C=C, block_t=tc, tc_eff=tc, n_valid=T, uniform_rows=flags,
        finals_only=False)
    assert _max_abs(post, _global(jpost, T)) <= TOL_POST
    assert _max_abs(fin, np.swapaxes(np.asarray(jfin), 0, 1)) <= TOL_POST
    np.testing.assert_allclose(norm.numpy(), _global(np.asarray(jnorm)[
        :, :, None], T)[:, 0], rtol=1e-5)

    sm, r, bfin = ps.psmooth_pass(post, tlat, tlat.transpose(1, 2)
                                  .contiguous(), tdyn, fin, tc, flags, "full")
    jsm, jr, jbfin = jps._psmooth_pass_ref(
        jnp.asarray(_chunk_major(post, C, tc)), jnp.asarray(tlat.numpy()),
        jnp.asarray(tlat.transpose(1, 2).numpy()), jnp.asarray(tdyn.numpy()),
        jnp.asarray(fin.transpose(0, 1).numpy()), C=C, block_t=tc,
        tc_eff=tc, n_valid=T, uniform_rows=flags, marginal=False,
        finals_only=False)
    assert _max_abs(sm, _global(jsm, T)) <= TOL_POST
    assert _max_abs(bfin, np.swapaxes(np.asarray(jbfin), 0, 1)) <= TOL_POST
    jr = _global(jr, T)
    where = np.abs(jr) > 1e-30
    np.testing.assert_allclose(r.numpy()[where], jr[where], rtol=1e-4)
    assert (r.numpy()[~where] == 0).all()
    # finals-only mode: the same carries, no emitted rows
    assert ps.pfilter_pass(w, tlat, tdyn, ins, tc, flags, False)[0] is None


SMOOTH_CASES = {
    # name: (T, L, n_dyn, masked bins, transition kwargs, ll spread)
    "joint_ragged": (1999, 20, 2, (), {}, 3.0),
    "latent_only": (1501, 16, 1, (), {"mv": 1.1}, 3.0),
    "masked_bins": (1203, 18, 2, (0, 7, 8), {}, 3.0),
    # a near-reducible chain seen through weak observations: the boundary
    # carries need extra fixed-point passes
    "slow_mixing": (2400, 12, 2, (), {"mv": 0.3, "pmj": 0.0005,
                                      "pjm": 0.0005}, 0.05),
}


@pytest.mark.parametrize("name", sorted(SMOOTH_CASES))
def test_smooth_parallel_matches_jax(name):
    T, L, n_dyn, masked, tkw, spread = SMOOTH_CASES[name]
    tlat, tdyn = _trans_mats(L, n_dyn, **tkw)
    flags = sk._detect_uniform_rows(tlat)
    ll = _ll(11, T, L, masked, spread)
    p_init = torch.full((n_dyn, L), 1.0 / (n_dyn * L))
    cfg = ps.choose_parallel_config(T, L, n_dyn)
    got = ps.smooth_parallel(torch.as_tensor(ll), tlat, tdyn, p_init, 1.0,
                             uniform_rows=flags, config=cfg, want_post=True)
    want = jps.smooth_parallel(
        jnp.asarray(ll), jnp.asarray(tlat.numpy()), jnp.asarray(tdyn.numpy()),
        jnp.asarray(p_init.numpy()), 1.0, uniform_rows=flags, config=cfg,
        want_post=True)
    smooth, lml, post, ratios, acc, diag, carries = got
    assert carries is None
    assert _rel(lml, want[1]) <= TOL_LML
    assert _max_abs(smooth, want[0]) <= TOL_POST
    assert _max_abs(post, want[2]) <= TOL_POST
    np.testing.assert_allclose(ratios.numpy(), np.asarray(want[3]),
                               rtol=1e-5)
    acc_err = _max_abs(acc, want[4]) / float(np.abs(want[4]).max())
    assert acc_err <= TOL_POST
    assert diag[:2] == (int(want[6][0]), int(want[6][1]))
    if masked:
        assert (smooth[..., list(masked)] == 0).all()
    if name == "slow_mixing":
        assert max(diag[:2]) > 2  # the multi-pass path ran


def _jtrans(L):
    lat, log_lat, dyn, log_dyn = jgpk.create_transition_prob_1d(
        jnp.arange(L), jnp.arange(2), movement_variance=1.3,
        p_move_to_jump=0.05, p_jump_to_move=0.08)
    return jhmm.JointTransition(dyn, lat, log_dyn, log_lat)


def _port_trans(jt):
    t = {k: torch.tensor(np.asarray(getattr(jt, k)))
         for k in ("Tdyn", "Tlat", "logTdyn", "logTlat")}
    return hmm.JointTransition(**t)


@pytest.mark.parametrize("T", [40, 1523])
def test_cuda_parallel_engine_matches_jax_pallas_parallel(T):
    """smooth_combined_chunked: 'cuda_parallel' vs 'pallas_parallel' with
    masked latent bins and a 2-D neuron mask; at T=40 both fall back to
    their sequential engines."""
    L = 9
    rng = np.random.default_rng(T)
    y = rng.poisson(1.5, size=(T, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, size=(L, N)).astype(np.float32)
    ma_l = np.ones(L, np.float32)
    ma_l[[1, 4]] = 0.0
    ma_n = (rng.random((T, N)) > 0.2).astype(np.float32)
    jt = _jtrans(L)
    want = jhmm.smooth_combined_chunked(
        y, tuning, {}, jt, ma_n, ma_l, engine="pallas_parallel")
    got = hmm.smooth_combined_chunked(
        y, torch.as_tensor(tuning), {}, _port_trans(jt), ma_n, ma_l,
        engine="cuda_parallel")
    assert _rel(got[1], want[1]) <= TOL_LML
    for i in (0, 2):  # acausal and causal log posteriors, as probabilities
        assert _max_abs(torch.exp(got[i]), np.exp(np.asarray(want[i]))) \
            <= TOL_POST
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-5)
    pj, pj_ref = torch.exp(got[4]).numpy(), np.exp(np.asarray(want[4]))
    assert _max_abs(pj, pj_ref) / pj_ref.max() <= TOL_POST
    np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]),
                               rtol=1e-5)
    assert (torch.exp(got[0])[:, :, [1, 4]] == 0).all()


def _spy_joint_acc(monkeypatch):
    """Record every ``ps.joint_acc`` call's (post, r) and pass it on."""
    calls, real = [], ps.joint_acc

    def spy(post, r):
        calls.append((post, r))
        return real(post, r)

    monkeypatch.setattr(ps, "joint_acc", spy)
    return calls


def test_want_acc_false_skips_joint_only(monkeypatch):
    L, T = 9, 1100
    rng = np.random.default_rng(2)
    y = rng.poisson(1.5, size=(T, N)).astype(np.float32)
    tuning = torch.as_tensor(rng.gamma(2.0, 1.0, size=(L, N))
                             .astype(np.float32))
    trans = _port_trans(_jtrans(L))
    ones_n, ones_l = torch.ones(N), torch.ones(L)
    diag = []
    calls = _spy_joint_acc(monkeypatch)
    full = hmm.smooth_combined_chunked(y, tuning, {}, trans, ones_n, ones_l,
                                       engine="cuda_parallel")
    assert len(calls) == 1
    lean = hmm.smooth_combined_chunked(y, tuning, {}, trans, ones_n, ones_l,
                                       engine="cuda_parallel",
                                       want_acc=False, diag_out=diag)
    assert len(calls) == 1  # no joint formed without want_acc
    assert lean[4] is None and full[4] is not None
    assert torch.equal(lean[0], full[0]) and float(lean[1]) == float(full[1])
    assert len(diag) == 1 and min(diag[0][:2]) >= 1
    # the sequential engines ignore the hint, as in the JAX package
    seq = hmm.smooth_combined_chunked(y, tuning, {}, trans, ones_n, ones_l,
                                      engine="cuda", want_acc=False)
    assert seq[4] is not None


@pytest.mark.parametrize("path", ["smooth_parallel", "joint_outer_acc",
                                  "latent_outer_acc"])
def test_pairwise_joint_on_cpu_is_the_plain_product(path, monkeypatch):
    """On CPU tensors the full mode's pairwise joint is the plain product
    bit for bit: the einsum, through ``ps.joint_acc`` (the hand-written
    kernel on a card), and P.T @ R with one channel.  ``smooth_parallel``
    calls ``joint_acc`` once, on its filter posteriors and K4's ratios;
    row T - 1 is no step (r = 0), so the card's T - 1 rows and the CPU's
    T sum the same pairs."""
    rng = np.random.default_rng(11)
    L, T = 9, 301
    trans = _port_trans(_jtrans(L))
    calls = _spy_joint_acc(monkeypatch)
    if path == "smooth_parallel":
        ll = torch.as_tensor(_ll(3, T, L))
        p_init = torch.full((2, L), 1.0 / (2 * L))
        out = ps.smooth_parallel(ll, trans.Tlat, trans.Tdyn, p_init, 1.0,
                                 uniform_rows=trans.uniform_rows,
                                 want_post=True)
        assert len(calls) == 1
        post, r = calls[0]
        assert torch.equal(post, out[2]) and r.shape == post.shape
        assert not r[T - 1].any() and r[T - 2].any()
        raw, got = torch.einsum("tdi,tej->deij", post, r), out[4]
        assert torch.equal(got, raw * trans.Tdyn[:, :, None, None]
                           * trans.Tlat[None])
        return
    P = torch.as_tensor(rng.dirichlet(np.ones(2 * L), T).reshape(T, 2, L)
                        .astype(np.float32))
    R = torch.as_tensor(rng.gamma(2.0, 0.5, (T, 2, L)).astype(np.float32))
    if path == "joint_outer_acc":
        want = torch.einsum("tdi,tej->deij", P, R) \
            * trans.Tdyn[:, :, None, None] * trans.Tlat[None]
        assert torch.equal(trans.outer_acc(P, R), want)
        assert len(calls) == 1
    else:
        lat = hmm.LatentTransition(trans.Tlat[0], trans.logTlat[0])
        P, R = P[:, 0].contiguous(), R[:, 0].contiguous()
        assert torch.equal(lat.outer_acc(P, R), (P.T @ R) * lat.T)
        assert not calls


def test_engine_resolution_and_cpu_wrappers():
    trans = _port_trans(_jtrans(9))
    big = hmm._PARALLEL_UPGRADE_MIN_T
    assert hmm.engine_resolves_parallel(10, trans, "cuda_parallel", "cpu")
    # the upgrade applies on a CUDA device only; 'prob' is never upgraded
    assert not hmm.engine_resolves_parallel(big, trans, "cuda", "cpu")
    assert not hmm.engine_resolves_parallel(big, trans, "prob", "cpu")
    # CPU tensors take the plain versions: no launch is counted
    f0, s0 = ps.pfilter_pass.launches, ps.psmooth_pass.launches
    w = torch.rand(50, 9)
    ins = torch.full((4, 2, 9), 1 / 18)
    post, _, _ = ps.pfilter_pass(w, trans.Tlat, trans.Tdyn, ins, 13,
                                 trans.uniform_rows, True)
    ps.psmooth_pass(post, trans.Tlat, trans.Tlat.transpose(1, 2)
                    .contiguous(), trans.Tdyn, ins, 13, trans.uniform_rows,
                    "finals")
    assert (ps.pfilter_pass.launches, ps.psmooth_pass.launches) == (f0, s0)
    with pytest.raises(ValueError):  # 4 chunks of 12 rows miss row 49
        ps.pfilter_pass(w, trans.Tlat, trans.Tdyn, ins, 12,
                        trans.uniform_rows, False)
    with pytest.raises(ValueError):
        ps.smooth_parallel(torch.zeros(20, 9), trans.Tlat, trans.Tdyn,
                           ins[0], 1.0, uniform_rows=trans.uniform_rows)


def test_subnormal_prior_in_the_smoothers_matches_jax():
    """A subnormal prior under a carry of normal size: the smoother steps
    of K2, K4 (plain versions) and the 'prob' engine give r = 0 there
    (``scan_kernels.PRIOR_FLOOR``), as the JAX package does (XLA flushes
    subnormals), where a plain division gives r = inf and a NaN row."""
    outs, (filt, prior, carry, tlat) = subnormal_prior_smoothers("cpu")
    tl = jnp.asarray(tlat.numpy())
    sm_j, r_j = jhmm._backward_scan_prob_ratios(
        jnp.asarray(filt.numpy())[None], jnp.asarray(prior.numpy())[None],
        jhmm.LatentTransition(tl, jnp.log(tl)), jnp.asarray(carry.numpy()))
    for name, (sm, r) in outs.items():
        assert bool(torch.isfinite(sm).all() and torch.isfinite(r).all()), name
        assert float(r[5]) == 0.0, name
        np.testing.assert_allclose(sm.numpy(), np.asarray(sm_j[0]), atol=1e-6)
        np.testing.assert_allclose(r.numpy(), np.asarray(r_j[0]), rtol=1e-6)
