"""``sweep_fit_poisson_jump`` on CPU tensors against the benchmark's plain
reference of a grid of fits (``benchmark/reference/sweep.py``: each run
alone, float64, from its own redrawn start under its own dense
transition), and the spans and counters of a traced sweep.

No JAX here.  The grid is 2 x 2 configurations x 2 chains at N = 20,
L = 40, T = 300, 3 EM iterations, Adam at the sweep's defaults
(``m_maxiter`` 100, ``m_tol`` 1e-6: at this size every M-step runs to the
cap, so the float32 program and the float64 reference take the same
number of Adam steps).  Tolerances, float32 against float64 (the largest
gap seen at this size in brackets): each iteration's log-marginal 1e-5
relative [1.3e-6], the final weights 5e-4 absolute [4.8e-5], the final
latent marginals 2e-4 absolute [3e-5], the last log-marginal against the
reference's E-step from the program's own final weights 1e-6 relative
[1.4e-7].  A run fitted under another configuration's transition is off
by 1e-3 or more in its log-marginals.
"""

import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import model as rm  # noqa: E402
from benchmark.reference import sweep as rs  # noqa: E402
from poor_man_gplvm_tpu_torch import PoissonGPLVMJump1D  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import mstep  # noqa: E402
from poor_man_gplvm_tpu_torch.parallel import sweep  # noqa: E402
from poor_man_gplvm_tpu_torch.utils import profiling  # noqa: E402

T, N, L = 300, 20, 40
LS = 10.0
RANGES = {"movement_variance": [0.5, 2.0], "p_move_to_jump": [0.01, 0.05]}
N_REPEAT, N_ITER, SEED = 2, 3, 7
B = 8
TOL_LML, TOL_PARAMS, TOL_MARG, TOL_FINAL = 1e-5, 5e-4, 2e-4, 1e-6
CFG = types.SimpleNamespace(n_latent=L, family="poisson", link="softplus",
                            noise_std=None)
CHILDREN = ("sweep.init", "sweep.statistics", "sweep.m_step",
            "sweep.emissions", "sweep.e_step")


@pytest.fixture(scope="module")
def y():
    model = PoissonGPLVMJump1D(N, n_latent_bin=L, tuning_lengthscale=LS,
                               device="cpu")
    return model.sample(T, generator=torch.Generator().manual_seed(1))[1]


def _sweep(y, **kw):
    return sweep.sweep_fit_poisson_jump(
        y, RANGES, n_repeat=N_REPEAT, n_iter=N_ITER, n_latent_bin=L,
        tuning_lengthscale=LS, generator=torch.Generator().manual_seed(SEED),
        device="cpu", **kw)


@pytest.fixture(scope="module")
def fits(y):
    """The program's sweep, and the reference's start of each run."""
    res = _sweep(y)
    hps = rs.grid_runs({**RANGES, "p_jump_to_move": [0.01],
                        "param_prior_std": [1.0]}, N_REPEAT)
    seeds = rs.run_seeds(SEED, B)
    basis = rm.tuning_basis(L, LS)
    starts = [rs.run_start(s, T, L, basis.shape[1], N, "cpu") for s in seeds]
    return res, hps, basis, starts


def _gaps(y, res, b, basis, hp, start):
    """(log-marginal, final weights, final marginal) gaps of the program's
    run b against the reference's fit of the same start under ``hp``."""
    ref = rs.fit_run(y, CFG, basis, hp, *start, N_ITER)
    lml = res["log_marginal_l"][b].double()
    return (max(abs(float(a) - r) / abs(r)
                for a, r in zip(lml, ref.log_marginal_l)),
            float((res["params"][b].double() - ref.params).abs().max()),
            float((res["log_posterior_latent"][b].exp().double()
                   - ref.last.latent_marg).abs().max()))


@pytest.mark.parametrize("b", range(B))
def test_each_run_matches_the_reference(y, fits, b):
    res, hps, basis, starts = fits
    lml, params, marg = _gaps(y, res, b, basis, hps[b], starts[b])
    assert lml <= TOL_LML and params <= TOL_PARAMS and marg <= TOL_MARG, \
        (lml, params, marg)
    final = rs.e_step(y, CFG, basis, hps[b], res["params"][b])
    got = float(res["log_marginal_l"][b, -1])
    assert abs(got - final.log_marginal) / abs(final.log_marginal) \
        <= TOL_FINAL


@pytest.mark.parametrize("b, other", [(0, 4), (3, 1), (6, 2)])
def test_a_swapped_transition_fails_the_tolerances(y, fits, b, other):
    """Run b held against the reference fitted under run ``other``'s
    configuration (another movement variance or jump probability)."""
    res, hps, basis, starts = fits
    assert hps[other] != hps[b]
    lml, params, marg = _gaps(y, res, b, basis, hps[other], starts[b])
    assert lml > 10 * TOL_LML, (lml, params, marg)


def _record_runner_trips(monkeypatch):
    """Each batched Adam run's ``n_iter``, M-step by M-step."""
    got = []
    orig = mstep.make_adam_runner_batch

    def make(*a, **k):
        run = orig(*a, **k)

        def recorded(*args):
            res = run(*args)
            got.append(res["n_iter"].tolist())
            return res

        return recorded

    monkeypatch.setattr(mstep, "make_adam_runner_batch", make)
    return got


def _stop_reads(trips, maxiter):
    """The runner's stop reads of an M-step of ``trips`` trips: one per
    trip from the sixth on, and one more where the test stopped the loop
    before ``maxiter - 1``."""
    return max(0, trips - 5 + (trips < maxiter - 1))


def test_traced_sweep_records_its_spans_and_adam_counters(y, monkeypatch):
    # a loose Adam tolerance, so that runs stop at their own trips
    trips = _record_runner_trips(monkeypatch)
    profiling.reset()
    with profiling.recording():
        _sweep(y, m_tol=1e-4)
    spans = profiling.spans()
    profiling.reset()
    tops = [s for s in spans if s.parent is None]
    assert [s.name for s in tops] == ["sweep"]
    top = tops[0]
    assert top.attrs["n_iter"] == N_ITER and top.attrs["n_runs"] == B
    kids = [s.name for s in spans if s.parent == top.id]
    assert sorted(set(kids)) == sorted(CHILDREN)
    assert kids.count("sweep.init") == 1
    assert all(kids.count(k) == N_ITER for k in CHILDREN[1:])
    assert len(spans) == 1 + len(kids)
    assert all(s.top == top.id and top.start_ns <= s.start_ns <= s.end_ns
               <= top.end_ns for s in spans)
    c = top.attrs["counters"]
    assert len(trips) == N_ITER
    assert c["adam_steps"] == sum(max(n) - 1 for n in trips)
    assert c["adam_run_steps"] == sum(k - 1 for n in trips for k in n)
    assert c["adam_run_steps"] < B * c["adam_steps"]  # runs stopped early
    assert c["host_syncs.adam_stop"] == sum(
        _stop_reads(max(n) - 1, 100) for n in trips)


def test_untraced_sweep_records_nothing_and_reads_as_before(y, monkeypatch):
    trips = _record_runner_trips(monkeypatch)
    profiling.reset()
    before = profiling.counters()
    _sweep(y, m_tol=1e-4)
    after = profiling.counters()
    assert profiling.spans() == []

    def delta(k):
        return after.get(k, 0) - before.get(k, 0)

    # one stop read a trip from the sixth on: the counters add none
    assert delta("host_syncs.adam_stop") == sum(
        _stop_reads(max(n) - 1, 100) for n in trips)
    assert delta("adam_steps") == sum(max(n) - 1 for n in trips)


def _runner_op_by_op(fun, step_size, maxiter, tol):
    """The batched Adam loop with every trip launched op by op (the loop
    that the card's graph replays), for the graph to be held to."""

    def value_and_grad(params, args):
        params = params.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = fun(params, *args)
            (grads,) = torch.autograd.grad(loss.sum(), params)
        return loss.detach(), grads

    def run(params, opt_state, *args):
        B = params.shape[0]
        dev = params.device
        bshape = (B,) + (1,) * (params.ndim - 1)
        loss, grads = value_and_grad(params, args)
        error = torch.sqrt(torch.sum(torch.square(grads), dim=(1, 2)))
        loss_history = torch.zeros((B, maxiter), device=dev)
        error_history = torch.zeros((B, maxiter), device=dev)
        loss_history[:, 0], error_history[:, 0] = loss, error
        n_iter = torch.ones((B,), dtype=torch.int64, device=dev)
        active = torch.ones((B,), dtype=torch.bool, device=dev)
        loss_prev = loss
        i = 0
        while i < maxiter - 1:
            if i >= 5:
                rel_change = (loss - loss_prev).abs() / torch.clamp(
                    loss.abs(), min=1e-8)
                active = active & (rel_change > tol)
                if not bool(active.any()):
                    break
            new_loss, grads = value_and_grad(params, args)
            updates, new_state = mstep.adam_update(grads, opt_state,
                                                   step_size)
            keep = active.reshape(bshape)
            params = torch.where(keep, params + updates, params)
            opt_state = mstep.AdamState(
                torch.where(active, new_state.count, opt_state.count),
                torch.where(keep, new_state.mu, opt_state.mu),
                torch.where(keep, new_state.nu, opt_state.nu))
            new_error = torch.sqrt(torch.sum(torch.square(grads),
                                             dim=(1, 2)))
            error = torch.where(active, new_error, error)
            loss_prev = torch.where(active, loss, loss_prev)
            loss = torch.where(active, new_loss, loss)
            i += 1
            n_iter = torch.where(active, i + 1, n_iter)
            loss_history[:, i] = torch.where(active, loss, 0.0)
            error_history[:, i] = torch.where(active, error, 0.0)
        return {"params": params, "opt_state": opt_state, "n_iter": n_iter,
                "final_loss": loss, "final_error": error,
                "loss_history": loss_history,
                "error_history": error_history}

    return run


def _graph_reads(trips, maxiter):
    """The card's reads of an M-step of ``trips`` trips: one in
    ``GRAPH_TRIPS_PER_READ`` replays from the sixth trip on, until a read
    finds that a replay moved no run, or the cap."""
    k, cap, i, reads = mstep.GRAPH_TRIPS_PER_READ, maxiter - 1, 5, 0
    while i < cap:
        i = min(i + k, cap)
        reads += 1
        if trips < i:
            break
    return reads


RUNNER_CASES = [(3e-3, 100, True), (1e-3, 100, None), (-1.0, 40, False),
                (1e-6, 7, None)]


def _runner_inputs(dev):
    g = torch.Generator().manual_seed(3)
    Bn, Lb, Kb, Nn = 6, 40, 9, 20
    args = ({"param_prior_std": torch.linspace(0.5, 2.0, Bn).to(dev)},
            (torch.randn(Lb, Kb, generator=g) * 0.3).to(dev),
            (torch.rand(Bn, Lb, Nn, generator=g) * 5).to(dev),
            (torch.rand(Bn, Lb, generator=g) * 10 + 1).to(dev))
    return torch.randn(Bn, Kb, Nn, generator=g).to(dev), args


@pytest.mark.parametrize("tol, maxiter, early", RUNNER_CASES)
def test_batched_adam_on_the_cpu_is_the_loop_op_by_op(tol, maxiter, early):
    """On the CPU the runner launches the autograd trip op by op: the same
    bits as the loop written out, and no fused trip counted."""
    p0, args = _runner_inputs(torch.device("cpu"))
    fun = mstep.poisson_m_step_objective_batch
    want = _runner_op_by_op(fun, 0.01, maxiter, tol)(
        p0, mstep.adam_init_batch(p0), *args)
    before = profiling.counters()
    got = mstep.make_adam_runner_batch(fun, 0.01, maxiter=maxiter, tol=tol)(
        p0, mstep.adam_init_batch(p0), *args)
    after = profiling.counters()
    for k in ("params", "n_iter", "final_loss", "final_error",
              "loss_history", "error_history"):
        assert torch.equal(got[k], want[k]), k
    for a, b in zip(got["opt_state"], want["opt_state"]):
        assert torch.equal(a, b)
    if early is not None:
        assert (max(want["n_iter"].tolist()) - 1 < maxiter - 1) == early
    assert after.get("adam_fused_trips", 0) == before.get(
        "adam_fused_trips", 0)
    assert after["adam_steps"] - before.get("adam_steps", 0) == max(
        want["n_iter"].tolist()) - 1


@pytest.mark.cuda
@pytest.mark.parametrize("tol, maxiter, early", RUNNER_CASES)
def test_batched_adam_graph_on_the_card_is_the_loop_op_by_op(tol, maxiter,
                                                             early):
    """On a card the runner replays a CUDA graph of its tested trips: the
    same bits as the loop launched op by op, with runs stopping at their
    own trips and every run stopped (the read that ends the loop after
    replays that moved no run), with every run to the cap, and with one
    replay; its counters as the CPU loop counts them, one read in
    ``GRAPH_TRIPS_PER_READ`` trips.  The objective is wrapped, so that the
    runner keeps the autograd trip (it fuses the trip of
    ``poisson_m_step_objective_batch`` itself; ``test_torch_adam_fused.py``
    holds that one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph path runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    p0, args = _runner_inputs(torch.device("cuda"))

    def fun(*a):
        return mstep.poisson_m_step_objective_batch(*a)

    want = _runner_op_by_op(fun, 0.01, maxiter, tol)(
        p0, mstep.adam_init_batch(p0), *args)
    before = profiling.counters()
    got = mstep.make_adam_runner_batch(fun, 0.01, maxiter=maxiter, tol=tol)(
        p0, mstep.adam_init_batch(p0), *args)
    after = profiling.counters()
    for k in ("params", "n_iter", "final_loss", "final_error",
              "loss_history", "error_history"):
        assert torch.equal(got[k], want[k]), k
    for a, b in zip(got["opt_state"], want["opt_state"]):
        assert torch.equal(a, b)
    n = want["n_iter"].tolist()
    trips = max(n) - 1
    if early is not None:  # every run stopped before the cap, or none
        assert (trips < maxiter - 1) == early

    def delta(k):
        return after.get(k, 0) - before.get(k, 0)

    assert delta("adam_steps") == trips
    assert delta("adam_run_steps") == sum(k - 1 for k in n)
    assert delta("host_syncs.adam_stop") == _graph_reads(trips, maxiter)
    assert delta("adam_fused_trips") == 0
