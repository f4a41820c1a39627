"""The batched Adam runner's fused trip on the card (``csrc/adam_poisson.cu``:
kernel A, the objective, its gradient and Adam in one pass over each run's
tile; kernel B, the runs' sums and the trip's state) against its plain
version ``mstep.poisson_value_and_grad_batch_plain``, and the runner that
takes it.

No JAX here (these tests run on the card's machine, which has none; the
plain version is held to the JAX objective in ``test_torch_ops.py``).
Every test needs a CUDA card and skips without one.  Run them with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_adam_fused.py``.

Tolerances, kernel against the plain version, both float32 (the products
sum over L and n_basis in other orders; the largest gap seen on the card
in brackets): losses and errors 2e-6 relative [1.2e-7]; after one trip
from a warm state the weights 1e-5 absolute, a thousandth of Adam's step
[3.7e-7 here, 1.9e-6 at the sweep's shape with unit weights: an update
divides a gradient by its own running scale, so a small one's sums in
another order move it most], the moments 1e-5 of their largest [1.5e-7];
against the plain version in float64, losses 2e-6 and errors 1e-5
relative.
"""

import pytest

torch = pytest.importorskip("torch")

from poor_man_gplvm_tpu_torch.ops import mstep  # noqa: E402
from poor_man_gplvm_tpu_torch.utils import profiling  # noqa: E402

STEP = 0.01
#: (B, L, n_basis, N, a basis per run): the sweep's widths (L and N past
#: the tiles of 64), a small rank, a rank above one group of 128 rows
CASES = [(5, 500, 77, 500, False), (5, 130, 77, 70, True),
         (3, 97, 5, 33, False), (3, 300, 200, 130, True)]
IDS = ["sweep_widths", "per_run_basis", "small_rank", "rank_200"]
LOSS_RTOL, PARAMS_ATOL, MOMENT_TOL, ERROR_RTOL_F64 = 2e-6, 1e-5, 1e-5, 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused trip's kernels run only "
                    "there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, L, K, N, per_run, seed=5):
    """(params, args) on the card: grouped statistics as a T = 2,000
    recording gives them, a basis of unit columns' scale."""
    dev = _card()
    g = torch.Generator().manual_seed(seed)
    shape = (B, L, K) if per_run else (L, K)
    basis = torch.randn(shape, generator=g) / K**0.5
    post = torch.rand((B, 2000, L), generator=g) ** 4
    post = post / post.sum(dim=2, keepdim=True)
    y = torch.poisson(torch.rand((2000, N), generator=g) * 1.5, generator=g)
    yw, tw = post.transpose(1, 2) @ y, post.sum(dim=1)
    prior = torch.linspace(0.5, 2.0, B)
    params = torch.randn((B, K, N), generator=g) * 0.5
    args = ({"param_prior_std": prior.to(dev)}, basis.to(dev), yw.to(dev),
            tw.to(dev))
    return params.to(dev), args


def _warm(params, args, trips=3):
    """The plain version's state after ``trips`` trips from Adam's start."""
    state = mstep.adam_init_batch(params)
    active = torch.ones(params.shape[0], dtype=torch.bool,
                        device=params.device)
    for _ in range(trips):
        r = mstep.poisson_value_and_grad_batch_plain(
            params, *args, opt_state=state, active=active, step_size=STEP)
        params, state = r["params"], r["opt_state"]
    return params, state


def _state(params, state, active, maxiter=8):
    B = params.shape[0]
    dev = params.device
    s = {"params": params.clone(), "count": state.count.clone(),
         "mu": state.mu.clone(), "nu": state.nu.clone(),
         "loss": torch.full((B,), 7.0, device=dev),
         "loss_prev": torch.full((B,), 9.0, device=dev),
         "error": torch.full((B,), 3.0, device=dev),
         "n_iter": torch.full((B,), 4, dtype=torch.int64, device=dev),
         "active": active.clone()}
    hist = (torch.zeros((B, maxiter), device=dev),
            torch.zeros((B, maxiter), device=dev))
    return s, hist


def _rel(a, b):
    return float(((a.double() - b.double()).abs() / b.double().abs()).max())


@pytest.mark.cuda
@pytest.mark.parametrize("B, L, K, N, per_run", CASES, ids=IDS)
def test_fused_evaluation_against_plain(B, L, K, N, per_run):
    """Kernel A in evaluation mode and kernel B: the losses and errors of
    the plain version in float32 and in float64."""
    params, args = _inputs(B, L, K, N, per_run)
    loss, error = mstep._fused_poisson_trip(params, args, STEP, None)[0](
        params)
    want = mstep.poisson_value_and_grad_batch_plain(params, *args)
    hyper, basis, yw, tw = args
    f64 = mstep.poisson_value_and_grad_batch_plain(
        params.double(), {"param_prior_std": hyper["param_prior_std"]
                          .double()}, basis.double(), yw.double(),
        tw.double())
    gaps = (_rel(loss, want["loss"]), _rel(error, want["error"]),
            _rel(loss, f64["loss"]), _rel(error, f64["error"]))
    assert gaps[0] <= LOSS_RTOL and gaps[1] <= LOSS_RTOL, gaps
    assert gaps[2] <= LOSS_RTOL and gaps[3] <= ERROR_RTOL_F64, gaps


@pytest.mark.cuda
@pytest.mark.parametrize("B, L, K, N, per_run", CASES, ids=IDS)
def test_fused_trip_against_plain(B, L, K, N, per_run):
    """One trip from a warm state with run 1 stopped: the live runs'
    weights, moments, losses and errors as the plain version's, the state's
    count, loss_prev, n_iter and history column; the stopped run's every
    entry bit for bit as it was, its history column 0."""
    params, args = _inputs(B, L, K, N, per_run)
    params, state = _warm(params, args)
    active = torch.ones(B, dtype=torch.bool, device=params.device)
    active[1] = False
    s, hist = _state(params, state, active)
    before = {k: v.clone() for k, v in s.items()}
    mstep._fused_poisson_trip(params, args, STEP, hist)[1](s, 5)
    want = mstep.poisson_value_and_grad_batch_plain(
        params, *args, opt_state=state, active=active, step_size=STEP)
    live = active
    assert float((s["params"] - want["params"])[live].abs().max()) \
        <= PARAMS_ATOL
    for k, w in zip(("mu", "nu"), want["opt_state"][1:]):
        gap = float((s[k] - w)[live].abs().max())
        assert gap <= MOMENT_TOL * float(w[live].abs().max()), (k, gap)
    assert _rel(s["loss"][live], want["loss"][live]) <= LOSS_RTOL
    assert _rel(s["error"][live], want["error"][live]) <= LOSS_RTOL
    assert torch.equal(s["count"], want["opt_state"].count)
    assert torch.equal(s["loss_prev"][live], before["loss"][live])
    assert (s["n_iter"][live] == 6).all()
    assert torch.equal(hist[0][:, 5], torch.where(active, s["loss"], 0.0))
    assert torch.equal(hist[1][:, 5], torch.where(active, s["error"], 0.0))
    for k, v in before.items():
        assert torch.equal(s[k][1], v[1]), k
    assert hist[0][:, [4, 6]].abs().sum() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B, L, K, N, per_run", CASES[::3], ids=IDS[::3])
def test_fused_trip_is_deterministic(B, L, K, N, per_run):
    """Two trips from the same state give the same bits (no atomics; the
    partial sums in a fixed order), with the step read from the card."""
    params, args = _inputs(B, L, K, N, per_run)
    params, state = _warm(params, args)
    active = torch.ones(B, dtype=torch.bool, device=params.device)
    outs = []
    for _ in range(2):
        s, hist = _state(params, state, active)
        step = torch.full((1,), 2, dtype=torch.int64, device=params.device)
        mstep._fused_poisson_trip(params, args, STEP, hist)[1](s, step)
        outs.append((s, hist))
    (a, ha), (b, hb) = outs
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert all(torch.equal(x, y) for x, y in zip(ha, hb))
    assert (a["n_iter"] == 3).all() and (ha[0][:, 2] == a["loss"]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tol, maxiter", [(-1.0, 40), (3e-3, 100)])
def test_fused_runner_counts_its_trips(tol, maxiter):
    """``make_adam_runner_batch`` on ``poisson_m_step_objective_batch`` on
    the card takes the fused trip on every trip (``adam_fused_trips`` =
    ``adam_steps``), gives the same bits twice, and stays with the autograd
    runner on the CPU: the same trips, weights within 2e-5 after up to 99
    trips."""
    params, args = _inputs(6, 40, 9, 20, False)
    fun = mstep.poisson_m_step_objective_batch
    outs = []
    for _ in range(2):
        before = profiling.counters()
        res = mstep.make_adam_runner_batch(fun, STEP, maxiter=maxiter,
                                           tol=tol)(
            params, mstep.adam_init_batch(params), *args)
        after = profiling.counters()

        def delta(k):
            return after.get(k, 0) - before.get(k, 0)

        assert delta("adam_fused_trips") == delta("adam_steps") > 0
        outs.append(res)
    for k in ("params", "n_iter", "final_loss", "final_error",
              "loss_history", "error_history"):
        assert torch.equal(outs[0][k], outs[1][k]), k
    cpu = [a.cpu() if torch.is_tensor(a) else
           {k: v.cpu() for k, v in a.items()} for a in args]
    before = profiling.counters()
    want = mstep.make_adam_runner_batch(fun, STEP, maxiter=maxiter, tol=tol)(
        params.cpu(), mstep.adam_init_batch(params.cpu()), *cpu)
    assert profiling.counters().get("adam_fused_trips", 0) == before.get(
        "adam_fused_trips", 0)
    assert torch.equal(outs[0]["n_iter"].cpu(), want["n_iter"])
    gap = float((outs[0]["params"].cpu() - want["params"]).abs().max())
    assert gap <= 2e-5, gap


@pytest.mark.parametrize("what", ["latent_above_max", "rank_above_latent",
                                  "basis_of_other_rank", "statistics_shape",
                                  "float64_params"])
def test_shapes_the_kernels_do_not_take_raise(what):
    """The fused trip's wrapper raises ``ValueError`` before any launch on
    shapes and types its kernels do not take (no fallback); on the CPU, as
    the checks are the host's."""
    B, L, K, N = 2, 12, 4, 7
    if what == "latent_above_max":
        L = 1025
    if what == "rank_above_latent":
        K = L + 1
    params = torch.zeros((B, K, N), dtype=torch.float64
                         if what == "float64_params" else torch.float32)
    basis = torch.zeros((L, K + (what == "basis_of_other_rank")))
    yw = torch.zeros((B, L + (what == "statistics_shape"), N))
    args = ({"param_prior_std": 1.0}, basis, yw, torch.zeros((B, L)))
    with pytest.raises(ValueError):
        mstep._fused_poisson_trip(params, args, STEP, None)
