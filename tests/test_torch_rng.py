"""The CPU generator's MT19937 stream drawn on the card (``ops/rng.py``,
``csrc/mt19937.cu``) and the models' route to it.

On the CPU: the wrapper's reading and writing of a generator's state
record; a numpy model of kernel A's three-phase twist, thread by thread as
the kernel runs it, against ``torch.rand`` bit for bit, in the values and
in the state it leaves; kernel B's row sums (f64, rounded once) and
posterior against PyTorch's CPU sum and the host recipe, within a few ulps;
the route (``init_draw.*`` counters).  On the card
(``cuda`` tests): the kernels against ``torch.rand`` and the host recipe,
and a fit started on each path.

No JAX here, so that the file also runs on the card's machine:

    python -m pytest --noconftest tests/test_torch_rng.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from poor_man_gplvm_tpu_torch import (  # noqa: E402
    GaussianGPLVM1D,
    GaussianGPLVMJump1D,
    PoissonGPLVMJump1D,
)
from poor_man_gplvm_tpu_torch.models.base import (  # noqa: E402
    _draws_on_card,
    _log_posterior_init,
)
from poor_man_gplvm_tpu_torch.ops import rng  # noqa: E402
from poor_man_gplvm_tpu_torch.utils import profiling  # noqa: E402

SEED = 2_718_281_901
MOVES = [0, 5, 623, 624, 625]
# (13, 97) = 2 * 624 + 13 draws: it ends inside a twist
SHAPES = [(1, 1), (3, 7), (1000, 500), (13, 97)]
SCALE = 0.1
# the normalised posterior's gap to the host recipe, in ulps: the host's
# f32 row sum is up to 3 ulps from the f64 one (5 ulps in the quotient, at
# most, in 4e8 entries drawn at L = 9 to 1,024)
POST_ULPS = 8


def _moved(k):
    """A generator of ``SEED`` that has drawn ``k`` floats."""
    g = torch.Generator().manual_seed(SEED)
    if k:
        torch.rand(k, generator=g)
    return g


# ---------------------------------------------------------------------------
# a numpy model of kernel A
# ---------------------------------------------------------------------------


def _twist(u, v):
    y = (u & np.uint32(0x80000000)) | (v & np.uint32(0x7FFFFFFF))
    return (y >> np.uint32(1)) ^ np.where(v & np.uint32(1),
                                          np.uint32(0x9908B0DF),
                                          np.uint32(0))


def _uniform(y):
    y = y ^ (y >> np.uint32(11))
    y = y ^ ((y << np.uint32(7)) & np.uint32(0x9D2C5680))
    y = y ^ ((y << np.uint32(15)) & np.uint32(0xEFC60000))
    y = y ^ (y >> np.uint32(18))
    return (y & np.uint32(0xFFFFFF)).astype(np.float32) * np.float32(2**-24)


def _model_draw(words, left, n, scale):
    """(floats, final words, position): kernel A's schedule in numpy.
    Thread t < 227 renews words t, t + 227 and t + 454 (t < 170) of a
    twist in three phases, each phase from old words and the thread's own
    new word 227 below; word 623 reads the new word 0, computed again from
    old words.  The old words of each twist are stored in stream order
    from the start position."""
    pos = 625 - left
    twists = 0 if n == 0 else (pos + n - 1) // 624
    buf = np.asarray(words, np.uint32).copy()
    out = np.empty(n, np.float32)
    t = np.arange(227)
    t3 = t[:170]

    def emit(base):
        idx = np.arange(624) + base
        keep = (idx >= 0) & (idx < n)
        out[idx[keep]] = _uniform(buf)[keep] * np.float32(scale)

    for k in range(1, twists + 1):
        o = buf
        emit((k - 1) * 624 - pos)
        new0 = o[397] ^ _twist(o[0:1], o[1:2])[0]
        c = np.append(o[455:624], new0)  # word 623 wraps to the new word 0
        buf = np.empty(624, np.uint32)
        buf[t] = o[t + 397] ^ _twist(o[t], o[t + 1])
        buf[t + 227] = buf[t] ^ _twist(o[t + 227], o[t + 228])
        buf[t3 + 454] = buf[t3 + 227] ^ _twist(o[t3 + 454], c)
    emit(twists * 624 - pos)
    return out, buf, pos + n - 624 * twists


def _model_normalise(u, offset):
    """Kernel B in numpy: ``offset + u`` in f32, each row's sum in f64
    rounded once to f32, the f32 quotients; returns (sums, posterior)."""
    v = (np.float32(offset) + u).astype(np.float32)
    sums = v.astype(np.float64).sum(axis=1, keepdims=True).astype(np.float32)
    return sums[:, 0], v / sums


def _ulps(a, b):
    """The largest gap in ulps between two arrays of non-negative f32."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - np.asarray(b, np.float32).view(np.int32)).max())


# ---------------------------------------------------------------------------
# CPU tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", MOVES)
def test_state_record_round_trips(k):
    """Reading a generator's record and writing it into another generator
    of the same seed, moved elsewhere, gives the first one's record and
    its next draws."""
    g = _moved(k)
    words, left, nxt = rng.read_state(g)
    assert words.dtype == np.uint32 and words.shape == (624,)
    assert left == (625 - k % 624 if k % 624 else 1)
    other = _moved(1000 + k)
    rng.write_state(other, words, left, nxt)
    assert torch.equal(other.get_state(), g.get_state())
    assert torch.equal(torch.rand(700, generator=other),
                       torch.rand(700, generator=g))
    # the seed and the normal sampler's fields are kept
    h = torch.Generator().manual_seed(7)
    torch.randn(1, generator=h)  # leaves a cached normal behind
    before = h.get_state().numpy().copy()
    rng.write_state(h, words, left, nxt)
    after = h.get_state().numpy()
    assert np.array_equal(after[:8], before[:8])
    assert np.array_equal(after[24 + 8 * 624:], before[24 + 8 * 624:])


def test_state_record_rejects_a_position_the_generator_never_writes():
    g = _moved(5)
    words, left, nxt = rng.read_state(g)
    rng.write_state(g, words, left, nxt + 1)
    with pytest.raises(ValueError, match="position"):
        rng.read_state(g)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", MOVES)
def test_three_phase_twist_matches_torch_rand(k, shape):
    g = _moved(k)
    words, left, _ = rng.read_state(g)
    n = int(np.prod(shape))
    vals, final, end = _model_draw(words, left, n, SCALE)
    want = torch.rand(shape, generator=g) * SCALE
    assert np.array_equal(vals, want.numpy().ravel())
    assert rng.end_position(625 - left, n)[1] == end
    model = _moved(0)
    rng.write_state(model, final, 625 - end, end)
    assert torch.equal(model.get_state(), g.get_state())


@pytest.mark.parametrize("latent_only", [False, True])
@pytest.mark.parametrize("L", [1, 3, 7, 8, 9, 97, 500, 1024])
def test_row_sum_order_matches_torch_sum(L, latent_only):
    """Kernel B's row sums (f64, rounded once) are within 3 ulps of
    PyTorch's CPU row sums, and its posterior within ``POST_ULPS`` of the
    host recipe's."""
    u = torch.rand((64, L), generator=_moved(L)) * SCALE
    offset = float(torch.ones(()) / L) if latent_only else 0.0
    host = torch.ones((64, L)) / L + u if latent_only else u
    sums, post = _model_normalise(u.numpy(), offset)
    assert _ulps(sums, host.sum(dim=1).numpy()) <= 3
    assert _ulps(post, (host / host.sum(dim=1, keepdim=True)).numpy()) \
        <= POST_ULPS


def test_cpu_stream_posterior_takes_a_cpu_generator_to_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA device"):
        rng.cpu_stream_posterior(3, 7, _moved(5), "cpu", SCALE)
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        rng.cpu_stream_posterior(3, 7, None, "cuda", SCALE)


def test_route_by_device_and_generator():
    n = 12
    before = profiling.counters()
    assert _draws_on_card(torch.device("cuda"), _moved(0), n)
    assert _draws_on_card("cuda:0", _moved(0), n)
    assert not _draws_on_card(torch.device("cpu"), _moved(0), n)
    assert not _draws_on_card(torch.device("cuda"), None, n)
    after = profiling.counters()
    assert after["init_draw.card"] - before.get("init_draw.card", 0) == 2 * n
    assert after["init_draw.host"] - before.get("init_draw.host", 0) == 2 * n


@pytest.mark.parametrize("cls", [PoissonGPLVMJump1D, GaussianGPLVM1D])
def test_a_fit_on_the_cpu_draws_on_the_host(cls):
    """A fit on the CPU takes the host recipe: its span counts T * L in
    ``init_draw.host`` and nothing in ``init_draw.card``, and its initial
    posterior is the recipe's."""
    T, L = 50, 7
    m = cls(4, n_latent_bin=L, movement_variance=1.0,
            tuning_lengthscale=3.0, device="cpu")
    _, y = m.sample(T, generator=torch.Generator().manual_seed(1))
    profiling.reset()
    with profiling.recording():
        res = m.fit_em(y, n_iter=1, verboase=False,
                       generator=torch.Generator().manual_seed(3))
    (fit,) = [s for s in profiling.spans() if s.name == "fit_em"]
    counts = fit.attrs["counters"]
    assert counts["init_draw.host"] == T * L
    assert "init_draw.card" not in counts
    log_post, _ = m.init_latent_posterior(
        T, torch.Generator().manual_seed(3))
    assert torch.equal(torch.as_tensor(res["log_posterior_init"]), log_post)
    profiling.reset()


# ---------------------------------------------------------------------------
# card tests
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mt19937 kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _clone(g):
    h = torch.Generator()
    h.set_state(g.get_state())
    return h


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(100_000, 500)])
@pytest.mark.parametrize("k", MOVES)
def test_card_draw_is_torch_rand_bit_for_bit(cuda, k, shape):
    g = _moved(k)
    host = _clone(g)
    got = rng._draw(shape, g, cuda, SCALE)
    want = torch.rand(shape, generator=host) * SCALE
    assert got.device.type == "cuda" and got.shape == want.shape
    assert torch.equal(got.cpu(), want)
    assert torch.equal(g.get_state(), host.get_state())
    # the generator draws on as if the host had drawn
    assert torch.equal(torch.rand(999, generator=g),
                       torch.rand(999, generator=host))


def _host_recipe(T, L, g, latent_only=False, device="cpu"):
    """The models' host recipe: drawn and normalised on the host, copied,
    its log taken on ``device``."""
    u = torch.rand((T, L), generator=g) * SCALE
    if latent_only:
        u = torch.ones((T, L)) / L + u
    return _log_posterior_init(u / u.sum(dim=1, keepdim=True), device)


def _rel(a, b):
    return float(((a.cpu().double() - b.double()).abs()
                  / b.double().abs().clamp_min(1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [GaussianGPLVMJump1D, GaussianGPLVM1D])
@pytest.mark.parametrize("T,L", [(100_000, 500), (13, 97)])
def test_card_posterior_matches_the_host_recipe(cuda, cls, T, L):
    m = cls(5, n_latent_bin=L, movement_variance=1.0,
            tuning_lengthscale=3.0, device=cuda)
    g, host = _moved(5), _moved(5)
    before = profiling.counters()
    launches = rng._launch_draw.launches, rng._launch_normalise.launches
    log_post, post = m.init_latent_posterior(T, g, random_scale=SCALE)
    after = profiling.counters()
    assert (rng._launch_draw.launches - launches[0],
            rng._launch_normalise.launches - launches[1]) == (1, 1)
    assert after["init_draw.card"] - before.get("init_draw.card", 0) == T * L
    assert after.get("init_draw.host", 0) == before.get("init_draw.host", 0)
    assert after["host_syncs.mt_state"] - before.get(
        "host_syncs.mt_state", 0) == 1
    want_log, want = _host_recipe(T, L, host, cls is GaussianGPLVM1D, cuda)
    assert torch.equal(g.get_state(), host.get_state())
    assert post.device.type == "cuda" and log_post.device.type == "cuda"
    assert _ulps(post.cpu().numpy(), want.cpu().numpy()) <= POST_ULPS
    assert _rel(log_post, want_log.cpu()) <= 3e-7


@pytest.mark.cuda
def test_card_normalise_floors_zeros(cuda):
    """A zero uniform (p = 2**-24 a draw) gets the host recipe's floor."""
    post = torch.rand((4, 9), device=cuda)
    post[1, 3] = 0.0
    log_post = rng._launch_normalise(post, 0.0)
    torch.cuda.synchronize()
    assert float(post[1, 3]) == 0.0
    assert float(log_post[1, 3]) == np.float32(rng.JOINT_ACC_INIT)
    assert torch.isfinite(log_post).all()


@pytest.mark.cuda
def test_card_route_skips_a_cuda_generator(cuda):
    assert not _draws_on_card(cuda, torch.Generator(device=cuda), 1)
    assert _draws_on_card(cuda, torch.Generator(), 1)


@pytest.mark.cuda
def test_card_fit_from_each_path_agrees(cuda):
    """A fit started from the card draw and one started from the host
    recipe's posterior (the same uniforms) give the same log-marginals."""
    T, L = 2_000, 50
    m = GaussianGPLVMJump1D(20, n_latent_bin=L, movement_variance=1.0,
                            tuning_lengthscale=5.0, noise_std=1.0,
                            device=cuda)
    _, y = m.sample(T, generator=torch.Generator().manual_seed(2))
    kw = dict(n_iter=5, output_mode="lean", verboase=False)
    card = GaussianGPLVMJump1D(20, n_latent_bin=L, movement_variance=1.0,
                               tuning_lengthscale=5.0, noise_std=1.0,
                               device=cuda).fit_em(
        y, generator=torch.Generator().manual_seed(9), **kw)
    log_init, _ = _host_recipe(T, L, torch.Generator().manual_seed(9))
    host = GaussianGPLVMJump1D(20, n_latent_bin=L, movement_variance=1.0,
                               tuning_lengthscale=5.0, noise_std=1.0,
                               device=cuda).fit_em(
        y, generator=torch.Generator().manual_seed(9),
        log_posterior_init=log_init, **kw)
    a = np.asarray([float(v) for v in card["log_marginal_l"]])
    b = np.asarray([float(v) for v in host["log_marginal_l"]])
    assert np.all(np.abs(a - b) <= 1e-6 * np.abs(b)), (a, b)
