"""K4's band of nonzeros (``ops/parallel_scan.py::transition_band``)
against the JAX package's transition matrices.

The movement channel of ``poor_man_gplvm_tpu.ops.kernels.
create_transition_prob_1d`` is an RBF of integer positions, exactly 0 in
f32 far from the diagonal, so K4 reads each column through a window of W
rows.  These tests hold the band on the CPU: the band rebuilds the
dense matrix exactly, the window heights are the RBF's, the windows stay
inside the matrix, degenerate and dense channels give W = L, the bf16
split of the band is the banded split of the dense matrix, and
``smooth_parallel`` on the CPU (which takes the plain versions) neither
depends on the band nor moves from the JAX package.  The card tests hold
K4 on the band against K4 forced dense, bit for bit
(``tests/test_torch_cuda_kernels.py::test_k4_band_equals_dense``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from poor_man_gplvm_tpu.ops import kernels as jkernels  # noqa: E402
from poor_man_gplvm_tpu.ops.pallas import parallel_scan as jps  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import kernels  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk  # noqa: E402
from poor_man_gplvm_tpu_torch.testing import (  # noqa: E402
    band_vs_dense,
    scan_case,
)

torch.set_num_threads(1)

MOVEMENT_VARIANCES = (0.5, 1, 2, 4)
#: window height of the RBF channel (movement_variance used as the
#: lengthscale) as the port builds it: entries are exactly 0 in f32 from
#: |i - j| >= 5.5 ls.  The JAX package's matrices on the CPU are narrower
#: (XLA flushes the subnormal entries to zero; ROADMAP section 3).
RBF_WIDTH = {0.5: 11, 1: 21, 2: 41, 4: 81}
RBF_WIDTH_JAX_CPU = {0.5: 9, 1: 19, 2: 37, 4: 74}


def _jax_transitions(L, mv, custom_kernel=None):
    lat, _, dyn, _ = jkernels.create_transition_prob_1d(
        jnp.arange(L), jnp.arange(2), mv, custom_kernel=custom_kernel)
    return (torch.as_tensor(np.array(lat, dtype=np.float32)),
            torch.as_tensor(np.array(dyn, dtype=np.float32)))


def _band(tlat, scan_prec="highest"):
    flags = sk._detect_uniform_rows(tlat)
    return flags, ps.transition_band(
        tlat, tlat.transpose(-1, -2).contiguous(), flags, scan_prec)


def _unband(band, L):
    """The dense (2, n_mat, L, L) matrices the band stands for."""
    two, n_mat, W, _ = band.mats.shape
    dense = torch.zeros((two * n_mat, L, L), dtype=band.mats.dtype)
    rows = band.start.reshape(-1, 1, L).long() + torch.arange(W)[None, :,
                                                                  None]
    dense.scatter_(1, rows, band.mats.reshape(-1, W, L))
    return dense.view(two, n_mat, L, L)


def _dense_width(mat):
    """The largest span of nonzero rows over the columns of ``mat``."""
    nz = mat.numpy() != 0
    first = nz.argmax(axis=0)
    last = mat.shape[0] - 1 - nz[::-1].argmax(axis=0)
    return int((last - first + 1).max())


@pytest.mark.parametrize("L", [100, 500])
@pytest.mark.parametrize("mv", MOVEMENT_VARIANCES)
def test_band_rebuilds_the_jax_transitions(L, mv):
    tlat, _ = _jax_transitions(L, mv)
    flags, band = _band(tlat)
    assert flags == (False, True)  # the jump channel takes the row sum
    assert band.mats.shape == (2, 1, band.W, L)
    assert band.W == RBF_WIDTH_JAX_CPU[mv] == _dense_width(tlat[0])
    # the windows stay inside [0, L)
    assert int(band.start.min()) >= 0
    assert int(band.start.max()) + band.W <= L
    dense = _unband(band, L)
    assert torch.equal(dense[0, 0], tlat[0])
    assert torch.equal(dense[1, 0], tlat[0].T)


@pytest.mark.parametrize("mv", MOVEMENT_VARIANCES)
def test_band_of_the_port_transitions(mv):
    L = 500
    tlat = kernels.create_transition_prob_1d(torch.arange(L), torch.arange(2),
                                             mv)[0]
    _, band = _band(tlat)
    assert band.W == RBF_WIDTH[mv] == _dense_width(tlat[0])
    assert int(band.start.max()) + band.W <= L
    assert torch.equal(_unband(band, L)[0, 0], tlat[0])


def test_zero_column_and_dense_kernel_give_full_width():
    L = 60
    tlat, _ = _jax_transitions(L, 1)
    with_zero = tlat.clone()
    with_zero[0, :, 17] = 0.0
    _, band = _band(with_zero)
    assert band.W == L and int(band.start.abs().max()) == 0
    assert torch.equal(_unband(band, L)[0, 0], with_zero[0])
    custom = np.random.default_rng(3).uniform(0.1, 1.0, (L, L))
    dense, _ = _jax_transitions(L, 1, custom_kernel=custom.astype(np.float32))
    _, band = _band(dense)
    assert band.W == L and int(band.start.abs().max()) == 0
    assert torch.equal(band.mats[0, 0], dense[0])
    assert torch.equal(band.mats[1, 0], dense[0].T)


def test_band_override_forces_dense():
    tlat, _ = _jax_transitions(100, 1)
    ps.set_band_override(True)
    try:
        _, band = _band(tlat)
    finally:
        ps.set_band_override(False)
    assert band.W == 100 and int(band.start.abs().max()) == 0
    assert torch.equal(band.mats[0, 0], tlat[0])
    assert _band(tlat)[1].W == RBF_WIDTH_JAX_CPU[1]


def test_constant_channel_has_no_band():
    flags, band = _band(_jax_transitions(40, 1)[0][1:])
    assert flags == (True,)
    assert band.W == 0 and band.mats.shape == (2, 0, 0, 40)


@pytest.mark.parametrize("scan_prec", ["bf16x3", "bf16"])
@pytest.mark.parametrize("mv", [1, 4])
def test_band_splits_equal_the_banded_split(mv, scan_prec):
    L = 100
    tlat, _ = _jax_transitions(L, mv)
    _, band = _band(tlat, scan_prec)
    hi, lo = ps.split_bf16(torch.stack([tlat[:1], tlat[:1].transpose(1, 2)]))
    rows = band.start.long()[..., None, :] + torch.arange(band.W)[:, None]
    assert torch.equal(band.hi, hi.gather(2, rows))
    assert torch.equal(band.lo, lo.gather(2, rows))
    # the window's extra entries are exact zeros in every part
    assert torch.equal(_unband(band._replace(mats=band.hi.float()), L)[0, 0],
                       hi[0, 0].float())


def test_band_vs_dense_helper_on_the_cpu():
    eq = band_vs_dense(scan_case(5, 401, 40, 2, "masked"),
                       torch.device("cpu"), "bf16x3")
    assert eq["band_equal_dense"] and eq["finite"] and eq["masked_exact_zero"]
    assert (eq["W"], eq["W_dense"]) == (21, 40)


def test_smooth_parallel_on_cpu_is_unchanged_by_the_band():
    T, L = 1999, 24
    tlat, tdyn = _jax_transitions(L, 1)
    flags = sk._detect_uniform_rows(tlat)
    ll = (np.random.default_rng(11).normal(size=(T, L)) * 3.0
          - 20.0).astype(np.float32)
    p_init = torch.full((2, L), 1.0 / (2 * L))
    cfg = ps.choose_parallel_config(T, L, 2)

    def run():
        return ps.smooth_parallel(torch.as_tensor(ll), tlat, tdyn, p_init,
                                  1.0, uniform_rows=flags, config=cfg,
                                  want_post=True)

    got = run()
    ps.set_band_override(True)
    try:
        dense = run()
    finally:
        ps.set_band_override(False)
    for a, b in zip(got[:5], dense[:5]):
        assert torch.equal(a, b)
    want = jps.smooth_parallel(
        jnp.asarray(ll), jnp.asarray(tlat.numpy()), jnp.asarray(tdyn.numpy()),
        jnp.asarray(p_init.numpy()), 1.0, uniform_rows=flags, config=cfg,
        want_post=True)
    lml = float(got[1])
    assert abs(lml - float(want[1])) <= 1e-5 * abs(float(want[1]))
    assert float((got[0] - torch.as_tensor(np.asarray(want[0]))).abs().max()) \
        <= 1e-4


@pytest.mark.parametrize("T, M, S", [(100_000, 1000, 2), (100_000, 200, 33),
                                     (20_001, 80, 132), (301, 80, 10),
                                     (1_000_000, 1000, 8)])
def test_joint_acc_slices_cover_time(T, M, S):
    got_S, rows = ps._acc_slices(T, M)
    assert got_S == S
    assert got_S * rows >= T and (got_S - 1) * rows < T
    assert rows <= ps._ACC_MAX_ROWS
