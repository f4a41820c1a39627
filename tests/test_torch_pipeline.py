"""The session pipeline end to end, the port against the JAX package: the
steps of ``scripts/pipeline_session.py`` and the burst and baseline
workflows of ``examples/03`` and ``examples/10``, on one seeded Kilosort
session (``testing.kilosort_session``: 2 probes x 12 units, 60 s at
10 ms, n_latent_bin = 21) written to disk and read back by each package.

- Counts, unit filters (total spikes, mean rate, presence ratio; the
  thresholds of the pipeline, the spike count scaled to the 60 s session)
  and the correlation sort: equal.
- The fit: 3 EM iterations from the JAX model's initial weights and its
  drawn initial posterior (the port's draw replaced, as in
  ``test_torch_sweep.py``), Adam capped at 20 iterations; log marginals
  within 1e-5 relative (PARITY.json), posteriors within 1e-2 (fit
  posteriors).  The port runs 'cuda_parallel', whose kernel wrappers run
  their plain versions on CPU tensors; JAX runs 'prob'.
- The decode with the JAX fit carried across (``convert.load_jax_state``):
  posteriors within 1e-4, log marginal within 1e-5 relative.
- The bursts of the z-scored MUA: equal; their epoch decode within 1e-4.
- The naive-Bayes baselines over 5 folds of ``cv_split``: predictions
  equal.
- The posterior-weighted position and the post-fit neuron sort.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.random as jr  # noqa: E402

import poor_man_gplvm_tpu as jpmg  # noqa: E402
from poor_man_gplvm_tpu import analysis as janalysis  # noqa: E402
from poor_man_gplvm_tpu import data as jdata  # noqa: E402
from poor_man_gplvm_tpu.utils import sorting as jsorting  # noqa: E402
from poor_man_gplvm_tpu.utils import timeseries as jts  # noqa: E402
import poor_man_gplvm_tpu_torch as pmt  # noqa: E402
from poor_man_gplvm_tpu_torch import analysis as panalysis  # noqa: E402
from poor_man_gplvm_tpu_torch import convert  # noqa: E402
from poor_man_gplvm_tpu_torch import data as pdata  # noqa: E402
from poor_man_gplvm_tpu_torch import testing  # noqa: E402
from poor_man_gplvm_tpu_torch.utils.compat import to_numpy  # noqa: E402
from poor_man_gplvm_tpu_torch.utils import timeseries as pts  # noqa: E402

torch.set_num_threads(1)

L = 21
DT = 0.01
FILTERS = dict(min_total_spikes=25, min_mean_rate=0.01,
               min_presence_ratio=0.5, n_coarse_bins=100)
MODEL_KW = dict(n_latent_bin=L, movement_variance=1.0,
                tuning_lengthscale=1.0)
FIT_KW = dict(n_iter=3, m_step_maxiter=20, verboase=False, fused=False)
TOL_LML, TOL_DECODE_POST, TOL_FIT_POST = 1e-5, 1e-4, 1e-2


def load_session_counts(data_mod, dirs):
    """``scripts/pipeline_session.py::load_session_counts`` through
    ``data_mod``: per-probe counts, the unit filters, the correlation
    sort.  Returns (sorted counts, time bins, per-probe keep masks)."""
    mats, keeps, times_ref = [], [], None
    for d in dirs:
        counts, time_bins, units = data_mod.compute_spike_counts_old(
            d, window_size=DT, step_size=DT, use_units="good", sigma=0,
            zscore=False, adj="")
        total = counts.sum(axis=1)
        mean_rate = total / (len(time_bins) * DT)
        presence = data_mod.get_presence_ratio(counts, time_bins,
                                               FILTERS["n_coarse_bins"])
        keep = ((total >= FILTERS["min_total_spikes"])
                & (mean_rate >= FILTERS["min_mean_rate"])
                & (presence >= FILTERS["min_presence_ratio"]))
        mats.append(counts[keep])
        keeps.append((units, keep))
        times_ref = time_bins
    counts = data_mod.sort_units(np.vstack(mats), mode="corr")
    return counts, times_ref, keeps


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    root = tmp_path_factory.mktemp("session")
    info = testing.kilosort_session(str(root), n_units=12, duration_s=60.0,
                                    n_latent_bin=L, seed=1)
    got = load_session_counts(pdata, info["dirs"])
    want = load_session_counts(jdata, info["dirs"])
    return info, got, want


def test_counts_filters_and_sort_equal(session):
    info, got, want = session
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    for (u_p, k_p), (u_j, k_j) in zip(got[2], want[2]):
        assert np.array_equal(u_p, u_j) and np.array_equal(k_p, k_j)
        # units 0 (presence 0.2) and 1 (1 % of the rate) fail; 2-4 are
        # not labelled good
        assert list(u_p[~k_p]) == [0, 1] and not set(u_p) & {2, 3, 4}
    assert got[0].shape == (14, info["T"] - 1)


@pytest.fixture(scope="module")
def fits(session):
    _, (counts, _, _), _ = session
    y = counts.T.astype(np.float32)
    N, T = counts.shape
    jm = jpmg.PoissonGPLVMJump1D(N, inference_engine="prob", **MODEL_KW)
    lpi, _ = jm.init_latent_posterior(T, jr.PRNGKey(3))
    lpi = np.asarray(lpi)
    state = convert.state_from_model(jm)
    want = jm.fit_em(y, log_posterior_init=lpi, **FIT_KW)
    pm = pmt.PoissonGPLVMJump1D(N, inference_engine="cuda_parallel",
                                device="cpu", **MODEL_KW)
    convert.load_jax_state(pm, state["params"], state["tuning_basis"])
    got = pm.fit_em(y, log_posterior_init=lpi, **FIT_KW)
    # the JAX fit carried across, for the decodes
    carried = pmt.PoissonGPLVMJump1D(N, inference_engine="cuda_parallel",
                                     device="cpu", **MODEL_KW)
    fitted = convert.state_from_model(jm)
    convert.load_jax_state(carried, fitted["params"], fitted["tuning_basis"])
    return y, jm, pm, carried, got, want


def _lml(res):
    return np.array([float(v) for v in res["log_marginal_l"]])


def test_fit_and_decode_match_jax(fits):
    y, jm, pm, carried, got, want = fits
    np.testing.assert_allclose(_lml(got), _lml(want), rtol=TOL_LML)
    assert np.all(np.diff(_lml(got)) >= -TOL_LML * abs(_lml(got)[0]))
    err = np.abs(got["posterior"].numpy() - np.asarray(want["posterior"]))
    assert err.max() <= TOL_FIT_POST
    dec_j = jm.decode_latent(y)
    dec_p = carried.decode_latent(y)
    for key in ("posterior_latent_marg", "posterior_dynamics_marg"):
        assert np.abs(dec_p[key].numpy()
                      - np.asarray(dec_j[key])).max() <= TOL_DECODE_POST
    np.testing.assert_allclose(float(dec_p["log_marginal_final"]),
                               float(dec_j["log_marginal_final"]),
                               rtol=TOL_LML)
    # the port's own fit decodes within the fit tolerance of the JAX one
    own = pm.decode_latent(y)["posterior_latent_marg"].numpy()
    assert np.abs(own - np.asarray(dec_j["posterior_latent_marg"])).max() \
        <= TOL_FIT_POST


def test_bursts_and_their_epoch_decode_match_jax(session, fits):
    _, (counts, _, _), _ = session
    y, jm, _, carried, _, _ = fits
    mua = counts.sum(axis=0)
    z_p = pdata.smooth_and_zscore(mua[None], sigma=1.0, zscore=True)[0]
    z_j = jdata.smooth_and_zscore(mua[None], sigma=1.0, zscore=True)[0]
    assert np.array_equal(z_p, z_j)
    b_p = pdata.detect_population_bursts(z_p, STEP_SIZE=DT)
    b_j = jdata.detect_population_bursts(z_j, STEP_SIZE=DT)
    assert b_p == b_j and len(b_p) >= 10
    intervals = np.array([[s, e + 1] for s, e in b_p])
    ep_p = carried.decode_latent_epochs(y, intervals)
    ep_j = jm.decode_latent_epochs(y, intervals)
    a = to_numpy(ep_p["posterior_latent_marg"])
    b = np.asarray(ep_j["posterior_latent_marg"])
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.nanmax(np.abs(a - b)) <= TOL_DECODE_POST
    np.testing.assert_allclose(to_numpy(ep_p["log_marginal_per_epoch"]),
                               np.asarray(ep_j["log_marginal_per_epoch"]),
                               rtol=TOL_LML)


def test_baseline_decoders_over_cv_folds_match_jax(session):
    info, (counts, _, _), _ = session
    T = counts.shape[1]
    Y = info["latent"][:T, 1]
    for kind in ("Poisson", "Gaussian"):
        for k in range(5):
            (xtr, ytr), (xte, _), _, _ = pdata.DecoderDataset(
                counts, Y).split(k, k_CV=5)
            (jxtr, jytr), (jxte, _), _, _ = jdata.DecoderDataset(
                counts, Y).split(k, k_CV=5)
            assert np.array_equal(xtr, jxtr) and np.array_equal(ytr, jytr)
            got = getattr(pdata, f"{kind}BayesDecoder")(
                L, device="cpu").fit(xtr, ytr).predict(xte)
            want = getattr(jdata, f"{kind}BayesDecoder")(L).fit(
                jxtr, jytr).predict(jxte)
            assert np.array_equal(got.numpy(), want)


def test_posterior_average_and_neuron_sort_match_jax(session, fits):
    info, (counts, time_bins, _), _ = session
    y, jm, _, carried, _, _ = fits
    T = counts.shape[1]
    pos = info["position"][:T]
    dec_p = carried.decode_latent(y, t_l=time_bins)
    dec_j = jm.decode_latent(y, t_l=time_bins)
    got = panalysis.get_posterior_weighted_average(
        pts.Tsd(d=pos, t=time_bins), dec_p["posterior_latent_marg"])
    want = janalysis.get_posterior_weighted_average(
        jts.Tsd(d=pos, t=time_bins), dec_j["posterior_latent_marg"])
    np.testing.assert_allclose(got[None], want.to_numpy(), atol=1e-2,
                               equal_nan=True)
    s_p = pmt.utils.post_fit_sort_neuron({"tuning": carried.tuning}, y,
                                         t_l=time_bins)
    s_j = jsorting.post_fit_sort_neuron({"tuning": jm.tuning}, y,
                                        t_l=time_bins)
    assert np.array_equal(s_p["argsort"], s_j["argsort"])
    assert np.array_equal(s_p["spk_to_plot"].d, s_j["spk_to_plot"].d)


def test_readme_ingestion_quickstart_runs_on_the_cpu():
    import pathlib
    import re

    text = (pathlib.Path(__file__).resolve().parents[1]
            / "README.md").read_text()
    blocks = re.findall(r"```python\n(.*?)```", text, flags=re.S)
    block = [b for b in blocks if "# ingestion quickstart" in b]
    assert len(block) == 1 and 'device = "cuda"' in block[0]
    scope = {}
    exec(compile(block[0].replace('device = "cuda"', 'device = "cpu"'),
                 "README.md", "exec"), scope)
    T = scope["counts"].shape[1]
    assert scope["dec"]["posterior_latent_marg"].d.shape == (T, L)
    assert np.isfinite(float(scope["em"]["log_marginal_l"][-1]))
    assert len(scope["bursts"]) > 0
