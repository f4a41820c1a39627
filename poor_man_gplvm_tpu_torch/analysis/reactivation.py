"""Reactivation analyses: pre/post epoch decoding with shuffle nulls.

Counterpart of ``poor_man_gplvm_tpu/analysis/reactivation.py`` (reference
poor_man_gplvm/reactivation_analysis.py).  Two shuffle types: circular
spike shuffles within an epoch (correlation structure against single-
neuron activation) and pre/post label permutations (whether the boundary
matters at all).

Where the JAX module returns a pandas DataFrame the port returns a
``utils.table.ResultTable`` (the card's machine has no pandas), whose
``to_dataframe()`` gives the JAX frame, index included.  The shuffles are
drawn on the host from ``np.random.default_rng(rng)`` in the JAX
module's order, so an ``rng`` seed gives both packages the same
shuffles.  The batched null decodes ``shuffle_batch_size`` shuffles at a
time: the dynamics decoder on the card as one launch of K1 and one of K2
per batch (``hmm.smooth_batch_latent_mean``), each shuffle's emissions
formed on its own; only the (shuffles, L) time means of the latent
marginals come back to the host.  ``verbose`` prints one line per batch
(or per shuffle of the serial loop); there is no progress bar.
"""

from __future__ import annotations

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.ops import emissions, hmm
from poor_man_gplvm_tpu_torch.utils import compat
from poor_man_gplvm_tpu_torch.utils.table import ResultTable, concat_tables

__all__ = [
    "decode_pre_post",
    "circular_shuffle_spikes_within_epoch_and_decode",
    "circular_shuffle_column_independently",
    "random_reassign_prepost_latent_difference",
    "generate_homogeneous_poisson_surrogate_data",
    "decode_ripple_epochs",
    "aggregate_within_ripple_per_epoch",
]


def _to_host(x):
    """``x`` as numpy.  The bytes of a tensor copied from a device other
    than the CPU are added to ``_to_host.bytes`` (what the nulls move to
    the host)."""
    if torch.is_tensor(x) and x.device.type != "cpu":
        _to_host.bytes += x.numel() * x.element_size()
    return compat.to_numpy(x)


_to_host.bytes = 0


def _log(verbose, msg):
    if verbose:
        print(msg, flush=True)


def _check_decoder(decoder_type):
    if decoder_type not in ("naive_bayes", "dynamics"):
        raise ValueError(f"decoder_type {decoder_type} not supported")


def _decode_marginal(model, arr, decoder_type):
    """The (T, L) latent marginal of one decode of ``arr``, on the model's
    device: naive Bayes' ``posterior_latent``, or the smoother's
    ``posterior_latent_marg`` (a latent-only model's ``posterior_all``)."""
    _check_decoder(decoder_type)
    if decoder_type == "naive_bayes":
        return model.decode_latent_naive_bayes(arr)["posterior_latent"]
    res = model.decode_latent(arr)
    return res["posterior_latent_marg"] if "posterior_latent_marg" in res \
        else res["posterior_all"]


def _mean_table(means):
    """The (L,) means of 'pre' and 'post' and their difference as the
    three-column table of one decode (the JAX module's DataFrame)."""
    means = {k: means[k] for k in ("pre", "post")}
    means["diff"] = means["post"] - means["pre"]
    return ResultTable(means)


def decode_pre_post(model, spk_mat_d, pre_post_epoch_d=None,
                    decoder_type="naive_bayes", common_ep=None):
    """Decode latents per pre/post epoch; mean posterior per epoch + diff
    (reference reactivation_analysis.py:21-55).  ``spk_mat_d``: a dict
    with 'pre' and 'post' spike matrices, or a TsdFrame cut by
    ``pre_post_epoch_d`` (then by ``common_ep``).  The time means are taken
    on the model's device.  Returns ``{"post_latent_d": {key: (T, L)
    numpy}, "post_latent_mean_d": ResultTable (pre, post, diff)}``."""
    if pre_post_epoch_d is not None and compat.is_tsdframe(spk_mat_d):
        if "pre" not in pre_post_epoch_d or "post" not in pre_post_epoch_d:
            raise ValueError("pre_post_epoch_d needs 'pre' and 'post'")
        spk_mat_d = {
            k: spk_mat_d.restrict(ep) for k, ep in pre_post_epoch_d.items()
        }
        if common_ep is not None:
            spk_mat_d = {k: v.restrict(common_ep)
                         for k, v in spk_mat_d.items()}
    elif "pre" not in spk_mat_d or "post" not in spk_mat_d:
        raise ValueError("spk_mat_d needs 'pre' and 'post'")

    post_latent_d, means = {}, {}
    for pre_post, spk_sub in spk_mat_d.items():
        arr = spk_sub.d if compat.is_tsdframe(spk_sub) else spk_sub
        marg = _decode_marginal(model, arr, decoder_type)
        post_latent_d[pre_post] = _to_host(marg)
        means[pre_post] = _to_host(marg.mean(dim=0))
    return {"post_latent_d": post_latent_d,
            "post_latent_mean_d": _mean_table(means)}


def circular_shuffle_column_independently(spk_mat, min_shift=5, rng=None):
    """Circularly shift each column independently
    (reference reactivation_analysis.py:84-92)."""
    rng = np.random.default_rng(rng)
    spk_mat = np.asarray(spk_mat)
    n_time, n_neuron = spk_mat.shape
    shuffled = spk_mat.copy()
    for j in range(n_neuron):
        shuffled[:, j] = np.roll(
            spk_mat[:, j], rng.integers(min_shift, n_time - min_shift)
        )
    return shuffled


def _batch_means(model, y_b, decoder_type):
    """(E, L) time means of the latent marginals of a batch of shuffles
    y_b (E, T, N), on the model's device.  Naive Bayes: each shuffle's
    emissions as ``decode_latent_naive_bayes`` forms them; the dynamics
    decoder: ``hmm.smooth_batch_latent_mean`` on the model's engine."""
    y_b = torch.as_tensor(y_b, dtype=torch.float32, device=model.device)
    hyper = model._emission_hyper({})
    if decoder_type == "naive_bayes":
        means = torch.empty((y_b.shape[0], model.n_latent_bin),
                            dtype=torch.float32, device=model.device)
        for e in range(y_b.shape[0]):
            log_post = emissions.get_naive_bayes_ma_chunk(
                y_b[e], model.tuning, hyper, model.ma_neuron_default,
                model.ma_latent_default,
                observation_model=model.observation_model)[0]
            means[e] = torch.exp(log_post).mean(dim=0)
        return means
    trans, _ = model._make_transition(hyper)
    return hmm.smooth_batch_latent_mean(
        y_b, model.tuning, hyper, trans, model.ma_neuron_default,
        model.ma_latent_default, observation_model=model.observation_model,
        engine=model.inference_engine)


def circular_shuffle_spikes_within_epoch_and_decode(
    model, spk_mat, pre_post_epoch_d, decoder_type="naive_bayes",
    common_ep=None, n_shuffle=100, verbose=True, rng=None, batched=True,
    shuffle_batch_size=32,
):
    """Circular within-epoch per-neuron shuffles -> decode -> stacked mean
    posteriors (reference reactivation_analysis.py:57-82).  Returns a
    ``ResultTable`` (pre, post, diff) indexed by (shuffle, latent bin), as
    ``pd.concat`` indexes the JAX module's frames.

    ``batched`` (default): the per-(shuffle, key) seeds are drawn in the
    JAX module's order, then each key's shuffles are built on the host
    ``shuffle_batch_size`` at a time and decoded as one batch
    (``_batch_means``): on the card one launch of K1 and one of K2 per
    batch for the dynamics decoder, each shuffle equal to the serial
    path's decode of it alone where that decode runs K1/K2 (below
    ``hmm._PARALLEL_UPGRADE_MIN_T`` bins).  ``batched=False``: the serial
    loop of ``decode_pre_post``'s decodes.  A batch that runs out of the
    card's memory raises ``MemoryError``."""
    _check_decoder(decoder_type)
    rng = np.random.default_rng(rng)
    spk_mat_d = {}
    for pre_post, ep in pre_post_epoch_d.items():
        sub = spk_mat.restrict(ep)
        if common_ep is not None:
            sub = sub.restrict(common_ep)
        spk_mat_d[pre_post] = np.asarray(sub.d)

    if not batched:
        out = {}
        for i in range(n_shuffle):
            shuffled_d = {
                k: circular_shuffle_column_independently(
                    v, min_shift=5, rng=rng.integers(2**31))
                for k, v in spk_mat_d.items()
            }
            out[i] = _mean_table({
                k: _to_host(_decode_marginal(model, v, decoder_type)
                            .mean(dim=0))
                for k, v in shuffled_d.items()})
            _log(verbose, f"reactivation null: shuffle {i + 1}/{n_shuffle}")
        return concat_tables(out)

    size = int(shuffle_batch_size)
    if size < 1:
        raise ValueError(
            f"shuffle_batch_size must be >= 1, got {shuffle_batch_size}")
    # the serial loop draws one seed per (shuffle, key) in this order; the
    # shuffles themselves are built a batch at a time, so host memory is
    # O(shuffle_batch_size * T * N)
    seeds_per_key = {k: [] for k in spk_mat_d}
    for _ in range(n_shuffle):
        for k in spk_mat_d:
            seeds_per_key[k].append(int(rng.integers(2**31)))

    mean_per_key = {}
    n_batch = -(-n_shuffle // size)
    for k, seeds in seeds_per_key.items():
        v = spk_mat_d[k]
        parts = []
        for b in range(n_batch):
            y_b = np.stack([
                circular_shuffle_column_independently(v, min_shift=5, rng=s)
                for s in seeds[b * size:(b + 1) * size]])
            try:
                parts.append(_to_host(_batch_means(model, y_b,
                                                   decoder_type)))
            except torch.cuda.OutOfMemoryError as exc:
                raise MemoryError(
                    f"a batch of {len(y_b)} shuffles of {y_b.shape[1:]} "
                    "does not fit the card; pass a smaller "
                    "shuffle_batch_size") from exc
            _log(verbose, f"reactivation null [{k}]: batch {b + 1}/{n_batch}")
        mean_per_key[k] = np.concatenate(parts, axis=0)  # (S, L)

    return concat_tables({
        i: _mean_table({k: mean_per_key[k][i] for k in mean_per_key})
        for i in range(n_shuffle)})


def random_reassign_prepost_latent_difference(posterior_latent_d,
                                              n_shuffle=100, verbose=True,
                                              rng=None):
    """Permute pre/post labels over timepoints; recompute epoch means + diff
    (reference reactivation_analysis.py:94-117).  Numpy; returns a
    ``ResultTable`` indexed by (shuffle, latent bin)."""
    rng = np.random.default_rng(rng)
    posts = {k: _to_host(v) for k, v in posterior_latent_d.items()}
    post_concat = np.concatenate(list(posts.values()), axis=0)
    label_l = np.concatenate([np.array([k] * len(v))
                              for k, v in posts.items()])
    out = {}
    for i in range(n_shuffle):
        label_sh = rng.permutation(label_l)
        out[i] = _mean_table({k: post_concat[label_sh == k].mean(axis=0)
                              for k in posts})
        _log(verbose, f"pre/post label shuffle {i + 1}/{n_shuffle}")
    return concat_tables(out)


def generate_homogeneous_poisson_surrogate_data(
    spk_times, intv_per_ep, count_bin=0.02, n_repeat=50, verbose=True, rng=None,
):
    """Per-epoch homogeneous-Poisson surrogates matching each unit's epoch
    firing rate (reference reactivation_analysis.py:120-151).

    spk_times: TsGroup (pynapple's or ``utils.timeseries``').  Returns
    (surrogate count matrices list, rate_per_ep, nbins_per_ep,
    concatenated bin timestamps)."""
    rng = np.random.default_rng(rng)
    nbins_per_ep, rate_per_ep, t_l = {}, {}, []
    for k, intv in intv_per_ep.items():
        restricted = spk_times.restrict(intv)
        counted = restricted.count(count_bin)
        nbins_per_ep[k] = counted.shape[0]
        t_l.append(counted.t)
        rate_per_ep[k] = np.asarray(restricted.rate)
    t_l = np.concatenate(t_l)

    surrogates = []
    for i in range(n_repeat):
        parts = [
            rng.poisson(
                rate_per_ep[k] * count_bin,
                size=(nbins_per_ep[k], rate_per_ep[k].shape[0]),
            )
            for k in rate_per_ep
        ]
        surrogates.append(np.concatenate(parts, axis=0))
        _log(verbose, f"surrogate {i + 1}/{n_repeat}")
    return surrogates, rate_per_ep, nbins_per_ep, t_l


def decode_ripple_epochs(model, spk_mat, ripple_intv, t_l=None,
                         hyperparam=None, batch_size=None):
    """Smoother-decode every ripple/burst epoch as one batch:
    ``model.decode_latent_epochs`` (on the card one launch of K1 and one
    of K2 per batch, one thread block per epoch), reshaped for the
    reactivation workflow.

    ``spk_mat`` may be a TsdFrame (then ``ripple_intv`` may be a
    time-valued IntervalSet) or a plain (T, N) array with ``ripple_intv``
    as (E, 2) bin-index pairs.

    Returns ``{"epoch_res": <decode_latent_epochs dict>,
    "posterior_mean_df": ResultTable of the (E, L) mean latent posteriors,
    one column per latent bin, rows indexed by 'epoch',
    "log_marginal_per_epoch": (E,)}``."""
    if compat.is_tsdframe(spk_mat):
        t_l = spk_mat.t if t_l is None else t_l
    res = model.decode_latent_epochs(
        spk_mat, ripple_intv, hyperparam=hyperparam, t_l=t_l,
        batch_size=batch_size,
    )
    mean = res["posterior_mean"]
    return {
        "epoch_res": res,
        "posterior_mean_df": ResultTable(
            {j: mean[:, j] for j in range(mean.shape[1])},
            index_names=("epoch",)),
        "log_marginal_per_epoch": res["log_marginal_per_epoch"],
    }


def aggregate_within_ripple_per_epoch(posterior_latent, ripple_intv_per_ep):
    """Max within each ripple, mean across ripples, per epoch
    (reference reactivation_analysis.py:153-176), in numpy: the per-ripple
    max skips NaN (as a pandas groupby max does), samples outside every
    ripple are dropped, and the mean over ripples skips NaN."""
    out = {}
    for ep, intv in ripple_intv_per_ep.items():
        if len(intv) == 0:
            continue
        post_ep = posterior_latent.restrict(intv)
        rip_label = np.asarray(intv.in_interval(post_ep), dtype=np.float64)
        d = np.asarray(post_ep.d)
        flat = d.reshape(d.shape[0], -1)
        keep = ~np.isnan(rip_label)
        _, ripple = np.unique(rip_label[keep], return_inverse=True)
        dtype = flat.dtype if np.issubdtype(flat.dtype, np.floating) \
            else np.float64
        per_ripple_max = np.full((ripple.max(initial=-1) + 1, flat.shape[1]),
                                 np.nan, dtype=dtype)
        np.fmax.at(per_ripple_max, ripple, flat[keep])
        with np.errstate(invalid="ignore"):
            count = np.sum(~np.isnan(per_ripple_max), axis=0)
            agg = np.nansum(per_ripple_max, axis=0) / count
        out[ep] = agg.astype(dtype).reshape(d.shape[1:])
    return out
