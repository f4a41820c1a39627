"""Statistical model validation: circular-shuffle nulls, decode-and-threshold
significance, posterior entropy, jump verification.

Counterpart of ``poor_man_gplvm_tpu/validation.py``.  The shuffles are
drawn on the host from ``np.random.default_rng(seed)`` in the JAX
package's order, so a seed gives both packages the same shuffles.  The
batched null decodes ``shuffle_batch_size`` shuffles at a time under the
model's one transition: on the card (``'cuda'`` and ``'cuda_parallel'``
alike) one launch of K1 and one of K2 per batch, one thread block per
shuffle (``ops/hmm.py::smooth_batch_full``); each batch's results are
copied to the host before the next batch starts.  ``verbose`` prints one
line per batch (no tqdm).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.ops import emissions, hmm
from poor_man_gplvm_tpu_torch.utils import compat

__all__ = [
    "circular_shuffle_data",
    "shuffle_and_decode",
    "test_one_model",
    "compute_entropy",
    "get_contrast_axis_and_proj",
    "segment_trial_by_jump",
]


def circular_shuffle_data(spk_tsdf, n_shuffle=100, ep=None, seed=None):
    """Generator of ``n_shuffle`` circularly shuffled copies (numpy): each
    neuron shifted on its own by ``rng.integers(0, T)``, ``rng =
    np.random.default_rng(seed)``.  ``ep``: restrict a TsdFrame to these
    intervals first."""
    rng = np.random.default_rng(seed)
    if ep is not None:
        if not compat.is_tsdframe(spk_tsdf):
            raise TypeError("input data must be a TsdFrame when ep is given")
        spk_tsdf = spk_tsdf.restrict(ep)
    arr = compat.to_numpy(spk_tsdf.d if compat.is_tsdframe(spk_tsdf)
                          else spk_tsdf)
    n_time, n_neuron = arr.shape
    for _ in range(n_shuffle):
        shuffled = arr.copy()
        for j in range(n_neuron):
            shuffled[:, j] = np.roll(arr[:, j], rng.integers(0, n_time))
        yield shuffled


class _HostStack:
    """The stacked (n_shuffle, ...) numpy result, filled batch by batch; a
    key whose value is None stays None.  A tensor is copied from the card
    straight into its row of the result: writing fresh host memory costs
    more than the copy itself (page faults), so no copy goes through an
    intermediate host array."""

    def __init__(self, n_shuffle):
        self.n_shuffle, self.out = n_shuffle, {}

    def put(self, s, res):
        """Copy shuffle ``s``'s result dict to the host."""
        for k, v in res.items():
            if v is None:
                self.out[k] = None
                continue
            if not torch.is_tensor(v):  # a float, as np.asarray keeps it
                v = torch.from_numpy(np.asarray(v))
            if k not in self.out:
                dtype = torch.empty((), dtype=v.dtype).numpy().dtype
                self.out[k] = np.empty((self.n_shuffle, *v.shape), dtype)
            torch.from_numpy(self.out[k][s:s + 1]).copy_(v[None])


def _log_batch(verbose, b, n_batch, size):
    if verbose:
        print(f"shuffle_and_decode: batch {b + 1}/{n_batch} ({size} "
              "shuffles)", flush=True)


def shuffle_and_decode(model, spk_tsdf, n_time_per_chunk=10000, dt_l=1,
                       n_shuffle=100, ep=None, decoder_type="naive_bayes",
                       seed=None, verbose=True, batched=True,
                       shuffle_batch_size=16, memory_mode=None):
    """Decode each circular shuffle of ``spk_tsdf`` with ``model``; returns
    the result dicts stacked over shuffles as numpy arrays (a key that is
    None, such as ``log_likelihood_all`` outside the full memory modes,
    stays None).

    ``decoder_type``: ``'naive_bayes'`` (the keys of
    ``decode_latent_naive_bayes``) or ``'dynamics'`` (the keys of
    ``decode_latent``).  ``batched=True`` decodes ``shuffle_batch_size``
    shuffles at a time: naive Bayes as one emission product per batch,
    the dynamics decoder through ``hmm.smooth_batch_full`` on the model's
    engine (``memory_mode``, default 'auto', passes through), each
    shuffle's dict built as ``decode_latent`` builds it.  ``batched=False``
    is the per-shuffle loop of ``decode_latent`` /
    ``decode_latent_naive_bayes`` (``memory_mode`` ignored, as in the JAX
    package).  A batch that runs out of the card's memory raises
    ``MemoryError``; pass a smaller ``shuffle_batch_size``."""
    if decoder_type not in ("naive_bayes", "dynamics"):
        raise ValueError(f"decoder_type {decoder_type} not supported")
    shuffles = circular_shuffle_data(spk_tsdf, n_shuffle=n_shuffle, ep=ep,
                                     seed=seed)
    stack = _HostStack(n_shuffle)
    if not batched:
        for s, y in enumerate(shuffles):
            if decoder_type == "naive_bayes":
                res = model.decode_latent_naive_bayes(
                    y, n_time_per_chunk=n_time_per_chunk, dt_l=dt_l)
            else:
                res = model.decode_latent(y, n_time_per_chunk=n_time_per_chunk)
            stack.put(s, res)
            _log_batch(verbose, s, n_shuffle, 1)
        return stack.out

    size = int(shuffle_batch_size)
    if size < 1:
        raise ValueError(
            f"shuffle_batch_size must be >= 1, got {shuffle_batch_size}")
    hyper = model._emission_hyper({})
    n_batch = -(-n_shuffle // size)
    for b in range(n_batch):
        # one batch of shuffles at a time: host memory O(size * T * N)
        y_b = torch.as_tensor(
            np.stack(list(itertools.islice(shuffles, size))),
            dtype=torch.float32, device=model.device)
        try:
            if decoder_type == "naive_bayes":
                _naive_bayes_batch(model, y_b, hyper, dt_l, stack, b * size)
            else:
                _dynamics_batch(model, y_b, hyper, n_time_per_chunk,
                                memory_mode or "auto", stack, b * size)
        except torch.cuda.OutOfMemoryError as exc:
            raise MemoryError(
                f"shuffle_and_decode: a batch of {y_b.shape[0]} shuffles of "
                f"{tuple(y_b.shape[1:])} does not fit the card; pass a "
                "smaller shuffle_batch_size") from exc
        del y_b
        _log_batch(verbose, b, n_batch, min(size, n_shuffle - b * size))
    return stack.out


def _naive_bayes_batch(model, y_b, hyper, dt_l, stack, s0):
    """Naive Bayes on a batch (E, T, N) as one (E * T, N) emission product;
    a per-bin ``dt_l`` (T,) is repeated for every shuffle."""
    E, T, N = y_b.shape
    dt = torch.as_tensor(dt_l, dtype=torch.float32)
    if dt.ndim:
        dt = dt.to(model.device).repeat(E)
    log_post, lml_l, _, ll = emissions.get_naive_bayes_ma(
        y_b.reshape(E * T, N), model.tuning, hyper, model.ma_neuron_default,
        model.ma_latent_default, dt_l=dt,
        observation_model=model.observation_model)
    log_post = log_post.view(E, T, -1)
    lml_l = lml_l.view(E, T)
    ll = ll.view(E, T, -1)
    lml_tot = lml_l.sum(dim=1)
    post = torch.exp(log_post)
    for e in range(E):
        stack.put(s0 + e, {
            "log_posterior_latent": log_post[e],
            "log_marginal_l": lml_l[e],
            "log_marginal_total": lml_tot[e],
            "posterior_latent": post[e],
            "ll_per_pos_l": ll[e],
        })


def _dynamics_batch(model, y_b, hyper, n_time_per_chunk, memory_mode, stack,
                    s0):
    """The smoother on a batch (E, T, N) through ``hmm.smooth_batch_full``,
    then each shuffle's ``decode_latent`` dict."""
    trans, _ = model._make_transition(hyper)
    log_post, lml, _, pred, acc, ll = hmm.smooth_batch_full(
        y_b, model.tuning, hyper, trans, model.ma_neuron_default,
        model.ma_latent_default, n_time_per_chunk=n_time_per_chunk,
        observation_model=model.observation_model,
        engine=model.inference_engine, memory_mode=memory_mode)
    for e in range(y_b.shape[0]):
        res = model._decode_res(log_post[e], pred[e], acc[e],
                                None if ll is None else ll[e])
        res["log_marginal_final"] = lml[e]
        stack.put(s0 + e, res)


def test_one_model(y_true, model_fit, n_shuffle=100,
                   decoder_type="naive_bayes", sig_key=None, seed=None):
    """Per-time-bin significance: decode the true data (a TsdFrame) and
    compare ``sig_key`` (default: ``log_marginal_l`` for naive Bayes,
    ``log_one_step_predictive_marginals_all`` for the dynamics decoder)
    with the 97.5 % quantile of the circular-shuffle null
    (``shuffle_and_decode`` in its default batches of 16).  Returns
    ``decode_res_true``, ``decode_res_shuffle``, ``log_marg_thresh`` and
    ``is_sig_tsd`` (a Tsd of bools on the data's times)."""
    y_true_t = y_true.t
    y_true_d = y_true.d
    if sig_key is None:
        sig_key = (
            "log_marginal_l"
            if decoder_type == "naive_bayes"
            else "log_one_step_predictive_marginals_all"
        )
    if decoder_type == "naive_bayes":
        res_true = model_fit.decode_latent_naive_bayes(y_true_d)
    elif decoder_type == "dynamics":
        res_true = model_fit.decode_latent(y_true_d)
    else:
        raise ValueError(f"decoder_type {decoder_type} not supported")
    res_shuffle = shuffle_and_decode(
        model_fit, y_true_d, n_time_per_chunk=10000, dt_l=1,
        n_shuffle=n_shuffle, ep=None, decoder_type=decoder_type, seed=seed,
    )
    log_marg_thresh = np.quantile(res_shuffle[sig_key], 0.975, axis=0)
    is_sig = compat.to_numpy(res_true[sig_key]) > log_marg_thresh
    return {
        "decode_res_true": res_true,
        "decode_res_shuffle": res_shuffle,
        "log_marg_thresh": log_marg_thresh,
        "is_sig_tsd": compat.tsd(d=is_sig, t=y_true_t),
    }


def compute_entropy(logp_l, axis=(-1, -2)):
    """Posterior entropy over the chosen axes."""
    logp_l = compat.to_numpy(logp_l)
    return -np.sum(np.exp(logp_l) * logp_l, axis=axis)


# ---------------------------------------------------------------------------
# jump verification
# ---------------------------------------------------------------------------


def get_contrast_axis_and_proj(x_sub, tuning, map_state_pre, map_state_post,
                               map_state_win=3):
    """Population-vector contrast axis between two latent states, and the
    projection of activity onto it.  Each state's axis is averaged over
    +/- map_state_win adjacent states."""
    tuning = compat.to_numpy(tuning)
    pre_range = slice(map_state_pre - map_state_win,
                      map_state_pre + map_state_win + 1)
    axis_pre = tuning[pre_range].mean(axis=0)
    post_range = slice(map_state_post - map_state_win,
                       map_state_post + map_state_win + 1)
    axis_post = tuning[post_range].mean(axis=0)
    contrast = axis_pre - axis_post
    contrast = contrast / np.linalg.norm(contrast)
    proj = compat.to_numpy(x_sub).dot(contrast)
    return proj, contrast


def segment_trial_by_jump(jump_p_sub, post_map_sub,
                          jump_p_merge_threshold_time=1, is_jump_threshold=0.5):
    """Segment a trial into continuous-dynamics epochs separated by jump
    epochs (Tsd inputs); the median MAP latent of each continuous
    segment."""
    jump_epoch = jump_p_sub.threshold(
        is_jump_threshold
    ).time_support.merge_close_intervals(jump_p_merge_threshold_time)
    continuous_epoch = post_map_sub.time_support.set_diff(jump_epoch)

    post_map_median_per_epoch = {}
    for ii, epoch in enumerate(continuous_epoch):
        restricted = post_map_sub.restrict(epoch)
        post_map_median_per_epoch[ii] = (
            np.nanmedian(np.asarray(restricted.d)) if len(restricted)
            else np.nan
        )
    return {
        "post_map_median_per_epoch": post_map_median_per_epoch,
        "jump_epoch": jump_epoch,
        "continuous_epoch": continuous_epoch,
    }
