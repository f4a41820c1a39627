"""Reference-compatible gain shuffle test (counterpart of
``poor_man_gplvm_tpu/experimental/test_exp.py``, mirroring
``poor_man_gplvm.experimental.test_exp``)."""

from __future__ import annotations

import numpy as np

from poor_man_gplvm_tpu_torch.experimental.gain import (  # noqa: F401
    shuffle_and_decode_gain,
)
from poor_man_gplvm_tpu_torch.utils import compat

__all__ = ["shuffle_and_decode", "shuffle_and_decode_gain"]


def shuffle_and_decode(model, spk_tsdf, n_time_per_chunk=10000, dt_l=1,
                       n_shuffle=100, ep=None, decoder_type="naive_bayes",
                       seed=None, verbose=True):
    """Circular-shuffle null for the gain model, re-fitting the gain per
    shuffle (reference experimental/test_exp.py:5-23): for each shuffle
    (``validation.circular_shuffle_data(seed=seed)``, the JAX package's
    draws for a seed) the gain is fitted to it from the model's posterior,
    then the shuffle is decoded.  Returns the result dicts stacked over
    shuffles as numpy arrays (the keys of non-scalar values).  A serial
    loop, as in the JAX package; ``verbose`` prints one line per shuffle
    (no progress bar)."""
    from poor_man_gplvm_tpu_torch.validation import circular_shuffle_data

    decoding_res_l = []
    for i, y_shuffled in enumerate(circular_shuffle_data(
            spk_tsdf, n_shuffle=n_shuffle, ep=ep, seed=seed)):
        y_arr = y_shuffled.d if compat.is_tsdframe(y_shuffled) else y_shuffled
        model.gain = model.get_gain_mstep_chunk(
            y_arr, model.log_posterior, model.tuning,
            n_time_per_chunk=n_time_per_chunk,
        )
        if decoder_type == "naive_bayes":
            decoding_res = model.decode_latent_naive_bayes(
                y_arr, n_time_per_chunk=n_time_per_chunk, dt_l=dt_l
            )
        else:
            decoding_res = model.decode_latent(
                y_arr, n_time_per_chunk=n_time_per_chunk
            )
        decoding_res_l.append(decoding_res)
        if verbose:
            print(f"shuffle {i + 1}/{n_shuffle}", flush=True)
    return {
        k: np.array([compat.to_numpy(d[k]) for d in decoding_res_l])
        for k in decoding_res_l[0].keys()
        if compat.to_numpy(decoding_res_l[0][k]).ndim > 0
    }
