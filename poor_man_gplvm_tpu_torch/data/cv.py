"""Blocked cross-validation splits and dataset container.

The port's own copy of ``poor_man_gplvm_tpu/data/cv.py`` (Hardcastle-style
blocked CV: the test fold takes a 1/k_CV slice out of each of n_blocks
contiguous blocks, so train/test interleave across the session).  The
masks are made on the host; a tensor is split on its own device (on the
card, a card tensor stays there), anything else as a numpy array.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["cv_split", "DecoderDataset"]


def _take(data, mask):
    if torch.is_tensor(data):
        return data[torch.as_tensor(mask, device=data.device)]
    return data[mask]


def cv_split(data, k, k_CV=10, n_blocks=10):
    """Split data (time-leading) into train/test for fold k of k_CV, plus the
    within-split indices where new contiguous blocks begin."""
    if not torch.is_tensor(data):
        data = np.asarray(data)
    block_size = len(data) // n_blocks
    mask_test = np.zeros(len(data), dtype=bool)
    for block in range(n_blocks):
        i_start = int((block + k / k_CV) * block_size)
        i_stop = int(i_start + block_size // k_CV)
        mask_test[i_start:i_stop] = True
    mask_train = ~mask_test

    data_test = _take(data, mask_test)
    data_train = _take(data, mask_train)

    train_switch_indices = [0]
    test_switch_indices = [0]
    train_count = test_count = 0
    for i in range(len(data) - 1):
        if mask_train[i]:
            train_count += 1
        if mask_test[i]:
            test_count += 1
        if not mask_train[i] and mask_train[i + 1]:
            train_switch_indices.append(train_count)
        if not mask_test[i] and mask_test[i + 1]:
            test_switch_indices.append(test_count)

    return (
        data_train, data_test,
        np.unique(train_switch_indices), np.unique(test_switch_indices),
    )


def _t(x):
    """The transpose of a 2-D array or tensor; a 1-D one as it is."""
    return x.T if x.ndim == 2 else x


class DecoderDataset:
    """(N, T) features + (T,) discrete targets with blocked-CV splitting;
    numpy arrays, or tensors that stay on their device."""

    def __init__(self, X, Y):
        if not torch.is_tensor(X):
            X = np.asarray(X)
        if not torch.is_tensor(Y):
            Y = np.asarray(Y)
        if X.ndim != 2:
            raise ValueError("X must have shape (N, T)")
        if Y.ndim != 1:
            raise ValueError("Y must have shape (T,)")
        if X.shape[1] != Y.shape[0]:
            raise ValueError("X.shape[1] must equal Y.shape[0]")
        self.X = X
        self.Y = Y

    def split(self, k, k_CV=10, n_blocks=10):
        """Returns ((X_train, Y_train), (X_test, Y_test), train_switch_ind,
        test_switch_ind)."""
        X_train, X_test, train_sw, test_sw = cv_split(
            _t(self.X), k, k_CV, n_blocks
        )
        Y_train, Y_test, _, _ = cv_split(self.Y, k, k_CV, n_blocks)
        return ((_t(X_train), _t(Y_train)), (_t(X_test), _t(Y_test)),
                train_sw, test_sw)
