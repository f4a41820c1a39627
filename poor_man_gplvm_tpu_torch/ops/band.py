"""The band of a transition stack: each column's window of nonzero rows.

The movement channel of every configuration the repo runs is an RBF of
integer positions, exactly 0 in f32 far from the diagonal (from |i - j| >=
11 at lengthscale 1), so a (1, L) @ (L, L) recursion dot needs only W of
the L rows of each column.  The scan kernels read the non-constant
channels through a ``Band``: K3 (``parallel_scan.pfilter_pass``) its push
half, K2 (``scan_kernels.smoother_scan``) its pull half, K4
(``parallel_scan.psmooth_pass``) both.  The window sum runs over the rows
ascending with fused multiply-adds, and ``fma(x, +0, a) = a``, so a kernel
on the band gives the dense kernel's bits; a dense channel is the band
W = L with every window at row 0, the same code.

Both kernel modules import this one; it imports neither.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from poor_man_gplvm_tpu_torch.utils import profiling

__all__ = [
    "Band",
    "band_windows",
    "check_band",
    "set_band_override",
    "split_bf16",
    "transition_band",
]

#: test hook: every band is the whole matrix (W = L, windows at 0)
_BAND_DENSE = False


def set_band_override(dense):
    """Test hook: with ``dense=True`` every band ``transition_band`` makes
    is the whole matrix (W = L, every window from row 0), the dense path of
    K2, K3 and K4; ``False`` restores the narrowest band.  Both give the
    same bits (the band leaves out only exact zeros), which the card tests
    hold."""
    global _BAND_DENSE
    _BAND_DENSE = bool(dense)


def split_bf16(x):
    """x (f32) -> (hi, lo) bf16 pair with hi + lo ~ x: hi the bf16
    rounding, lo the bf16 rounding of the residual."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


class Band(NamedTuple):
    """The band the kernels read in place of the non-constant channels of
    tlat (the push) and tlat_t (the pull): ``mats[0, m]`` and ``mats[1,
    m]`` (W, L) hold rows ``start[., m, j] + k`` of column j of the m-th
    non-constant channel's tlat and tlat_t, k < W.  Each half is
    contiguous.  ``hi``/``lo``: its ``split_bf16`` outside "highest".
    The band of a stack of G configurations (K1/K2 with a configuration
    index) has a leading G axis on ``start`` and ``mats``, one W for all:
    the widest configuration's, the others padded with exact zeros."""

    W: int
    start: torch.Tensor          # ([G,] 2, n_mat, L) int32
    mats: torch.Tensor           # ([G,] 2, n_mat, W, L) float32
    hi: Optional[torch.Tensor]   # (2, n_mat, W, L) bfloat16
    lo: Optional[torch.Tensor]


def band_windows(mats):
    """The windows of rows that hold every nonzero of each column of
    ``mats`` (n, L, L): returns (start (n, L) int32, W).  W is the largest
    last - first + 1 over all columns (L for an all-zero column), the same
    for all; column j's window starts at min(first_j, L - W), so that it
    stays inside [0, L) and its extra rows are exact zeros.  With
    ``set_band_override(True)``: W = L, every start 0.  Reads W to the
    host (one sync)."""
    n, L = mats.shape[0], mats.shape[-1]
    if n == 0:
        return torch.zeros((0, L), dtype=torch.int32, device=mats.device), 0
    if _BAND_DENSE:
        return torch.zeros((n, L), dtype=torch.int32, device=mats.device), L
    nz = mats != 0
    rows = torch.arange(L, device=mats.device)[:, None]
    first = torch.where(nz, rows, L).amin(dim=1)
    last = torch.where(nz, rows, -1).amax(dim=1)
    profiling.host_sync("band")
    W = int(torch.where(last >= first, last - first + 1, L).max())
    return torch.clamp(first, max=L - W).to(torch.int32), W


def _gather_band(mats, start, W):
    """(n, W, L) band of ``mats`` (n, L, L): band[m, k, j] = mats[m,
    start[m, j] + k, j]."""
    idx = start.long()[:, None, :] + torch.arange(
        W, device=mats.device)[None, :, None]
    return mats.gather(1, idx)


def transition_band(tlat, tlat_t, uniform_rows, scan_prec="highest"):
    """The ``Band`` of ``tlat`` and ``tlat_t`` (n_dyn, L, L): the push and
    pull windows of every channel not flagged constant in ``uniform_rows``
    (a constant channel takes the row-sum shortcut and has no band), with
    its bf16 split outside "highest".  Made once per solve; W, which sizes
    the kernels' shared memory, is one host read per solve, not per pass.
    A dense channel gives W = L: the dense matvec.

    A stack of G configurations, tlat and tlat_t (G, n_dyn, L, L) with one
    ``uniform_rows`` for all, gives the stacked band of K1/K2 with a
    configuration index ("highest" only): every window is as wide as the
    widest configuration's, so a narrower configuration's window covers
    its nonzeros and the rows it adds are exact zeros."""
    L = tlat.shape[-1]
    lead = tuple(tlat.shape[:-3])
    if len(lead) > 1 or (lead and scan_prec != "highest"):
        raise ValueError("a band stacks configurations along one axis, "
                         "in 'highest' only")
    keep = [d for d, flag in enumerate(uniform_rows) if not flag]
    idx = profiling.to_device(torch.tensor(keep, dtype=torch.int64),
                              tlat.device)
    mats = torch.stack([tlat[..., idx, :, :], tlat_t[..., idx, :, :]],
                       dim=len(lead)).reshape(-1, L, L)
    start, W = band_windows(mats)
    band = _gather_band(mats, start, W).view(*lead, 2, len(keep), W, L)
    hi, lo = (None, None) if scan_prec == "highest" else split_bf16(band)
    return Band(W, start.view(*lead, 2, len(keep), L).contiguous(),
                band.contiguous(), hi, lo)


def check_band(band, uniform_rows, L, device, scan_prec="highest",
               n_config=None):
    """Raise unless ``band`` is a ``Band`` of the non-constant channels of
    ``uniform_rows`` over L latent bins, on ``device``, with the bf16 split
    that ``scan_prec`` reads; with ``n_config`` the stacked band of that
    many configurations."""
    n_mat = sum(not f for f in uniform_rows)
    lead = () if n_config is None else (n_config,)
    shape = (*lead, 2, n_mat, band.W, L)
    ok = (tuple(band.mats.shape) == shape
          and tuple(band.start.shape) == (*lead, 2, n_mat, L)
          and band.mats.dtype == torch.float32
          and band.start.dtype == torch.int32
          and band.mats.device == device and band.start.device == device
          and band.mats.is_contiguous() and band.start.is_contiguous()
          and (n_mat == 0 or 1 <= band.W <= L))
    if ok and scan_prec != "highest":
        parts = (band.hi,) if scan_prec == "bf16" else (band.hi, band.lo)
        ok = all(p is not None and tuple(p.shape) == shape
                 and p.dtype == torch.bfloat16 and p.device == device
                 and p.is_contiguous() for p in parts)
    if not ok:
        raise ValueError("band does not match the channels, device or "
                         "precision of this pass")
