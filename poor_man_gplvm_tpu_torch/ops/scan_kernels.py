"""Sequential HMM filter/smoother scans: CUDA kernels and plain versions.

Counterpart of ``poor_man_gplvm_tpu/ops/pallas/scan_kernels.py``.  The two
Pallas TPU kernels become hand-written CUDA C++ kernels for Hopper
(``csrc/scan_kernels.cu``; its header says what bounds them on the card):

* K1 ``filter_scan``  <- ``_filter_kernel`` / ``filter_chunk_pallas``
* K2 ``smoother_scan`` <- ``_smoother_kernel`` / ``smoother_chunk_pallas``,
  on the pull half of the band of each channel's nonzeros
  (``ops/band.py::transition_band``)

Each wrapper checks its inputs, allocates the outputs with ``torch.empty``
and launches on the current stream without synchronising.  On a CPU tensor
it runs the plain PyTorch version of the same function instead (a Python
loop over time, as ``hmm._forward_scan_prob`` / ``_backward_scan_prob``);
on a CUDA tensor it launches the kernel or raises.  Each wrapper counts its
launches in ``<wrapper>.launches`` so a run can show that it went through
the kernel.

``filter_chunk`` and ``smoother_chunk`` keep the JAX wrappers' signatures
and outputs: the likelihood weights ``w = exp(scale*(ll - rowmax))`` are
formed outside the sequential loop, and the per-step log ratios are
``log(s_t) + scale * m_t`` with s_t the normaliser the filter wrote.
"""

from __future__ import annotations

import torch

from poor_man_gplvm_tpu_torch.ops.band import check_band, transition_band

__all__ = [
    "filter_chunk",
    "smoother_chunk",
    "filter_scan",
    "filter_scan_plain",
    "smoother_scan",
    "smoother_scan_plain",
]

#: normaliser clamp of both kernels (as in the TPU kernels)
NORM_FLOOR = 1e-38
MAX_DYN = 2
MAX_LATENT = 1024


def _detect_uniform_rows(tlat):
    """Per-dynamics flags: True when Tlat[d] is CONSTANT (every entry equal,
    the jump channel's uniform transition).  Identical but non-constant rows
    are NOT flagged: the kernels' shortcut ``sum(v) * row`` equals the true
    matvec only for a constant matrix.  One host sync."""
    dev = (tlat - tlat[:, :1, :1]).abs().amax(dim=(1, 2)) < 1e-12
    return tuple(bool(f) for f in dev.tolist())


def _mask(uniform_rows):
    return sum(1 << d for d, f in enumerate(uniform_rows) if f)


def _check(name, x, shape, device):
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_dims(n_dyn, L, uniform_rows):
    if not 1 <= n_dyn <= MAX_DYN:
        raise ValueError(f"n_dyn must be 1 or 2, got {n_dyn}")
    if not 1 <= L <= MAX_LATENT:
        raise ValueError(f"L must be in [1, {MAX_LATENT}], got {L}")
    if len(uniform_rows) != n_dyn:
        raise ValueError("uniform_rows needs one flag per dynamics channel")


def _stream_ptr(device):
    return torch.cuda.current_stream(device).cuda_stream


def _lib():
    from poor_man_gplvm_tpu_torch.ops._build import load_scan_kernels

    return load_scan_kernels()


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# K1: causal filter
# ---------------------------------------------------------------------------


def filter_scan_plain(w, tlat, tdyn, p_init, uniform_rows):
    """Plain version of K1.  w: (T, L) likelihood weights; tlat (n_dyn, L,
    L); tdyn (n_dyn, n_dyn); p_init (n_dyn, L).  Returns post and prior
    (T, n_dyn, L) and the per-step normaliser (T,)."""
    T = w.shape[0]
    n_dyn, L = p_init.shape
    post = torch.empty((T, n_dyn, L), dtype=w.dtype, device=w.device)
    prior = torch.empty_like(post)
    norm = torch.empty((T,), dtype=w.dtype, device=w.device)
    carry = p_init
    for t in range(T):
        q = tdyn.T @ carry  # q[d] = sum_p Tdyn[p, d] * carry[p]
        rows = []
        for d in range(n_dyn):
            if uniform_rows[d]:
                rows.append(q[d].sum() * tlat[d, 0])
            else:
                rows.append(q[d] @ tlat[d])
        pr = torch.stack(rows)
        u = pr * w[t]
        s = u.sum()
        carry = u / torch.clamp(s, min=NORM_FLOOR)
        post[t], prior[t], norm[t] = carry, pr, s
    return post, prior, norm


def filter_scan(w, tlat, tdyn, p_init, uniform_rows):
    """K1 wrapper: same arguments and outputs as ``filter_scan_plain``."""
    T, L = w.shape
    n_dyn = tlat.shape[0]
    _check_dims(n_dyn, L, uniform_rows)
    dev = w.device
    _check("w", w, (T, L), dev)
    _check("tlat", tlat, (n_dyn, L, L), dev)
    _check("tdyn", tdyn, (n_dyn, n_dyn), dev)
    _check("p_init", p_init, (n_dyn, L), dev)
    if dev.type == "cpu":
        return filter_scan_plain(w, tlat, tdyn, p_init, uniform_rows)
    if dev.type != "cuda":
        raise ValueError(f"filter_scan runs on cpu or cuda, not {dev.type}")
    post = torch.empty((T, n_dyn, L), dtype=torch.float32, device=dev)
    prior = torch.empty_like(post)
    norm = torch.empty((T,), dtype=torch.float32, device=dev)
    if T == 0:
        return post, prior, norm
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = _lib().pmg_filter_scan(
            w.data_ptr(), tlat.data_ptr(), tdyn.data_ptr(),
            p_init.data_ptr(), post.data_ptr(), prior.data_ptr(),
            norm.data_ptr(), T, n_dyn, L, _mask(uniform_rows),
            _stream_ptr(dev),
        )
    filter_scan.launches += 1
    _raise_on(err, "filter_scan")
    return post, prior, norm


filter_scan.launches = 0


def filter_chunk(ll, tlat, tdyn, p_init, likelihood_scale, uniform_rows=None):
    """Causal filter over (T, L) log-likelihoods (``filter_chunk_pallas``).

    ll: (T, L); tlat: (n_dyn, L, L) row-stochastic; tdyn: (n_dyn, n_dyn);
    p_init: (n_dyn, L) probability-space carry.
    Returns (post (T, n_dyn, L), prior (T, n_dyn, L), ratios (T,))."""
    if uniform_rows is None:
        uniform_rows = _detect_uniform_rows(tlat)
    m = ll.amax(dim=1)
    w = torch.exp(likelihood_scale * (ll - m[:, None])).contiguous()
    post, prior, norm = filter_scan(
        w, tlat.contiguous(), tdyn.contiguous(), p_init.contiguous(),
        uniform_rows,
    )
    return post, prior, torch.log(norm) + likelihood_scale * m


# ---------------------------------------------------------------------------
# K2: backward smoother
# ---------------------------------------------------------------------------


def smoother_scan_plain(filt, prior, tlat_t, tdyn, init, uniform_rows):
    """Plain version of K2.  filt, prior: (T, n_dyn, L) filter posteriors
    and +1-shifted priors; tlat_t: (n_dyn, L, L) TRANSPOSED latent kernels;
    tdyn (n_dyn, n_dyn); init (n_dyn, L) smoothed posterior after the last
    row.  Returns smooth and the ratios r (T, n_dyn, L)."""
    T, n_dyn, L = filt.shape
    smooth = torch.empty_like(filt)
    rout = torch.empty_like(filt)
    carry = init
    zero = torch.zeros((), dtype=filt.dtype, device=filt.device)
    for t in range(T - 1, -1, -1):
        pn = prior[t]
        pos = pn > 0
        r = torch.where(pos, carry / torch.where(pos, pn, 1.0), zero)
        rows = []
        for e in range(n_dyn):
            if uniform_rows[e]:
                rows.append(r[e].sum() * tlat_t[e, 0])
            else:
                rows.append(r[e] @ tlat_t[e])  # = Tlat[e] @ r[e]
        out = tdyn @ torch.stack(rows)  # out[d] = sum_e Tdyn[d, e] pull[e]
        v = filt[t] * out
        carry = v / torch.clamp(v.sum(), min=NORM_FLOOR)
        smooth[t], rout[t] = carry, r
    return smooth, rout


def smoother_scan(filt, prior, tlat_t, tdyn, init, uniform_rows, band=None):
    """K2 wrapper: same arguments and outputs as ``smoother_scan_plain``.
    On the card the kernel reads the non-constant channels through the
    pull half of ``band``, the ``transition_band`` of tlat_t's stack (made
    here when None: one host read; a caller with several chunks makes it
    once), and gives the dense product's bits."""
    T, n_dyn, L = filt.shape
    _check_dims(n_dyn, L, uniform_rows)
    dev = filt.device
    _check("filt", filt, (T, n_dyn, L), dev)
    _check("prior", prior, (T, n_dyn, L), dev)
    _check("tlat_t", tlat_t, (n_dyn, L, L), dev)
    _check("tdyn", tdyn, (n_dyn, n_dyn), dev)
    _check("init", init, (n_dyn, L), dev)
    if band is not None:
        check_band(band, uniform_rows, L, dev)
    if dev.type == "cpu":
        return smoother_scan_plain(filt, prior, tlat_t, tdyn, init,
                                   uniform_rows)
    if dev.type != "cuda":
        raise ValueError(f"smoother_scan runs on cpu or cuda, not {dev.type}")
    smooth = torch.empty((T, n_dyn, L), dtype=torch.float32, device=dev)
    rout = torch.empty_like(smooth)
    if T == 0:  # nothing to smooth over (a T=1 sequence): launch nothing
        return smooth, rout
    if band is None:
        band = transition_band(tlat_t.transpose(-1, -2).contiguous(), tlat_t,
                               uniform_rows)
    with torch.cuda.device(dev):
        # the pull half is the second, contiguous half of the band
        err = _lib().pmg_smoother_scan(
            filt.data_ptr(), prior.data_ptr(), tlat_t.data_ptr(),
            band.mats[1].data_ptr(), band.start[1].data_ptr(),
            tdyn.data_ptr(), init.data_ptr(), smooth.data_ptr(),
            rout.data_ptr(), T, n_dyn, L, band.W, _mask(uniform_rows),
            _stream_ptr(dev),
        )
    smoother_scan.launches += 1
    _raise_on(err, "smoother_scan")
    return smooth, rout


smoother_scan.launches = 0


def smoother_chunk(filt_xs, prior_xs, tlat, tdyn, smooth_init,
                   uniform_rows=None, band=None):
    """Backward smoother over (T', n_dyn, L) filter posteriors and
    +1-shifted priors (``smoother_chunk_pallas``); ``band``: the
    ``transition_band`` of tlat, see ``smoother_scan``.
    Returns (smooth (T', n_dyn, L), ratios (T', n_dyn, L))."""
    if uniform_rows is None:
        uniform_rows = _detect_uniform_rows(tlat)
    # pre-transposed latent kernels: thread j of the kernel then reads
    # TlatT[e][i][j] for i = 0..L-1, neighbouring threads on neighbouring
    # addresses
    tlat_t = tlat.transpose(-1, -2).contiguous()
    return smoother_scan(
        filt_xs.contiguous(), prior_xs.contiguous(), tlat_t,
        tdyn.contiguous(), smooth_init.contiguous(), uniform_rows, band,
    )
