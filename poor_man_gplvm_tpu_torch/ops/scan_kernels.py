"""Sequential HMM filter/smoother scans: CUDA kernels and plain versions.

Counterpart of ``poor_man_gplvm_tpu/ops/pallas/scan_kernels.py``.  The two
Pallas TPU kernels become hand-written CUDA C++ kernels for Hopper
(``csrc/scan_kernels.cu``; its header says what bounds them on the card),
each on its half of the band of every channel's nonzeros
(``ops/band.py::transition_band``) and with a batch axis, one thread block
per sequence:

* K1 ``filter_scan`` / ``filter_scan_batch``  <- ``_filter_kernel`` /
  ``filter_chunk_pallas``, on the push half;
* K2 ``smoother_scan`` / ``smoother_scan_batch`` <- ``_smoother_kernel`` /
  ``smoother_chunk_pallas``, on the pull half.

The unbatched wrappers launch the same kernel on a batch of one.  The
batched ones take (E, Tmax, ...) arrays and a device int32 array of
lengths; a sequence runs exactly its own length, and the rows past it are
left as allocated (unspecified).  With ``cfg``, a device int32 array of
one configuration index per sequence, they take a stack of G transition
configurations (tlat (G, n_dyn, L, L), tdyn (G, n_dyn, n_dyn), the stacked
band of ``ops/band.py::transition_band``): a sweep's runs, each under its
own transition, in one launch.  ``filter_scan_batch(norm_only=True)`` is
K1 without its row stores: it returns only the normalisers, with the same
bits.

Each wrapper checks its inputs, allocates the outputs with ``torch.empty``
and launches on the current stream without synchronising (the batched
wrappers read the smallest and largest length to the host to check them).
On a CPU tensor it runs the plain PyTorch version of the same function
instead (a Python loop over time, as ``hmm._forward_scan_prob`` /
``_backward_scan_prob``; ``*_batch_plain`` loop over the sequences); on a
CUDA tensor it launches the kernel or raises.  Each wrapper counts its
launches in ``<wrapper>.launches`` (the batched ones also in
``launches_by_mode``) so a run can show that it went through the kernel.

``filter_chunk`` and ``smoother_chunk`` keep the JAX wrappers' signatures
and outputs: the likelihood weights ``w = exp(scale*(ll - rowmax))`` are
formed outside the sequential loop, and the per-step log ratios are
``log(s_t) + scale * m_t`` with s_t the normaliser the filter wrote;
``*_chunk_batch`` do the same for a batch.
"""

from __future__ import annotations

import torch

from poor_man_gplvm_tpu_torch.ops.band import check_band, transition_band
from poor_man_gplvm_tpu_torch.utils import profiling

__all__ = [
    "filter_chunk",
    "smoother_chunk",
    "filter_scan",
    "filter_scan_plain",
    "smoother_scan",
    "smoother_scan_plain",
    "filter_chunk_batch",
    "smoother_chunk_batch",
    "filter_scan_batch",
    "filter_scan_batch_plain",
    "smoother_scan_batch",
    "smoother_scan_batch_plain",
    "smoother_push_scan",
    "smoother_push_scan_plain",
    "smoother_push_chunk",
    "push_plan",
]

#: normaliser clamp of both kernels (as in the TPU kernels)
NORM_FLOOR = 1e-38
#: the smoothers' ratio r = carry / prior treats a prior below the smallest
#: normal float32 as zero, as the JAX package does (XLA flushes
#: subnormals): a subnormal prior under a carry of normal size would give
#: r = inf and a NaN row; with the floor the pulled vector, a row-stochastic
#: average of the r, stays below 1 / PRIOR_FLOOR (``scan_common.cuh::
#: kPriorFloor``)
PRIOR_FLOOR = float(torch.finfo(torch.float32).tiny)
MAX_DYN = 2
MAX_LATENT = 1024


def smoother_ratio(carry, prior):
    """The smoother's ratio ``carry / prior``, 0 where ``prior`` is below
    ``PRIOR_FLOOR`` (K2, K4 and the 'prob' engine)."""
    pos = prior >= PRIOR_FLOOR
    return torch.where(pos, carry / torch.where(pos, prior, 1.0),
                       torch.zeros_like(prior))


def _detect_uniform_rows(tlat):
    """Per-dynamics flags: True when Tlat[d] is CONSTANT (every entry equal,
    the jump channel's uniform transition).  Identical but non-constant rows
    are NOT flagged: the kernels' shortcut ``sum(v) * row`` equals the true
    matvec only for a constant matrix.  One host sync."""
    dev = (tlat - tlat[:, :1, :1]).abs().amax(dim=(1, 2)) < 1e-12
    profiling.host_sync("uniform_rows")
    return tuple(bool(f) for f in dev.tolist())


def _mask(uniform_rows):
    return sum(1 << d for d, f in enumerate(uniform_rows) if f)


def _check(name, x, shape, device, batch=False):
    """Raise unless ``x`` is a float32 tensor of ``shape`` on ``device``,
    contiguous; with ``batch`` the stride between sequences (dim 0) is
    free, so that a slice along time of a batched array passes."""
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not (_rows_contiguous(x) if batch else x.is_contiguous()):
        raise ValueError(f"{name} must be contiguous")


def _rows_contiguous(x):
    """Whether each x[e] is contiguous and the sequences do not overlap."""
    if x.numel() == 0 or x.is_contiguous():
        return True
    return x[0].is_contiguous() and (
        x.shape[0] == 1 or x.stride(0) >= x[0].numel())


def _as_rows(x):
    return x if _rows_contiguous(x) else x.contiguous()


def _check_dims(n_dyn, L, uniform_rows):
    if not 1 <= n_dyn <= MAX_DYN:
        raise ValueError(f"n_dyn must be 1 or 2, got {n_dyn}")
    if not 1 <= L <= MAX_LATENT:
        raise ValueError(f"L must be in [1, {MAX_LATENT}], got {L}")
    if len(uniform_rows) != n_dyn:
        raise ValueError("uniform_rows needs one flag per dynamics channel")


def _check_index(name, idx, E, device, lowest, highest, noun=None):
    """Raise unless ``idx`` is an int32 (E,) tensor on ``device`` with
    every entry (``noun``) in [lowest, highest] (one host read)."""
    if not torch.is_tensor(idx) or idx.dtype != torch.int32:
        raise TypeError(f"{name} must be an int32 tensor, got "
                        f"{getattr(idx, 'dtype', type(idx))}")
    if tuple(idx.shape) != (E,):
        raise ValueError(f"{name} must have shape ({E},), got "
                         f"{tuple(idx.shape)}")
    if idx.device != device:
        raise ValueError(f"{name} is on {idx.device}, expected {device}")
    if not idx.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if E:
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < lowest or hi > highest:
            raise ValueError(f"every {noun or 'entry of ' + name} must be "
                             f"in [{lowest}, {highest}], got {lo} to {hi}")


def _check_lengths(lengths, E, Tmax, device, shortest):
    """Raise unless ``lengths`` is an int32 (E,) tensor on ``device`` with
    every entry in [shortest, Tmax] (one host read)."""
    _check_index("lengths", lengths, E, device, shortest, Tmax, "length")


def _check_stack(tlat_name, tlat, tdyn, cfg, E, n_dyn, L, device):
    """Check the transition operands of a batched launch: one stack (cfg
    None) or G of them indexed by ``cfg`` (E,) int32.  Returns G (None
    without cfg)."""
    if cfg is None:
        _check(tlat_name, tlat, (n_dyn, L, L), device)
        _check("tdyn", tdyn, (n_dyn, n_dyn), device)
        return None
    G = tlat.shape[0]
    _check(tlat_name, tlat, (G, n_dyn, L, L), device)
    _check("tdyn", tdyn, (G, n_dyn, n_dyn), device)
    _check_index("cfg", cfg, E, device, 0, G - 1)
    return G


def _seq_transition(tlat, tdyn, cfg, e):
    """Sequence e's transition stack in a plain version."""
    if cfg is None:
        return tlat, tdyn
    g = int(cfg[e])
    return tlat[g], tdyn[g]


def _valid_rows(lengths, Tmax):
    """(E, Tmax) bool: row t of sequence e is one of its own."""
    steps = torch.arange(Tmax, device=lengths.device)
    return steps[None, :] < lengths[:, None]


def _stream_ptr(device):
    return torch.cuda.current_stream(device).cuda_stream


def _lib():
    from poor_man_gplvm_tpu_torch.ops._build import load_scan_kernels

    return load_scan_kernels()


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _band_for(band, tlat, tlat_t, uniform_rows):
    """``band``, or the ``transition_band`` of the stack when None (one host
    read; a caller with several calls makes it once)."""
    if band is not None:
        return band
    if tlat_t is None:
        tlat_t = tlat.transpose(-1, -2).contiguous()
    if tlat is None:
        tlat = tlat_t.transpose(-1, -2).contiguous()
    return transition_band(tlat, tlat_t, uniform_rows)


def _ptr(x):
    return 0 if x is None else x.data_ptr()


def _stack_mode(cfg):
    return "shared" if cfg is None else "cfg"


def _count_mode(fn, mode):
    fn.launches_by_mode[mode] = fn.launches_by_mode.get(mode, 0) + 1


def _stack_args(band, half, tlat, tdyn, cfg):
    """(band half pointer, window pointer, the configuration strides of
    tlat, band, win0 and tdyn) of a launch: the strides are 0 without a
    configuration index."""
    mats = band.mats.select(-4, half)
    start = band.start.select(-3, half)
    if cfg is None:
        return mats.data_ptr(), start.data_ptr(), 0, 0, 0, 0
    return (mats.data_ptr(), start.data_ptr(), tlat[0].numel(),
            band.mats[0].numel(), band.start[0].numel(), tdyn[0].numel())


# ---------------------------------------------------------------------------
# K1: causal filter
# ---------------------------------------------------------------------------


def _push_plain(p, tlat, tdyn, uniform_rows):
    """The prior that follows the state p (n_dyn, L): the push of K1's plain
    version, q[d] = sum_p Tdyn[p, d] * p[p], then q[d] @ Tlat[d] (a
    constant channel: sum(q[d]) * its first row)."""
    q = tdyn.T @ p
    rows = []
    for d in range(p.shape[0]):
        if uniform_rows[d]:
            rows.append(q[d].sum() * tlat[d, 0])
        else:
            rows.append(q[d] @ tlat[d])
    return torch.stack(rows)


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
        pr = _push_plain(carry, tlat, tdyn, uniform_rows)
        u = pr * w[t]
        s = u.sum()
        carry = u / torch.clamp(s, min=NORM_FLOOR)
        post[t], prior[t], norm[t] = carry, pr, s
    return post, prior, norm


def filter_scan_batch_plain(w, tlat, tdyn, p_init, lengths, uniform_rows,
                            cfg=None):
    """Plain version of K1 over a batch: ``filter_scan_plain`` on each
    sequence's own rows.  w (E, Tmax, L); p_init (E, n_dyn, L); lengths
    (E,); with ``cfg`` (E,) sequence e runs under tlat[cfg[e]] and
    tdyn[cfg[e]] of a stack.  Returns post and prior (E, Tmax, n_dyn, L)
    and the normalisers (E, Tmax), zero past each sequence's length."""
    E, Tmax, L = w.shape
    n_dyn = p_init.shape[1]
    post = torch.zeros((E, Tmax, n_dyn, L), dtype=w.dtype, device=w.device)
    prior = torch.zeros_like(post)
    norm = torch.zeros((E, Tmax), dtype=w.dtype, device=w.device)
    for e, n in enumerate(lengths.tolist()):
        tl, td = _seq_transition(tlat, tdyn, cfg, e)
        post[e, :n], prior[e, :n], norm[e, :n] = filter_scan_plain(
            w[e, :n], tl, td, p_init[e], uniform_rows)
    return post, prior, norm


def _launch_filter(w, tlat, tdyn, p_init, lengths, uniform_rows, band,
                   cfg=None, store=True):
    """One K1 launch over the batch w (E, Tmax, L), E and Tmax >= 1;
    ``lengths`` None runs Tmax rows of every sequence; ``store=False``
    allocates and writes only the normalisers (post and prior None)."""
    E, Tmax, L = w.shape
    n_dyn = tlat.shape[-3]
    dev = w.device
    post = prior = None
    if store:
        post = torch.empty((E, Tmax, n_dyn, L), dtype=torch.float32,
                           device=dev)
        prior = torch.empty_like(post)
    norm = torch.empty((E, Tmax), dtype=torch.float32, device=dev)
    band = _band_for(band, tlat, None, uniform_rows)
    # the push half is the first, contiguous half of each band
    mats, win0, *strides = _stack_args(band, 0, tlat, tdyn, cfg)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = _lib().pmg_filter_scan(
            w.data_ptr(), tlat.data_ptr(), mats, win0, tdyn.data_ptr(),
            p_init.data_ptr(), _ptr(lengths), _ptr(cfg), _ptr(post),
            _ptr(prior), norm.data_ptr(), w.stride(0), *strides, E, Tmax,
            n_dyn, L, band.W, _mask(uniform_rows), _stream_ptr(dev),
        )
    return err, (post, prior, norm)


def filter_scan(w, tlat, tdyn, p_init, uniform_rows, band=None):
    """K1 wrapper: same arguments and outputs as ``filter_scan_plain``.
    On the card the kernel reads the non-constant channels through the
    push half of ``band``, the ``transition_band`` of tlat's stack (made
    here when None: one host read; a caller with several chunks makes it
    once), and gives the dense product's bits."""
    T, L = w.shape
    n_dyn = tlat.shape[0]
    _check_dims(n_dyn, L, uniform_rows)
    dev = w.device
    _check("w", w, (T, L), dev)
    _check("tlat", tlat, (n_dyn, L, L), dev)
    _check("tdyn", tdyn, (n_dyn, n_dyn), dev)
    _check("p_init", p_init, (n_dyn, L), dev)
    if band is not None:
        check_band(band, uniform_rows, L, dev)
    if dev.type == "cpu":
        return filter_scan_plain(w, tlat, tdyn, p_init, uniform_rows)
    if dev.type != "cuda":
        raise ValueError(f"filter_scan runs on cpu or cuda, not {dev.type}")
    if T == 0:
        return (torch.empty((0, n_dyn, L), dtype=torch.float32, device=dev),
                torch.empty((0, n_dyn, L), dtype=torch.float32, device=dev),
                torch.empty((0,), dtype=torch.float32, device=dev))
    err, out = _launch_filter(w[None], tlat, tdyn, p_init[None], None,
                              uniform_rows, band)
    filter_scan.launches += 1
    _raise_on(err, "filter_scan")
    return tuple(x[0] for x in out)


filter_scan.launches = 0


def filter_scan_batch(w, tlat, tdyn, p_init, lengths, uniform_rows,
                      band=None, cfg=None, norm_only=False):
    """K1 over a batch of sequences, one thread block each, in one launch:
    same arguments and outputs as ``filter_scan_batch_plain`` (lengths: an
    int32 tensor on w's device, every entry in [1, Tmax]), but the rows
    past a sequence's length are left unwritten.  Each sequence's rows are
    bit-equal to ``filter_scan`` on that sequence alone under its own
    transition.

    ``cfg``: an int32 (E,) tensor on w's device; tlat (G, n_dyn, L, L) and
    tdyn (G, n_dyn, n_dyn) then stack G configurations that share the
    constant-channel flags ``uniform_rows``, and sequence e runs under
    configuration cfg[e] (``band``: the stacked band of the G, made here
    when None).  ``norm_only``: return (None, None, norm); the kernel
    skips its row stores and the normalisers keep their bits."""
    E, Tmax, L = w.shape
    n_dyn = tlat.shape[-3]
    _check_dims(n_dyn, L, uniform_rows)
    dev = w.device
    _check("w", w, (E, Tmax, L), dev, batch=True)
    G = _check_stack("tlat", tlat, tdyn, cfg, E, n_dyn, L, dev)
    _check("p_init", p_init, (E, n_dyn, L), dev)
    _check_lengths(lengths, E, Tmax, dev, shortest=1)
    if band is not None:
        check_band(band, uniform_rows, L, dev, n_config=G)
    if dev.type == "cpu":
        out = filter_scan_batch_plain(w, tlat, tdyn, p_init, lengths,
                                      uniform_rows, cfg)
        return (None, None, out[2]) if norm_only else out
    if dev.type != "cuda":
        raise ValueError(
            f"filter_scan_batch runs on cpu or cuda, not {dev.type}")
    if E == 0:
        rows = None if norm_only else torch.empty((0, Tmax, n_dyn, L),
                                                  device=dev)
        return rows, rows, torch.empty((0, Tmax), device=dev)
    err, out = _launch_filter(w, tlat, tdyn, p_init, lengths, uniform_rows,
                              band, cfg, store=not norm_only)
    filter_scan_batch.launches += 1
    _count_mode(filter_scan_batch,
                "norm" if norm_only else _stack_mode(cfg))
    _raise_on(err, "filter_scan_batch")
    return out


filter_scan_batch.launches = 0
#: launches by mode: "shared" (one transition for the batch), "cfg" (a
#: configuration per sequence), "norm" (norm-only, either)
filter_scan_batch.launches_by_mode = {}


def _weights(ll, likelihood_scale):
    """(w, m): the max-shifted likelihood weights of the last axis."""
    m = ll.amax(dim=-1)
    return torch.exp(likelihood_scale * (ll - m[..., None])).contiguous(), m


def filter_chunk(ll, tlat, tdyn, p_init, likelihood_scale, uniform_rows=None,
                 band=None):
    """Causal filter over (T, L) log-likelihoods (``filter_chunk_pallas``).

    ll: (T, L); tlat: (n_dyn, L, L) row-stochastic; tdyn: (n_dyn, n_dyn);
    p_init: (n_dyn, L) probability-space carry; ``band``: the
    ``transition_band`` of tlat, see ``filter_scan``.
    Returns (post (T, n_dyn, L), prior (T, n_dyn, L), ratios (T,))."""
    if uniform_rows is None:
        uniform_rows = _detect_uniform_rows(tlat)
    w, m = _weights(ll, likelihood_scale)
    post, prior, norm = filter_scan(
        w, tlat.contiguous(), tdyn.contiguous(), p_init.contiguous(),
        uniform_rows, band,
    )
    return post, prior, torch.log(norm) + likelihood_scale * m


def filter_chunk_batch(ll, tlat, tdyn, p_init, lengths, likelihood_scale,
                       uniform_rows=None, band=None, cfg=None,
                       norm_only=False):
    """``filter_chunk`` over a batch: ll (E, Tmax, L), p_init (E, n_dyn,
    L), lengths (E,) int32; ``cfg`` and ``norm_only`` as for
    ``filter_scan_batch`` (``uniform_rows`` None: detected on the first
    configuration).  Returns (post, prior (E, Tmax, n_dyn, L), or None
    with ``norm_only``, ratios (E, Tmax)); the ratios are 0 past each
    sequence's length, so their sum over time is the sequence's log
    marginal."""
    if uniform_rows is None:
        uniform_rows = _detect_uniform_rows(tlat.reshape(-1, *tlat.shape[-3:])[0])
    w, m = _weights(ll, likelihood_scale)
    post, prior, norm = filter_scan_batch(
        w, tlat.contiguous(), tdyn.contiguous(), p_init.contiguous(),
        lengths, uniform_rows, band, cfg=cfg, norm_only=norm_only,
    )
    valid = _valid_rows(lengths, ll.shape[1])
    ratios = torch.log(torch.where(valid, norm, 1.0)) + likelihood_scale * m
    return post, prior, torch.where(valid, ratios, 0.0)


# ---------------------------------------------------------------------------
# K2: backward smoother
# ---------------------------------------------------------------------------


def smoother_scan_plain(filt, prior, tlat_t, tdyn, init, uniform_rows):
    """Plain version of K2.  filt, prior: (T, n_dyn, L) filter posteriors
    and +1-shifted priors; tlat_t: (n_dyn, L, L) TRANSPOSED latent kernels;
    tdyn (n_dyn, n_dyn); init (n_dyn, L) smoothed posterior after the last
    row.  Returns smooth and the ratios r (T, n_dyn, L)."""
    T = filt.shape[0]
    smooth = torch.empty_like(filt)
    rout = torch.empty_like(filt)
    carry = init
    for t in range(T - 1, -1, -1):
        carry, smooth[t], rout[t] = _smooth_step_plain(
            carry, prior[t], filt[t], tlat_t, tdyn, uniform_rows)
    return smooth, rout


def _smooth_step_plain(carry, prior_next, filt, tlat_t, tdyn, uniform_rows):
    """One step of K2's plain version: (carry, smoothed row, r)."""
    r = smoother_ratio(carry, prior_next)
    rows = []
    for e in range(filt.shape[0]):
        if uniform_rows[e]:
            rows.append(r[e].sum() * tlat_t[e, 0])
        else:
            rows.append(r[e] @ tlat_t[e])  # = Tlat[e] @ r[e]
    out = tdyn @ torch.stack(rows)  # out[d] = sum_e Tdyn[d, e] pull[e]
    v = filt * out
    carry = v / torch.clamp(v.sum(), min=NORM_FLOOR)
    return carry, carry, r


def smoother_scan_batch_plain(filt, prior, tlat_t, tdyn, init, lengths,
                              uniform_rows, cfg=None):
    """Plain version of K2 over a batch: ``smoother_scan_plain`` on each
    sequence's own rows.  filt, prior (E, Tmax, n_dyn, L); init (E, n_dyn,
    L); lengths (E,), 0 for a sequence with nothing to smooth over; with
    ``cfg`` (E,) sequence e runs under tlat_t[cfg[e]] and tdyn[cfg[e]].
    Returns smooth and r (E, Tmax, n_dyn, L), zero past each length."""
    smooth = torch.zeros(filt.shape, dtype=filt.dtype, device=filt.device)
    rout = torch.zeros_like(smooth)
    for e, n in enumerate(lengths.tolist()):
        if n:
            tl, td = _seq_transition(tlat_t, tdyn, cfg, e)
            smooth[e, :n], rout[e, :n] = smoother_scan_plain(
                filt[e, :n], prior[e, :n], tl, td, init[e], uniform_rows)
    return smooth, rout


def _launch_smoother(filt, prior, tlat_t, tdyn, init, lengths, uniform_rows,
                     band, cfg=None):
    """One K2 launch over the batch filt, prior (E, Tmax, n_dyn, L), E and
    Tmax >= 1; ``lengths`` None runs Tmax rows of every sequence."""
    E, Tmax, n_dyn, L = filt.shape
    dev = filt.device
    smooth = torch.empty((E, Tmax, n_dyn, L), dtype=torch.float32, device=dev)
    rout = torch.empty_like(smooth)
    band = _band_for(band, None, tlat_t, uniform_rows)
    # the pull half is the second, contiguous half of each band
    mats, win0, *strides = _stack_args(band, 1, tlat_t, tdyn, cfg)
    with torch.cuda.device(dev):
        err = _lib().pmg_smoother_scan(
            filt.data_ptr(), prior.data_ptr(), tlat_t.data_ptr(), mats, win0,
            tdyn.data_ptr(), init.data_ptr(), _ptr(lengths), _ptr(cfg),
            smooth.data_ptr(), rout.data_ptr(), filt.stride(0),
            prior.stride(0), *strides, E, Tmax, n_dyn, L, band.W,
            _mask(uniform_rows), _stream_ptr(dev),
        )
    return err, (smooth, rout)


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
    if T == 0:  # nothing to smooth over (a T=1 sequence): launch nothing
        return (torch.empty((0, n_dyn, L), dtype=torch.float32, device=dev),
                torch.empty((0, n_dyn, L), dtype=torch.float32, device=dev))
    err, out = _launch_smoother(filt[None], prior[None], tlat_t, tdyn,
                                init[None], None, uniform_rows, band)
    smoother_scan.launches += 1
    _raise_on(err, "smoother_scan")
    return tuple(x[0] for x in out)


smoother_scan.launches = 0


def smoother_scan_batch(filt, prior, tlat_t, tdyn, init, lengths,
                        uniform_rows, band=None, cfg=None):
    """K2 over a batch of sequences, one thread block each, in one launch:
    same arguments and outputs as ``smoother_scan_batch_plain`` (lengths:
    an int32 tensor on filt's device, every entry in [0, Tmax]), but the
    rows past a sequence's length are left unwritten.  filt and prior may
    be slices along time of larger batched arrays (the filter's outputs:
    ``post[:, :-1]``, ``prior[:, 1:]``): the kernel takes their stride
    between sequences.  Each sequence's rows are bit-equal to
    ``smoother_scan`` on that sequence alone under its own transition.
    ``cfg``: as for ``filter_scan_batch``, with tlat_t (G, n_dyn, L, L)
    the transposed stacks."""
    E, Tmax, n_dyn, L = filt.shape
    _check_dims(n_dyn, L, uniform_rows)
    dev = filt.device
    _check("filt", filt, (E, Tmax, n_dyn, L), dev, batch=True)
    _check("prior", prior, (E, Tmax, n_dyn, L), dev, batch=True)
    G = _check_stack("tlat_t", tlat_t, tdyn, cfg, E, n_dyn, L, dev)
    _check("init", init, (E, n_dyn, L), dev)
    _check_lengths(lengths, E, Tmax, dev, shortest=0)
    if band is not None:
        check_band(band, uniform_rows, L, dev, n_config=G)
    if dev.type == "cpu":
        return smoother_scan_batch_plain(filt, prior, tlat_t, tdyn, init,
                                         lengths, uniform_rows, cfg)
    if dev.type != "cuda":
        raise ValueError(
            f"smoother_scan_batch runs on cpu or cuda, not {dev.type}")
    if E == 0 or Tmax == 0:  # nothing to smooth over: launch nothing
        return (torch.empty((E, Tmax, n_dyn, L), device=dev),
                torch.empty((E, Tmax, n_dyn, L), device=dev))
    err, out = _launch_smoother(filt, prior, tlat_t, tdyn, init, lengths,
                                uniform_rows, band, cfg)
    smoother_scan_batch.launches += 1
    _count_mode(smoother_scan_batch, _stack_mode(cfg))
    _raise_on(err, "smoother_scan_batch")
    return out


smoother_scan_batch.launches = 0
#: launches by mode: "shared" or "cfg", as for filter_scan_batch
smoother_scan_batch.launches_by_mode = {}


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


def smoother_chunk_batch(filt_xs, prior_xs, tlat, tdyn, smooth_init, lengths,
                         uniform_rows=None, band=None, cfg=None):
    """``smoother_chunk`` over a batch: filt_xs, prior_xs (E, T', n_dyn,
    L) (slices along time of the filter's outputs are read in place),
    smooth_init (E, n_dyn, L), lengths (E,) int32 rows to smooth over;
    ``cfg`` as for ``filter_chunk_batch``.  Returns (smooth, ratios) (E,
    T', n_dyn, L)."""
    if uniform_rows is None:
        uniform_rows = _detect_uniform_rows(tlat.reshape(-1, *tlat.shape[-3:])[0])
    tlat_t = tlat.transpose(-1, -2).contiguous()
    return smoother_scan_batch(
        _as_rows(filt_xs), _as_rows(prior_xs), tlat_t, tdyn.contiguous(),
        smooth_init.contiguous(), lengths, uniform_rows, band, cfg=cfg,
    )


# ---------------------------------------------------------------------------
# K2 with the prior recomputed: the 'filter' memory modes' smoother
# ---------------------------------------------------------------------------


def smoother_push_scan_plain(filt, tlat, tlat_t, tdyn, init, uniform_rows):
    """Plain version of K2 with the prior recomputed.  filt (T, n_dyn, L)
    float32 or bfloat16 filter posteriors; tlat and tlat_t (n_dyn, L, L);
    tdyn (n_dyn, n_dyn); init (n_dyn, L).  Each step's +1-shifted prior is
    ``_push_plain`` of its filter row (K1's plain push, so on f32 rows the
    plain filter's prior bits), then K2's plain step.  Returns smooth and
    the ratios r (T, n_dyn, L), float32."""
    T = filt.shape[0]
    smooth = torch.empty(filt.shape, dtype=torch.float32, device=filt.device)
    rout = torch.empty_like(smooth)
    carry = init
    for t in range(T - 1, -1, -1):
        f = filt[t].float()
        carry, smooth[t], rout[t] = _smooth_step_plain(
            carry, _push_plain(f, tlat, tdyn, uniform_rows), f, tlat_t, tdyn,
            uniform_rows)
    return smooth, rout


#: K2 with the prior recomputed (``csrc/scan_kernels.cu``), the tests'
#: mirror of its host code's plan: its ring depths in the order tried, and
#: the shared memory a scan kernel's layout may take
#: (``scan_common.cuh::kResidentCap``)
PUSH_STAGES = (4, 3, 2)
RESIDENT_CAP = 200 * 1024


def _align16(n):
    return -(-n // 16) * 16


def push_cluster_bytes(n_dyn, n_mat, L, W, filt_bytes, stages, resident):
    """Shared memory of each block of K2 with the prior recomputed
    (``scan_kernels.cu::push_layout``): the barriers and the ring of prior
    codes (f64), then the larger of the producer's part (the filter-row
    stages, two mixed rows, the push half of the band when resident) and
    the consumer's (r, the pull half when resident)."""
    vec = 4 * n_dyn * L
    half = 4 * n_mat * W * L if resident else 0
    ring = _align16(_align16(3 * stages * 8) + stages * n_dyn * L * 8)
    q = ring + stages * (_align16(n_dyn * L * filt_bytes) + 16)
    prod = _align16(_align16(q + 2 * vec) + half)
    cons = _align16(_align16(ring + vec) + half)
    return max(prod, cons)


def push_plan(n_dyn, n_mat, L, W, bf16):
    """The launch plan of K2 with the prior recomputed, a mirror of the
    kernel's host code (``push_plan_of``; the card tests hold the two
    together through ``pmg_smoother_push_smem``): ``design`` 'cluster', a
    cluster of two blocks of ``threads`` each (one consumer thread per
    latent column, running K2's step; a producer block forming the priors
    ``stages`` rows ahead into the consumer's ring) at every L; both
    halves of the band ``resident`` where the layout fits ``RESIDENT_CAP``
    with them at 2 stages, else read from L2; ``stages`` the most of
    ``PUSH_STAGES`` that fit; ``smem`` bytes of dynamic shared memory per
    block."""
    W = W if n_mat else 0
    fb = 2 if bf16 else 4
    resident = push_cluster_bytes(n_dyn, n_mat, L, W, fb, 2,
                                  True) <= RESIDENT_CAP
    S = next(S for S in PUSH_STAGES if push_cluster_bytes(
        n_dyn, n_mat, L, W, fb, S, resident) <= RESIDENT_CAP)
    return {"design": "cluster", "threads": -(-L // 32) * 32, "cluster": 2,
            "stages": S, "resident": resident,
            "smem": push_cluster_bytes(n_dyn, n_mat, L, W, fb, S, resident)}


def smoother_push_scan(filt, tlat, tlat_t, tdyn, init, uniform_rows,
                       band=None):
    """K2 with the prior recomputed: same arguments and outputs as
    ``smoother_push_scan_plain``.  On the card one launch reads the
    non-constant channels through both halves of ``band`` (the push for
    the prior, the pull for the smoother; made here when None) and gives
    what K2 gives on the priors K1 wrote, bit for bit, for f32 rows, on a
    cluster of two blocks (``push_plan``'s plan).  Counts its launches in
    ``launches`` and ``launches_by_mode`` ("f32", "bf16": the store it
    read)."""
    T, n_dyn, L = filt.shape
    _check_dims(n_dyn, L, uniform_rows)
    dev = filt.device
    if filt.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"filt must be float32 or bfloat16, got {filt.dtype}")
    if not filt.is_contiguous():
        raise ValueError("filt must be contiguous")
    if filt.device != dev:
        raise ValueError(f"filt is on {filt.device}, expected {dev}")
    _check("tlat", tlat, (n_dyn, L, L), dev)
    _check("tlat_t", tlat_t, (n_dyn, L, L), dev)
    _check("tdyn", tdyn, (n_dyn, n_dyn), dev)
    _check("init", init, (n_dyn, L), dev)
    if band is not None:
        check_band(band, uniform_rows, L, dev)
    if dev.type == "cpu":
        return smoother_push_scan_plain(filt, tlat, tlat_t, tdyn, init,
                                        uniform_rows)
    if dev.type != "cuda":
        raise ValueError(
            f"smoother_push_scan runs on cpu or cuda, not {dev.type}")
    smooth = torch.empty((T, n_dyn, L), dtype=torch.float32, device=dev)
    rout = torch.empty_like(smooth)
    if T == 0:  # nothing to smooth over: launch nothing
        return smooth, rout
    band = _band_for(band, tlat, tlat_t, uniform_rows)
    bf16 = filt.dtype == torch.bfloat16
    with torch.cuda.device(dev):
        err = _lib().pmg_smoother_push_scan(
            filt.data_ptr(), tlat.data_ptr(), tlat_t.data_ptr(),
            band.mats.data_ptr(), band.start.data_ptr(), tdyn.data_ptr(),
            init.data_ptr(), smooth.data_ptr(), rout.data_ptr(), T, n_dyn,
            L, band.W, _mask(uniform_rows), int(bf16), _stream_ptr(dev),
        )
    smoother_push_scan.launches += 1
    _count_mode(smoother_push_scan, "bf16" if bf16 else "f32")
    _raise_on(err, "smoother_push_scan")
    return smooth, rout


smoother_push_scan.launches = 0
#: launches by the store read: "f32" ('filter') or "bf16" ('filter_bf16')
smoother_push_scan.launches_by_mode = {}


def smoother_push_chunk(filt_xs, tlat, tdyn, smooth_init, uniform_rows=None,
                        band=None):
    """Backward smoother over (T', n_dyn, L) stored filter posteriors
    (float32 or bfloat16), each +1-shifted prior recomputed from its row
    (``smoother_push_scan``).  Returns (smooth, ratios) (T', n_dyn, L)."""
    if uniform_rows is None:
        uniform_rows = _detect_uniform_rows(tlat)
    tlat = tlat.contiguous()
    return smoother_push_scan(
        filt_xs.contiguous(), tlat, tlat.transpose(-1, -2).contiguous(),
        tdyn.contiguous(), smooth_init.contiguous(), uniform_rows, band,
    )
