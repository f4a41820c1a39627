"""Parallel-in-time (chunked fixed-point) forward-backward smoother.

Counterpart of ``poor_man_gplvm_tpu/ops/pallas/parallel_scan.py``.  The
sequence of T steps is cut into C chunks of ``tc = ceil(T / C)`` rows;
chunk c owns global rows [c*tc, (c+1)*tc) clipped to T.  Every pass runs
all chunks at once, each from its boundary carry, and the carries are
solved by fixed-point iteration over whole passes:

    pass k:   run all chunks from ins_k -> finals_k
    update:   ins_{k+1} = shift(finals_k)   (chunk 0's input is exact)
    stop:     max |ins_{k+1} - ins_k| <= tol, or after C passes

The fixed point is the exact sequential recursion, and C passes make it
exact by induction, so the answer carries a convergence certificate.

The Pallas TPU kernels become hand-written CUDA kernels for Hopper
(``csrc/parallel_scan.cu``; its header says what bounds them on the card):

* K3 ``pfilter_pass``  <- ``_pfilter_kernel`` / ``_pfilter_pass``
  (finals-only and emit), on the push half of the band of each channel's
  nonzeros (``ops/band.py::transition_band``)
* K4 ``psmooth_pass``  <- ``_psmooth_kernel`` / ``_psmooth_pass``
  (finals-only, full, marginal, and marginal with the pairwise joint), on
  both halves of the band
* K5, inside K3/K4: the recursion dot in ``"highest"``, ``"bf16x3"`` or
  ``"bf16"`` precision (``_split_bf16`` / ``_scan_dot``), selected by
  ``set_scan_precision``
* ``joint_acc`` <- the pairwise-joint epilogue of ``_psmooth_kernel``'s
  marginal mode, as a kernel of its own over the ratios K4 writes, on the
  tensor cores in 3xTF32

Each wrapper checks its inputs, allocates its outputs with ``torch.empty``
and launches on the current stream without synchronising.  On a CPU tensor
it runs its plain PyTorch version instead (``*_plain``: batched torch ops
over the C chunks, one Python step per row); on a CUDA tensor it launches
the kernel or raises.  Each wrapper counts its launches in
``<wrapper>.launches`` and, per mode and precision, in
``<wrapper>.launches_by_mode`` (keys ``"<mode>/<precision>"``, and also
``"<mode>/<precision>/nv"`` for a launch whose validity bound ``n_valid``
is not the row count, a time shard's pass in ``parallel/spmd.py``).

Layout: Hopper needs no 128-lane padding and the kernels need no
chunk-major copy: the weights w (T, L) and the posteriors (T, n_dyn, L) are
read and written in global time order, and the boundary carries are
(C, n_dyn, L).
"""

from __future__ import annotations

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.ops.band import (  # noqa: F401 (re-exported)
    Band,
    _gather_band,
    band_windows,
    check_band,
    set_band_override,
    split_bf16,
    transition_band,
)
from poor_man_gplvm_tpu_torch.ops.scan_kernels import (
    NORM_FLOOR,
    _check,
    _check_dims,
    _mask,
    _raise_on,
    _stream_ptr,
    smoother_ratio,
)

__all__ = [
    "SCAN_PRECISIONS",
    "PSMOOTH_MODES",
    "set_scan_precision",
    "scan_mode_key",
    "set_config_override",
    "set_band_override",
    "Band",
    "band_windows",
    "transition_band",
    "split_bf16",
    "scan_dot",
    "choose_parallel_config",
    "carry_spec",
    "pfilter_pass",
    "pfilter_pass_plain",
    "psmooth_pass",
    "psmooth_pass_plain",
    "joint_acc",
    "joint_acc_plain",
    "smooth_parallel",
]

SCAN_PRECISIONS = ("highest", "bf16x3", "bf16")
_PREC_CODE = {p: i for i, p in enumerate(SCAN_PRECISIONS)}
#: K4 output modes: boundary carries only; smooth and r (T, n_dyn, L); the
#: latent (T, L) and dynamics (T, n_dyn) marginals; the marginals and the
#: raw pairwise joint sum_t post[t, d]^T r[t, e] (n_dyn, n_dyn, L, L)
PSMOOTH_MODES = ("finals", "full", "marginal", "marginal_acc")

# ---------------------------------------------------------------------------
# configuration knobs (module state, as in the JAX package)
# ---------------------------------------------------------------------------

#: manual (C, block_t_fwd, block_t_bwd) override of the launch config
_CONFIG_OVERRIDE = None
#: precision of the fixed-point recursion dots
_SCAN_PRECISION = "highest"


def set_scan_precision(mode):
    """Set the precision of the parallel-scan recursion dots (K5).

    - ``"highest"`` (default): f32 FMAs, the reference-parity numerics;
    - ``"bf16x3"``: the 3-pass hi/lo bf16 split, a_hi.b_hi + a_lo.b_hi +
      a_hi.b_lo with f32 sums (~5e-7 element error on the dots; the
      per-step normalisation keeps it from accumulating);
    - ``"bf16"``: one bf16 pass, bf16(a).b_hi (~1e-3 posterior error).

    Read by ``smooth_parallel`` at each call; the port caches no program,
    so a flip takes effect at the next solve."""
    global _SCAN_PRECISION
    if mode not in SCAN_PRECISIONS:
        raise ValueError(f"unknown scan precision {mode!r}")
    _SCAN_PRECISION = mode


def scan_mode_key():
    """(config override, scan precision): the module state a caller that
    caches per-shape decisions keys on."""
    return (_CONFIG_OVERRIDE, _SCAN_PRECISION)


def set_config_override(cfg):
    """Force the launch config to ``cfg = (C, block_t_fwd, block_t_bwd)``,
    or restore the automatic choice with ``None``.  As in the JAX package
    the override replaces the chunk count before the rule that shrinks C
    for short sequences; the JAX package's VMEM clamps are a TPU fact and
    are not ported."""
    global _CONFIG_OVERRIDE
    _CONFIG_OVERRIDE = None if cfg is None else tuple(int(v) for v in cfg)


def scan_dot(a, b, mode, b_hilo=None):
    """One recursion dot ``a @ b`` under scan precision ``mode``, as the
    JAX package's ``_scan_dot``: bf16 operands enter f32 products with f32
    sums (a product of two bf16 values is exact in f32).  ``b_hilo`` is
    the weight operand's precomputed ``split_bf16``."""
    if mode == "highest":
        return a @ b
    b_hi, b_lo = b_hilo if b_hilo is not None else split_bf16(b)
    b_hi = b_hi.float()
    if mode == "bf16":
        return a.to(torch.bfloat16).float() @ b_hi
    if mode != "bf16x3":
        raise ValueError(f"unknown scan precision {mode!r}")
    a_hi, a_lo = (v.float() for v in split_bf16(a))
    return a_hi @ b_hi + a_lo @ b_hi + a_hi @ b_lo.float()


def choose_parallel_config(T, L, n_dyn):
    """(C, block_t_fwd, block_t_bwd) for the fixed-point scans, or None when
    the sequence is too short to chunk (the caller then runs the sequential
    engine).

    The JAX package's chunk-count rule: C starts at 128 (or at the
    override's C) and halves while T < C * bt_f * 8 (each chunk amortises
    its boundary solve over >= 8 blocks of bt_f rows), with bt_f = 16 up to
    L = 256 and 8 above.  Its VMEM budget clamps are a TPU fact and are not
    ported (they do not bind at L <= 500).  The port's kernels do not block
    time, so bt_f and bt_b enter only this rule; they are returned so the
    tuple equals JAX's."""
    del n_dyn  # the rule depends on it only through the TPU VMEM clamps
    if _CONFIG_OVERRIDE is not None:
        C, bt_f, bt_b = _CONFIG_OVERRIDE
    else:
        C = 128
        bt_f = 16 if L <= 256 else 8
        bt_b = bt_f if L <= 256 else 2
    while C > 2 and T < C * bt_f * 8:
        C //= 2
    if C < 2 or T < 4 * bt_f:
        return None
    return C, bt_f, bt_b


def carry_spec(T, L, n_dyn, config=None):
    """Shape of the boundary-carry arrays, (C, n_dyn, L), or None when the
    parallel engine does not apply."""
    if config is None:
        config = choose_parallel_config(T, L, n_dyn)
    if config is None:
        return None
    return (config[0], max(1, n_dyn), L)


def _lib():
    from poor_man_gplvm_tpu_torch.ops._build import load_parallel_scan

    return load_parallel_scan()


def _check_chunks(T, C, tc):
    if T < 1 or C < 1 or tc < 1 or C * tc < T:
        raise ValueError(f"C={C} chunks of tc={tc} rows must cover T={T}")


def _n_valid(n_valid, T, extra):
    """The validity bound of a pass over T rows: T when None, else an int
    in [0, T + extra] (``extra`` 0 for K3, 1 for K4)."""
    if n_valid is None:
        return T
    n_valid = int(n_valid)
    if not 0 <= n_valid <= T + extra:
        raise ValueError(f"n_valid={n_valid} must lie in [0, {T + extra}]")
    return n_valid


def _check_prec(scan_prec):
    if scan_prec not in SCAN_PRECISIONS:
        raise ValueError(f"unknown scan precision {scan_prec!r}")


def _splits(mats, scan_prec, splits):
    """Per-channel bf16 splits of ``mats`` (n_dyn, L, L): None in
    "highest", else ``splits`` if given (hi, lo), or made here."""
    if scan_prec == "highest":
        return None
    return split_bf16(mats) if splits is None else splits


def _count(fn, mode, scan_prec, shard=False):
    """Count a launch under ``<mode>/<precision>``, and with ``shard`` (a
    validity bound other than T) also under ``<mode>/<precision>/nv``."""
    fn.launches += 1
    key = f"{mode}/{scan_prec}"
    for k in (key, f"{key}/nv") if shard else (key,):
        fn.launches_by_mode[k] = fn.launches_by_mode.get(k, 0) + 1


def reset_launches():
    """Set every launch count of this module's wrappers to 0."""
    for fn in (pfilter_pass, psmooth_pass, joint_acc):
        fn.launches = 0
        fn.launches_by_mode = {}


def _matvec(v, mats, uniform_rows, scan_prec="highest", splits=None):
    """(C, n_dyn, L) rows times one (L, L) matrix per channel:
    out[:, d] = v[:, d] @ mats[d] under ``scan_prec`` (``splits``: the
    matrices' (hi, lo)); a constant channel takes sum(v) * row, in f32."""
    return torch.stack([
        v[:, d].sum(dim=-1, keepdim=True) * mats[d, 0] if flag
        else scan_dot(v[:, d], mats[d], scan_prec,
                      None if splits is None else (splits[0][d],
                                                   splits[1][d]))
        for d, flag in enumerate(uniform_rows)
    ], dim=1)


def _chunked(x, C, tc):
    """(T, ...) global rows -> (C, tc, ...), zero-padded past T."""
    pad = x.new_zeros((C * tc,) + tuple(x.shape[1:]))
    pad[:x.shape[0]] = x
    return pad.view((C, tc) + tuple(x.shape[1:]))


def _unchunked(xc, T):
    """(C, tc, ...) -> (T, ...) global rows."""
    return xc.reshape((-1,) + tuple(xc.shape[2:]))[:T]


# ---------------------------------------------------------------------------
# K3: filter pass
# ---------------------------------------------------------------------------


def pfilter_pass_plain(w, tlat, tdyn, ins, tc, uniform_rows, emit,
                       scan_prec="highest", splits=None, n_valid=None):
    """Plain version of K3.  w: (T, L) likelihood weights; tlat (n_dyn, L,
    L); tdyn (n_dyn, n_dyn); ins (C, n_dyn, L) boundary carries; tc rows
    per chunk; ``scan_prec`` the recursion-dot precision and ``splits``
    tlat's ``split_bf16`` (made here when None).  Row tau of chunk c
    (global row c*tc + tau) is a step when it is < ``n_valid`` (0 <=
    n_valid <= T, default T, the JAX kernel's runtime bound); the other
    rows pass the carry through, with norm 1.  Returns (post (T, n_dyn,
    L), norm (T,), finals (C, n_dyn, L)) with norm_t = max(s_t, 1e-38);
    post and norm are None unless ``emit``."""
    T = w.shape[0]
    C = ins.shape[0]
    nv = _n_valid(n_valid, T, 0)
    splits = _splits(tlat, scan_prec, splits)
    w_c = _chunked(w, C, tc)
    off = torch.arange(C, device=w.device) * tc
    carry = ins
    if emit:
        post_c = w.new_empty((C, tc) + tuple(ins.shape[1:]))
        norm_c = w.new_ones((C, tc))
    for tau in range(tc):
        valid = (off + tau) < nv
        q = torch.einsum("cpl,pd->cdl", carry, tdyn)
        u = _matvec(q, tlat, uniform_rows, scan_prec, splits) \
            * w_c[:, tau, None, :]
        s = torch.clamp(u.sum(dim=(1, 2)), min=NORM_FLOOR)
        carry = torch.where(valid[:, None, None], u / s[:, None, None], carry)
        if emit:
            post_c[:, tau] = carry
            norm_c[:, tau] = torch.where(valid, s, norm_c[:, tau])
    if not emit:
        return None, None, carry
    return _unchunked(post_c, T), _unchunked(norm_c, T), carry


def pfilter_pass(w, tlat, tdyn, ins, tc, uniform_rows, emit,
                 scan_prec="highest", splits=None, band=None, n_valid=None):
    """K3 wrapper: same arguments and outputs as ``pfilter_pass_plain``.
    On the card the kernel reads the non-constant channels through the
    push half of ``band``, their ``transition_band`` in ``scan_prec`` (made
    here when None; ``splits`` is then unused), and gives the dense
    product's bits."""
    T, L = w.shape
    C, n_dyn = ins.shape[:2]
    _check_dims(n_dyn, L, uniform_rows)
    _check_chunks(T, C, tc)
    nv = _n_valid(n_valid, T, 0)
    _check_prec(scan_prec)
    dev = w.device
    _check("w", w, (T, L), dev)
    _check("tlat", tlat, (n_dyn, L, L), dev)
    _check("tdyn", tdyn, (n_dyn, n_dyn), dev)
    _check("ins", ins, (C, n_dyn, L), dev)
    if band is not None:
        check_band(band, uniform_rows, L, dev, scan_prec)
    if dev.type == "cpu":
        return pfilter_pass_plain(w, tlat, tdyn, ins, tc, uniform_rows, emit,
                                  scan_prec, splits, nv)
    if dev.type != "cuda":
        raise ValueError(f"pfilter_pass runs on cpu or cuda, not {dev.type}")
    if band is None:
        band = transition_band(tlat, tlat.transpose(-1, -2).contiguous(),
                               uniform_rows, scan_prec)
    finals = torch.empty_like(ins)
    post = norm = None
    if emit:
        post = torch.empty((T, n_dyn, L), dtype=torch.float32, device=dev)
        norm = torch.empty((T,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        # the push half leads each of the band's tensors
        err = _lib().pmg_pfilter_pass(
            w.data_ptr(), tlat.data_ptr(), _ptr(band.mats), _ptr(band.hi),
            _ptr(band.lo), _ptr(band.start), tdyn.data_ptr(), ins.data_ptr(),
            finals.data_ptr(), _ptr(post), _ptr(norm), T, C, tc, nv, n_dyn,
            L,
            band.W, _mask(uniform_rows), int(emit), _PREC_CODE[scan_prec],
            _stream_ptr(dev),
        )
    _count(pfilter_pass, "emit" if emit else "finals", scan_prec, nv != T)
    _raise_on(err, "pfilter_pass")
    return post, norm, finals


def _ptr(x):
    return None if x is None else x.data_ptr()


# ---------------------------------------------------------------------------
# K4: smoother pass
# ---------------------------------------------------------------------------


def psmooth_pass_plain(post, tlat, tlat_t, tdyn, ins, tc, uniform_rows,
                       mode, scan_prec="highest", splits=None, n_valid=None):
    """Plain version of K4.  post: (T, n_dyn, L) filter posteriors; tlat
    and tlat_t (n_dyn, L, L) the latent kernels and their transposes; tdyn
    (n_dyn, n_dyn); ins (C, n_dyn, L) smoothed posteriors after each
    chunk's last row; ``splits`` the ``split_bf16`` of (tlat, tlat_t) when
    ``scan_prec`` is not "highest" (made here when None).  Per row,
    backward: prior = push(post_t) (K3's arithmetic), r = carry / prior
    (0 where the prior is below ``PRIOR_FLOOR``), pull, normalise.  A row
    is a step when its global index is < ``n_valid`` - 1 (0 <= n_valid <=
    T + 1, default T: every row but T - 1; T + 1: every row, the last
    reading the carry that ``ins`` gives after it); the others pass the
    carry through (and store r = 0).  Returns, by ``mode`` (see
    ``PSMOOTH_MODES``):

    * "finals": (None, None, finals (C, n_dyn, L));
    * "full": (smooth (T, n_dyn, L), r (T, n_dyn, L), finals);
    * "marginal": (lat (T, L), dyn (T, n_dyn), finals) with lat = sum_d
      smooth and dyn = sum_l smooth;
    * "marginal_acc": (lat, dyn, acc, finals) with the raw pairwise joint
      acc[d, e] = sum_t post[t, d]^T r[t, e] (``joint_acc_plain``)."""
    if mode not in PSMOOTH_MODES:
        raise ValueError(f"mode must be one of {PSMOOTH_MODES}, got {mode!r}")
    T = post.shape[0]
    C = ins.shape[0]
    nv = _n_valid(n_valid, T, 1)
    if splits is None and scan_prec != "highest":
        splits = (split_bf16(tlat), split_bf16(tlat_t))
    sp_f, sp_b = splits if splits is not None else (None, None)
    post_c = _chunked(post, C, tc)
    off = torch.arange(C, device=post.device) * tc
    carry = ins
    keep_r = mode in ("full", "marginal_acc")
    if mode == "full":
        smooth_c = torch.empty_like(post_c)
    elif mode != "finals":
        lat_c = post_c.new_empty(post_c.shape[:2] + post_c.shape[3:])
        dyn_c = post_c.new_empty(post_c.shape[:3])
    if keep_r:
        r_c = torch.empty_like(post_c)
    for tau in range(tc - 1, -1, -1):
        valid = ((off + tau) < nv - 1)[:, None, None]
        filt = post_c[:, tau]
        prior = _matvec(torch.einsum("cpl,pd->cdl", filt, tdyn), tlat,
                        uniform_rows, scan_prec, sp_f)
        r = torch.where(valid, smoother_ratio(carry, prior),
                        torch.zeros_like(prior))
        out = torch.einsum("de,cel->cdl", tdyn,
                           _matvec(r, tlat_t, uniform_rows, scan_prec, sp_b))
        sm = filt * out
        norm = torch.clamp(sm.sum(dim=(1, 2), keepdim=True), min=NORM_FLOOR)
        carry = torch.where(valid, sm / norm, carry)
        if keep_r:
            r_c[:, tau] = r
        if mode == "full":
            smooth_c[:, tau] = carry
        elif mode != "finals":
            lat_c[:, tau] = carry.sum(dim=1)
            dyn_c[:, tau] = carry.sum(dim=2)
    if mode == "finals":
        return None, None, carry
    if mode == "full":
        return _unchunked(smooth_c, T), _unchunked(r_c, T), carry
    lat, dyn = _unchunked(lat_c, T), _unchunked(dyn_c, T)
    if mode == "marginal":
        return lat, dyn, carry
    return lat, dyn, joint_acc_plain(post, _unchunked(r_c, T)), carry


def psmooth_pass(post, tlat, tlat_t, tdyn, ins, tc, uniform_rows, mode,
                 scan_prec="highest", splits=None, band=None, n_valid=None):
    """K4 wrapper: same arguments and outputs as ``psmooth_pass_plain``.
    On the card the kernel reads the non-constant channels through
    ``band``, their ``transition_band`` in ``scan_prec`` (made here when
    None; ``splits`` is then unused), and gives the dense product's bits.
    In "marginal_acc" mode K4 writes r to a (T, n_dyn, L) scratch that
    ``joint_acc`` then reduces (the TPU kernel's on-chip accumulator, 4 MB
    at L = 500, fits no SM's shared memory)."""
    T, n_dyn, L = post.shape
    C = ins.shape[0]
    _check_dims(n_dyn, L, uniform_rows)
    _check_chunks(T, C, tc)
    nv = _n_valid(n_valid, T, 1)
    _check_prec(scan_prec)
    if mode not in PSMOOTH_MODES:
        raise ValueError(f"mode must be one of {PSMOOTH_MODES}, got {mode!r}")
    dev = post.device
    _check("post", post, (T, n_dyn, L), dev)
    _check("tlat", tlat, (n_dyn, L, L), dev)
    _check("tlat_t", tlat_t, (n_dyn, L, L), dev)
    _check("tdyn", tdyn, (n_dyn, n_dyn), dev)
    _check("ins", ins, (C, n_dyn, L), dev)
    if band is not None:
        check_band(band, uniform_rows, L, dev, scan_prec)
    if dev.type == "cpu":
        return psmooth_pass_plain(post, tlat, tlat_t, tdyn, ins, tc,
                                  uniform_rows, mode, scan_prec, splits, nv)
    if dev.type != "cuda":
        raise ValueError(f"psmooth_pass runs on cpu or cuda, not {dev.type}")
    if band is None:
        band = transition_band(tlat, tlat_t, uniform_rows, scan_prec)
    finals = torch.empty_like(ins)
    out = out2 = out3 = None
    if mode == "full":
        out = torch.empty_like(post)
    elif mode != "finals":
        out = torch.empty((T, L), dtype=torch.float32, device=dev)
        out3 = torch.empty((T, n_dyn), dtype=torch.float32, device=dev)
    if mode in ("full", "marginal_acc"):
        out2 = torch.empty_like(post)
    with torch.cuda.device(dev):
        err = _lib().pmg_psmooth_pass(
            post.data_ptr(), tlat.data_ptr(), tlat_t.data_ptr(),
            _ptr(band.mats), _ptr(band.hi), _ptr(band.lo),
            _ptr(band.start), tdyn.data_ptr(), ins.data_ptr(),
            finals.data_ptr(), _ptr(out), _ptr(out2), _ptr(out3), T, C, tc,
            nv, n_dyn, L, band.W, _mask(uniform_rows),
            PSMOOTH_MODES.index(mode), _PREC_CODE[scan_prec],
            _stream_ptr(dev),
        )
    _count(psmooth_pass, mode, scan_prec, nv != T)
    _raise_on(err, "psmooth_pass")
    if mode == "finals":
        return None, None, finals
    if mode == "full":
        return out, out2, finals
    if mode == "marginal":
        return out, out3, finals
    return out, out3, joint_acc(post, out2), finals


# ---------------------------------------------------------------------------
# joint_acc: the pairwise-joint reduction of K4's marginal+acc mode
# ---------------------------------------------------------------------------

#: joint_acc's output tile (128 x 128, one block of 8 warps and 70 KB of
#: shared memory in flight per SM), the H100's SMs, and at most this many
#: time rows per split-K slice (rounding of long f32 sums)
_ACC_TILE = 128
_ACC_SMS = 132
_ACC_MAX_ROWS = 131_072
_ACC_STAGE_ROWS = 32


def joint_acc_plain(post, r):
    """Plain version of ``joint_acc``: acc[d, e, i, j] = sum_t post[t, d,
    i] * r[t, e, j] over (T, n_dyn, L) inputs, f32."""
    return torch.einsum("tdi,tej->deij", post, r)


def _acc_slices(T, M):
    """(S, rows per slice) of joint_acc's split over time: as many slices
    as keep the tiles x S blocks within one wave of the card (at least
    one, at least T / ``_ACC_MAX_ROWS``, at most one per 32-row stage)."""
    tiles = (-(-M // _ACC_TILE)) ** 2
    S = max(1, _ACC_SMS // tiles, -(-T // _ACC_MAX_ROWS))
    S = max(1, min(S, -(-T // _ACC_STAGE_ROWS)))
    return S, -(-T // S)


def _joint_acc_run(post, r, passes):
    """Launch joint_acc's kernels on (T, n_dyn, L) CUDA tensors: ``passes``
    3 is the 3xTF32 product, 1 the one-pass (hi.hi) control the tests hold
    against the limit."""
    T, n_dyn, L = post.shape
    dev = post.device
    _check_dims(n_dyn, L, (False,) * n_dyn)
    M = n_dyn * L
    S, rows = _acc_slices(T, M)
    partial = torch.empty((S, M, M), dtype=torch.float32, device=dev)
    acc = torch.empty((n_dyn, n_dyn, L, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().pmg_joint_acc(post.data_ptr(), r.data_ptr(),
                                   partial.data_ptr(), acc.data_ptr(), T,
                                   n_dyn, L, S, rows, passes,
                                   _stream_ptr(dev))
    _raise_on(err, "joint_acc")
    return acc


def joint_acc(post, r):
    """``joint_acc`` wrapper: same arguments and output as
    ``joint_acc_plain``.  On the card: the product on the tensor cores in
    3xTF32 (f32 accuracy), split-K over S slices of time into an (S,
    n_dyn*L, n_dyn*L) partial buffer, then a second kernel that adds the
    partials in slice order (deterministic)."""
    T, n_dyn, L = post.shape
    dev = post.device
    _check("post", post, (T, n_dyn, L), dev)
    _check("r", r, (T, n_dyn, L), dev)
    if dev.type == "cpu":
        return joint_acc_plain(post, r)
    if dev.type != "cuda":
        raise ValueError(f"joint_acc runs on cpu or cuda, not {dev.type}")
    _count(joint_acc, "acc", "highest")
    return _joint_acc_run(post, r, 3)


reset_launches()


# ---------------------------------------------------------------------------
# fixed-point driver
# ---------------------------------------------------------------------------


def _max_abs(a, b):
    return (a - b).abs().max()


def _solve(run_pass, shift, ins, tol, max_passes, pred=None, lam=None):
    """Fixed-point loop over whole passes, one host read of the movement
    per pass; returns (ins, passes, last movement).

    Strict (``pred`` None): a peeled first pass, then passes while the
    carries move by more than ``tol``, at most ``max_passes`` in all.
    Fast (``pred``, ``lam`` float32 scalars, the warm-started solve): the
    loop enters with delta = ``pred`` (which may already pass, i.e. no
    pass at all) and runs while ``delta * lam > tol``."""
    if pred is None:
        new = shift(run_pass(ins))
        delta, passes = float(_max_abs(new, ins)), 1
        lam = np.float32(1.0)
    else:
        new, delta, passes = ins, float(pred), 0
    tol = np.float32(tol)
    while np.float32(delta) * lam > tol and passes < max_passes:
        ins, new = new, shift(run_pass(new))
        delta, passes = float(_max_abs(new, ins)), passes + 1
    return new, passes, delta


def _fast_terms(pred, valid, drift_i, resid_i):
    """(lam, predicted movement) of a fast warm-started solve, in float32
    as the JAX driver computes them: lam = clip(resid / drift, 1e-12, 1)
    from the previous solve, entry movement 4 * drift / lam; (1, inf)
    without a valid seed."""
    if not valid:
        return np.float32(1.0), np.float32(np.inf)
    drift, resid = np.float32(pred[drift_i]), np.float32(pred[resid_i])
    lam = np.float32(np.clip(resid / np.maximum(drift, np.float32(1e-30)),
                             np.float32(1e-12), np.float32(1.0)))
    return lam, np.float32(4.0) * drift / lam


def smooth_parallel(ll, tlat, tdyn, p_init, likelihood_scale, *,
                    uniform_rows, marginal=False, want_post=False,
                    config=None, max_passes=None, tol=1e-6,
                    warm_start=None, fast=False, want_carry=False,
                    want_acc=True):
    """Fixed-point parallel-in-time forward-backward smoother.

    ll: (T, L) log-likelihood; tlat (n_dyn, L, L); tdyn (n_dyn, n_dyn);
    p_init (n_dyn, L) probability-space initial carry.  The recursion dots
    run in the precision ``set_scan_precision`` set.

    Returns ``(smooth, log_marginal, post, ratios, acc, diag, carries)`` in
    PROBABILITY space:

    * smooth: (T, n_dyn, L), or the pair (latent marginal (T, L), dynamics
      marginal (T, n_dyn)) when ``marginal`` (K4's marginal modes);
    * post: the (T, n_dyn, L) filter posteriors when ``want_post``, else
      None; ratios: the per-step log ratios (T,);
    * acc: the pairwise joint (n_dyn, n_dyn, L, L), None unless
      ``want_acc`` (in marginal mode it comes from K4's ratios through
      ``joint_acc``, in full mode from an einsum outside the kernel);
    * diag = (fwd_passes, bwd_passes, fwd_delta, bwd_delta), followed by
      the emit passes' post-hoc residuals (emit_delta_f, emit_delta_b)
      when ``want_carry``;
    * carries: with ``want_carry``, (fwd, bwd, pred) -- the freshest
      boundary carries ((C, n_dyn, L) each, see ``carry_spec``) and pred =
      [drift_f, drift_b, emit_resid_f, emit_resid_b] (4,) -- else None.

    ``warm_start``: optional ``(fwd, bwd, pred, valid)``, the ``carries``
    of a previous same-shape solve and a bool.  Chunk 0's forward input and
    the backward inputs from the chunk holding row T-1 on stay exact.  In
    strict mode (``fast=False``) a seed still passes the delta <= tol
    certificate.  With ``fast=True`` the loops exit on the PREDICTED
    residual delta * lam (lam = previous emit residual / previous drift),
    enter with 4 * drift / lam (a seed already within tol skips every
    finals-only pass), and run no peeled pass; every fast solve is
    certified post-hoc by the emit passes' residuals (diag[4:6]), which
    the caller checks.  ``tol``: 1e-6 strict, 1e-4 for the fast mode's
    callers."""
    T, L = ll.shape
    n_dyn = tlat.shape[0]
    if config is None:
        config = choose_parallel_config(T, L, n_dyn)
    if config is None:
        raise ValueError(f"problem too small for the parallel engine (T={T})")
    C = config[0]
    tc = -(-T // C)
    if max_passes is None:
        max_passes = C
    prec = _SCAN_PRECISION
    tlat = tlat.to(torch.float32).contiguous()
    tdyn = tdyn.to(torch.float32).contiguous()
    tlat_t = tlat.transpose(-1, -2).contiguous()
    # once per solve: the band K3 and K4 read on the card, and the dense
    # bf16 splits that only the plain versions read, on the CPU
    band = transition_band(tlat, tlat_t, uniform_rows, prec)
    sp_f = sp_b = None
    if ll.device.type == "cpu" and prec != "highest":
        sp_f = split_bf16(tlat)
        sp_b = (sp_f, split_bf16(tlat_t))
    has_ws = warm_start is not None
    if has_ws:
        fwd_ws, bwd_ws, ws_pred, ws_valid = warm_start
        ws_valid = bool(ws_valid)
        ws_pred = (np.asarray(ws_pred.cpu() if torch.is_tensor(ws_pred)
                              else ws_pred, dtype=np.float32)
                   if fast and ws_valid else None)
    else:
        ws_valid = False
    use_fast = fast and has_ws

    # ---- forward fixed point (finals-only passes + one emitting pass) ----
    m = ll.amax(dim=1)
    w = torch.exp(likelihood_scale * (ll - m[:, None])).contiguous()
    ins0 = torch.full((C, n_dyn, L), 1.0 / (n_dyn * L), dtype=torch.float32,
                      device=ll.device)
    if ws_valid:
        ins0 = fwd_ws.to(torch.float32).clone()
    ins0[0] = p_init

    def fwd(ins):
        return pfilter_pass(w, tlat, tdyn, ins, tc, uniform_rows, False,
                            prec, sp_f, band)[2]

    def fwd_shift(fin):
        return torch.cat([ins0[:1], fin[:-1]])

    lam_f, pred_f = _fast_terms(ws_pred, ws_valid, 0, 2) if use_fast \
        else (None, None)
    ins_f, fwd_passes, fwd_delta = _solve(
        fwd, fwd_shift, ins0, tol, max_passes,
        pred=(pred_f if use_fast else (np.inf if has_ws else None)),
        lam=(lam_f if use_fast else np.float32(1.0)))
    post, norm, fin_emit = pfilter_pass(w, tlat, tdyn, ins_f, tc,
                                        uniform_rows, True, prec, sp_f, band)
    del w
    ratios = torch.log(norm) + likelihood_scale * m
    log_marginal = ratios.sum()

    # ---- backward fixed point ----
    # chunk c's boundary is the smoothed posterior of row (c+1)*tc; chunks
    # from c_star (which holds row T-1) on start from post_{T-1}, which is
    # exact, and the filter posterior of each boundary row is the guess
    c_star = (T - 1) // tc
    post_T1 = post[T - 1]
    if ws_valid:
        guess = bwd_ws.to(torch.float32).clone()
    else:
        rows = torch.arange(1, C + 1, device=ll.device) * tc
        guess = post[torch.clamp(rows, max=T - 1)].contiguous()
    guess[c_star:] = post_T1

    def bwd(ins):
        return psmooth_pass(post, tlat, tlat_t, tdyn, ins, tc, uniform_rows,
                            "finals", prec, sp_b, band)[2]

    def bwd_shift(fin):
        new = torch.cat([fin[1:], post_T1[None]])
        new[c_star:] = post_T1
        return new

    lam_b, pred_b = _fast_terms(ws_pred, ws_valid, 1, 3) if use_fast \
        else (None, None)
    ins_b, bwd_passes, bwd_delta = _solve(
        bwd, bwd_shift, guess, tol, max_passes,
        pred=(pred_b if use_fast else (np.inf if has_ws else None)),
        lam=(lam_b if use_fast else np.float32(1.0)))
    mode = ("marginal_acc" if want_acc else "marginal") if marginal \
        else "full"
    emit = psmooth_pass(post, tlat, tlat_t, tdyn, ins_b, tc, uniform_rows,
                        mode, prec, sp_b, band)
    fin_b = emit[-1]
    acc = None
    if marginal:
        smooth = (emit[0], emit[1])
        if want_acc:
            acc = emit[2]
    else:
        smooth = emit[0]
        if want_acc:
            # the pairwise-joint contraction runs outside the kernel, as in
            # the JAX package's full mode (rows that are not steps carry
            # r = 0)
            acc = torch.einsum("tdi,tej->deij", post, emit[1])
    if acc is not None:
        acc = acc * tdyn[:, :, None, None] * tlat[None]

    diag = (fwd_passes, bwd_passes, fwd_delta, bwd_delta)
    carries = None
    if want_carry:
        emit_ins_f = fwd_shift(fin_emit)
        emit_ins_b = bwd_shift(fin_b)
        resid_f = _max_abs(emit_ins_f, ins_f)
        resid_b = _max_abs(emit_ins_b, ins_b)
        pred = torch.stack([_max_abs(emit_ins_f, ins0),
                            _max_abs(emit_ins_b, guess), resid_f, resid_b])
        diag = diag + (resid_f, resid_b)
        carries = (emit_ins_f, emit_ins_b, pred)
    return (smooth, log_marginal, post if want_post else None, ratios, acc,
            diag, carries)
