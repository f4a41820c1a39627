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

The two Pallas TPU kernels become hand-written CUDA kernels for Hopper
(``csrc/parallel_scan.cu``; its header says what bounds them on the card):

* K3 ``pfilter_pass``  <- ``_pfilter_kernel`` / ``_pfilter_pass``
* K4 ``psmooth_pass``  <- ``_psmooth_kernel`` / ``_psmooth_pass``
  (finals-only and full modes; the two marginal modes are not ported)

Each wrapper checks its inputs, allocates its outputs with ``torch.empty``
and launches on the current stream without synchronising.  On a CPU tensor
it runs its plain PyTorch version instead (``*_plain``: batched torch ops
over the C chunks, one Python step per row); on a CUDA tensor it launches
the kernel or raises.  Each wrapper counts its launches in
``<wrapper>.launches``.

Layout: Hopper needs no 128-lane padding and the kernels need no
chunk-major copy: the weights w (T, L) and the posteriors (T, n_dyn, L) are
read and written in global time order, and the boundary carries are
(C, n_dyn, L).  The recursion dots are plain f32 FMAs (the JAX package's
default ``"highest"`` scan precision; ``bf16x3``/``bf16`` are not ported).
"""

from __future__ import annotations

import torch

from poor_man_gplvm_tpu_torch.ops.scan_kernels import (
    NORM_FLOOR,
    _check,
    _check_dims,
    _mask,
    _raise_on,
    _stream_ptr,
)

__all__ = [
    "choose_parallel_config",
    "carry_spec",
    "pfilter_pass",
    "pfilter_pass_plain",
    "psmooth_pass",
    "psmooth_pass_plain",
    "smooth_parallel",
]


def choose_parallel_config(T, L, n_dyn):
    """(C, block_t_fwd, block_t_bwd) for the fixed-point scans, or None when
    the sequence is too short to chunk (the caller then runs the sequential
    engine).

    The JAX package's chunk-count rule: C starts at 128 and halves while
    T < C * bt_f * 8 (each chunk amortises its boundary solve over >= 8
    blocks of bt_f rows), with bt_f = 16 up to L = 256 and 8 above.  Its
    VMEM budget clamps are a TPU fact and are not ported (they do not bind
    at L <= 500).  The port's kernels do not block time, so bt_f and bt_b
    enter only this rule; they are returned so the tuple equals JAX's."""
    del n_dyn  # the rule depends on it only through the TPU VMEM clamps
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


def _matvec(v, mats, uniform_rows):
    """(C, n_dyn, L) rows times one (L, L) matrix per channel:
    out[:, d] = v[:, d] @ mats[d]; a constant channel takes sum(v) * row."""
    return torch.stack([
        v[:, d].sum(dim=-1, keepdim=True) * mats[d, 0] if flag
        else v[:, d] @ mats[d]
        for d, flag in enumerate(uniform_rows)
    ], dim=1)


def _chunked(x, C, tc):
    """(T, ...) global rows -> (C, tc, ...), zero-padded past T."""
    pad = x.new_zeros((C * tc,) + tuple(x.shape[1:]))
    pad[:x.shape[0]] = x
    return pad.view((C, tc) + tuple(x.shape[1:]))


# ---------------------------------------------------------------------------
# K3: filter pass
# ---------------------------------------------------------------------------


def pfilter_pass_plain(w, tlat, tdyn, ins, tc, uniform_rows, emit):
    """Plain version of K3.  w: (T, L) likelihood weights; tlat (n_dyn, L,
    L); tdyn (n_dyn, n_dyn); ins (C, n_dyn, L) boundary carries; tc rows
    per chunk.  Row tau of chunk c (global row c*tc + tau) is a step when
    it is < T.  Returns (post (T, n_dyn, L), norm (T,), finals (C, n_dyn,
    L)) with norm_t = max(s_t, 1e-38); post and norm are None unless
    ``emit``."""
    T = w.shape[0]
    C = ins.shape[0]
    w_c = _chunked(w, C, tc)
    off = torch.arange(C, device=w.device) * tc
    carry = ins
    if emit:
        post_c = w.new_empty((C, tc) + tuple(ins.shape[1:]))
        norm_c = w.new_ones((C, tc))
    for tau in range(tc):
        valid = (off + tau) < T
        q = torch.einsum("cpl,pd->cdl", carry, tdyn)
        u = _matvec(q, tlat, uniform_rows) * w_c[:, tau, None, :]
        s = torch.clamp(u.sum(dim=(1, 2)), min=NORM_FLOOR)
        carry = torch.where(valid[:, None, None], u / s[:, None, None], carry)
        if emit:
            post_c[:, tau] = carry
            norm_c[:, tau] = torch.where(valid, s, norm_c[:, tau])
    if not emit:
        return None, None, carry
    return (post_c.reshape((C * tc,) + tuple(ins.shape[1:]))[:T],
            norm_c.reshape(-1)[:T], carry)


def pfilter_pass(w, tlat, tdyn, ins, tc, uniform_rows, emit):
    """K3 wrapper: same arguments and outputs as ``pfilter_pass_plain``."""
    T, L = w.shape
    C, n_dyn = ins.shape[:2]
    _check_dims(n_dyn, L, uniform_rows)
    _check_chunks(T, C, tc)
    dev = w.device
    _check("w", w, (T, L), dev)
    _check("tlat", tlat, (n_dyn, L, L), dev)
    _check("tdyn", tdyn, (n_dyn, n_dyn), dev)
    _check("ins", ins, (C, n_dyn, L), dev)
    if dev.type == "cpu":
        return pfilter_pass_plain(w, tlat, tdyn, ins, tc, uniform_rows, emit)
    if dev.type != "cuda":
        raise ValueError(f"pfilter_pass runs on cpu or cuda, not {dev.type}")
    finals = torch.empty_like(ins)
    post = norm = None
    if emit:
        post = torch.empty((T, n_dyn, L), dtype=torch.float32, device=dev)
        norm = torch.empty((T,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = _lib().pmg_pfilter_pass(
            w.data_ptr(), tlat.data_ptr(), tdyn.data_ptr(), ins.data_ptr(),
            finals.data_ptr(), post.data_ptr() if emit else None,
            norm.data_ptr() if emit else None, T, C, tc, n_dyn, L,
            _mask(uniform_rows), int(emit), _stream_ptr(dev),
        )
    pfilter_pass.launches += 1
    _raise_on(err, "pfilter_pass")
    return post, norm, finals


pfilter_pass.launches = 0


# ---------------------------------------------------------------------------
# K4: smoother pass
# ---------------------------------------------------------------------------


def psmooth_pass_plain(post, tlat, tlat_t, tdyn, ins, tc, uniform_rows,
                       emit):
    """Plain version of K4.  post: (T, n_dyn, L) filter posteriors; tlat
    and tlat_t (n_dyn, L, L) the latent kernels and their transposes; tdyn
    (n_dyn, n_dyn); ins (C, n_dyn, L) smoothed posteriors after each
    chunk's last row.  Per row, backward: prior = push(post_t), r =
    carry / prior (0 where the prior is 0), pull, normalise.  A row is a
    step when its global index is < T - 1; the others pass the carry
    through (and store r = 0).  Returns (smooth (T, n_dyn, L), r (T, n_dyn,
    L), finals (C, n_dyn, L)); smooth and r are None unless ``emit``."""
    T = post.shape[0]
    C = ins.shape[0]
    post_c = _chunked(post, C, tc)
    off = torch.arange(C, device=post.device) * tc
    carry = ins
    if emit:
        smooth_c = torch.empty_like(post_c)
        r_c = torch.empty_like(post_c)
    for tau in range(tc - 1, -1, -1):
        valid = ((off + tau) < T - 1)[:, None, None]
        filt = post_c[:, tau]
        prior = _matvec(torch.einsum("cpl,pd->cdl", filt, tdyn), tlat,
                        uniform_rows)
        pos = prior > 0
        r = torch.where(pos & valid, carry / torch.where(pos, prior, 1.0),
                        torch.zeros_like(prior))
        out = torch.einsum("de,cel->cdl", tdyn,
                           _matvec(r, tlat_t, uniform_rows))
        sm = filt * out
        norm = torch.clamp(sm.sum(dim=(1, 2), keepdim=True), min=NORM_FLOOR)
        carry = torch.where(valid, sm / norm, carry)
        if emit:
            smooth_c[:, tau] = carry
            r_c[:, tau] = r
    if not emit:
        return None, None, carry
    shape = (C * tc,) + tuple(post.shape[1:])
    return (smooth_c.reshape(shape)[:T], r_c.reshape(shape)[:T], carry)


def psmooth_pass(post, tlat, tlat_t, tdyn, ins, tc, uniform_rows, emit):
    """K4 wrapper: same arguments and outputs as ``psmooth_pass_plain``."""
    T, n_dyn, L = post.shape
    C = ins.shape[0]
    _check_dims(n_dyn, L, uniform_rows)
    _check_chunks(T, C, tc)
    dev = post.device
    _check("post", post, (T, n_dyn, L), dev)
    _check("tlat", tlat, (n_dyn, L, L), dev)
    _check("tlat_t", tlat_t, (n_dyn, L, L), dev)
    _check("tdyn", tdyn, (n_dyn, n_dyn), dev)
    _check("ins", ins, (C, n_dyn, L), dev)
    if dev.type == "cpu":
        return psmooth_pass_plain(post, tlat, tlat_t, tdyn, ins, tc,
                                  uniform_rows, emit)
    if dev.type != "cuda":
        raise ValueError(f"psmooth_pass runs on cpu or cuda, not {dev.type}")
    finals = torch.empty_like(ins)
    smooth = r = None
    if emit:
        smooth = torch.empty_like(post)
        r = torch.empty_like(post)
    with torch.cuda.device(dev):
        err = _lib().pmg_psmooth_pass(
            post.data_ptr(), tlat.data_ptr(), tlat_t.data_ptr(),
            tdyn.data_ptr(), ins.data_ptr(), finals.data_ptr(),
            smooth.data_ptr() if emit else None,
            r.data_ptr() if emit else None, T, C, tc, n_dyn, L,
            _mask(uniform_rows), int(emit), _stream_ptr(dev),
        )
    psmooth_pass.launches += 1
    _raise_on(err, "psmooth_pass")
    return smooth, r, finals


psmooth_pass.launches = 0


# ---------------------------------------------------------------------------
# fixed-point driver
# ---------------------------------------------------------------------------


def _solve(run_pass, shift, ins, tol, max_passes):
    """Peeled first pass, then passes while the carries move by more than
    ``tol`` (one host read of the movement per pass), at most
    ``max_passes`` in all.  Returns (ins, passes, last movement)."""
    new = shift(run_pass(ins))
    delta, passes = float((new - ins).abs().max()), 1
    while delta > tol and passes < max_passes:
        ins, new = new, shift(run_pass(new))
        delta, passes = float((new - ins).abs().max()), passes + 1
    return new, passes, delta


def smooth_parallel(ll, tlat, tdyn, p_init, likelihood_scale, *,
                    uniform_rows, config=None, max_passes=None, tol=1e-6,
                    want_acc=True):
    """Fixed-point parallel-in-time forward-backward smoother (strict mode).

    ll: (T, L) log-likelihood; tlat (n_dyn, L, L); tdyn (n_dyn, n_dyn);
    p_init (n_dyn, L) probability-space initial carry.

    Returns ``(smooth, log_marginal, post, ratios, acc, diag)`` in
    PROBABILITY space: smooth and post (T, n_dyn, L), the per-step log
    ratios (T,), acc the accumulated pairwise joint (n_dyn, n_dyn, L, L)
    (None when ``want_acc`` is False) and diag = (fwd_passes, bwd_passes,
    fwd_delta, bwd_delta).  The warm start, fast mode and carry export of
    the JAX ``smooth_parallel`` belong to the fused mid-EM iterations and
    are not ported."""
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
    tlat = tlat.to(torch.float32).contiguous()
    tdyn = tdyn.to(torch.float32).contiguous()
    tlat_t = tlat.transpose(-1, -2).contiguous()

    # ---- forward fixed point (finals-only passes + one emitting pass) ----
    m = ll.amax(dim=1)
    w = torch.exp(likelihood_scale * (ll - m[:, None])).contiguous()
    ins0 = torch.full((C, n_dyn, L), 1.0 / (n_dyn * L), dtype=torch.float32,
                      device=ll.device)
    ins0[0] = p_init

    def fwd(ins):
        return pfilter_pass(w, tlat, tdyn, ins, tc, uniform_rows,
                            emit=False)[2]

    def fwd_shift(fin):
        return torch.cat([ins0[:1], fin[:-1]])

    ins_f, fwd_passes, fwd_delta = _solve(fwd, fwd_shift, ins0, tol,
                                          max_passes)
    post, norm, _ = pfilter_pass(w, tlat, tdyn, ins_f, tc, uniform_rows,
                                 emit=True)
    ratios = torch.log(norm) + likelihood_scale * m
    log_marginal = ratios.sum()

    # ---- backward fixed point ----
    # chunk c's boundary is the smoothed posterior of row (c+1)*tc; chunks
    # from c_star (which holds row T-1) on start from post_{T-1}, which is
    # exact, and the filter posterior of each boundary row is the guess
    c_star = (T - 1) // tc
    post_T1 = post[T - 1]
    rows = torch.arange(1, C + 1, device=ll.device) * tc
    guess = post[torch.clamp(rows, max=T - 1)].contiguous()
    guess[c_star:] = post_T1

    def bwd(ins):
        return psmooth_pass(post, tlat, tlat_t, tdyn, ins, tc, uniform_rows,
                            emit=False)[2]

    def bwd_shift(fin):
        new = torch.cat([fin[1:], post_T1[None]])
        new[c_star:] = post_T1
        return new

    ins_b, bwd_passes, bwd_delta = _solve(bwd, bwd_shift, guess, tol,
                                          max_passes)
    smooth, r, _ = psmooth_pass(post, tlat, tlat_t, tdyn, ins_b, tc,
                                uniform_rows, emit=True)
    acc = None
    if want_acc:
        # the pairwise-joint contraction runs outside the kernel, as in the
        # JAX package's full mode (rows that are not steps carry r = 0)
        acc = (torch.einsum("tdi,tej->deij", post, r)
               * tdyn[:, :, None, None] * tlat[None])
    diag = (fwd_passes, bwd_passes, fwd_delta, bwd_delta)
    return smooth, log_marginal, post, ratios, acc, diag
