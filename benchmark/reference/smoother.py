"""Forward-backward smoother of the jump model, in plain PyTorch.

The state is (dynamics d, latent bin l); a step applies the dynamics
transition, then the latent transition of the new dynamics state
(continuous: ``Tcont``; jump: uniform), then the emission.  The first
step's prior is that push applied to the uniform state.

The sequence is cut into C chunks of k steps that run side by side, one
Python step at a time over all chunks.  Each chunk needs the message at its
boundary, which the chunk before it produces: every pass starts each chunk
from the previous pass's boundary messages, and the passes repeat until a
pass's inputs equal its own outputs at every boundary (to ``tol``).  Then
the chunks chain into the sequential recursion exactly: the check is a
certificate, not an approximation.  The filter and the smoother are
normalised at every step; the log-marginal sums the filter's log
normalisers.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.model import F64


@dataclasses.dataclass
class Smoothed:
    """What the reference computes of one sequence (float64 tensors on
    the inputs' device, or the control's float32)."""

    log_marginal: float
    latent_marg: torch.Tensor  # (T, L)
    dyn_marg: torch.Tensor  # (T, n_dyn)
    joint: torch.Tensor = None  # (n_dyn, n_dyn, L, L): sums to T - 1
    passes: tuple = ()


def _push(a, trans, prec):
    """Prior of the next step from states ``a`` (C, 2, L)."""
    q = torch.einsum("cdl,de->cel", a, trans.Tdyn)
    pr = torch.empty_like(q)
    pr[:, 0] = prec.mm(q[:, 0], trans.Tcont)
    pr[:, 1] = q[:, 1].sum(dim=1, keepdim=True) / trans.L
    return pr


def _pull(v, trans, prec):
    """``sum_(e, j) A[(d, i) -> (e, j)] v[e, j]`` for rows ``v`` (C, 2, L)."""
    s = torch.empty_like(v)
    s[:, 0] = prec.mm(v[:, 0], trans.Tcont.T)
    s[:, 1] = v[:, 1].sum(dim=1, keepdim=True) / trans.L
    return torch.einsum("de,cel->cdl", trans.Tdyn, s)


def _fixed_point(run_pass, guess, tol, max_passes, shift, strict):
    """Run passes until every chunk's input equals the output of the chunk
    it follows; returns the number of passes.  ``strict``: raise if they
    still move after ``max_passes`` (else keep the last pass)."""
    starts = guess
    for n in range(1, max_passes + 1):
        ends = run_pass(starts)
        new = shift(ends)
        if float((new - starts).abs().max()) <= tol:
            return n
        starts = new
    if strict:
        raise RuntimeError(
            f"reference smoother: chunk boundaries still move after "
            f"{max_passes} passes")
    return max_passes


def smooth(ll, trans, prec=F64, k=500, want_joint=False, tol=None,
           max_passes=64, rows=100_000):
    """Smooth log-likelihoods ``ll`` (T, L) under ``trans``.  ``ll`` is
    overwritten by the emission weights.  Returns ``Smoothed``."""
    T, L = ll.shape
    dev, dt = ll.device, prec.dtype
    # float64 is a continuous map: its passes settle to rounding, and a
    # pass count past ``max_passes`` is an error.  The control's TF32
    # rounding of the state makes each step a step function, so its
    # boundaries settle only to the rounding's own noise (~2e-5, or more
    # where the emissions say little): it keeps its last pass
    strict = dt == torch.float64
    tol = (1e-13 if strict else 1e-4) if tol is None else tol
    max_passes = max_passes if strict else min(max_passes, 16)
    k = min(k, T)
    C = -(-T // k)
    pad = C * k - T
    m = ll.amax(dim=1)
    w = ll.sub_(m[:, None]).exp_()
    if pad:  # padded steps weigh every state alike: exact in both directions
        w = torch.cat([w, torch.ones((pad, L), dtype=dt, device=dev)])
    wc = w.view(C, k, L)
    filt = torch.empty((C, k, 2, L), dtype=dt, device=dev)
    norm = torch.empty((C, k), dtype=dt, device=dev)
    p0 = torch.full((2, L), 1.0 / (2 * L), dtype=dt, device=dev)

    def fwd(starts):
        a = starts
        for s in range(k):
            u = _push(a, trans, prec) * wc[:, s, None, :]
            z = u.sum(dim=(1, 2))
            a = u / z[:, None, None]
            filt[:, s] = a
            norm[:, s] = z
        return a

    def fwd_shift(ends):
        return torch.cat([p0[None], ends[:-1]])

    guess = torch.full((C, 2, L), 1.0 / (2 * L), dtype=dt, device=dev)
    guess[0] = p0
    n_fwd = _fixed_point(fwd, guess, tol, max_passes, fwd_shift, strict)
    lml = (torch.log(norm.reshape(-1)[:T]).sum() + m.to(dt).sum()).item()

    beta = torch.empty_like(filt)

    def bwd(starts):
        b = starts
        for s in range(k - 1, -1, -1):
            beta[:, s] = b
            b = _pull(wc[:, s, None, :] * b, trans, prec)
            b = b / b.sum(dim=(1, 2))[:, None, None]
        return b

    ones = torch.full((2, L), 1.0 / (2 * L), dtype=dt, device=dev)

    def bwd_shift(ends):
        return torch.cat([ends[1:], ones[None]])

    guess = torch.full((C, 2, L), 1.0 / (2 * L), dtype=dt, device=dev)
    n_bwd = _fixed_point(bwd, guess, tol, max_passes, bwd_shift, strict)

    f2 = filt.view(C * k, 2, L)
    b2 = beta.view(C * k, 2, L)
    lat = torch.empty((T, L), dtype=dt, device=dev)
    dyn = torch.empty((T, 2), dtype=dt, device=dev)
    for a in range(0, T, rows):
        g = f2[a:a + rows][: T - a] * b2[a:a + rows][: T - a]
        g = g / g.sum(dim=(1, 2))[:, None, None]
        lat[a:a + rows] = g.sum(dim=1)
        dyn[a:a + rows] = g.sum(dim=2)
    out = Smoothed(lml, lat, dyn, passes=(n_fwd, n_bwd))
    if not want_joint:
        return out
    # R[t+1] = w[t+1] beta[t+1] / sum(prior[t+1] w[t+1] beta[t+1]): each
    # step's pairwise posterior, filt[t] (x) R[t+1] * A, sums to one
    w2 = w.view(C * k, L)
    for a in range(1, T, rows):
        sl = slice(a, min(a + rows, T))
        r = w2[sl, None, :] * b2[sl]
        pr = _push(f2[a - 1:sl.stop - 1], trans, prec)
        b2[sl] = r / (pr * r).sum(dim=(1, 2))[:, None, None]
    acc = prec.mm(f2[:T - 1].reshape(T - 1, 2 * L).T,
                  b2[1:T].reshape(T - 1, 2 * L)).view(2, L, 2, L)
    acc = acc.permute(0, 2, 1, 3)  # (d, e, i, j)
    cont = torch.stack([trans.Tcont,
                        torch.full_like(trans.Tcont, 1.0 / L)])
    out.joint = acc * trans.Tdyn[:, :, None, None] * cont[None]
    return out


def joint_keys(joint):
    """``p_joint_full`` and ``p_transition_dynamics`` of a pairwise joint
    (n_dyn, n_dyn, L, L)."""
    full = joint / joint.sum()
    dyn = full.sum(dim=(2, 3))
    return {"p_joint_full": full,
            "p_transition_dynamics": dyn / dyn.sum(dim=1, keepdim=True)}

