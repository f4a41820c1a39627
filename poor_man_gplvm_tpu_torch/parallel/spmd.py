"""Inference and EM over a ('data', 'time', 'neuron') mesh of devices.

Counterpart of ``poor_man_gplvm_tpu/parallel/spmd.py``.  The JAX package is
single-controller: one process builds a ``Mesh`` over ``jax.devices()``,
and ``jax.shard_map`` runs one body per device with XLA collectives
between them.  The port keeps that contract in one process: a ``Mesh`` is a
(data, time, neuron) array of ``torch.device``s, each shard's tensors live
on its device, the bodies run one shard after another (each launch
asynchronous on its device), and the collectives are plain functions on
per-shard tensor lists (``ppermute``, ``psum``, ``pmax``,
``broadcast_last``).  A mesh may repeat a device: four time shards on one
card run the shard-local kernels, the boundary exchange and the neuron sums
as four cards would, as JAX's tests force 8 virtual CPU devices.

* **data**: independent chains (``make_sharded_em_step``).
* **neuron**: each shard forms its neurons' partial (T_local, L) emission
  log-likelihood with ``ops/emissions.py`` and an all-ones latent mask; the
  partials are summed in shard order, then the latent mask is applied to
  the real rows.  The M-step is per neuron, so params and Adam state shard
  over neurons, and only the loss of the stopping rule is summed.
* **time**, two engines:

  - ``'pscan'``: the fixed-point parallel-in-time scans across the mesh.
    Each time shard runs K3/K4 (``ops/parallel_scan.py``) over its own C
    chunks with its shard-local validity bound ``n_valid``; the
    chunk-boundary carries cross shards by ``ppermute``, and one host read
    per pass, the ``pmax`` of the carries' movement over all shards,
    decides the loop (at most n_time * C passes, where the answer is exact
    by induction).  A shard boundary is one more chunk boundary.
  - ``'pipeline'``: the staged carry hand-off on K1/K2
    (``ops/scan_kernels.py``).  At stage k, time shard s runs chain k - s
    from the carry shard s - 1 handed it at stage k - 1 (K1's ``p_init``;
    a received smoothed row is K2's ``init``), so B chains take B +
    n_time - 1 stages; the shards of a stage that share a device go
    through one batched launch, one thread block per chain.  Each shard
    runs exactly its real rows (``lengths``): padded rows are never run.

T and N need not divide the mesh: they are padded exactly (masked rows and
columns, tuning columns and per-neuron ``noise_std`` padded with 1.0,
``dt_l`` with 1.0) and the padding is cut off on the way out.
"""

from __future__ import annotations

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.ops import band as bd
from poor_man_gplvm_tpu_torch.ops import hmm, mstep
from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps
from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk
from poor_man_gplvm_tpu_torch.ops.emissions import MASK_NEG

__all__ = [
    "Mesh",
    "factorize_devices",
    "make_mesh",
    "sharded_smooth",
    "make_sharded_em_step",
    "make_sharded_poisson_em_step",
    "ppermute",
    "psum",
    "pmax",
    "broadcast_last",
]

AXIS_NAMES = ("data", "time", "neuron")
TIME_ENGINES = ("auto", "pscan", "pipeline")


def _norm_device(d):
    """``torch.device(d)`` with a CUDA device's index filled in, so that
    it compares equal to its tensors' ``.device``."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A (data, time, neuron) array of ``torch.device``s.  ``devices``: a
    numpy object array of the devices (a device may repeat);
    ``axis_names``: ('data', 'time', 'neuron'); ``shape``: the ordered
    name -> size map, as ``jax.sharding.Mesh.shape``."""

    def __init__(self, devices, axis_names=AXIS_NAMES):
        arr = np.asarray(devices, dtype=object)
        if tuple(axis_names) != AXIS_NAMES or arr.ndim != 3:
            raise ValueError(
                f"a mesh is a 3-D device array over the axes {AXIS_NAMES}")
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [_norm_device(d) for d in arr.reshape(-1)]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = AXIS_NAMES

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        devs = sorted({str(d) for d in self.devices.reshape(-1)})
        return f"Mesh({self.shape}, devices={devs})"


def check_mesh(mesh):
    """Raise ``TypeError`` unless ``mesh`` is a ``Mesh``."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a poor_man_gplvm_tpu_torch.parallel.spmd.Mesh "
            f"(make_mesh), got {type(mesh).__name__}")
    return mesh


def factorize_devices(n, batch=1, n_neuron=None, n_time=None):
    """Split n devices into (data, time, neuron) axis sizes, by the JAX
    package's rule: data gets the largest power-of-two divisor of n that is
    <= ``batch``; of the rest, neuron 2 when that leaves an even time axis
    above 2, else 1, and time the rest.  ``n_neuron``/``n_time`` are hard
    requests, satisfied first; ``batch`` only bounds the data axis."""
    if n_neuron is not None or n_time is not None:
        fixed = (n_time or 1) * (n_neuron or 1)
        if n % fixed:
            raise ValueError(
                f"time({n_time}) * neuron({n_neuron}) = {fixed} does not "
                f"divide {n} devices"
            )
        rest = n // fixed
        data = 1
        while data * 2 <= rest and data * 2 <= batch and rest % (data * 2) == 0:
            data *= 2
        if n_neuron is None:
            n_neuron = rest // data
        elif n_time is None:
            n_time = rest // data
        elif data != rest and rest <= batch:
            data = rest
        if data * n_time * n_neuron != n:
            raise ValueError(
                f"data({data}) * time({n_time}) * neuron({n_neuron}) != {n}; "
                f"pass batch/n_time/n_neuron that factor the device count"
            )
        return data, n_time, n_neuron
    data = 1
    while data * 2 <= n and data * 2 <= batch and n % (data * 2) == 0:
        data *= 2
    rest = n // data
    neuron = 1
    if rest % 2 == 0 and rest > 2:
        neuron = 2
    time = rest // neuron
    return data, time, neuron


def make_mesh(n_devices=None, batch=1, devices=None, shape=None,
              n_neuron=None, n_time=None):
    """A ('data', 'time', 'neuron') ``Mesh``.  ``devices``: the devices to
    lay out (a device may repeat; default: every CUDA card, and with no
    card this raises, it never falls back to the CPU); ``n_devices``: use
    the first that many (default all); ``shape``: an explicit (data, time,
    neuron) tuple, else ``factorize_devices(n_devices, batch, n_neuron,
    n_time)``."""
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if n_cards == 0:
            raise RuntimeError(
                "make_mesh() with no devices needs a CUDA card, and "
                "torch.cuda.is_available() is False; pass devices= (e.g. "
                "[torch.device('cpu')] * 8) to lay out a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"n_devices={n_devices} but only {len(devices)} "
                         "devices were given")
    if shape is not None:
        if int(np.prod(shape)) != n_devices:
            raise ValueError(
                f"mesh shape {tuple(shape)} does not multiply to "
                f"{n_devices} devices"
            )
    else:
        shape = factorize_devices(n_devices, batch, n_neuron=n_neuron,
                                  n_time=n_time)
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devices[:n_devices]
    return Mesh(arr.reshape(tuple(shape)))


# ---------------------------------------------------------------------------
# collectives on per-shard tensor lists (one entry per shard along an axis)
# ---------------------------------------------------------------------------


def _to(x, dev):
    """``x`` on ``dev``: no copy between shards of one device, an
    asynchronous copy between devices."""
    return x if x.device == dev else x.to(dev, non_blocking=True)


def ppermute(xs, devs, shift=1):
    """The shift along an axis: shard i + ``shift`` receives ``xs[i]`` on
    its device, and a shard that receives nothing gets zeros (JAX's
    ``lax.ppermute`` with the pairs (i, i + shift))."""
    n = len(xs)
    out = []
    for i in range(n):
        src = i - shift
        out.append(_to(xs[src], devs[i]) if 0 <= src < n
                   else torch.zeros_like(_to(xs[i], devs[i])))
    return out


def _reduce(xs, devs, op):
    total = xs[0]
    for x in xs[1:]:
        total = op(total, _to(x, total.device))
    return [_to(total, d) for d in devs]


def psum(xs, devs):
    """The sum over an axis, in shard order, on every shard's device."""
    return _reduce(xs, devs, torch.add)


def pmax(xs, devs):
    """The elementwise maximum over an axis, on every shard's device."""
    return _reduce(xs, devs, torch.maximum)


def broadcast_last(xs, devs):
    """The last shard's value on every shard's device (JAX's psum of the
    last shard's finals, zeros elsewhere)."""
    return [_to(xs[-1], d) for d in devs]


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _ll_partial(y, tuning, ma2d, emission, noise_std, dt=None):
    """Per-neuron-shard partial emission log-likelihood (T_local, L) with an
    all-ones latent mask; the sum over the neuron shards completes it.
    ``dt``: None (dt = 1, the matmul form) or a per-time (T_local,) vector
    (the gain model's path, in the blocked elementwise form)."""
    ones_lat = torch.ones(tuning.shape[0], dtype=torch.float32,
                          device=tuning.device)
    return hmm._loglik(y, tuning, {"noise_std": noise_std}, ma2d, ones_lat,
                       emission, dt)


def _pad_to(x, axis, mult, value=0.0):
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=axis)


class _Trans:
    """The transition's stacks (tlat (n_dyn, L, L), its transpose, tdyn),
    their constant-channel flags and bands, copied once to each device of
    the mesh that needs them."""

    def __init__(self, trans):
        tlat, tdyn = hmm._transition_stack(trans)
        self.is_joint = hasattr(trans, "Tdyn")
        self.flags = trans.uniform_rows
        self.tlat = tlat.to(torch.float32).contiguous()
        self.tdyn = tdyn.to(torch.float32).contiguous()
        self.tlat_t = self.tlat.transpose(-1, -2).contiguous()
        self.n_dyn, self.L = self.tlat.shape[0], self.tlat.shape[-1]
        # the initial state, exp of the uniform log state as every engine
        # forms it
        self.init = torch.exp(trans.uniform_log_init()).to(
            torch.float32).reshape(self.n_dyn, self.L)
        self._bands = {}
        self._on = {}

    def on(self, dev):
        """(tlat, tlat_t, tdyn) on ``dev``."""
        if dev not in self._on:
            self._on[dev] = tuple(_to(x, dev) for x in (
                self.tlat, self.tlat_t, self.tdyn))
        return self._on[dev]

    def band(self, dev, prec):
        """The ``transition_band`` in ``prec``, made once per call (on the
        transition's device) and copied to ``dev``."""
        key = (prec, None)
        if key not in self._bands:
            self._bands[key] = bd.transition_band(self.tlat, self.tlat_t,
                                                  self.flags, prec)
        b = self._bands[key]
        if (prec, dev) not in self._bands:
            self._bands[(prec, dev)] = bd.Band(
                b.W, _to(b.start, dev), _to(b.mats, dev),
                None if b.hi is None else _to(b.hi, dev),
                None if b.lo is None else _to(b.lo, dev))
        return self._bands[(prec, dev)]

    def p_init(self, dev):
        """The initial state (n_dyn, L) on ``dev``."""
        return _to(self.init, dev)

    def push(self, post, dev):
        """prior_{t+1} = push(post_t) of (..., n_dyn, L) rows."""
        tlat, _, tdyn = self.on(dev)
        q = torch.einsum("...pl,pd->...dl", post, tdyn)
        return torch.einsum("...di,dij->...dj", q, tlat)

    def scale_acc(self, acc_raw):
        """The pairwise joint from its raw (n_dyn, n_dyn, L, L) sum."""
        dev = acc_raw.device
        tlat, _, tdyn = self.on(dev)
        acc = acc_raw * tdyn[:, :, None, None] * tlat[None]
        return acc if self.is_joint else acc[0, 0]


# ---------------------------------------------------------------------------
# the 'pipeline' engine: K1/K2 in stages
# ---------------------------------------------------------------------------


def _by_device(items, dev_of):
    groups = {}
    for it in items:
        groups.setdefault(dev_of(it), []).append(it)
    return groups.items()


def _staggered_forward(ll, devs, tr, scale, lens):
    """The staged exact filter.  ll[d][s]: (Bl, Tl, L) on devs[d][s], the
    data shard d's chains over time shard s; lens[s] the real rows of time
    shard s (the same for every chain).  At stage k, shard s runs chain
    k - s from the carry shard s - 1 handed it; the shards of a stage on
    one device are one K1 launch.  Returns post[d][s] (Bl, Tl, n_dyn, L)
    and ratios[d][s] (Bl, Tl), zero past the real rows, and lml[d] (Bl,)
    on devs[d][-1]."""
    D, nt = len(ll), len(ll[0])
    Bl, Tl, L = ll[0][0].shape
    n_dyn = tr.n_dyn
    post = [[torch.zeros((Bl, Tl, n_dyn, L), dtype=torch.float32,
                         device=devs[d][s]) for s in range(nt)]
            for d in range(D)]
    ratios = [[torch.zeros((Bl, Tl), dtype=torch.float32, device=devs[d][s])
               for s in range(nt)] for d in range(D)]
    # carry[d][b] = (filter posterior after the rows run so far, log z)
    carry = [[None] * Bl for _ in range(D)]
    for k in range(Bl + nt - 1):
        items = [(d, s, k - s) for d in range(D) for s in range(nt)
                 if 0 <= k - s < Bl and lens[s] > 0]
        for dev, group in _by_device(items, lambda it: devs[it[0]][it[1]]):
            n = [lens[s] for _, s, _ in group]
            x = torch.stack([ll[d][s][b] for d, s, b in group])
            p0 = torch.stack([
                tr.p_init(dev) if carry[d][b] is None
                else _to(carry[d][b][0], dev) for d, _, b in group])
            tlat, _, tdyn = tr.on(dev)
            p, _, r = sk.filter_chunk_batch(
                x, tlat, tdyn, p0, torch.tensor(n, dtype=torch.int32,
                                                device=dev),
                scale, uniform_rows=tr.flags,
                band=tr.band(dev, "highest") if dev.type == "cuda" else None)
            for e, (d, s, b) in enumerate(group):
                post[d][s][b, :n[e]] = p[e, :n[e]]
                ratios[d][s][b] = r[e]
                logz = r[e].sum()
                if carry[d][b] is not None:
                    logz = _to(carry[d][b][1], dev) + logz
                carry[d][b] = (p[e, n[e] - 1], logz)
    lml = [torch.stack([_to(carry[d][b][1], devs[d][-1])
                        for b in range(Bl)]) for d in range(D)]
    return post, ratios, lml


def _staggered_backward(post, devs, tr, lens):
    """The staged exact smoother (stages in reverse shard order) over the
    filter posteriors post[d][s] of ``_staggered_forward``.  Time shard s
    runs K2 over its rows before the global last row (all Tl before the
    shard that holds it, none after), from the smoothed row shard s + 1
    handed it, or, on the shard that holds the last row, from its filter
    posterior, which is that row's smoothed posterior; the priors are
    push(post) of each row.  Returns smooth[d][s] (Bl, Tl, n_dyn, L), zero
    past the real rows, and the raw pairwise joint sum_t post_t^T r_t of
    each chain, acc[d] (Bl, n_dyn, n_dyn, L, L) on devs[d][0]."""
    D, nt = len(post), len(post[0])
    Bl, Tl, n_dyn, L = post[0][0].shape
    T = sum(lens)
    owner = (T - 1) // Tl
    j_last = T - 1 - owner * Tl
    k2_rows = [Tl if s < owner else (j_last if s == owner else 0)
               for s in range(nt)]
    smooth = [[torch.zeros_like(post[d][s]) for s in range(nt)]
              for d in range(D)]
    acc = [[None] * Bl for _ in range(D)]
    for d in range(D):
        smooth[d][owner][:, j_last] = post[d][owner][:, j_last]
    for k in range(Bl + nt - 1):
        items = [(d, s, k - (nt - 1 - s)) for d in range(D)
                 for s in range(owner + 1)
                 if 0 <= k - (nt - 1 - s) < Bl and k2_rows[s] > 0]
        for dev, group in _by_device(items, lambda it: devs[it[0]][it[1]]):
            n = [k2_rows[s] for _, s, _ in group]
            nmax = max(n)
            filt = torch.stack([post[d][s][b, :nmax] for d, s, b in group])
            init = torch.stack([
                _to(post[d][s][b, j_last] if s == owner
                    else smooth[d][s + 1][b, 0], dev) for d, s, b in group])
            tlat, _, tdyn = tr.on(dev)
            sm, r = sk.smoother_chunk_batch(
                filt, tr.push(filt, dev), tlat, tdyn, init,
                torch.tensor(n, dtype=torch.int32, device=dev),
                uniform_rows=tr.flags,
                band=tr.band(dev, "highest") if dev.type == "cuda" else None)
            for e, (d, s, b) in enumerate(group):
                smooth[d][s][b, :n[e]] = sm[e, :n[e]]
                part = ps.joint_acc(filt[e, :n[e]], r[e, :n[e]])
                prev = acc[d][b]
                acc[d][b] = part if prev is None else \
                    _to(prev, dev) + part
    zero = torch.zeros((n_dyn, n_dyn, L, L), dtype=torch.float32)
    accs = [torch.stack([
        _to(a, devs[d][0]) if a is not None else zero.to(devs[d][0])
        for a in acc[d]]) for d in range(D)]
    return smooth, accs


# ---------------------------------------------------------------------------
# the 'pscan' engine: the fixed-point scans across the mesh
# ---------------------------------------------------------------------------


def _max_move(new, old, devs):
    """The pmax over the shards of max |new - old|, read to the host (the
    one read per pass)."""
    m = [(n - o).abs().max().reshape(1) for n, o in zip(new, old)]
    return float(pmax(m, devs)[0])


def _fixed_point(run_pass, shift, ins, devs, tol, max_passes):
    """A peeled first pass, then passes while the carries of any shard
    move by more than ``tol``, at most ``max_passes`` in all (JAX's
    ``fp_cond``).  Returns (carries, passes, last movement)."""
    new = shift(run_pass(ins))
    delta, passes = _max_move(new, ins, devs), 1
    tol = np.float32(tol)
    while np.float32(delta) > tol and passes < max_passes:
        ins, new = new, shift(run_pass(new))
        delta, passes = _max_move(new, ins, devs), passes + 1
    return new, passes, delta


def _pscan_smooth(ll, devs, tr, scale, t_true, tol=1e-6, diag_out=None):
    """The cross-mesh fixed-point smoother over the time shards ll[s]
    (Tl, L) on devs[s].  Returns (smooth, lml, post, ratios, acc) in
    probability space: per-shard lists of (Tl, n_dyn, L) smoothed and
    filter posteriors and (Tl,) log ratios, the log marginal and the
    pairwise joint on devs[0]."""
    nt = len(ll)
    Tl, L = ll[0].shape
    n_dyn = tr.n_dyn
    prec = ps._SCAN_PRECISION
    cfg = ps.choose_parallel_config(Tl, L, n_dyn)
    if cfg is None:
        # a local shard too short for the single-sequence rule: C = 1
        # parallelises across the shards alone
        cfg = (max(1, min(16, Tl // 16)), 8, 8)
    C = cfg[0]
    tc = -(-Tl // C)
    nv_fwd = [int(np.clip(t_true - s * Tl, 0, Tl)) for s in range(nt)]
    nv_bwd = [int(np.clip(t_true - 1 - s * Tl, 0, Tl)) + 1
              for s in range(nt)]
    cpu = devs[0].type == "cpu"
    sp_f = sp_b = None
    if cpu and prec != "highest":
        sp_f = ps.split_bf16(tr.tlat)
        sp_b = (sp_f, ps.split_bf16(tr.tlat_t))

    m = [x.amax(dim=1) for x in ll]
    w = [torch.exp(scale * (x - mi[:, None])).contiguous()
         for x, mi in zip(ll, m)]
    init_p = tr.p_init(devs[0])  # chunk 0 of shard 0 starts there
    ins0 = []
    for s, dev in enumerate(devs):
        x = torch.full((C, n_dyn, L), 1.0 / (n_dyn * L), dtype=torch.float32,
                       device=dev)
        if s == 0:
            x[0] = init_p
        ins0.append(x)

    def fwd(ins, emit=False):
        out = []
        for s, dev in enumerate(devs):
            tlat, _, tdyn = tr.on(dev)
            res = ps.pfilter_pass(w[s], tlat, tdyn, ins[s], tc, tr.flags,
                                  emit, prec, sp_f, tr.band(dev, prec),
                                  n_valid=nv_fwd[s])
            out.append(res if emit else res[2])
        return out

    def shift_f(fin):
        recv = ppermute([f[-1] for f in fin], devs)
        return [torch.cat([(init_p if s == 0 else recv[s])[None], f[:-1]])
                for s, f in enumerate(fin)]

    ins_f, fp, fd = _fixed_point(fwd, shift_f, ins0, devs, tol, nt * C)
    emitted = fwd(ins_f, emit=True)
    post = [e[0] for e in emitted]
    ratios = []
    for s, (e, dev) in enumerate(zip(emitted, devs)):
        r = torch.log(e[1]) + scale * m[s]
        real = (s * Tl + torch.arange(Tl, device=dev)) < t_true
        ratios.append(torch.where(real, r, 0.0))
    lml = psum([r.sum().reshape(1) for r in ratios], devs)[0][0]

    # backward: chunks at or past the global last row's chunk on its shard,
    # and every chunk of a later shard, take post_{T-1} (exact)
    owner = (t_true - 1) // Tl
    j_last = t_true - 1 - owner * Tl
    c_j = j_last // tc
    pt1 = [_to(post[owner][j_last], dev) for dev in devs]
    ovr = [torch.arange(C, device=dev) >= (c_j if s == owner else
                                           (0 if s > owner else C))
           for s, dev in enumerate(devs)]

    def apply_ovr(ins):
        return [torch.where(o[:, None, None], p[None], x)
                for x, o, p in zip(ins, ovr, pt1)]

    def bwd(ins, mode="finals"):
        out = []
        for s, dev in enumerate(devs):
            tlat, tlat_t, tdyn = tr.on(dev)
            res = ps.psmooth_pass(post[s], tlat, tlat_t, tdyn, ins[s], tc,
                                  tr.flags, mode, prec, sp_b,
                                  tr.band(dev, prec), n_valid=nv_bwd[s])
            out.append(res if mode != "finals" else res[2])
        return out

    def shift_b(fin):
        recv = ppermute([f[0] for f in fin], devs, shift=-1)
        return apply_ovr([torch.cat([f[1:], r[None]])
                          for f, r in zip(fin, recv)])

    # the guess: the filter posterior of each chunk's boundary row
    rows = [torch.clamp(torch.arange(1, C + 1, device=dev) * tc, max=Tl - 1)
            for dev in devs]
    recv0 = ppermute([p[0] for p in post], devs, shift=-1)
    guess = apply_ovr([torch.cat([p[r[:-1]], q[None]])
                       for p, r, q in zip(post, rows, recv0)])
    ins_b, bp, bdelta = _fixed_point(bwd, shift_b, guess, devs, tol, nt * C)
    emitted = bwd(ins_b, "full")
    smooth = [e[0] for e in emitted]
    # rows that are not steps carry r = 0, so each shard's contraction sums
    # only real (t, t+1) pairs
    acc_raw = psum([ps.joint_acc(p, e[1]) for p, e in zip(post, emitted)],
                   devs)[0]
    if diag_out is not None:
        diag_out.append((fp, bp, fd, bdelta))
    return smooth, lml, post, ratios, tr.scale_acc(acc_raw)


# ---------------------------------------------------------------------------
# the sharded smoother (one sequence) for the model classes
# ---------------------------------------------------------------------------


def sharded_smooth(
    mesh,
    y,
    tuning,
    hyperparam,
    trans,
    ma_neuron,
    ma_latent=None,
    likelihood_scale=1.0,
    observation_model="poisson",
    dt_l=None,
    time_engine="auto",
    diag_out=None,
):
    """Forward-backward smoother over a mesh, time sharded over
    mesh['time'] and neurons over mesh['neuron']: a drop-in for
    ``hmm.smooth_combined_chunked`` returning the same 6-tuple
    ``(log_acausal, log_marginal_final, log_causal, log_one_step_pred,
    log_accumulated_joint, log_likelihood_all)`` with
    ``log_likelihood_all`` None, on the mesh's first device.

    ``time_engine``: ``'pscan'`` (K3/K4 on every time shard at once, the
    carries solved across the mesh), ``'pipeline'`` (the staged K1/K2
    hand-off), or ``'auto'`` (default): 'pscan' when a time shard is long
    enough for ``choose_parallel_config``, else 'pipeline'.  The data axis
    plays no part here (the first data row of the mesh runs it).  Works
    for both state spaces and both emissions; T and N need not divide the
    mesh.  ``diag_out``: a list to which the 'pscan' engine appends
    ``(fwd_passes, bwd_passes, fwd_delta, bwd_delta)``."""
    check_mesh(mesh)
    if time_engine not in TIME_ENGINES:
        raise ValueError(f"unknown time_engine {time_engine!r}")
    d_time, d_neuron = mesh.shape["time"], mesh.shape["neuron"]
    devs = mesh.devices[0]  # (time, neuron)
    dev0 = devs[0, 0]
    y = torch.as_tensor(y, dtype=torch.float32)
    T, N = y.shape
    L = tuning.shape[0]
    tuning = torch.as_tensor(tuning, dtype=torch.float32)
    ma = torch.broadcast_to(torch.as_tensor(ma_neuron, dtype=torch.float32,
                                            device=y.device), (T, N))
    if ma_latent is None:
        ma_latent = torch.ones(L)
    keep_lat = torch.as_tensor(ma_latent).to(torch.bool)
    noise_std = torch.as_tensor(hyperparam.get("noise_std", 1.0),
                                dtype=torch.float32)
    if noise_std.ndim == 1:
        # padded neurons are fully masked; 1.0 keeps log(std) finite
        noise_std = _pad_to(noise_std, 0, d_neuron, 1.0)
    y_p = _pad_to(_pad_to(y, 0, d_time), 1, d_neuron)
    ma_p = _pad_to(_pad_to(ma, 0, d_time), 1, d_neuron)
    tuning_p = _pad_to(tuning, 1, d_neuron, 1.0)  # log(lam) stays finite
    Tp, Np = y_p.shape
    Tl, Nl = Tp // d_time, Np // d_neuron
    dt_p = None
    if dt_l is not None:
        dt_p = _pad_to(torch.broadcast_to(torch.as_tensor(
            dt_l, dtype=torch.float32, device=y.device), (T,)), 0, d_time,
            1.0)
    tr = _Trans(trans)
    if time_engine == "auto":
        time_engine = ("pscan" if ps.choose_parallel_config(
            Tl, L, tr.n_dyn) is not None else "pipeline")

    # each (time, neuron) shard's partial emissions, summed over the neuron
    # shards in order; the latent mask on real rows only (padded rows stay
    # uniform and are never run)
    ll = []
    for s in range(d_time):
        rows = slice(s * Tl, (s + 1) * Tl)
        parts = []
        for n in range(d_neuron):
            dev, cols = devs[s, n], slice(n * Nl, (n + 1) * Nl)
            parts.append(_ll_partial(
                _to(y_p[rows, cols], dev), _to(tuning_p[:, cols], dev),
                _to(ma_p[rows, cols], dev), observation_model,
                _to(noise_std[cols] if noise_std.ndim else noise_std, dev),
                None if dt_p is None else _to(dt_p[rows], dev)))
        x = psum(parts, [devs[s, 0]] * d_neuron)[0]
        real = (s * Tl + torch.arange(Tl, device=x.device)) < T
        mask = real[:, None] & ~_to(keep_lat, x.device)[None, :]
        ll.append(torch.where(mask, MASK_NEG, x))
    tdevs = list(devs[:, 0])

    if time_engine == "pscan":
        smooth, lml, post, ratios, acc = _pscan_smooth(
            ll, tdevs, tr, float(likelihood_scale), T, diag_out=diag_out)
    else:
        lens = [int(np.clip(T - s * Tl, 0, Tl)) for s in range(d_time)]
        post_s, ratio_s, lml_d = _staggered_forward(
            [[x[None] for x in ll]], [tdevs], tr, float(likelihood_scale),
            lens)
        smooth_s, acc_d = _staggered_backward(post_s, [tdevs], tr, lens)
        post = [p[0] for p in post_s[0]]
        smooth = [p[0] for p in smooth_s[0]]
        ratios = [r[0] for r in ratio_s[0]]
        lml = lml_d[0][0]
        acc = tr.scale_acc(acc_d[0][0])

    def gather(xs):
        x = torch.cat([_to(v, dev0) for v in xs])[:T]
        return x if tr.is_joint or x.ndim == 1 else x[:, 0]

    return (
        hmm.prob_to_log(gather(smooth)),
        _to(lml, dev0),
        hmm.prob_to_log(gather(post)),
        gather(ratios),
        hmm.prob_to_log(_to(acc, dev0)),
        None,
    )


# ---------------------------------------------------------------------------
# the sharded EM step (chains over 'data')
# ---------------------------------------------------------------------------


def make_sharded_em_step(
    mesh,
    basis,
    trans,
    emission="poisson",
    param_prior_std=1.0,
    noise_std=0.5,
    likelihood_scale=1.0,
    m_step_size=0.01,
    m_maxiter=100,
    m_tol=1e-6,
):
    """A multi-device EM step.

    ``emission``: 'poisson' (softplus link; Adam with this module's own
    stopping rule, ``(i < m_maxiter - 1) & ((i < 5) | rel > m_tol)`` on the
    loss summed over the neuron shards, one Adam per chain and neuron
    shard) or 'gaussian' (linear link; the ridge solve on the statistics
    summed over the time shards).  ``trans``: a JointTransition or
    LatentTransition.

    Returns ``step(params, opt_state, log_post_latent, y) -> (params',
    opt_state', log_post_latent', log_marginal, final_loss)`` with y (B, T,
    N), params (B, n_basis, N), log_post_latent (B, T, L), opt_state the
    port's ``AdamState`` batched over chains (``mstep.adam_init_batch``;
    passed through by 'gaussian'), log_marginal and final_loss (B,), all
    on the mesh's first device.  B, T and N must divide the data, time and
    neuron axes.  One call is reference EM iteration i: the M-step on the
    current posterior, then the E-step with the new tuning on the
    'pipeline' engine (B chains through the time shards in B / data + time
    - 1 stages)."""
    check_mesh(mesh)
    if emission not in ("poisson", "gaussian"):
        raise ValueError(f"emission must be 'poisson' or 'gaussian', got "
                         f"{emission!r}")
    D, nt, nn = (mesh.shape[a] for a in AXIS_NAMES)
    devs = mesh.devices
    dev0 = devs[0, 0, 0]
    tr = _Trans(trans)
    basis_on = {}

    def basis_at(dev):
        if dev not in basis_on:
            basis_on[dev] = _to(torch.as_tensor(basis, dtype=torch.float32),
                                dev)
        return basis_on[dev]

    def adam(params, state, y_w, t_w, dev):
        """Adam of one data shard's Bl chains, params[n] (Bl, n_basis, Nl)
        on the neuron shards' devices ``dev[n]``: each chain stops at its
        own iteration by the rule on its loss summed over the shards."""
        Bl = params[0].shape[0]
        hyper = [{"param_prior_std": torch.full(
            (Bl,), float(param_prior_std), device=d)} for d in dev]

        def value_and_grad(n, p):
            p = p.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = mstep.poisson_m_step_objective_batch(
                    p, hyper[n], basis_at(dev[n]), y_w[n], t_w[n])
                (g,) = torch.autograd.grad(loss.sum(), p)
            return loss.detach(), g

        def global_loss(losses):
            return psum(losses, [dev[0]] * nn)[0]

        loss = global_loss([mstep.poisson_m_step_objective_batch(
            params[n], hyper[n], basis_at(dev[n]), y_w[n], t_w[n])
            for n in range(nn)])
        loss_prev = loss
        active = torch.ones((Bl,), dtype=torch.bool, device=dev[0])
        i = 0
        while True:
            rel = (loss - loss_prev).abs() / torch.clamp(loss.abs(),
                                                         min=1e-8)
            active = active & (i < m_maxiter - 1) & ((i < 5) | (rel > m_tol))
            if not bool(active.any()):
                break
            new_losses = []
            for n in range(nn):
                nl, g = value_and_grad(n, params[n])
                upd, new = mstep.adam_update(g, state[n], m_step_size)
                act = _to(active, dev[n])
                keep = act.reshape(-1, 1, 1)
                params[n] = torch.where(keep, params[n] + upd, params[n])
                state[n] = mstep.AdamState(
                    torch.where(act, new.count, state[n].count),
                    torch.where(keep, new.mu, state[n].mu),
                    torch.where(keep, new.nu, state[n].nu))
                new_losses.append(nl)
            new_loss = global_loss(new_losses)
            loss_prev = torch.where(active, loss, loss_prev)
            loss = torch.where(active, new_loss, loss)
            i += 1
        return params, state, loss

    def step(params, opt_state, log_post, y):
        y = torch.as_tensor(y, dtype=torch.float32)
        log_post = torch.as_tensor(log_post, dtype=torch.float32)
        params = torch.as_tensor(params, dtype=torch.float32)
        B, T, N = y.shape
        L = log_post.shape[-1]
        if B % D or T % nt or N % nn:
            raise ValueError(
                f"(B, T, N) = {(B, T, N)} must divide the mesh's (data, "
                f"time, neuron) = {(D, nt, nn)}")
        Bl, Tl, Nl = B // D, T // nt, N // nn
        lens = [Tl] * nt
        out_p, out_s, out_lp, out_lml, out_loss = [], [], [], [], []
        for d in range(D):
            chains = slice(d * Bl, (d + 1) * Bl)
            ndev = list(devs[d, 0])  # each neuron shard's M-step device
            # ---- M-step: statistics summed over the time shards ----
            y_w, t_w = [], []
            for n in range(nn):
                cols = slice(n * Nl, (n + 1) * Nl)
                yw_s, tw_s = [], []
                for s in range(nt):
                    dev = devs[d, s, n]
                    rows = slice(s * Tl, (s + 1) * Tl)
                    post = torch.exp(_to(log_post[chains, rows], dev))
                    yw_s.append(post.transpose(1, 2)
                                @ _to(y[chains, rows, cols], dev))
                    tw_s.append(post.sum(dim=1))
                y_w.append(psum(yw_s, [ndev[n]] * nt)[0])
                t_w.append(psum(tw_s, [ndev[n]] * nt)[0])
            p_n = [_to(params[chains, :, n * Nl:(n + 1) * Nl], ndev[n])
                   for n in range(nn)]
            if emission == "poisson":
                st_n = [mstep.AdamState(
                    _to(opt_state.count[chains], ndev[n]),
                    _to(opt_state.mu[chains, :, n * Nl:(n + 1) * Nl],
                        ndev[n]),
                    _to(opt_state.nu[chains, :, n * Nl:(n + 1) * Nl],
                        ndev[n])) for n in range(nn)]
                p_n, st_n, loss = adam(p_n, st_n, y_w, t_w, ndev)
                tun_n = [mstep.get_tuning_softplus(p, basis_at(ndev[n]))
                         for n, p in enumerate(p_n)]
                out_s.append(st_n)
            else:
                hyper = {k: torch.full((Bl,), float(v)) for k, v in (
                    ("noise_std", noise_std),
                    ("param_prior_std", param_prior_std))}
                p_n = [mstep.gaussian_m_step_analytic_batch(
                    {k: v.to(ndev[n]) for k, v in hyper.items()},
                    basis_at(ndev[n]), y_w[n], t_w[n]) for n in range(nn)]
                tun_n = [mstep.get_tuning_linear(p, basis_at(ndev[n]))
                         for n, p in enumerate(p_n)]
                loss = None
            out_p.append(torch.cat([_to(p, dev0) for p in p_n], dim=2))
            # ---- E-step: emissions summed over the neuron shards ----
            ll = []
            for s in range(nt):
                rows = slice(s * Tl, (s + 1) * Tl)
                parts = []
                for n in range(nn):
                    dev = devs[d, s, n]
                    y_b = _to(y[chains, rows, n * Nl:(n + 1) * Nl], dev)
                    tun = _to(tun_n[n], dev)
                    parts.append(torch.stack([_ll_partial(
                        y_b[b], tun[b], torch.ones_like(y_b[b]), emission,
                        torch.tensor(float(noise_std), device=dev))
                        for b in range(Bl)]))
                ll.append(psum(parts, [devs[d, s, 0]] * nn)[0])
            tdevs = list(devs[d, :, 0])
            post_f, _ratios, lml = _staggered_forward(
                [ll], [tdevs], tr, float(likelihood_scale), lens)
            smooth, _acc = _staggered_backward(post_f, [tdevs], tr, lens)
            lat = torch.cat([_to(x.sum(dim=2), dev0) for x in smooth[0]],
                            dim=1)
            out_lp.append(hmm.prob_to_log(lat))
            out_lml.append(_to(lml[0], dev0))
            out_loss.append(torch.zeros((Bl,), device=dev0) if loss is None
                            else _to(loss, dev0))
        if emission == "poisson":
            opt_new = mstep.AdamState(*(
                torch.cat([torch.cat([_to(getattr(st[n], f), dev0)
                                      for n in range(nn)], dim=2)
                           if f != "count" else _to(st[0].count, dev0)
                           for st in out_s])
                for f in ("count", "mu", "nu")))
        else:
            opt_new = opt_state
        return (torch.cat(out_p), opt_new, torch.cat(out_lp),
                torch.cat(out_lml), torch.cat(out_loss))

    return step


def make_sharded_poisson_em_step(
    mesh,
    basis,
    trans,
    param_prior_std=1.0,
    likelihood_scale=1.0,
    m_step_size=0.01,
    m_maxiter=100,
    m_tol=1e-6,
):
    """The Poisson EM step (``make_sharded_em_step(emission='poisson')``)."""
    return make_sharded_em_step(
        mesh, basis, trans, emission="poisson",
        param_prior_std=param_prior_std, likelihood_scale=likelihood_scale,
        m_step_size=m_step_size, m_maxiter=m_maxiter, m_tol=m_tol,
    )
