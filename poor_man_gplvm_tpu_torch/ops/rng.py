"""A CPU ``torch.Generator``'s own stream, drawn on the card bit for bit.

A CPU generator is MT19937 (``at::mt19937``), and ``torch.rand`` in
float32 makes each float from one tempered 32-bit output ``w`` as
``(w & 0xFFFFFF) * 2**-24``, one after another in memory order.  Its
``get_state()`` record (``STATE_BYTES`` bytes) holds the generator's 624
words and how many of them are read, so the kernels of ``csrc/mt19937.cu``
draw the very same floats on the card, and the words they end with go back
into the caller's generator by ``set_state``: afterwards the generator
draws exactly what it would after ``torch.rand`` on the host.  Its seed and
its normal sampler's fields are left as they were.

``cpu_stream_posterior(T, L, generator, device, scale, offset)`` is the
models' random initial posterior on a CUDA device: ``offset +
torch.rand((T, L), generator=generator) * scale`` normalised by rows, and
its log with the zeros at ``JOINT_ACC_INIT``; it returns ``(log_post,
post)``.  Its host recipe is ``_GPLVMCommon.init_latent_posterior``
(``models/base.py``).  It copies the generator's 624 words to the card
(``profiling.to_device``), launches the draw (kernel A, one thread block
running the recurrence) and the normalisation (kernel B), and then reads
the final words back: one host read, counted at the site ``mt_state``,
which waits for both kernels.  Each kernel's launches are counted in
``<launcher>.launches`` (``_launch_draw``, ``_launch_normalise``).  The
uniforms are the host's bit for bit; kernel B sums each row in f64 and
the host in f32, so the normalised posterior is within a few ulps of the
host recipe's.
"""

from __future__ import annotations

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.ops.hmm import JOINT_ACC_INIT
from poor_man_gplvm_tpu_torch.utils import profiling

__all__ = ["cpu_stream_posterior", "read_state", "write_state",
           "end_position", "STATE_BYTES", "N_WORDS"]

#: MT19937's words
N_WORDS = 624
#: the size of a CPU generator's ``get_state()`` record: the seed (u64),
#: ``left`` (i32), ``seeded`` (i32), ``next`` (u64), the 624 words (each a
#: u64), then the normal sampler's fields
STATE_BYTES = 5056
_LEFT, _NEXT = slice(8, 12), slice(16, 24)
_WORDS = slice(24, 24 + 8 * N_WORDS)


def read_state(generator):
    """``(words, left, next)`` of a CPU generator's record: its 624 words
    (uint32) and the two fields that place its next draw.  The next draw
    reads word ``N_WORDS + 1 - left``, after a twist where that is 624
    (``left`` 1; a fresh generator's ``next`` is then 0)."""
    st = generator.get_state().numpy()
    if st.size != STATE_BYTES:
        raise ValueError(f"a CPU generator's state has {STATE_BYTES} bytes; "
                         f"got {st.size}")
    left = int(st[_LEFT].view(np.int32)[0])
    nxt = int(st[_NEXT].view(np.uint64)[0])
    if not 1 <= left <= N_WORDS or (left > 1 and nxt != N_WORDS + 1 - left):
        raise ValueError(f"not an MT19937 position: left {left}, next {nxt}")
    return st[_WORDS].view(np.uint64).astype(np.uint32), left, nxt


def write_state(generator, words, left, nxt):
    """Put the 624 ``words`` and the fields ``left`` and ``next`` into the
    generator's record, keeping its other fields."""
    st = generator.get_state().numpy().copy()
    st[_LEFT] = np.array([left], np.int32).view(np.uint8)
    st[_NEXT] = np.array([nxt], np.uint64).view(np.uint8)
    st[_WORDS] = np.asarray(words, np.uint32).astype(np.uint64).view(np.uint8)
    generator.set_state(torch.from_numpy(st))


def end_position(pos, n):
    """``(twists, pos)``: the twists a draw of ``n`` words from position
    ``pos`` (the words already read) makes, and the position it ends at."""
    if n == 0:
        return 0, pos
    twists = (pos + n - 1) // N_WORDS
    return twists, pos + n - N_WORDS * twists


def _lib():
    from poor_man_gplvm_tpu_torch.ops._build import load

    return load("mt19937")


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _launch_draw(n, generator, device, scale):
    """Kernel A on the current stream: ``(out, state_out, end)``, the n
    floats and the final words on ``device`` and the position they end
    at."""
    words, left, _ = read_state(generator)
    pos = N_WORDS + 1 - left
    state_in = profiling.to_device(words.view(np.int32), device)
    state_out = torch.empty_like(state_in)
    out = torch.empty(n, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _lib().pmg_mt_draw(
            state_in.data_ptr(), pos, n, scale, out.data_ptr(),
            state_out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, "mt19937 draw")
    _launch_draw.launches += 1
    return out, state_out, end_position(pos, n)[1]


_launch_draw.launches = 0


def _launch_normalise(post, offset):
    """Kernel B on the current stream: ``post`` (T, L) normalised by rows
    in place after adding ``offset``; returns its log."""
    T, L = post.shape
    log_post = torch.empty_like(post)
    with torch.cuda.device(post.device):
        err = _lib().pmg_mt_normalise(
            post.data_ptr(), log_post.data_ptr(), T, L, offset,
            JOINT_ACC_INIT, torch.cuda.current_stream(post.device).cuda_stream)
    _raise_on(err, "mt19937 normalise")
    _launch_normalise.launches += 1
    return log_post


_launch_normalise.launches = 0


def _advance(generator, state_out, end):
    """Read the final words back (waiting for every kernel launched before
    on the stream) and put them into ``generator`` at position ``end``."""
    final = state_out.cpu().numpy().view(np.uint32)
    profiling.host_sync("mt_state")
    write_state(generator, final, N_WORDS + 1 - end, end)


def _draw(shape, generator, device, scale=1.0):
    """``torch.rand(shape, generator=generator) * scale`` drawn on the CUDA
    ``device`` by kernel A alone, the same bits, ``generator`` ending where
    ``torch.rand`` leaves it (the tests' and the smoke's view of kernel
    A)."""
    out, state_out, end = _launch_draw(
        int(np.prod(shape, dtype=np.int64)), generator, device, scale)
    _advance(generator, state_out, end)
    return out.reshape(shape)


def cpu_stream_posterior(T, L, generator, device, scale, offset=0.0):
    """``(log_post, post)`` on the CUDA ``device`` of ``offset +
    torch.rand((T, L), generator=generator) * scale``, each row normalised,
    the log's zeros at ``JOINT_ACC_INIT``: drawn and normalised there
    (kernels A and B), ``generator`` (a CPU ``torch.Generator``) ending
    where the host recipe leaves it."""
    device = torch.device(device)
    if not (isinstance(generator, torch.Generator)
            and generator.device.type == "cpu" and device.type == "cuda"):
        raise ValueError("draws a CPU torch.Generator's stream on a CUDA "
                         f"device; got {generator!r} and {device}")
    post, state_out, end = _launch_draw(T * L, generator, device, scale)
    post = post.reshape(T, L)
    log_post = _launch_normalise(post, offset)
    _advance(generator, state_out, end)
    return log_post, post
