"""The program's own spans and counters in a traced run, for the readers
of the ``program_span`` and ``program_counter`` metrics.

The program (``poor_man_gplvm_tpu_torch.utils.profiling``) records spans
while a ``torch.profiler`` session is active, so in a traced run it records
exactly the window's traced calls: one top-level span each, ``fit_em`` or
``decode_latent``, which holds the deltas of the program's counters over
the call (``attrs['counters']``) and of the card's allocator
(``attrs['cuda_mallocs']``).  A program without the recorder gives None,
and so does a run whose count of those top-level spans is not
``ctx.traced_calls``.
"""

from __future__ import annotations


def calls(ctx, top):
    """(every recorded span, the top-level spans named ``top``), or None."""
    if not ctx.traced_calls:
        return None
    try:
        from poor_man_gplvm_tpu_torch.utils import profiling

        spans = profiling.spans()
    except (ImportError, AttributeError):
        return None
    tops = [s for s in spans if s.parent is None and s.name == top]
    if len(tops) != ctx.traced_calls:
        return None
    return spans, tops


def ms_per_call(ctx, top, name, inside=True):
    """Milliseconds of the spans ``name`` per traced call: those under the
    calls' top-level spans ``top``, or with ``inside=False`` every one
    recorded (a span the program opens outside the call, inside the
    traced window)."""
    got = calls(ctx, top)
    if got is None:
        return None
    spans, tops = got
    ids = {s.id for s in tops}
    ns = sum(s.end_ns - s.start_ns for s in spans
             if s.name == name and (not inside or s.top in ids))
    return ns * 1e-6 / ctx.traced_calls


def counter_sum(ctx, top, key):
    """The sum over the calls' top-level spans ``top`` of the counter
    ``key``'s delta, or None."""
    got = calls(ctx, top)
    if got is None:
        return None
    return sum(s.attrs.get("counters", {}).get(key, 0) for s in got[1])


def attr_sum(ctx, top, key):
    """The sum over the calls' top-level spans ``top`` of ``attrs[key]``;
    None where a span lacks it (a run on the CPU has no allocator)."""
    got = calls(ctx, top)
    if got is None or any(key not in s.attrs for s in got[1]):
        return None
    return sum(s.attrs[key] for s in got[1])
