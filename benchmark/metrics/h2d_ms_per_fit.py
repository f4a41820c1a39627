"""h2d_ms_per_fit: device milliseconds of the host-to-device copies in the
device trace over the traced fits.  (The profiler's copy events do not
always carry their byte counts, so the copies are timed, not sized.)"""


def read(ctx):
    if ctx.trace is None or not ctx.traced_calls:
        return None
    return ctx.trace.kernel_seconds(r"^Memcpy HtoD") * 1e3 / ctx.traced_calls
