"""host_syncs_per_call.decode: reads of a device value by the host (the
program's counter ``host_syncs``) over the traced calls' ``decode_latent``
spans, per call."""

from benchmark import spans


def read(ctx):
    n = spans.counter_sum(ctx, "decode_latent", "host_syncs")
    return None if n is None else n / ctx.traced_calls
