"""device_allocs_per_call.decode: cudaMalloc calls of the caching
allocator (``memory_stats()['segment.all.allocated']``) over the traced
``decode_latent`` calls, per call."""

from benchmark import spans


def read(ctx):
    n = spans.attr_sum(ctx, "decode_latent", "cuda_mallocs")
    return None if n is None else n / ctx.traced_calls
