"""gemm_ms_per_call.decode: device milliseconds of the matrix-product
kernels (the library's GEMMs, and the program's bf16_gemm at the lower
matmul levels) over the traced decode calls."""

GEMM = r"(?i)gemm"


def read(ctx):
    if ctx.trace is None or not ctx.traced_calls:
        return None
    s = ctx.trace.kernel_seconds(GEMM)
    return s / ctx.traced_calls * 1e3 if s > 0 else None
