"""setup_s: seconds from the process's start to the first timed call
(imports, the kernel build on a checkout's first run, sampling, warm-up)."""


def read(ctx):
    return ctx.setup_s
