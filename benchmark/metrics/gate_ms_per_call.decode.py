"""gate_ms_per_call.decode: milliseconds of the program's span
``smooth.engine_gate`` (the engine gate's read of the card's free memory)
inside the traced ``decode_latent`` calls, per call."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_call(ctx, "decode_latent", "smooth.engine_gate")
