"""basis_ms_per_fit: milliseconds of the program's span ``model.basis``
(the tuning basis's Gram SVD on the host and its copy to the card) per
traced fit: each fit's model construction, and the fit's own when it
sweeps the length scale."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_call(ctx, "fit_em", "model.basis", inside=False)
