"""init_posterior_ms_per_fit: milliseconds of the program's span
``fit.init_posterior`` (the initial posterior's CPU draw, normalisation,
copy to the card and log) per traced fit."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_call(ctx, "fit_em", "fit.init_posterior")
