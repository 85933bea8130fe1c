"""How far the slowest rank's own sweep rate falls below the fastest's:
(fastest − slowest) / fastest, each rank counting its own chain-sweeps
over its own time, every rank running at once (the ``sampler_mesh``
driver's ``rank_sweeps``)."""

UNIT = "%"


def read(ctx):
    rates = ctx.get("rank_rates")
    if not rates or len(rates) < 2:
        return None
    return 100.0 * (max(rates) - min(rates)) / max(rates)
