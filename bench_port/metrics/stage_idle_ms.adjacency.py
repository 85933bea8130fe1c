"""Device idle ms a sweep, over the traced window's full sweeps, while the
host was inside the program's adjacency stage (its span
``sweep.adjacency``): the birth–death stage's share of the idle gaps."""

from bench_port.metrics._spans import idle_ms

UNIT = "ms"


def read(ctx):
    return idle_ms(ctx, ("sweep.adjacency",))
