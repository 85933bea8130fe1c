"""Device idle ms a sweep, over the traced window's full sweeps, while the
host was inside the program's glm stage (its span ``sweep.glm``: the
Laplace-MH block of the bias and stimulus weights)."""

from bench_port.metrics._spans import idle_ms

UNIT = "ms"


def read(ctx):
    return idle_ms(ctx, ("sweep.glm",))
