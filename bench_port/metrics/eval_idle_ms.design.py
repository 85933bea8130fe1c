"""Device idle ms an evaluation, over the traced window, while the host
was rebuilding a block's spike design (the program's span
``loglik.design``, one a block of the streamed design)."""

from bench_port.metrics._spans import idle_ms

UNIT = "ms"


def read(ctx):
    return idle_ms(ctx, ("loglik.design",))
