"""Device idle ms an evaluation, over the traced window, while the host
was inside the backward pass of ``value_and_grad`` (the program's span
``value_and_grad.backward``)."""

from bench_port.metrics._spans import idle_ms

UNIT = "ms"


def read(ctx):
    return idle_ms(ctx, ("value_and_grad.backward",))
