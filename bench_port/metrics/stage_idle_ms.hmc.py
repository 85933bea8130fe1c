"""Device idle ms a sweep, over the traced window's full sweeps, while the
host was inside the program's two HMC stages (its spans ``sweep.imp`` and
``sweep.latent``, grouped as ``hmc_ms`` groups them)."""

from bench_port.metrics._spans import idle_ms

UNIT = "ms"


def read(ctx):
    return idle_ms(ctx, ("sweep.imp", "sweep.latent"))
