"""Device milliseconds an evaluation outside the fused likelihood kernels:
the union of the device's activities in the traced window less the fused
kernels' time, over the evaluations (the streamed design, the other
currents, the priors, autograd)."""

from bench_port.metrics._device import FUSED

UNIT = "ms"


def read(ctx):
    tr = ctx["trace"]
    if not tr.in_window():
        return None
    fused_s, _ = tr.kernel_s(FUSED)
    return 1e3 * (tr.busy_s() - fused_s) / ctx["steps"]
