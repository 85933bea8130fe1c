"""Share of the traced window in which no operation ran on the device:
1 − the union of the device's activity intervals / the window. Read as
``device_idle_pct.sampler`` in the sampler cells and as
``device_idle_pct.evals`` in the evaluation cells. The window is traced
under ``torch.profiler``, which slows the host's launches: where the host
paces the step, this reads higher than an unprofiled run would."""

UNIT = "%"


def read(ctx):
    """Nothing where no operation ran on the device (a run off the card)."""
    tr = ctx["trace"]
    busy = tr.busy_s()
    return 100.0 * (1.0 - busy / tr.window_s) if busy > 0 else None
