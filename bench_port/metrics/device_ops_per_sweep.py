"""Device activities (kernels, copies, fills) a sweep, in the traced
window of full sweeps: the launches the host issues for the device."""

UNIT = "ops/sweep"


def read(ctx):
    ops = ctx["trace"].in_window()
    return len(ops) / ctx["steps"] if ops else None
