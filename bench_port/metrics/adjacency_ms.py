"""The adjacency stage alone (``make_sweep(stages=("adjacency",))``): host
milliseconds a sweep after a synchronize, over ``stage_sweeps`` sweeps,
timed before the profiler attaches."""

UNIT = "ms"


def read(ctx):
    return ctx.get("stage_ms", {}).get("adjacency")
