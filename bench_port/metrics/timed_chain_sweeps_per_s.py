"""The sampler's rate over the full sweeps that a traced run times on the
host clock before the profiler attaches (``timed_sweeps``, from a
synchronize before the first to one after the last): chain-sweeps a
second. The window's rate on the same path, read per layer: the host
paces the sweep, and its speed wanders by more between runs than an
end-to-end bound can hold."""

UNIT = "chain-sweeps/s"


def read(ctx):
    chains = ctx["traffic"].get("chains")
    if not chains or not ctx.get("timed_s"):
        return None
    return chains * ctx["timed_steps"] / ctx["timed_s"]
