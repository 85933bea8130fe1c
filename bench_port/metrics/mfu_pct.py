"""The whole step's share of the card's peak: the model's operations a step
(``yardstick.sweep_flops`` of every chain, or ``yardstick.eval_flops``) ×
the steps timed on the host clock before the profiler attached / their
seconds / the float32-accurate (3xTF32) peak. Read as ``mfu_pct.sampler``
(a step is a sweep of all chains) and ``mfu_pct.evals`` (an evaluation)."""

from bench_port import yardstick

UNIT = "%"


def read(ctx):
    """Nothing off the card: the peak is the card's."""
    if ctx["device"].type != "cuda" or not ctx.get("timed_s"):
        return None
    return 100.0 * ctx["flops_per_step"] * ctx["timed_steps"] / ctx["timed_s"] / yardstick.F32_ACCURATE_FLOP_PER_S
