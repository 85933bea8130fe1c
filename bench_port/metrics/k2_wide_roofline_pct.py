"""K2's wide-U instance's share of its roofline: the frozen least time of
each call (``yardstick.bound_ms`` at each block's shape) over its device
time by name in the traced window. Nothing where the calls are not one per
block of each evaluation."""

from bench_port import yardstick
from bench_port.metrics._device import K2_WIDE

UNIT = "%"


def read(ctx):
    seconds, calls = ctx["trace"].kernel_s(K2_WIDE)
    blocks = ctx.get("k2_blocks")
    if not blocks or calls == 0 or calls != ctx["steps"] * len(blocks):
        return None
    least_ms = ctx["steps"] * sum(yardstick.bound_ms(True, *b) for b in blocks)
    return 100.0 * least_ms / 1e3 / seconds
