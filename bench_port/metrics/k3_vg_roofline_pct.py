"""K3-vg's share of its roofline: the frozen least time of each call
(``yardstick.bound_ms`` at its group of chains) over K3-vg's device time
by name in the traced window. Nothing where K3-vg did not run, or ran a
number of calls that is not a whole number of evaluations."""

from bench_port import yardstick
from bench_port.metrics._device import K3_VG

UNIT = "%"


def read(ctx):
    seconds, calls = ctx["trace"].kernel_s(K3_VG)
    groups = [g for g in ctx.get("k3_groups", ()) if g > 1]
    if calls == 0 or not groups or len(groups) != len(ctx["k3_groups"]) or calls % len(groups):
        return None
    T, NB, N = ctx["shape"]
    least_ms = calls // len(groups) * sum(yardstick.bound_ms(True, T, NB, N, C=g) for g in groups)
    return 100.0 * least_ms / 1e3 / seconds
