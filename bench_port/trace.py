"""Reading a ``torch.profiler`` trace of the card: the device's activities,
their union, the benchmark's own spans, and the idle gaps between.

The benchmark marks its own spans with ``torch.profiler.record_function``
under names that start with ``SPAN``; the readers of ``bench_port/metrics``
take what they need from the :class:`Trace` built here.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["SPAN", "Trace", "profiled", "span"]

SPAN = "bench."


def span(name: str):
    """A benchmark span named ``SPAN + name`` on the profiler's timeline."""
    return torch.profiler.record_function(SPAN + name)


class Trace:
    """The device activities (name, start µs, end µs) and benchmark spans
    of one profiled stretch, with the window (the span ``SPAN + "window"``)
    that the metrics are taken over."""

    def __init__(self, device_ops: list, spans: list):
        self.device_ops = sorted(device_ops, key=lambda e: e[1])
        self.spans = spans
        win = [s for s in spans if s[0] == SPAN + "window"]
        if len(win) != 1:
            raise ValueError(f"a trace needs one window span, found {len(win)}")
        self.w0, self.w1 = win[0][1], win[0][2]

    @classmethod
    def of(cls, prof) -> "Trace":
        dev, spans = [], []
        for e in prof.events():
            r = e.time_range
            if e.name.startswith(SPAN):
                # the profiler also puts each span on the device's timeline
                # (a "gpu_user_annotation"): not an operation of the device
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    spans.append((e.name, r.start, r.end))
            elif e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((e.name, r.start, r.end))
        return cls(dev, spans)

    def in_window(self) -> list:
        return [e for e in self.device_ops if e[1] >= self.w0 and e[2] <= self.w1]

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    @staticmethod
    def union(ops: list) -> list:
        """The merged intervals [(start, end)] that ``ops`` cover."""
        out = []
        for _, a, b in sorted(ops, key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device, in the window."""
        return sum(b - a for a, b in self.union(self.in_window())) / 1e6

    def kernel_s(self, pattern) -> tuple:
        """(seconds, calls) of the window's activities whose name matches the
        compiled regular expression ``pattern``."""
        hits = [e for e in self.in_window() if pattern.search(e[0])]
        return sum(b - a for _, a, b in hits) / 1e6, len(hits)

    def _label(self, t: float) -> str:
        """The innermost benchmark span that holds host time ``t``."""
        best = None
        for name, a, b in self.spans:
            if a <= t <= b and (best is None or b - a < best[2] - best[1]):
                best = (name, a, b)
        return "outside" if best is None else best[0][len(SPAN):]

    def breakdown(self, n: int = 10) -> dict:
        """The ``n`` device operations that took most time, by name, and the
        idle gaps of the whole trace summed by the span the host was in at
        each gap's start, longest first; seconds."""
        by_name = {}
        for name, a, b in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        gaps = {}
        merged = self.union(self.device_ops)
        for (_, b0), (a1, _) in zip(merged, merged[1:]):
            label = self._label(b0)
            gaps[label] = gaps.get(label, 0.0) + (a1 - b0) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:200], v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}


@contextlib.contextmanager
def profiled(device: torch.device):
    """``torch.profiler`` over the card's activities and the host's, yielding
    a holder whose ``trace`` is set on exit; the stretch ends with a
    synchronize, so the device has finished what it was given."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Profiled", (), {})()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield holder
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    holder.trace = Trace.of(prof)
