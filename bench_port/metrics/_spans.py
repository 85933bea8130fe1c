"""The program's own spans (``theano_pyglm_torch.utils.metrics.spans``) on
the trace's clock, and the device's idle time cut by them.

The program keeps its spans on the host's ``time.time_ns()`` clock, the
trace its events in µs from the profiler's start. The benchmark spans that
wrap one whole program call each are the anchors: ``sweep`` and every
``stage.<name>`` (a stage run alone) each wrap one top-level program
``sweep``, ``eval`` one ``value_and_grad``. Anchors and top-level program
spans of those names are paired in order; the offset is the smallest of
the pairs' (program start − anchor start), the pair in which the program's
span began soonest after its anchor. Nothing is given where the counts or
the names do not pair, or the pairs' offsets spread more than
``SPREAD_US``: the clocks then cannot be matched. A program without spans
(one that predates them) gives nothing.
"""

from __future__ import annotations

from bench_port.trace import SPAN, Trace

#: the program span each anchor (a benchmark span, by name) wraps; and every ``STAGE`` anchor a ``sweep``
ANCHORS = {"sweep": "sweep", "eval": "value_and_grad"}
STAGE = "stage."
SPREAD_US = 1000.0


def partner(anchor: str) -> str | None:
    """The program span that the benchmark span ``anchor`` wraps, or None
    where it is no anchor."""
    return "sweep" if anchor.startswith(STAGE) else ANCHORS.get(anchor)


def program_spans() -> list | None:
    """The program's recorded spans, or None where it keeps none."""
    try:
        from theano_pyglm_torch.utils.metrics import spans
    except ImportError:
        return None
    return spans()


def aligned(tr: Trace, spans: list) -> list | None:
    """``spans`` (name, start ns, end ns, depth) moved onto ``tr``'s clock
    (µs), those inside the window, sorted by start; None where the anchors
    do not pair (module docstring)."""
    anchors = sorted((s for s in tr.spans if partner(s[0][len(SPAN):])), key=lambda s: s[1])
    kinds = set(ANCHORS.values())
    tops = sorted((s for s in spans if s[3] == 0 and s[0] in kinds), key=lambda s: s[1])
    if not anchors or len(anchors) != len(tops):
        return None
    if any(partner(a[0][len(SPAN):]) != p[0] for a, p in zip(anchors, tops)):
        return None
    base = tops[0][1]  # integer ns: a float64 of the epoch's ns keeps only 0.25 µs

    def us(t):
        return (t - base) / 1e3

    offsets = [us(p[1]) - a[1] for a, p in zip(anchors, tops)]
    if max(offsets) - min(offsets) > SPREAD_US:
        return None
    off = min(offsets)
    moved = [(name, us(a) - off, us(b) - off, depth) for name, a, b, depth in spans]
    return sorted((s for s in moved if s[1] >= tr.w0 and s[2] <= tr.w1), key=lambda s: (s[1], -s[2]))


def _segments(spans: list) -> list:
    """The time ``spans`` cover, cut where the innermost open span changes:
    [(start, end, path)], path the names from the outermost span in."""
    segs, stack, t = [], [], None

    def emit(a, b, path):
        if b > a:
            segs.append((a, b, path))

    for name, a, b, _ in spans:
        while stack and stack[-1][0] <= a:
            end, path = stack.pop()
            emit(t, end, path)
            t = end
        if stack:
            emit(t, a, stack[-1][1])
        t = a
        stack.append((b, (stack[-1][1] if stack else ()) + (name,)))
    while stack:
        end, path = stack.pop()
        emit(t, end, path)
        t = end
    return segs


def idle_by_path(tr: Trace, spans: list) -> dict:
    """The window's idle time (µs) between the merged device activities,
    each piece put down to the innermost aligned span open over it:
    {path: µs}, path the span's names from the outermost in, () where the
    host was in no span. The values add up to the window's idle time."""
    busy = Trace.union(tr.in_window())
    idle, t = [], tr.w0
    for a, b in busy:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    if tr.w1 > t:
        idle.append((t, tr.w1))
    out = {}
    segs = _segments(spans)
    i = 0
    for a, b in idle:
        while i < len(segs) and segs[i][1] <= a:
            i += 1
        t, j = a, i
        while t < b:
            if j < len(segs) and segs[j][0] < b:
                s0, s1, path = segs[j]
                if s0 > t:
                    out[()] = out.get((), 0.0) + s0 - t
                lo, hi = max(s0, t), min(s1, b)
                out[path] = out.get(path, 0.0) + hi - lo
                t = hi
                if s1 <= b:
                    j += 1
                else:
                    break
            else:
                out[()] = out.get((), 0.0) + b - t
                t = b
    return out


def idle_ms(ctx, names) -> float | None:
    """Device idle ms a step (a sweep or an evaluation of the traced window)
    while the host was inside a span named in ``names``; None where the
    trace holds no device activity in the window or the program's spans
    cannot be put on its clock."""
    tr = ctx["trace"]
    if not tr.in_window():
        return None
    spans = program_spans()
    moved = None if spans is None else aligned(tr, spans)
    if moved is None:
        return None
    by_path = idle_by_path(tr, moved)
    us = sum(v for path, v in by_path.items() if set(path) & set(names))
    return us / 1e3 / ctx["steps"]
