"""The program's spans on the trace's clock (``metrics/_spans.py``) and the
device's idle time cut by them: synthetic traces with a known offset, and
the spans of a traced CPU run of the tiny flagship cell."""

from __future__ import annotations

import pytest
import torch

from bench_port import harness
from bench_port.metrics import _spans
from bench_port.tests import tiny
from bench_port.trace import SPAN, Trace

#: the program's clock (ns) at the trace's 0 µs
ZERO_NS = 1_792_342_303_109_881_625


def _ns(us: float) -> int:
    return ZERO_NS + int(round(us * 1e3))


def _trace(ops=()) -> Trace:
    """A window 0–1,000 µs with two benchmark sweeps in it."""
    spans = [(SPAN + "window", 0.0, 1000.0), (SPAN + "sweep", 10.0, 400.0), (SPAN + "sweep", 500.0, 900.0)]
    return Trace(list(ops), spans)


def _program(lag2_us: float = 5.0) -> list:
    """Two program sweeps, the first begun just as its anchor and the second
    ``lag2_us`` after its own, with stage spans in the first; in the order
    the spans closed, on the program's clock."""
    return [
        ("sweep.imp", _ns(20.0), _ns(100.0), 1),
        ("sweep.adjacency", _ns(100.0), _ns(380.0), 1),
        ("sweep", _ns(10.0), _ns(390.0), 0),
        ("sweep.adjacency", _ns(500.0 + lag2_us), _ns(800.0), 1),
        ("sweep", _ns(500.0 + lag2_us), _ns(880.0), 0),
    ]


def test_the_offset_is_recovered():
    moved = _spans.aligned(_trace(), _program())
    assert [s[0] for s in moved] == ["sweep", "sweep.imp", "sweep.adjacency", "sweep", "sweep.adjacency"]
    assert moved[0][1:3] == (pytest.approx(10.0), pytest.approx(390.0))
    assert moved[1][1:3] == (pytest.approx(20.0), pytest.approx(100.0))
    assert moved[3][1] == pytest.approx(505.0)


def test_an_idle_gap_across_two_stages_is_split_between_them():
    ops = [("k", 0.0, 50.0), ("k", 150.0, 200.0), ("k", 600.0, 700.0), ("copy", 950.0, 990.0)]
    tr = _trace(ops)
    by_path = _spans.idle_by_path(tr, _spans.aligned(tr, _program()))
    window_idle = tr.window_s * 1e6 - tr.busy_s() * 1e6
    assert sum(by_path.values()) == pytest.approx(window_idle)
    # the gap 50–150 µs: 50 in the impulse stage, 50 in the adjacency stage
    assert by_path[("sweep", "sweep.imp")] == pytest.approx(50.0)
    # then 200–380 in the first sweep, 505–600 and 700–800 in the second
    assert by_path[("sweep", "sweep.adjacency")] == pytest.approx(50.0 + 180.0 + 95.0 + 100.0)
    assert by_path[("sweep",)] == pytest.approx(10.0 + 80.0)  # 380–390, 800–880
    assert by_path[()] == pytest.approx(115.0 + 70.0 + 10.0)  # 390–505, 880–950, 990–1,000


def test_idle_ms_reads_a_stage_a_step(monkeypatch):
    ops = [("k", 0.0, 50.0), ("k", 150.0, 200.0), ("k", 600.0, 700.0), ("copy", 950.0, 990.0)]
    monkeypatch.setattr(_spans, "program_spans", _program)
    ctx = {"trace": _trace(ops), "steps": 2}
    assert _spans.idle_ms(ctx, ("sweep.imp",)) == pytest.approx(50.0 / 1e3 / 2)
    assert _spans.idle_ms(ctx, ("sweep.imp", "sweep.adjacency")) == pytest.approx(475.0 / 1e3 / 2)
    assert _spans.idle_ms({"trace": _trace(), "steps": 2}, ("sweep.imp",)) is None  # no device activity
    monkeypatch.setattr(_spans, "program_spans", lambda: None)
    assert _spans.idle_ms(ctx, ("sweep.imp",)) is None  # a program without spans


def test_unpaired_anchors_give_nothing():
    tr = _trace()
    assert _spans.aligned(tr, _program()[:3]) is None  # one program sweep for two anchors
    assert _spans.aligned(tr, _program() + [("sweep", _ns(950.0), _ns(960.0), 0)]) is None
    assert _spans.aligned(tr, _program(lag2_us=1500.0)) is None  # offsets 1.5 ms apart
    renamed = [("value_and_grad", a, b, d) if n == "sweep" and d == 0 and a > _ns(400.0) else (n, a, b, d)
               for n, a, b, d in _program()]
    assert _spans.aligned(tr, renamed) is None
    assert _spans.aligned(Trace([], [(SPAN + "window", 0.0, 10.0)]), []) is None


def test_segments_put_time_down_to_the_innermost_span():
    spans = [("a", 0.0, 10.0, 0), ("b", 2.0, 5.0, 1), ("c", 3.0, 4.0, 2), ("d", 6.0, 8.0, 1), ("e", 20.0, 30.0, 0)]
    assert _spans._segments(spans) == [(0.0, 2.0, ("a",)), (2.0, 3.0, ("a", "b")), (3.0, 4.0, ("a", "b", "c")),
                                       (4.0, 5.0, ("a", "b")), (5.0, 6.0, ("a",)), (6.0, 8.0, ("a", "d")),
                                       (8.0, 10.0, ("a",)), (20.0, 30.0, ("e",))]


def test_a_traced_cpu_run_puts_each_program_sweep_inside_its_anchor(monkeypatch):
    """The tiny flagship cell traced on the CPU: its program spans, as the
    readers see them, line up with the benchmark's spans."""
    seen = {}

    class Probe:
        UNIT = "ms"

        @staticmethod
        def read(ctx):
            seen["trace"], seen["spans"], seen["steps"] = ctx["trace"], _spans.program_spans(), ctx["steps"]
            return None

    monkeypatch.setattr(harness, "reader", lambda name: Probe)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tiny.run("flagship-c16", trace=True)
    finally:
        torch.set_num_threads(n)
    tr = seen["trace"]
    moved = _spans.aligned(tr, seen["spans"])
    assert moved is not None
    anchors = sorted((s for s in tr.spans if s[0] == SPAN + "sweep"), key=lambda s: s[1])
    sweeps = [s for s in moved if s[0] == "sweep"]
    assert len(sweeps) == len(anchors) == seen["steps"]
    for (_, a0, a1), (_, p0, p1, depth) in zip(anchors, sweeps):
        assert depth == 0
        assert a0 <= p0 <= p1 <= a1
    stages = {s[0] for s in moved} - {"sweep"}
    assert {"sweep.adjacency", "sweep.imp", "sweep.latent", "sweep.glm"} <= stages
    by_path = _spans.idle_by_path(tr, moved)
    assert sum(by_path.values()) == pytest.approx(tr.window_s * 1e6)  # no device activity on the CPU
