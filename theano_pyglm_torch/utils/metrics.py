"""JSONL metrics, wall-clock timers and the port's spans — port of
:mod:`theano_pyglm_tpu.utils.metrics`.

The reference prints iteration, log-p and accept-rate lines; here a small
JSONL writer and a timer give the same visibility in a machine-readable
form (log-p traces, accept rates and ESS in one file per run).

The timer is also the port's span. While a ``torch.profiler`` session is
active on the thread, each timed block is kept in memory as
(name, start ns, end ns, depth) on the host's ``time.time_ns()`` clock
(:func:`spans`), and is entered as a range of the same name on the
profiler's host timeline, so that it shows in an exported trace. The range
is a plain function range (``_RecordFunctionFast``), never a user
annotation (``record_function``): the profiler copies user annotations onto
the device's timeline, where they would read as device activity. The store
is cleared when a span finds the profiler on after the last span found it
off, so each profiling session starts with an empty store. Without a
profiler a span records nothing and costs a flag check and two clock
reads.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

import torch
from torch._C._profiler import _RecordFunctionFast

__all__ = ["MetricsWriter", "timer", "spans"]

#: spans kept while a profiler is on: (name, start ns, end ns, depth)
_SPANS: deque = deque(maxlen=1 << 20)
#: whether the last span found a profiler on
_ON = [False]
#: each thread's depth of open recorded spans
_LOCAL = threading.local()
_profiler_enabled = torch.autograd._profiler_enabled
_now = time.time_ns


def spans() -> list:
    """The spans recorded in the current (or last) profiling session, in
    the order they closed: (name, start ns, end ns, depth) on the clock of
    ``time.time_ns()``; depth 0 is a span no other recorded span of its
    thread holds. A session is told from the last by a span that found
    the profiler off in between: two sessions with no span between them
    share the store."""
    return list(_SPANS)


class MetricsWriter:
    """Append-only JSONL metrics stream; one dict per step."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._fh = None
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self.t0 = time.time()

    def log(self, step: int, **metrics) -> None:
        rec = {"step": step, "wall_s": round(time.time() - self.t0, 3), **metrics}
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        if self.echo:
            print(" ".join(f"{k}={v}" for k, v in rec.items()))

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()


class timer:
    """Wall-clock timer and span named ``label``; read ``.elapsed`` (s)
    after the block. Device work queued inside the block is timed only if
    the block ends by synchronizing. Under a profiler the block is also
    recorded (see the module's docstring)."""

    __slots__ = ("label", "echo", "elapsed", "_start", "_range")

    def __init__(self, label: str = "", echo: bool = False):
        self.label = label
        self.echo = echo
        self.elapsed = 0.0
        self._range = None

    def __enter__(self):
        if _profiler_enabled():
            if not _ON[0]:
                _ON[0] = True
                _SPANS.clear()
            self._range = _RecordFunctionFast(self.label)
            self._range.__enter__()
            _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
        elif _ON[0]:
            _ON[0] = False
        self._start = _now()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end = _now()
        self.elapsed = (end - self._start) * 1e-9
        if self._range is not None:
            self._range.__exit__(None, None, None)
            _LOCAL.depth -= 1
            _SPANS.append((self.label, self._start, end, _LOCAL.depth))
        if self.echo:
            print(f"[{self.label}] {self.elapsed:.3f}s")
