"""JSONL metrics and wall-clock timers — port of
:mod:`theano_pyglm_tpu.utils.metrics` (plain Python).

The reference prints iteration, log-p and accept-rate lines; here a small
JSONL writer and a timer give the same visibility in a machine-readable
form (log-p traces, accept rates and ESS in one file per run).
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Optional

__all__ = ["MetricsWriter", "timer"]


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


@contextmanager
def timer(label: str = "", echo: bool = False):
    """Wall-clock timer; read ``.elapsed`` after the block. Device work
    queued inside the block is timed only if the block ends by
    synchronizing."""

    class _T:
        elapsed = 0.0

    t = _T()
    start = time.perf_counter()
    try:
        yield t
    finally:
        t.elapsed = time.perf_counter() - start
        if echo:
            print(f"[{label}] {t.elapsed:.3f}s")
