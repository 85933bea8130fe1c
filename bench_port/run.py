#!/usr/bin/env python3
"""The port's benchmark: one run of one cell on the card it is started on.

    python3 bench_port/run.py --workload flagship-c16 --seed 7 --seconds 40 --trace 0

Run from the root of a checkout. The cell ``<workload>`` is
``bench_port/workloads/<workload>.json`` (see ``bench_port/harness.py``).
``--trace 0`` measures the cell's end-to-end metrics over ``--seconds``;
``--trace 1`` traces the cell under ``torch.profiler`` and reports its
per-layer metrics. Either way the run ends by comparing what the timed path
produced with the plain reference (``bench_port/reference``), and prints,
as the last line of its standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` when
traced), then ``checks``, each compared number beside its limit. The same
numbers close its standard error.

It needs a CUDA device (as many as the cell's chips) and exits non-zero
without printing a result when there is none, or when JAX or the JAX
package has been loaded into the process (in a multi-card cell, into any
rank's).
"""

from __future__ import annotations

import time

STARTED = time.time()  # set-up is counted from here: the imports are part of it

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every kernel cache in fixed directories inside the checkout (the
    program builds its own libraries under ``theano_pyglm_torch/_build``)."""
    base = CHECKOUT / ".bench_cache"
    os.environ.setdefault("CUDA_CACHE_PATH", str(base / "nv"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"


def _fail(msg: str, code: int) -> None:
    print(f"bench_port: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def result_line(out: dict, device: dict) -> dict:
    """The printed object; ``checks`` last."""
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in out["checks"].values())
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": {k: {"value": float(v), "unit": u} for k, (v, u) in out["metrics"].items()},
            "device": device}
    if "trace_summary" in out:
        line["breakdown"] = out["trace_summary"]["breakdown"]
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from bench_port import harness

    cell = harness.resolve(args.workload)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available():
        _fail("no CUDA device: this benchmark runs on the card only", 2)
    if torch.cuda.device_count() < chips:
        _fail(f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} present", 2)
    if chips > 1:
        # one process a card: this one only waits for them
        out = harness.run_ranks(args.workload, args.seed, args.seconds, bool(args.trace), chips, started=STARTED)
    else:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, started=STARTED)
        out["kind"] = torch.cuda.get_device_name(device)
    loaded = sorted(set(harness.forbidden_loaded()) | set(out.get("forbidden", ())))
    if loaded:
        _fail(f"forbidden modules loaded in the run: {loaded}", 3)
    dev = {"platform": "gpu", "kind": out["kind"], "count": chips, "memory_peak_bytes": int(out["peak"])}
    if args.trace:
        dev.update(busy_s=out["trace_summary"]["busy_s"], window_s=out["trace_summary"]["window_s"])
    line = result_line(out, dev)
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
