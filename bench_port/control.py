#!/usr/bin/env python3
"""Readings that a cell's limits are set from: for each seed, the numbers
that ``run.py`` compares, read from the program (a short window at the
cell's own load) and from the control, the reference computed in TF32 and
put in the program's place at the same states.

    python3 bench_port/control.py --workload flagship-c16 --seeds 11,12,13 --seconds 5 [--control-seeds 3]

One JSON line per seed on standard output: {"seed", "program": {number:
reading}, "control": {...}} (the control on the first ``--control-seeds``
seeds only). The benchmark's own runs do not run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def readings(cell: dict, seed: int, seconds: float, device, control: bool) -> dict:
    """{"program": gaps, "control": gaps or None} of one seed."""
    import torch

    drv = cell["driver"]
    ctx = {"cell": cell, "config": cell["config"], "traffic": cell["traffic"], "seed": seed,
           "device": device, "seconds": seconds}
    st = drv.setup(ctx)
    drv.window(ctx, st)
    judged = drv.outputs(ctx, st)
    del st
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"program": drv.readings(ctx, judged), "control": None}
    if control:
        out["control"] = drv.readings(ctx, {**judged, **drv.control_outputs(ctx, judged)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from bench_port import harness

    if not torch.cuda.is_available():
        print("bench_port: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload)
    device = torch.device("cuda", 0)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        r = readings(cell, seed, args.seconds, device, i < args.control_seeds)
        print(json.dumps({"seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
