"""The harness: a cell is found by its name, and everything it is made of
by the names in its files.

    bench_port/workloads/<cell>.json   config, traffic, chips, limits
    bench_port/configs/<config>.json   the model's sizes and recipe
    bench_port/traffic/<traffic>.json  the traffic's parameters and its driver
    bench_port/traffic/<driver>.py     setup / window / traced / outputs / check
    bench_port/metrics/<metric>.py     read(ctx) -> a number, or None

A traced run reads the per-layer metrics that ``BENCHMARK.json`` lists for
the cell (:func:`per_layer_metrics`), each by the reader named as it is, or
as the part of its name before the first dot (``mfu_pct.sampler`` and
``mfu_pct.evals`` are both read by ``metrics/mfu_pct.py``).

A later cell, traffic mix, configuration or per-layer metric is a new file
beside these, and an entry in ``BENCHMARK.json``; no file here names one.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import multiprocessing
import re
import socket
import sys
import time
import traceback
from pathlib import Path

import torch

__all__ = ["HERE", "FORBIDDEN", "load_json", "load_module", "resolve", "forbidden_loaded", "run_cell",
           "run_ranks", "metric_names", "per_layer_metrics", "reader"]

HERE = Path(__file__).resolve().parent
#: top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "theano_pyglm_tpu")
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _path(kind: str, name: str, suffix: str) -> Path:
    if not _NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = HERE / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} ({path})")
    return path


def load_json(kind: str, name: str) -> dict:
    with open(_path(kind, name, ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    path = _path(kind, name, ".py")
    mod_name = f"bench_port._{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_names() -> list:
    """The readers under ``metrics/``, by name."""
    return sorted(p.stem for p in (HERE / "metrics").glob("*.py") if not p.name.startswith("_"))


def reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<metric>.py``, or else the
    one named by the part of ``metric`` before its first dot."""
    name = metric if (HERE / "metrics" / f"{metric}.py").is_file() else metric.split(".")[0]
    return load_module("metrics", name)


def per_layer_metrics(workload: str) -> list:
    """The per-layer metrics of ``BENCHMARK.json`` that the cell reports:
    those whose ``workloads`` name it, and those without ``workloads``
    whose ``moves`` is an end-to-end metric the cell reports."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in bench["end_to_end"] if workload in m.get("workloads", [workload])}
    return [m["name"] for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def resolve(workload: str) -> dict:
    """The cell's workload, configuration and traffic dicts and its driver."""
    w = load_json("workloads", workload)
    traffic = load_json("traffic", w["traffic"])
    return {"name": workload, "workload": w, "config": load_json("configs", w["config"]),
            "traffic": traffic, "driver": load_module("traffic", traffic["driver"])}


def forbidden_loaded() -> list:
    """The forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: torch.device, mesh=None,
             host_group=None, started=None, metrics=None) -> dict:
    """One run of a resolved cell: set-up, the measured (or traced) window,
    the program's outputs kept, its state freed, then the comparison with
    the reference. Returns {"metrics", "checks", "peak", "attempted",
    "failed"} and, traced, "trace_summary" (busy_s, window_s, breakdown);
    a rank of a multi-card cell (``mesh``, its ``host_group`` a gloo group
    of the same ranks) also its "rank" timings. ``setup_s`` runs from
    ``started`` (``time.time()``; default: now) to the window's start.
    ``metrics``: the per-layer metrics a traced run reads (default: the
    cell's in ``BENCHMARK.json``)."""
    drv = cell["driver"]
    ctx = {"cell": cell, "config": cell["config"], "traffic": cell["traffic"], "seed": int(seed),
           "device": device, "seconds": float(seconds), "mesh": mesh, "host_group": host_group}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    started = time.time() if started is None else started
    st = drv.setup(ctx)
    _sync(device)
    setup_s = time.time() - started
    if trace:
        measured = drv.traced(ctx, st)
    else:
        measured = drv.window(ctx, st)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    judged = drv.outputs(ctx, st)
    del st
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check(ctx, judged)
    out = {"checks": checks, "peak": peak, "attempted": measured["attempted"], "failed": measured["failed"]}
    if trace:
        ctx.update(measured)
        values = {}
        for name in per_layer_metrics(cell["name"]) if metrics is None else metrics:
            mod = reader(name)
            v = mod.read(ctx)
            if v is not None:
                values[name] = (v, mod.UNIT)
        out["metrics"] = values
        tr = measured["trace"]
        out["trace_summary"] = {"busy_s": tr.busy_s(), "window_s": tr.window_s, "breakdown": tr.breakdown()}
    else:
        out["metrics"] = dict(measured.get("metrics", {}), setup_s=(setup_s, "s"),
                              peak_mem_gib=(peak / 2**30, "GiB"))
        if "rank" in measured:
            out["rank"] = measured["rank"]
    return out


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _function(spec: str):
    mod, fn = spec.split(":")
    return getattr(importlib.import_module(mod), fn)


def _rank(workload, seed, seconds, trace, rank, ranks, port, device_type, cell_of, patches, started, metrics,
          queue) -> None:
    """One rank of a multi-card cell, in a process of its own: joins the
    group, runs the cell on its card, and puts (rank, its result or the
    traceback) on ``queue``; the result's "forbidden" lists the forbidden
    modules loaded in this process. ``cell_of``: "module:function" that
    resolves the cell by name. ``patches``: (module, or "driver",
    attribute, "module:function") set before the run (a test's faults)."""
    from theano_pyglm_torch.parallel import distributed
    from theano_pyglm_torch.parallel.mesh import chain_mesh

    try:
        dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
        distributed.initialize(f"localhost:{port}", ranks, rank, device=dev)
        host_group = torch.distributed.new_group(backend="gloo")
        cell = _function(cell_of)(workload)
        for where, attr, target in patches:
            setattr(cell["driver"] if where == "driver" else importlib.import_module(where), attr, _function(target))
        out = run_cell(cell, seed, seconds, trace, dev, chain_mesh(), host_group, started, metrics)
        out["kind"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        out["forbidden"] = forbidden_loaded()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        distributed.shutdown()


def run_ranks(workload: str, seed: int, seconds: float, trace: bool, ranks: int, device_type: str = "cuda",
              cell_of: str = "bench_port.harness:resolve", patches=(), timeout: float = 340.0,
              started=None, metrics=None) -> dict:
    """A multi-card cell: one process a card (``spawn``), a group on a free
    local port, every rank running :func:`run_cell` on its block of the
    chains. Returns what :func:`run_cell` returns, over all ranks: the
    chain-sweeps of every rank over the longest window, the longest set-up,
    the largest peak, the worst reading of each compared number, per-layer
    metrics and device times averaged over the ranks, rank 0's breakdown,
    and under "forbidden" the forbidden modules that any rank loaded. Each
    rank's set-up runs from ``started`` (default: now), before the
    processes start."""
    started = time.time() if started is None else started
    mp = multiprocessing.get_context("spawn")
    queue = mp.Queue()
    port = _free_port()
    procs = [mp.Process(target=_rank, args=(workload, seed, seconds, trace, r, ranks, port, device_type, cell_of,
                                             tuple(patches), started, metrics, queue))
             for r in range(ranks)]
    for p in procs:
        p.start()
    outs = {}
    try:
        deadline = time.monotonic() + timeout
        while len(outs) < ranks:
            r, out = queue.get(timeout=max(1.0, deadline - time.monotonic()))
            if isinstance(out, str):
                raise RuntimeError(f"rank {r} failed:\n{out}")
            outs[r] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    first = outs[0]
    combined = {"attempted": sum(o["attempted"] for o in outs.values()),
                "failed": sum(o["failed"] for o in outs.values()),
                "peak": max(o["peak"] for o in outs.values()),
                "checks": {k: {"value": max(o["checks"][k]["value"] for o in outs.values()), "limit": c["limit"]}
                           for k, c in first["checks"].items()}}
    names = set.intersection(*(set(o["metrics"]) for o in outs.values()))
    combined["kind"] = first["kind"]
    combined["forbidden"] = sorted(set().union(*(o["forbidden"] for o in outs.values())))
    combined["metrics"] = {k: (sum(o["metrics"][k][0] for o in outs.values()) / ranks, first["metrics"][k][1])
                           for k in names}
    if trace:
        summaries = [o["trace_summary"] for o in outs.values()]
        combined["trace_summary"] = {"busy_s": sum(t["busy_s"] for t in summaries) / ranks,
                                     "window_s": sum(t["window_s"] for t in summaries) / ranks,
                                     "breakdown": first["trace_summary"]["breakdown"]}
    else:
        longest = max(o["rank"]["wall_s"] for o in outs.values())
        combined["metrics"]["chain_sweeps_per_s"] = (
            sum(o["rank"]["chain_sweeps"] for o in outs.values()) / longest, "chain-sweeps/s")
        combined["metrics"]["setup_s"] = (max(o["metrics"]["setup_s"][0] for o in outs.values()), "s")
        combined["metrics"]["peak_mem_gib"] = (combined["peak"] / 2**30, "GiB")
    return combined
