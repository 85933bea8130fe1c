"""Cells of ``bench_port/workloads`` cut to a size a CPU test can hold:
the same files, with the sizes below put over them."""

from __future__ import annotations

import copy
import sys
import types

import torch

from bench_port import harness

SIZES = {"N": 4, "T": 1_500, "chains": 2, "n_warmup": 2, "time_chunk": 400, "ref_block": 512}


def cell(workload: str, **limits) -> dict:
    """The resolved cell ``workload`` at the tiny sizes; ``limits`` replace
    the workload's."""
    c = harness.resolve(workload)
    c = {**c, "config": copy.deepcopy(c["config"]), "traffic": copy.deepcopy(c["traffic"]),
         "workload": copy.deepcopy(c["workload"])}
    cfg, tr = c["config"], c["traffic"]
    cfg["spec"]["N"] = SIZES["N"]
    cfg["T"] = SIZES["T"]
    if "n_warmup" in cfg:
        cfg["n_warmup"] = SIZES["n_warmup"]
        cfg["chunk_size"] = 7
        cfg["thin"] = 2
    for k in ("chains", "time_chunk", "ref_block"):
        if k in tr:
            tr[k] = SIZES[k]
    for k in ("trace_sweeps", "stage_sweeps", "rank_sweeps"):
        if k in tr:
            tr[k] = 2
    if "trace_evals" in tr:
        tr["trace_evals"] = 3
    c["workload"]["limits"].update(limits)
    return c


def run(workload: str, seed: int = 3, seconds: float = 0.3, trace: bool = False, **limits) -> dict:
    torch.manual_seed(0)
    return harness.run_cell(cell(workload, **limits), seed, seconds, trace, torch.device("cpu"))


def local_gather(tree, mesh, dim=0):
    """``gather_chains`` with the exchange between ranks left out."""
    return tree


def unchanged_make_sweep(*args, **kw):
    """``make_sweep`` whose sweep returns the state it was given."""
    return lambda gens, state, adapt, beta=1.0: state


def setup_loading_jax_on_rank_1(ctx):
    """The four-card driver's set-up, with a module named ``jax`` loaded on
    rank 1 only."""
    from bench_port.traffic import sampler_mesh

    if ctx["mesh"].rank == 1:
        sys.modules["jax"] = types.ModuleType("jax")
    return sampler_mesh.setup(ctx)
