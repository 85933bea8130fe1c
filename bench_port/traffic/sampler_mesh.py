"""Traffic driver ``sampler_mesh``: the ``sampler`` driver's chains split
over the ranks of a 'chains' mesh, one process a card, as
``parallel.chains.gibbs_sample_chains(mesh=...)`` splits them: each rank
runs its block of C chains (C·size in all) with the generators and jitter
that block has in a one-process run, the warm-up's adaptation is shared
over every chain, and the kept draws are gathered in chain order
(``parallel.mesh.gather_chains``) every chunk and at the end, where the
final state of every chain is gathered too.

The window runs on every rank at once. Every ``thin`` sweeps the ranks
agree, by an all-reduce of one flag over a host (gloo) group, whether any
rank's clock has passed ``--seconds``, so each rank stops after the same
sweep and the gathers match. A rank's own time is its window less its waits
in that agreement.

Read as ``sampler`` reads them, on each rank's own chains, plus
``chains_missing``: the chains that the final state's gather did not bring.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from theano_pyglm_torch.parallel.mesh import gather_chains

from bench_port.traffic import sampler as base
from bench_port.trace import span


def setup(ctx) -> dict:
    st = base.setup(ctx, ctx["mesh"])
    _gather(ctx, [st["state"]["params"]])
    return st


def _gather(ctx, chunk: list) -> dict:
    """A chunk's kept draws of every chain, in chain order, on the host."""
    kept = {k: torch.stack([p[k] for p in chunk]) for k in chunk[0]}
    return {k: v.cpu().numpy() for k, v in gather_chains(kept, ctx["mesh"], 1).items()}


def _run(ctx, st, seconds=None, n_max=None, name=None) -> tuple:
    """(sweeps, window seconds, seconds waited for the other ranks)."""
    cfg = ctx["config"]
    sweep, gens, state = st["sweep"], st["gens"], st["state"]
    thin, chunk_size = cfg["thin"], cfg["chunk_size"]
    st["start"] = {k: v.clone() for k, v in state["params"].items()}
    chunk, n, waited = [], 0, 0.0
    t0 = time.perf_counter()
    while True:
        prev = state
        if name is None:
            state = sweep(gens, state, False, 1.0)
        else:
            with span(name):
                state = sweep(gens, state, False, 1.0)
        n += 1
        if n % thin == 0:
            chunk.append(state["params"])
        if n % chunk_size == 0:
            _gather(ctx, chunk)
            chunk = []
        if n_max is not None:
            if n >= n_max:
                break
        elif n % thin == 0:
            flag = torch.tensor([int(time.perf_counter() - t0 >= seconds)])
            w0 = time.perf_counter()
            dist.all_reduce(flag, dist.ReduceOp.MAX, group=ctx["host_group"])
            waited += time.perf_counter() - w0
            if flag.item():
                break
    if chunk:
        _gather(ctx, chunk)
    # every rank ends holding every chain's state, as gibbs_sample_chains returns it
    st["gathered"] = _gather(ctx, [state["params"]])["A"].shape[1]
    base._sync(ctx["device"])
    st.update(state=state, prev=prev, sweeps=n)
    return n, time.perf_counter() - t0, waited


def window(ctx, st) -> dict:
    C = ctx["traffic"]["chains"]
    base._sync(ctx["device"])
    n, wall, waited = _run(ctx, st, seconds=ctx["seconds"])
    return {"attempted": n * C, "failed": base._failed(st, n),
            "rank": {"chain_sweeps": n * C, "wall_s": wall, "own_s": wall - waited}}


def traced(ctx, st) -> dict:
    """Each rank's own sweep rate over ``rank_sweeps`` sweeps, every rank
    at once and none waiting for another, gathered over the host group;
    then the stages alone and the profiled window as ``sampler`` has them,
    the window closing with the ranks' gather."""
    tr, dev = ctx["traffic"], ctx["device"]
    C = tr["chains"]
    base._sync(dev)
    t0 = time.perf_counter()
    s = st["state"]
    for _ in range(tr["rank_sweeps"]):
        s = st["sweep"](st["gens"], s, False, 1.0)
    base._sync(dev)
    rate = torch.tensor([tr["rank_sweeps"] * C / (time.perf_counter() - t0)], dtype=torch.float64)
    rates = [torch.zeros_like(rate) for _ in range(ctx["mesh"].size)]
    dist.all_gather(rates, rate, group=ctx["host_group"])
    out = base.traced(ctx, st, run=lambda: _run(ctx, st, n_max=tr["trace_sweeps"], name="sweep")[0])
    out["rank_rates"] = [float(r) for r in rates]
    return out


def outputs(ctx, st) -> dict:
    out = base.outputs(ctx, st)
    out["gathered"] = st["gathered"]
    out["total"] = ctx["traffic"]["chains"] * ctx["mesh"].size
    return out


control_outputs = base.control_outputs


def readings(ctx, judged) -> dict:
    return {**base.readings(ctx, judged), "chains_missing": float(judged["total"] - judged["gathered"])}


def check(ctx, judged) -> dict:
    r = readings(ctx, judged)
    return {k: {"value": r[k], "limit": lim} for k, lim in ctx["cell"]["workload"]["limits"].items()}
