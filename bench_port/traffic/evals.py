"""Traffic driver ``evals``: value and gradient of the full log-joint in a
closed loop, the call that ``map_fit``'s L-BFGS makes
(``inference.map.value_and_grad`` over the continuous leaves). Each
gradient is consumed by a step of ``step`` along it, as ``bench.py`` and
``chip_smoke.evals_per_sec`` (whose loop this is) do, so every evaluation
is at a new point.

``design``: ``resident`` builds the (T, N, B) spike design once in set-up;
``streamed`` keeps only the spikes (``materialize_design=False``) and the
population rebuilds each block of ``time_chunk`` bins per evaluation.

Read against the reference once the window has closed: the gradient
(``grad_gap``, compared) and the value (``logjoint_gap``, read and not
compared: the TF32 control does not separate it from the program's own
rounding) of the last evaluation, at the point it was made.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from theano_pyglm_torch import Population
from theano_pyglm_torch.inference.map import split_params, value_and_grad

from bench_port import yardstick
from bench_port.inputs import make_inputs
from bench_port.reference import glm as ref
from bench_port.trace import profiled, span


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def setup(ctx) -> dict:
    cfg, tr, dev, seed = ctx["config"], ctx["traffic"], ctx["device"], ctx["seed"]
    inp = make_inputs(cfg, seed, dev)
    streamed = tr["design"] == "streamed"
    pop = Population(cfg["spec"], device=dev, time_chunk=tr["time_chunk"] if streamed else None)
    data = pop.prepare_data(inp["S"], stim=inp["stim"], materialize_design=not streamed)
    q, frozen = split_params(inp["params"])
    st = {"pop": pop, "data": data, "inputs": inp, "frozen": frozen, "q": {k: v.clone() for k, v in q.items()},
          "bad": torch.zeros((), dtype=torch.int64, device=dev)}
    for _ in range(tr["warm_evals"]):
        _step(ctx, st)
    return st


def _step(ctx, st) -> None:
    pop, data, frozen, q = st["pop"], st["data"], st["frozen"], st["q"]
    val, g = value_and_grad(lambda p: pop.log_joint({**frozen, **p}, data), q)
    st["last"] = (q, val, g)
    st["bad"] += ~torch.isfinite(val)
    with torch.no_grad():
        st["q"] = {k: v + ctx["traffic"]["step"] * g[k] for k, v in q.items()}


def _run(ctx, st, n_max=None, seconds=None, name=None) -> tuple:
    st["bad"].zero_()
    n = 0
    t0 = time.perf_counter()
    while True:
        if name is None:
            _step(ctx, st)
        else:
            with span(name):
                _step(ctx, st)
        n += 1
        if (n_max is not None and n >= n_max) or (seconds is not None and time.perf_counter() - t0 >= seconds):
            break
    _sync(ctx["device"])
    return n, time.perf_counter() - t0


def window(ctx, st) -> dict:
    _sync(ctx["device"])
    n, wall = _run(ctx, st, seconds=ctx["seconds"])
    return {"attempted": n, "failed": int(st["bad"]), "metrics": {"evals_per_s": (n / wall, "evals/s")}}


def _blocks(ctx) -> list:
    """The (T, NB, N) shape of each fused call of one evaluation."""
    tr, spec = ctx["traffic"], ctx["config"]["spec"]
    T, N = ctx["config"]["T"], spec["N"]
    NB = N * spec["impulse"]["basis"]["n_bas"]
    if tr["design"] != "streamed":
        return [(T, NB, N)]
    return [(min(tr["time_chunk"], T - t0), NB, N) for t0 in range(0, T, tr["time_chunk"])]


def traced(ctx, st) -> dict:
    """``timed_evals`` evaluations on the host clock (the profiler, once
    attached, slows host launches), then ``trace_evals`` under the
    profiler."""
    dev = ctx["device"]
    _sync(dev)
    timed, timed_s = _run(ctx, st, n_max=ctx["traffic"]["timed_evals"])
    with profiled(dev) as pr:
        with span("window"):
            n, _ = _run(ctx, st, n_max=ctx["traffic"]["trace_evals"], name="eval")
    spec = ctx["config"]["spec"]
    N, B = spec["N"], spec["impulse"]["basis"]["n_bas"]
    DB = spec["bkgd"]["D_stim"] * spec["bkgd"]["basis"]["n_bas"]
    flops = yardstick.eval_flops(ctx["config"]["T"], N, B, DB)
    return {"attempted": n, "failed": int(st["bad"]), "trace": pr.trace, "steps": n,
            "timed_steps": timed, "timed_s": timed_s, "flops_per_step": sum(flops.values()), "k2_blocks": _blocks(ctx)}


def outputs(ctx, st) -> dict:
    q, val, g = st["last"]
    keep = {k: v.detach().clone() for k, v in q.items()}
    return {"params": {**st["frozen"], **keep}, "value": val.detach().clone(),
            "grads": {k: v.detach().clone() for k, v in g.items()},
            "S": st["inputs"]["S"], "stim": st["inputs"]["stim"]}


def _values(ctx, judged, precision: str) -> dict:
    v, g, _, _ = ref.log_joint_and_grad(ctx["config"]["spec"], judged["params"], judged["S"], judged["stim"],
                                        block=ctx["traffic"]["ref_block"], precision=precision)
    return {"value": torch.tensor(v, dtype=torch.float64), "grads": {k: g[k].double() for k in judged["grads"]}}


def control_outputs(ctx, judged) -> dict:
    """The value and gradient as the control makes them: the reference in
    TF32 put in the program's place, at the same point."""
    return _values(ctx, judged, "tf32")


def readings(ctx, judged) -> dict:
    """The numbers of ``judged`` (the program's outputs, or the control's)
    against the float64 reference."""
    want = _values(ctx, judged, "float64")
    v = float(judged["value"])
    value_gap = abs(v - float(want["value"])) / abs(float(want["value"]))
    norms = {k: float(torch.linalg.norm(g)) for k, g in want["grads"].items()}
    floor = float(np.median(list(norms.values())))
    grad_gap = max(float(torch.linalg.norm(judged["grads"][k].double() - g)) / max(norms[k], floor)
                   for k, g in want["grads"].items())
    return {"logjoint_gap": value_gap, "grad_gap": grad_gap}


def check(ctx, judged) -> dict:
    r = readings(ctx, judged)
    return {k: {"value": r[k], "limit": lim} for k, lim in ctx["cell"]["workload"]["limits"].items()}
