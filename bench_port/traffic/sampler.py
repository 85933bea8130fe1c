"""Traffic driver ``sampler``: the chain-batched Gibbs sweep in a closed loop.

Set-up draws the inputs, builds the population and its designs, starts C
chains at the generating parameters jittered by ``init_jitter``, and runs
an adapting warm-up of the configuration's ``n_warmup`` sweeps; the chains then take the
across-chain median step size and mass, as ``gibbs_sample_chains`` does at
the end of its warm-up, and ``settle_sweeps`` sampling sweeps warm the
window's path. The window steps the sweep of ``make_sweep`` as
``parallel.chains`` / ``mcmc._run`` step it (C generators, the state stacked
on the chain axis, adapt off, β = 1), keeps every ``thin``-th state and
copies the kept draws to the host every ``chunk_size`` sweeps and at the end.

Once the window has closed, the state it ended in goes once more through
the sweep's adjacency stage, and once through its two HMC stages (impulse
weights, latent locations), each as ``make_sweep(stages=...)`` runs it
alone, with the window's own generators, whose states are kept. Read against
the reference, chain by chain (:func:`readings`):

- ``adj_gap``: each adjacency entry's (A, W) against the reference's
  replay of the stage from the same state and draws (``reference/sweep``),
  |ΔA| + |ΔW|/σ_W from the nearest outcome it allows, worst entry of the
  worst chain;
- ``hmc_gap``: each HMC transition's position against the reference's
  leapfrog from the same state, momentum and uniform, over the length of
  the reference's move, worst block of the worst chain;
- ``grad_gap``: the gradient of the log-joint over the continuous leaves
  at the state the window ended in, through the program's chain-batched
  likelihood (K3-vg in each group of chains), worst leaf of the worst
  chain, against the larger of that leaf's norm and the median leaf's;
- ``stuck_chains``: chains whose continuous leaves did not move over the
  window;
- ``imp_logp_gap``: the impulse block's log-density as the window's last
  HMC transition cached it, at the parameters that transition saw;
- ``logjoint_gap``: the log-joint's value at the final state.

The workload's ``limits`` name the numbers compared. The last two values
are read and not compared: the TF32 control reads them within 1–4 times
the program's own float32 rounding, so no limit separates the two.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from theano_pyglm_torch import Population
from theano_pyglm_torch.inference.mcmc import init_mcmc_state, make_sweep
from theano_pyglm_torch.ops.kernels import chain_groups
from theano_pyglm_torch.parallel.chains import _share_adaptation

from bench_port import yardstick
from bench_port.inputs import make_inputs, seeds
from bench_port.reference import glm as ref
from bench_port.reference import sweep as ref_sweep
from bench_port.trace import profiled, span

JITTER_LEAVES = ("bias", "w_stim", "w_ir", "locs", "W")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def setup(ctx, mesh=None) -> dict:
    """Inputs, population, C chains and their warm-up. Under a 'chains'
    ``mesh`` this rank's C chains are block ``mesh.rank`` of C·size, with
    the generators and jitter that block has in a one-process run of all
    of them, and the warm-up's adaptation is shared over every chain."""
    cfg, tr, dev, seed = ctx["config"], ctx["traffic"], ctx["device"], ctx["seed"]
    inp = make_inputs(cfg, seed, dev)
    pop = Population(cfg["spec"], device=dev)
    data = pop.prepare_data(inp["S"], stim=inp["stim"])
    C = tr["chains"]
    size, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    s = seeds(seed, 3 + C * size + 1)[3:]
    gens = [torch.Generator(device=dev).manual_seed(x) for x in s[rank * C:(rank + 1) * C]]
    g_jit = torch.Generator(device=dev).manual_seed(s[C * size])
    params = inp["params"]
    inits = {k: v.expand(C, *v.shape).clone() for k, v in params.items()}
    for k in JITTER_LEAVES:
        if k in inits:
            noise = torch.randn((C * size,) + inits[k].shape[1:], generator=g_jit, dtype=inits[k].dtype,
                                device=dev)
            inits[k] = inits[k] + cfg["init_jitter"] * noise[rank * C:(rank + 1) * C]
    state = init_mcmc_state(pop, inits, step_size=tr["step_size"])
    kw = dict(n_leapfrog=cfg["n_leapfrog"], target_accept=tr["target_accept"], fisher_params=params)
    sweep = make_sweep(pop, data, **kw)
    for _ in range(cfg["n_warmup"]):
        state = sweep(gens, state, True, 1.0)
    state = _share_adaptation(state, mesh)
    for _ in range(tr["settle_sweeps"]):
        state = sweep(gens, state, False, 1.0)
    _to_host([state["params"]])
    return {"pop": pop, "data": data, "inputs": inp, "sweep": sweep, "gens": gens, "state": state,
            "sweep_kw": kw}


def _to_host(chunk: list) -> dict:
    """The kept draws of a chunk, stacked on the device and copied to the host."""
    return {k: torch.stack([p[k] for p in chunk]).cpu().numpy() for k in chunk[0]}


def _run(ctx, st, n_max=None, seconds=None, name=None):
    """Sweeps until ``n_max`` or the host clock passes ``seconds``; the kept
    draws go to the host every chunk and at the end."""
    cfg, dev = ctx["config"], ctx["device"]
    sweep, gens, state = st["sweep"], st["gens"], st["state"]
    thin, chunk_size = cfg["thin"], cfg["chunk_size"]
    st["start"] = {k: v.clone() for k, v in state["params"].items()}
    chunk, n = [], 0
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
            _to_host(chunk)
            chunk = []
        if (n_max is not None and n >= n_max) or (seconds is not None and time.perf_counter() - t0 >= seconds):
            break
    if chunk:
        _to_host(chunk)
    _sync(dev)
    st.update(state=state, prev=prev, sweeps=n)
    return n, time.perf_counter() - t0


def _failed(st, n) -> int:
    """Chain-sweeps of the chains whose final state holds a non-finite value."""
    p = st["state"]["params"]
    bad = torch.zeros(p["A"].shape[0], dtype=torch.bool, device=p["A"].device)
    for v in p.values():
        if v.is_floating_point():
            bad |= ~torch.isfinite(v.reshape(v.shape[0], -1)).all(-1)
    return int(bad.sum()) * n


def window(ctx, st) -> dict:
    C = ctx["traffic"]["chains"]
    _sync(ctx["device"])
    n, wall = _run(ctx, st, seconds=ctx["seconds"])
    return {"attempted": n * C, "failed": _failed(st, n),
            "metrics": {"chain_sweeps_per_s": (n * C / wall, "chain-sweeps/s")}}


def _stage_sweep(ctx, st, stages):
    return make_sweep(st["pop"], st["data"], stages=stages, diagnostic=True, **st["sweep_kw"])


def traced(ctx, st, run=None) -> dict:
    """On the host clock first (the profiler, once attached, slows host
    launches): ``timed_sweeps`` full sweeps, then each measured stage alone
    over ``stage_sweeps`` sweeps. Then ``trace_sweeps`` full sweeps under
    the profiler (``run()``, which returns the sweeps it ran, where given),
    and each measured stage once more alone under it, for the idle gaps'
    labels."""
    tr, dev = ctx["traffic"], ctx["device"]
    C = tr["chains"]
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(tr["timed_sweeps"]):
        st["state"] = st["sweep"](st["gens"], st["state"], False, 1.0)
    _sync(dev)
    timed_s = time.perf_counter() - t0
    alone = {"adjacency": _stage_sweep(ctx, st, ("adjacency",)),
             "hmc": _stage_sweep(ctx, st, ("imp", "latent"))}
    stage_ms = {}
    for key, sw in alone.items():
        s = sw(st["gens"], st["state"], False, 1.0)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(tr["stage_sweeps"]):
            s = sw(st["gens"], s, False, 1.0)
        _sync(dev)
        stage_ms[key] = 1e3 * (time.perf_counter() - t0) / tr["stage_sweeps"]
    with profiled(dev) as pr:
        with span("window"):
            n = run() if run is not None else _run(ctx, st, n_max=tr["trace_sweeps"], name="sweep")[0]
        s = st["state"]
        for key, sw in alone.items():
            with span("stage." + key):
                s = sw(st["gens"], s, False, 1.0)
                _sync(dev)
    spec = ctx["config"]["spec"]
    N, B = spec["N"], spec["impulse"]["basis"]["n_bas"]
    DB = spec["bkgd"]["D_stim"] * spec["bkgd"]["basis"]["n_bas"]
    T = ctx["config"]["T"]
    flops = yardstick.sweep_flops(T, N, B, DB, ctx["config"]["n_leapfrog"])
    return {"attempted": n * C, "failed": _failed(st, n), "trace": pr.trace, "steps": n,
            "timed_steps": tr["timed_sweeps"], "timed_s": timed_s,
            "stage_ms": stage_ms, "flops_per_step": C * sum(flops.values()),
            "k3_groups": chain_groups(N * B, N, C), "shape": (T, N * B, N)}


def _gen_states(gens) -> list:
    return [g.get_state() for g in gens]


def outputs(ctx, st) -> dict:
    """What the window produced, kept past the program's state: the final
    and the previous sweep's parameters, the impulse block's cached
    log-density, the log-joint and its gradient at the final state through
    the program's chain-batched entry, and the outputs of the adjacency
    stage and of the HMC stages run once more from the final state, with
    the generators' states before each."""
    pop, data, state = st["pop"], st["data"], st["state"]
    p = state["params"]
    q = {k: v for k, v in p.items() if k in ref.CONTINUOUS}
    frozen = {k: v for k, v in p.items() if k not in ref.CONTINUOUS}
    with torch.enable_grad():
        x = {k: v.detach().requires_grad_(True) for k, v in q.items()}
        val = pop.log_joint({**frozen, **x}, data)
        grads = torch.autograd.grad(val.sum(), list(x.values()))

    def keep(d):
        return {k: v.detach().clone() for k, v in d.items()}

    out = {"final": keep(p), "prev": keep(st["prev"]["params"]), "start": st["start"],
           "imp_logp": state["imp"].log_prob.detach().clone(), "value": val.detach().clone(),
           "grads": dict(zip(x, (g.detach().clone() for g in grads))),
           "S": st["inputs"]["S"], "stim": st["inputs"]["stim"]}
    out["adj_gens"] = _gen_states(st["gens"])
    adj = _stage_sweep(ctx, st, ("adjacency",))(st["gens"], state, False, 1.0)["params"]
    out["adj_out"] = keep({k: adj[k] for k in ("A", "W")})
    out["hmc_gens"] = _gen_states(st["gens"])
    hmc = _stage_sweep(ctx, st, ("imp", "latent"))(st["gens"], state, False, 1.0)
    blocks = [(b, k) for b, k in _HMC_LEAVES if b in state]
    out["hmc_out"] = keep({k: hmc["params"][k] for _, k in blocks})
    out["hmc_step"] = {k: state[b].step_size.detach().clone() for b, k in blocks}
    out["hmc_scale"] = {k: state[b].scale[k].detach().clone() for b, k in blocks}
    return out


#: the sweep's HMC blocks that the check replays, in the sweep's order, and their leaf
_HMC_LEAVES = (("imp", "w_ir"), ("latent", "locs"))


def _imp_params(judged, c):
    """Chain c's parameters as the last sweep's impulse stage saw them: the
    previous state's, with the glm block's and the impulse weights' new
    values."""
    p = {k: v[c] for k, v in judged["prev"].items()}
    for k in ("bias", "w_stim", "w_ir"):
        p[k] = judged["final"][k][c]
    return p


def _chain(d: dict, c: int) -> dict:
    return {k: v[c] for k, v in d.items()}


def _stages(ctx, judged, precision: str, follow: bool) -> dict:
    """The reference's replays of the adjacency and HMC stages, chain by
    chain, in ``precision``: each chain's own outputs {"adj_out", "hmc_out"}
    and, with ``follow``, the gaps of ``judged``'s outputs {"adj_gap",
    "hmc_gap"} (each the worst chain's)."""
    model, n_steps = ctx["config"]["spec"], ctx["config"]["n_leapfrog"]
    S, stim = judged["S"], judged["stim"]
    T, N = S.shape
    dev = S.device
    blocks = ref.design_blocks(model, S, stim, precision=precision)
    f = ref._float(precision)
    leaves = list(judged["hmc_out"])
    C = judged["value"].shape[0]
    adj = {"A": [], "W": []}
    hmc = {k: [] for k in leaves}
    adj_gap, hmc_gap = 0.0, 0.0
    for c in range(C):
        p = _chain(judged["final"], c)
        draws = ref_sweep.adjacency_draws(judged["adj_gens"][c], N, T, dev)
        r = ref_sweep.adjacency_replay(model, p, S, stim, draws, precision,
                                       follow=_chain(judged["adj_out"], c) if follow else None)
        for k in adj:
            adj[k].append(r[k])
        if follow:
            adj_gap = max(adj_gap, float(r["gap"].max()))
        moves = ref_sweep.hmc_draws(judged["hmc_gens"][c], [tuple(p[k].shape) for k in leaves], dev)
        pf = {k: v.to(dev, f) for k, v in p.items()}
        for k, (p0, u) in zip(leaves, moves):
            if k == "w_ir":
                target, n_terms = ref_sweep.impulse_target(model, pf, S, stim, blocks, precision), T * N
            else:
                target, n_terms = ref_sweep.latent_target(model, pf, precision), p[k].numel() + N * N
            r = ref_sweep.hmc_replay(target, pf[k], float(judged["hmc_step"][k][c]),
                                     judged["hmc_scale"][k][c].to(dev, f), p0, float(u), n_steps, n_terms,
                                     follow=judged["hmc_out"][k][c] if follow else None)
            hmc[k].append(r["q"])
            if follow:
                hmc_gap = max(hmc_gap, r["gap"])
    out = {"adj_out": {k: torch.stack(v) for k, v in adj.items()},
           "hmc_out": {k: torch.stack(v) for k, v in hmc.items()}}
    if follow:
        out.update(adj_gap=adj_gap, hmc_gap=hmc_gap)
    return out


def _values(ctx, judged, precision: str) -> dict:
    """The log-joint, its gradient and the impulse block's log-density of
    every chain by the reference in ``precision``, at ``judged``'s states."""
    model = ctx["config"]["spec"]
    S, stim = judged["S"], judged["stim"]
    blocks = ref.design_blocks(model, S, stim, precision=precision)
    C = judged["value"].shape[0]
    vals, imp, grads = [], [], {k: [] for k in judged["grads"]}
    for c in range(C):
        v, g, _, _ = ref.log_joint_and_grad(model, _chain(judged["final"], c), S, stim, precision=precision,
                                            blocks=blocks)
        vals.append(v)
        for k in grads:
            grads[k].append(g[k].double())
        pc = _imp_params(judged, c)
        ll, _ = ref.log_likelihood_and_grad(model, pc, S, stim, precision=precision, blocks=blocks)
        _, parts, _ = ref.log_prior_and_grad(model, pc, precision)
        imp.append(ll + parts["impulse"])
    dev = judged["value"].device
    return {"value": torch.tensor(vals, dtype=torch.float64, device=dev),
            "imp_logp": torch.tensor(imp, dtype=torch.float64, device=dev),
            "grads": {k: torch.stack(v) for k, v in grads.items()}}


def control_outputs(ctx, judged) -> dict:
    """The outputs of :func:`outputs` as the control makes them: the
    reference in TF32 put in the program's place, at the same states and
    with the same draws."""
    return {**_values(ctx, judged, "tf32"), **_stages(ctx, judged, "tf32", follow=False)}


def readings(ctx, judged) -> dict:
    """Every number of ``judged`` (the program's outputs, or the control's)
    against the float64 reference: each the worst chain's."""
    want = _values(ctx, judged, "float64")
    val = judged["value"].double()
    imp = judged["imp_logp"].double()
    value_gap = ((val - want["value"]).abs() / want["value"].abs()).max()
    imp_gap = ((imp - want["imp_logp"]).abs() / want["imp_logp"].abs()).max()
    grad_gap = 0.0
    C = val.shape[0]
    for c in range(C):
        norms = {k: float(torch.linalg.norm(want["grads"][k][c])) for k in want["grads"]}
        floor = float(np.median(list(norms.values())))
        for k, g in want["grads"].items():
            d = float(torch.linalg.norm(judged["grads"][k][c].double() - g[c]))
            grad_gap = max(grad_gap, d / max(norms[k], floor))
    stuck = 0
    for c in range(C):
        if all(torch.equal(judged["final"][k][c], judged["start"][k][c])
               for k in ref.CONTINUOUS if k in judged["final"]):
            stuck += 1
    stages = _stages(ctx, judged, "float64", follow=True)
    return {"adj_gap": stages["adj_gap"], "hmc_gap": stages["hmc_gap"], "imp_logp_gap": float(imp_gap),
            "logjoint_gap": float(value_gap), "grad_gap": grad_gap, "stuck_chains": float(stuck)}


def check(ctx, judged) -> dict:
    r = readings(ctx, judged)
    return {k: {"value": r[k], "limit": lim} for k, lim in ctx["cell"]["workload"]["limits"].items()}
