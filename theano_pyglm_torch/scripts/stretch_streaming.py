#!/usr/bin/env python3
"""Long-recording run on the PyTorch port: N=100 neurons, T=600,000 bins
(10 min at 1 ms) — the counterpart of ``scripts/stretch_streaming.py``,
with the same model, planted network, stimulus and report keys.

  * MAP streams the design: ``prepare_data(materialize_design=False)`` and
    ``time_chunk=65,536``, so the (T, N, B) spike design (1.2 GB here) is
    never built; each block rebuilds its own from the spikes with the exact
    L-bin causal halo and launches K2 (value+grad) or K1 (value) once;
  * MCMC runs on the resident (materialized) design, and the adjacency
    birth–death builds the unit-coupling tensor ψ (T, N, N), 24 GB in
    full, ``row_batch=4`` postsynaptic rows at a time (960 MB).

MAP stops after at most 480 L-BFGS iterations, or once 40 iterations
changed the log-joint by less than 1e-3 of its size; MCMC checkpoints every
chunk into ``<resultsDir>/ckpt`` and a rerun resumes from there.

Writes ``<resultsDir>/stretch_report.json``: wall clocks, ms per sweep,
acceptance rates, link-prediction AUC against the generating network and
Geyer ESS of the connected weights.

  python3 -m theano_pyglm_torch.scripts.stretch_streaming [-r results/stretch_torch]
  python3 -m theano_pyglm_torch.scripts.stretch_streaming --quick --device cpu   # N=10, T=6,000
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

MAP_MAX_ITER, MAP_TOL, MAP_WINDOW = 480, 1e-3, 40
TIME_CHUNK = 65_536


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def planted(dev, N: int, T: int, pop_cls=None):
    """(spec, population, generating parameters, stimulus (T, 1) numpy):
    ``sparse_weighted_model`` with bias N(2.3, 0.3), edges from the ER prior
    draw and weights ±1.5 with equal probability, inhibitory self-coupling
    (−2.0): acceptance config 2's recipe, balanced so that the in-degree at
    N=100 does not run away. ``pop_cls`` defaults to ``Population``."""
    from theano_pyglm_torch import Population, make_model

    spec = make_model("sparse_weighted_model", N)
    spec["bias"] = {"mu": 2.3, "sigma": 0.3}
    pop = (pop_cls or Population)(spec, device=dev)
    true = pop.sample(torch.Generator(device=dev).manual_seed(0))
    rngw = np.random.RandomState(1)
    Wp = np.where(rngw.rand(N, N) < 0.5, 1.5, -1.5).astype(np.float32)
    np.fill_diagonal(Wp, -2.0)
    true["W"] = torch.as_tensor(Wp, device=dev, dtype=pop.dtype) * true["A"]
    stim = np.random.RandomState(2).randn(T, 1).astype(np.float32)
    return spec, pop, true, stim


def simulate(pop, true, T: int, stim):
    """The recording: (S, rates), spikes drawn by a generator seeded with 3."""
    return pop.simulate(torch.Generator(device=pop.device).manual_seed(3), true, T, stim=stim)


def fit_streamed(pop_stream, data_stream):
    """MAP on streamed data from the smart initialization with A all ones:
    (params, log-joint, iterations)."""
    from theano_pyglm_torch.inference import map_fit
    from theano_pyglm_torch.inference.smart_init import smart_initialize

    init = smart_initialize(pop_stream, data_stream)
    init["A"] = torch.ones((pop_stream.N, pop_stream.N), device=pop_stream.device, dtype=pop_stream.dtype)
    return map_fit(pop_stream, data_stream, init, max_iter=MAP_MAX_ITER, tol=MAP_TOL, window=MAP_WINDOW)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true", help="N=10, T=6,000 (a CPU smoke run)")
    ap.add_argument("--resultsDir", "-r", default="results/stretch_torch")
    ap.add_argument("--n_warmup", type=int, default=150)
    ap.add_argument("--n_samples", type=int, default=300)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, or cpu)")
    args = ap.parse_args(argv)
    q = args.quick

    from theano_pyglm_torch import Population
    from theano_pyglm_torch.inference import gibbs_sample
    from theano_pyglm_torch.utils.diagnostics import ess

    dev = torch.device(args.device)
    N = 10 if q else 100
    T = 6_000 if q else 600_000
    report = {"N": N, "T": T, "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    report["psi_full_gb"] = round(T * N * N * 4 / 1e9, 1)
    report["x_imp_gb"] = round(T * N * 5 * 4 / 1e9, 2)

    spec, pop, true, stim = planted(dev, N, T)
    t0 = time.time()
    S, rates = simulate(pop, true, T, stim)
    _sync(dev)
    report["simulate_s"] = round(time.time() - t0, 1)
    report["mean_rate_hz"] = round(float(rates.mean()), 2)
    report["spikes"] = int(S.sum())
    print(f"simulated: {report}", flush=True)

    # ---- MAP, streamed: the design is never materialized -----------------
    t0 = time.time()
    chunk = 2_000 if q else TIME_CHUNK
    pop_stream = Population(spec, time_chunk=chunk, device=dev)
    data_stream = pop_stream.prepare_data(S, stim=stim, materialize_design=False)
    fit, logp, iters = fit_streamed(pop_stream, data_stream)
    with torch.no_grad():
        logp_true = float(pop_stream.log_joint(true, data_stream))
    report["map_streaming"] = {
        "log_joint": float(logp),
        "log_joint_at_truth": logp_true,
        "iters": int(iters),
        "wall_s": round(time.time() - t0, 1),
        "time_chunk": chunk,
    }
    print(f"MAP done: {report['map_streaming']}", flush=True)

    # ---- MCMC: the resident design (1.2 GB), ψ row-batched ---------------
    data = pop.prepare_data(S, stim=stim)
    row_batch = 2 if q else 4
    n_w, n_s = (20, 30) if q else (args.n_warmup, args.n_samples)
    ticks = []
    t0 = time.time()
    samples, diag, _ = gibbs_sample(
        pop, data, torch.Generator(device=dev).manual_seed(4),
        n_samples=n_s, n_warmup=n_w, thin=1,
        init_params=dict(fit),
        row_batch=row_batch,
        checkpoint_dir=os.path.join(args.resultsDir, "ckpt"),
        resume=True,
        callback=lambda phase, it, st: ticks.append((phase, it, time.time())),
    )
    _sync(dev)
    wall = time.time() - t0
    # ms per sweep between chunk ends, per phase (a resumed run's first
    # chunk includes the restore)
    steady = {}
    for ph in ("warmup", "sample"):
        gaps = [(t1 - t0_) / (i1 - i0)
                for (p0, i0, t0_), (p1, i1, t1) in zip(ticks, ticks[1:])
                if p0 == p1 == ph and i1 > i0]
        if gaps:
            steady[ph] = sorted(gaps)[len(gaps) // 2]
    half = n_s // 2
    A_post = samples["A"][half:].mean(axis=0)
    A_true = true["A"].cpu().numpy()
    off = ~np.eye(N, dtype=bool)
    th = np.sort(np.unique(A_post[off]))[::-1]
    tpr = [(A_post[off][A_true[off] == 1] >= t).mean() for t in th]
    fpr = [(A_post[off][A_true[off] == 0] >= t).mean() for t in th]
    auc = float(np.trapezoid(tpr, fpr))
    W_post = samples["W"][half:].mean(axis=0)
    conn = (A_true > 0) & off
    w_err = float(np.abs((W_post - true["W"].cpu().numpy())[conn]).mean())
    # Geyer ESS of the connected weights' chains (second half), at most ~200 edges
    W_tail = samples["W"][half:][:, conn]  # (half, n_edges)
    W_sub = W_tail[:, :: max(1, W_tail.shape[1] // 200)]
    ess_vals = ess(W_sub[:, None, :])  # (n, 1 chain, p)
    report["mcmc"] = {
        "n_warmup": n_w,
        "n_samples": n_s,
        "row_batch": row_batch,
        "ms_per_sweep": round(wall / (n_w + n_s) * 1e3, 1),
        "ms_per_sweep_steady": {ph: round(v * 1e3, 1) for ph, v in steady.items()},
        "wall_s": round(wall, 1),
        "accept_rate_glm": round(float(diag["accept_rate_glm"]), 3),
        "accept_rate_imp": round(float(diag["accept_rate_imp"]), 3),
        "accept_rate_adjacency": round(float(diag["accept_rate_adjacency"]), 3),
        "link_prediction_auc": round(auc, 3),
        "W_mean_abs_err_connected": round(w_err, 3),
        "ess_W_median": round(float(np.median(ess_vals)), 1),
        "ess_W_min": round(float(np.min(ess_vals)), 1),
    }
    print(f"MCMC done: {report['mcmc']}", flush=True)

    os.makedirs(args.resultsDir, exist_ok=True)
    with open(os.path.join(args.resultsDir, "stretch_report.json"), "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
