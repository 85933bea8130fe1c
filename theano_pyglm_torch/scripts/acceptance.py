#!/usr/bin/env python3
"""The acceptance configs of BASELINE.json on the PyTorch port, end to end,
with a JSON report: the counterpart of ``scripts/acceptance.py``, with its
data recipes and report keys.

  1. single-neuron standard GLM, 60 s at 1 ms, MAP
  2. N=10 Erdős–Rényi network, sparse MAP with cross-validated λ, support
     recovery (lasso, debiased Wald, posterior median model)
  3. N=10 network, 4 chains of the joint sampler from a jittered MAP fit
  4. N=16 SBM latent-type model, planted partition, 4 chains with annealed
     warmup, per-chain ARI against the planted partition
  5. N=27 distance-dependent model, one chain (the multi-chain flagship is
     ``theano_pyglm_torch.scripts.rgc_flagship``)

Full size by default, on the current CUDA device; ``--quick`` shrinks sizes
and ``--device cpu`` runs on the CPU:

  python3 -m theano_pyglm_torch.scripts.acceptance [--quick] [--device cpu] [--configs 1,2,3,4] [-r DIR]

Each ``configN(device, ...)`` returns its report dict; ``dataN(device, ...)``
builds its population, generating parameters, spikes and stimulus. Every
draw comes from a seed: parameters from a host ``torch.Generator`` (the
same on every device), spikes from one on the device, stimuli from numpy.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from theano_pyglm_torch import Population, make_model
from theano_pyglm_torch.inference.gibbs import compute_psi, rest_current
from theano_pyglm_torch.inference.map import cross_validate_lambda, map_fit, sparse_map_fit
from theano_pyglm_torch.inference.mcmc import gibbs_sample
from theano_pyglm_torch.inference.smart_init import smart_initialize
from theano_pyglm_torch.parallel.chains import gibbs_sample_chains
from theano_pyglm_torch.utils.convert import params_from_numpy
from theano_pyglm_torch.utils.diagnostics import adjusted_rand_index, summarize_chains, support_metrics

__all__ = ["data1", "data2", "data3", "data4", "data5", "reference_stim4", "support_estimates", "sample4", "config1",
           "config2", "config3", "config4", "config5", "QUICK", "main"]

N2 = N3 = 10
N4 = 16

#: sizes of ``--quick`` (the JAX script's), keyword arguments of each config
QUICK = {
    1: dict(T=5_000),
    2: dict(T=4_000, lambdas=(1.0, 10.0), n_folds=1, xv_iter=100, map_iter=100, refit_iter=100, n_post=50),
    3: dict(T=3_000, map_iter=100, n_samples=50),
    4: dict(T=3_000, n_samples=50, n_chains=2),
    5: dict(T=3_000, n_iters=100),
}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _progress(label: str):
    """A sampler callback printing the phase, sweeps done and seconds so far."""
    t0 = time.time()
    return lambda phase, it, states: print(f"  {label}: {phase} {it} @ {time.time() - t0:.0f} s", flush=True)


def _generators(device, seed: int):
    """(host generator for the parameters, device generator for the spikes)."""
    return torch.Generator().manual_seed(seed), torch.Generator(device=device).manual_seed(seed + 1)


def _synth(name, N, T, seed, device, pop_cls, planted=None):
    """(pop, true, S, stim): bias N(2.5, 0.4), a 1-D white stimulus, and
    ``planted(pop, true)`` applied to the prior draw before simulating."""
    spec = make_model(name, N)
    spec["bias"] = {"mu": 2.5, "sigma": 0.4}
    return _simulate(pop_cls(spec, device=device), T, seed, planted)


def _simulate(pop, T, seed, planted=None):
    g_host, g_dev = _generators(pop.device, seed)
    true = pop.sample(g_host)
    if planted is not None:
        true = planted(pop, true)
    stim = np.random.RandomState(seed).randn(T, 1).astype(np.float32) if pop.basis_stim is not None else None
    S, _ = pop.simulate(g_dev, true, T, stim=stim)
    return pop, true, S, stim


def _planted_er_weights(rng_seed):
    """Identifiable planted weights on the sampled ER edges: |W| = 2.5 off
    the diagonal (positive with probability 0.7), −2 on it. A prior draw
    W ~ N(0, 2²) leaves about half the edges undetectable at these T."""

    def planted(pop, true):
        r = np.random.RandomState(rng_seed)
        W = np.where(r.rand(pop.N, pop.N) < 0.7, 2.5, -2.5)
        np.fill_diagonal(W, -2.0)
        return {**true, "W": torch.as_tensor(W, dtype=pop.dtype, device=pop.device) * true["A"]}

    return planted


def data1(device, T=60_000, pop_cls=Population):
    return _synth("standard_glm", 1, T, 0, device, pop_cls)


def data2(device, T=240_000, pop_cls=Population):
    return _synth("sparse_weighted_model", N2, T, 0, device, pop_cls, _planted_er_weights(20))


def data3(device, T=30_000, pop_cls=Population):
    return _synth("sparse_weighted_model", N3, T, 2, device, pop_cls, _planted_er_weights(30))


#: config 4's planted two-block SBM
Y4 = np.array([0] * (N4 // 2) + [1] * (N4 - N4 // 2))
BM4 = np.array([[0.7, 0.05], [0.05, 0.7]])
#: config 4's data as the JAX package's script draws them at T=60,000: its
#: generating parameters and spike counts (written by tests/torch_parity.py)
REFERENCE4 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config4_reference.npz")
#: stimulus bins the JAX package's script draws for configs 1-3 before config 4's
STIM_BEFORE4 = (60_000, 240_000, 30_000)


def reference_stim4(T=60_000):
    """The first ``T`` bins of config 4's stimulus in the JAX package's
    script: one numpy stream seeded with 0 serves configs 1-4 in turn."""
    r = np.random.RandomState(0)
    for n in STIM_BEFORE4:
        r.randn(n, 1)
    return r.randn(60_000, 1).astype(np.float32)[:T]


def data4(device, T=60_000, pop_cls=Population, reference=True):
    """The planted partition: a strongly blocked SBM, ~18 Hz rates and
    fixed-magnitude weights make every edge identifiable at T=60,000, so
    block recovery tests the sampler, not the data; the tighter filter-shape
    prior (σ=0.5) lets the filters and A co-mix.

    ``reference``: the JAX package's draw of the recipe, its generating
    parameters and the first ``T`` bins of its spikes and stimulus (the data
    its recorded result comes from); else the port's own draw (parameters
    from a host generator, spikes from the device's), whose bias draws give
    three neurons base rates (e^bias) of 7.5-9.7 Hz."""
    spec = make_model("sbm_weighted_model", N4)
    spec["bias"] = {"mu": 2.8, "sigma": 0.3}
    spec["impulse"]["sigma"] = 0.5
    pop = pop_cls(spec, device=device)
    if reference:
        with np.load(REFERENCE4) as ref:
            if T > ref["S"].shape[0]:
                raise ValueError(f"the reference data hold {ref['S'].shape[0]} bins, not {T}")
            true = params_from_numpy({k: ref[k] for k in ref.files if k != "S"}, device=pop.device,
                                     dtype=pop.dtype)
            S = torch.as_tensor(ref["S"][:T], device=pop.device).to(pop.dtype)
        return pop, true, S, reference_stim4(T)

    def planted(pop, true):
        r = np.random.RandomState(4)
        A = (r.rand(N4, N4) < BM4[Y4[:, None], Y4[None, :]]).astype(np.float64)
        np.fill_diagonal(A, 1.0)
        W = np.where(r.rand(N4, N4) < 0.7, 2.5, -2.5)
        np.fill_diagonal(W, -2.0)
        f = dict(dtype=pop.dtype, device=pop.device)
        return {**true, "y": torch.as_tensor(Y4, dtype=torch.int64, device=pop.device),
                "Bm": torch.as_tensor(BM4, **f), "pi": torch.full((2,), 0.5, **f),
                "A": torch.as_tensor(A, **f), "W": torch.as_tensor(W * A, **f)}

    return _simulate(pop, T, 4, planted)


def data5(device, T=60_000, pop_cls=Population):
    return _synth("distance_weighted_model", 27, T, 6, device, pop_cls)


def config1(device, T=60_000):
    """Single-neuron standard GLM, MAP from the smart init. The MAP is run
    twice: the first call also pays the one-time import of the optimizer's
    dependencies."""
    t0 = time.time()
    pop, true, S, stim = data1(device, T)
    _sync(device)
    t_sim = time.time() - t0
    data = pop.prepare_data(S, stim=stim)
    init = smart_initialize(pop, data)
    times = []
    for _ in range(2):
        t1 = time.time()
        fit, logp, iters = map_fit(pop, data, init)
        _sync(device)
        times.append(time.time() - t1)
    with torch.no_grad():
        lp_true = float(pop.log_joint(true, data))
    return {
        "log_joint": float(logp),
        "log_joint_at_truth": lp_true,
        "map_beats_truth": bool(float(logp) >= lp_true - 1e-3),
        "iters": int(iters),
        "simulate_s": round(t_sim, 1),
        "map_cold_s": round(times[0], 1),
        "map_warm_s": round(times[1], 1),
        "compile_overhead_s": round(times[0] - times[1], 1),
        "wall_s": round(time.time() - t0, 1),
    }


def support_estimates(pop, data, params, A_samples, A_true, refit_iter: int = 300) -> dict:
    """Support recovery of the sparse MAP ``params`` against ``A_true``:
    the lasso thresholded at |W| ≥ 0.05; the debiased Wald rule
    (unpenalized refit with A clamped to the lasso support, then keep the
    edges with |W| ≥ 2 SE, SE = 1/√Fisher from the exp-Poisson diagonal
    Fisher information Σ_t λ_t·dt·ψ²; it ignores the correlation of edges
    into one neuron, so it overstates the SE and costs recall); and the
    posterior median model, P(A_ij | data) > 1/2 over the draws
    ``A_samples`` (n_draws, n_chains, N, N) of the collapsed (A, W) sampler."""
    W = params["W"].cpu().numpy()
    support0 = (np.abs(W) >= 0.05).astype(np.float64)
    np.fill_diagonal(support0, 1.0)
    clamped = {**params, "A": torch.as_tensor(support0, dtype=pop.dtype, device=pop.device)}
    refit, _, _ = map_fit(pop, data, clamped, max_iter=refit_iter)
    with torch.no_grad():
        psi = compute_psi(pop, refit, data)  # (T, N_post, N_pre)
        I_tot = rest_current(pop, refit, data) + torch.einsum("tnm,nm->tn", psi, refit["A"] * refit["W"])
        lam_dt = pop.nlin.rate(I_tot) * pop.dt
        fisher = torch.einsum("tn,tnm->nm", lam_dt, psi * psi).cpu().numpy()
    W_refit = refit["W"].cpu().numpy()
    se = 1.0 / np.sqrt(np.maximum(fisher, 1e-12))
    W_wald = np.where((support0 > 0) & (np.abs(W_refit) >= 2.0 * se), W_refit, 0.0)
    A_bayes = (np.asarray(A_samples).mean(axis=(0, 1)) > 0.5).astype(np.float64)
    np.fill_diagonal(A_bayes, 0.0)
    return {
        "support_recovery_lasso": support_metrics(W, A_true, thresh=0.05),
        # W_wald is exactly zero off its support: the threshold ~0 measures the Wald rule alone
        "support_recovery_wald": support_metrics(W_wald, A_true, thresh=1e-9),
        "support_recovery": support_metrics(A_bayes, A_true, thresh=0.5),
    }


def config2(device, T=240_000, lambdas=(0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0, 300.0), n_folds=3,
            xv_iter=300, map_iter=400, refit_iter=300, n_post=400, post_warmup=None):
    """N=10 ER network with planted weights, T=240,000: cross-validated λ
    (a log-spaced grid, contiguous k-fold, the warm-started lasso path),
    sparse MAP at the best λ, then the three support estimates of
    :func:`support_estimates`, the headline being the posterior median
    model of the collapsed (A, W) sampler, 2 chains warm-started from the
    lasso fit."""
    t0 = time.time()
    pop, true, S, stim = data2(device, T)
    init = smart_initialize(pop, pop.prepare_data(S, stim=stim))
    init["A"] = torch.ones_like(init["A"])  # dense fitting: sparsity comes from λ
    best, _, scores = cross_validate_lambda(pop, S, stim, init, list(lambdas), max_iter=xv_iter, n_folds=n_folds)
    data = pop.prepare_data(S, stim=stim)
    params, logp, _ = sparse_map_fit(pop, data, init, best, max_iter=map_iter)
    samples, _, _ = gibbs_sample_chains(
        pop, data, 9, n_chains=2, n_samples=n_post,
        n_warmup=max(50, n_post // 2) if post_warmup is None else post_warmup,
        chunk_size=min(200, n_post), init_params=dict(params), init_jitter=0.05, callback=_progress("config 2"),
    )
    W = params["W"].cpu().numpy()
    A_true = true["A"].cpu().numpy()
    off = ~np.eye(pop.N, dtype=bool)
    return {
        "best_lambda": float(best),
        "lambda_interior": bool(lambdas[0] < best < lambdas[-1]),
        "xv_scores": [round(s, 1) for s in scores],
        "offdiag_sparsity_frac_below_0.05": float((np.abs(W[off]) < 0.05).mean()),
        "true_offdiag_density": float(A_true[off].mean()),
        **support_estimates(pop, data, params, samples["A"], A_true, refit_iter),
        "support_estimator": f"posterior median model, P(A_ij|data) > 0.5, 2x{n_post} draws collapsed (A,W) sampler",
        "log_joint": float(logp),
        "wall_s": round(time.time() - t0, 1),
    }


def config3(device, T=30_000, map_iter=300, n_samples=1000, n_warmup=None):
    """N=10 network with planted weights, 4 chains from the MAP fit with
    per-chain jitter (prior-drawn starts can settle in different modes of
    the multimodal (A, W, filters) posterior, and R̂ then measures that)."""
    t0 = time.time()
    pop, true, S, stim = data3(device, T)
    data = pop.prepare_data(S, stim=stim)
    init, _, _ = map_fit(pop, data, smart_initialize(pop, data), max_iter=map_iter)
    samples, _, _ = gibbs_sample_chains(
        pop, data, 3, n_chains=4, n_samples=n_samples,
        n_warmup=max(200, n_samples // 2) if n_warmup is None else n_warmup,
        chunk_size=min(200, n_samples), init_params=init, init_jitter=0.05, callback=_progress("config 3"),
    )
    conv = summarize_chains(samples)
    return {
        "n_samples_per_chain": n_samples,
        "max_rhat_W": round(conv["W"]["max_rhat"], 3),
        "min_ess_W": round(conv["W"]["min_ess"], 1),
        "max_rhat_bias": round(conv["bias"]["max_rhat"], 3),
        "min_ess_bias": round(conv["bias"]["min_ess"], 1),
        "wall_s": round(time.time() - t0, 1),
    }


def sample4(pop, data, A_true, seed: int, n_samples: int, n_chains: int, label: str = "config 4",
            anneal_frac: float = 0.5, n_warmup=None):
    """Config 4's sampler on ``data``: ``n_chains`` chains seeded from
    ``seed``, from the smart init with annealed warmup (the likelihood
    tempered over the first ``anneal_frac`` of ``n_warmup`` warmup sweeps,
    by default half of ``n_samples``, so (A, filters, y) co-mix before the
    posterior sharpens; 0 turns the annealing off), then 2·``n_samples``
    sampling sweeps, so the scored second half sits past the slow exit from
    partial assignments. Prints each chain's ARI every ``min(200,
    n_warmup)`` sweeps, its mean ARI in four windows of the sampling sweeps
    and its final state's misplaced neurons. Returns (the
    report entries but ``wall_s``, the windows per chain)."""
    ns4 = 2 * n_samples
    n_warmup = n_samples if n_warmup is None else n_warmup
    progress = _progress(label)

    def callback(phase, it, states):
        progress(phase, it, states)
        aris = [round(adjusted_rand_index(s["params"]["y"].cpu().numpy(), Y4), 3) for s in states]
        print(f"  {label}: ARI per chain now {aris}", flush=True)

    samples, diag, states = gibbs_sample_chains(
        pop, data, seed, n_chains=n_chains, n_samples=ns4, n_warmup=n_warmup,
        chunk_size=min(200, n_warmup), init_params=smart_initialize(pop, data), anneal_frac=anneal_frac,
        callback=callback,
    )
    half = ns4 // 2
    y = samples["y"]  # (n_samples, n_chains, N)
    ari = np.array([[adjusted_rand_index(y[i, c], Y4) for c in range(n_chains)] for i in range(ns4)])
    windows = [[round(float(w.mean()), 3) for w in np.array_split(ari[:, c], 4)] for c in range(n_chains)]
    print(f"  {label}: mean ARI per chain in four windows of the {ns4} sampling sweeps {windows}", flush=True)
    for c, st in enumerate(states):
        p = st["params"]
        y_c, A_c = p["y"].cpu().numpy(), p["A"].cpu().numpy()
        off = min((np.flatnonzero(y_c != lab) for lab in (Y4, 1 - Y4)), key=len)  # types up to relabeling
        with torch.no_grad():
            lj = float(pop.log_joint(p, data))
        wrong = {int(n): (np.flatnonzero(A_c[n] != A_true[n]).tolist(),
                          np.flatnonzero(A_c[:, n] != A_true[:, n]).tolist()) for n in off}
        print(f"  {label}: chain {c} final state: log-joint {lj:.3f}; neurons off the planted partition, with "
              f"the entries of their A row and column that differ from the truth: {wrong}", flush=True)
    per_chain_ari, chain_modes = [], []
    for c in range(n_chains):
        per_chain_ari.append(round(float(ari[half:, c].mean()), 3))
        tail = y[half:, c]
        chain_modes.append(np.array([np.bincount(tail[:, n]).argmax() for n in range(N4)]))
    cross = [adjusted_rand_index(chain_modes[i], chain_modes[j])
             for i in range(n_chains) for j in range(i + 1, n_chains)]
    A_err = float(np.abs(samples["A"][half:].mean(axis=(0, 1)) - A_true).mean())
    return {
        "n_samples": ns4,
        "n_chains": n_chains,
        "anneal_frac": anneal_frac,
        "accept_rate": round(float(np.mean(diag["accept_rate_glm"])), 3),
        "planted_partition_ari_per_chain": per_chain_ari,
        "planted_partition_ari_min_chain": min(per_chain_ari),
        "cross_chain_type_agreement_ari": round(float(np.mean(cross)), 3),
        "adjacency_mean_abs_error": round(A_err, 3),
        "types_used": int(len(np.unique(y[-1]))),
    }, windows


def config4(device, T=60_000, n_samples=1000, n_chains=4):
    """N=16 SBM with a planted partition, on the JAX package's draw of the
    data (:func:`data4`), sampled by :func:`sample4` with the chains seeded
    from 5, as the JAX package's script seeds them. Reports per-chain ARI
    against the planted partition and the agreement of the chains' modal
    types."""
    t0 = time.time()
    pop, true, S, stim = data4(device, T)
    report, _ = sample4(pop, pop.prepare_data(S, stim=stim), true["A"].cpu().numpy(), 5, n_samples, n_chains)
    return {**report, "wall_s": round(time.time() - t0, 1)}


def config5(device, T=60_000, n_iters=2_000):
    """N=27 distance model, one chain: ``n_iters`` sampling sweeps thinned
    by 10 after ``n_iters``/4 warmup sweeps (with only a tenth as warmup the
    frozen step size decays over the long sampling phase)."""
    t0 = time.time()
    pop, true, S, stim = data5(device, T)
    data = pop.prepare_data(S, stim=stim)
    _, diag, _ = gibbs_sample(
        pop, data, torch.Generator(device=pop.device).manual_seed(7), n_samples=n_iters // 10, thin=10,
        n_warmup=n_iters // 4, chunk_size=min(500, n_iters // 10), callback=_progress("config 5"),
    )
    return {
        "iters": n_iters + n_iters // 10,
        "accept_rate": round(float(diag["accept_rate_glm"]), 3),
        "wall_s": round(time.time() - t0, 1),
        "note": "full 10k multi-chain run: theano_pyglm_torch/scripts/rgc_flagship.py",
    }


REPORT_KEYS = {1: "config1_standard_glm_map", 2: "config2_sparse_map_xv", 3: "config3_hmc_4chains",
               4: "config4_sbm", 5: "config5_distance_mcmc"}
CONFIGS = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}


def _device_info(device) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": device.type}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "nvidia_smi": card}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true", help="the small sizes of QUICK")
    p.add_argument("--full5", action="store_true", help="run config 5 at 10,000 sampling sweeps")
    p.add_argument("--configs", type=str, default="1,2,3,4,5", help="comma-separated subset of 1-5")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--resultsDir", "-r", type=str, default="results/acceptance_torch")
    args = p.parse_args(argv)
    which = sorted({int(c) for c in args.configs.split(",")})
    unknown = set(which) - set(CONFIGS)
    if unknown:
        raise ValueError(f"unknown configs {sorted(unknown)}")

    os.makedirs(args.resultsDir, exist_ok=True)
    report = {"device": _device_info(args.device)}
    for c in which:
        kw = dict(QUICK[c]) if args.quick else {}
        if c == 5 and args.full5:
            kw["n_iters"] = 10_000
        report[REPORT_KEYS[c]] = CONFIGS[c](args.device, **kw)
        print(f"config {c} done", report[REPORT_KEYS[c]], flush=True)
        # written after every config, so a run cut short keeps what it finished
        with open(os.path.join(args.resultsDir, "acceptance_report.json"), "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
