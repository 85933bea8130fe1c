#!/usr/bin/env python3
"""The flagship run on the PyTorch port (acceptance config 5):

N=27 distance-dependent (latent-location) network GLM, 60 s at 1 ms of
synthetic data, joint MCMC (the glm Laplace block, HMC on the impulse logits
and the latent locations, the collapsed (A, W) birth–death, the rotation
move), several chains from a jittered MAP start, then R̂, ESS and
link-prediction AUC. The counterpart of ``scripts/rgc_flagship.py``, with
the same arguments and summary JSON; it runs on the current CUDA device
unless ``--device cpu`` is given.

  python3 -m theano_pyglm_torch.scripts.rgc_flagship [--n_iters 10000] [--n_chains 4] [-r results/rgc_torch]

On k GPUs, one process each, the chains split over the ranks (the JAX
script's chain mesh; ``--n_chains`` a multiple of k):

  torchrun --nproc_per_node k -m theano_pyglm_torch.scripts.rgc_flagship

Rank 0 simulates and fits; the sampler starts every rank, on
cuda:<LOCAL_RANK>, from rank 0's data and fit; rank 0 prints and writes.

:func:`run` is the sampling half (chains, diagnostics, AUC) for callers that
already hold a population, data and a MAP fit.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from theano_pyglm_torch import Population, make_model
from theano_pyglm_torch.inference.map import map_fit, split_params
from theano_pyglm_torch.inference.smart_init import smart_initialize
from theano_pyglm_torch.parallel import distributed
from theano_pyglm_torch.parallel.chains import gibbs_sample_chains
from theano_pyglm_torch.parallel.mesh import chain_mesh
from theano_pyglm_torch.utils.diagnostics import summarize_chains

__all__ = ["link_prediction_auc", "summarize", "run", "main"]


def link_prediction_auc(A_post, A_true) -> float:
    """ROC AUC of the posterior edge probabilities against the true graph."""
    A_post, A_true = np.asarray(A_post), np.asarray(A_true)
    th = np.sort(np.unique(A_post))[::-1]
    tpr = [(A_post[A_true == 1] >= t).mean() for t in th]
    fpr = [(A_post[A_true == 0] >= t).mean() for t in th]
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return float(trapezoid(tpr, fpr))


def summarize(samples: dict, A_true, wall_s: float, iters: int, n_chains: int) -> dict:
    """The flagship's summary: wall time, ms per iteration, AUC and the
    convergence table, with R̂/ESS also of the pairwise location distances
    (raw locations are orientation gauge, mixed by the rotation move)."""
    conv = summarize_chains(samples)
    if "locs" in samples:
        L = np.asarray(samples["locs"])  # (n_draws, n_chains, N, D)
        iu = np.triu_indices(L.shape[2], k=1)
        d = np.linalg.norm(L[:, :, :, None, :] - L[:, :, None, :, :], axis=-1)[:, :, iu[0], iu[1]]
        conv.update(summarize_chains({"locs_pairwise_dist": d}))
    auc = link_prediction_auc(samples["A"].mean(axis=(0, 1)), A_true)
    return {
        "wall_clock_s": round(wall_s, 1),
        "iters": iters,
        "n_chains": n_chains,
        "ms_per_iteration": round(wall_s / iters * 1e3, 2),
        "link_prediction_auc": round(auc, 3),
        "convergence": {k: {kk: round(vv, 3) for kk, vv in v.items()} for k, v in conv.items()},
    }


def run(pop, data, true, init, seed: int = 0, n_chains: int = 4, n_iters: int = 10_000,
        n_warmup: int = 1_000, thin: int = 10, n_leapfrog: int = 10, init_jitter: float = 0.05,
        chunk_size: int = 250, callback=None, mesh=None):
    """Sample ``n_chains`` chains from the MAP fit ``init`` and summarize
    them against the generating parameters ``true``; with a 'chains'
    ``mesh``, this rank's block of them (every rank returns every chain).

    Returns (samples, diagnostics, states, summary); ``summary`` is the
    flagship's JSON (see :func:`summarize`)."""
    t0 = time.time()
    samples, diag, states = gibbs_sample_chains(
        pop, data, seed, n_chains=n_chains, n_samples=n_iters // thin, n_warmup=n_warmup,
        thin=thin, n_leapfrog=n_leapfrog, chunk_size=chunk_size, init_params=init,
        init_jitter=init_jitter, callback=callback, mesh=mesh,
    )
    if pop.device.type == "cuda":
        torch.cuda.synchronize(pop.device)
    wall = time.time() - t0
    A_true = true["A"].detach().cpu().numpy()
    summary = summarize(samples, A_true, wall, n_iters + n_warmup, n_chains)
    return samples, diag, states, summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--N", type=int, default=27)
    p.add_argument("--T_sec", type=float, default=60.0)
    p.add_argument("--n_iters", type=int, default=10_000)
    p.add_argument("--n_warmup", type=int, default=1_000)
    p.add_argument("--n_chains", type=int, default=4)
    p.add_argument("--thin", type=int, default=10)
    p.add_argument("--resultsDir", "-r", type=str, default="results/rgc_flagship_torch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    # several ranks (torchrun): the chains split over them, each on its own GPU
    mesh = chain_mesh() if distributed.initialize(device=args.device) else None
    device = args.device if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0

    def say(msg):
        if lead:
            print(msg, flush=True)

    # RGC-realistic firing rates (~20 Hz baseline; Pillow et al. 2008 cells)
    spec = make_model("distance_weighted_model", args.N, bias={"mu": 3.0, "sigma": 0.4})
    pop = Population(spec, device=device)
    g_host = torch.Generator().manual_seed(args.seed)
    true = pop.sample(g_host)
    T = int(round(args.T_sec / pop.dt))
    stim = torch.randn((T, 1), generator=g_host).numpy()
    if lead:
        t0 = time.time()
        S, rates = pop.simulate(torch.Generator(device=pop.device).manual_seed(args.seed), true, T, stim=stim)
        say(f"simulated {float(S.sum()):.0f} spikes ({float(rates.mean()):.1f} Hz) in {time.time() - t0:.1f}s")
        data = pop.prepare_data(S, stim=stim)

        # MAP-start the chains (jittered): prior-draw inits leave long warmup
        # transients that can poison a chain's adaptation window
        t0 = time.time()
        init, map_logp, _ = map_fit(pop, data, smart_initialize(pop, data, g_host))
        say(f"MAP init: log-joint {float(map_logp):.1f} in {time.time() - t0:.1f}s")
    else:
        # rank 0 alone simulates and fits: the sampler broadcasts its data
        # and fit into these placeholders of the same shapes and layout
        data = pop.prepare_data(torch.zeros((T, pop.N)), stim=stim)
        opt, frozen = split_params(true)
        init = {**frozen, **opt}

    t0 = time.time()
    samples, _, _, summary = run(
        pop, data, true, init, seed=args.seed, n_chains=args.n_chains, n_iters=args.n_iters,
        n_warmup=args.n_warmup, thin=args.thin, mesh=mesh,
        callback=lambda ph, it, st: say(f"  {ph} {it} @ {time.time() - t0:.0f}s"),
    )
    if mesh is not None:
        summary["ranks"] = mesh.size
    if lead:
        print(json.dumps(summary, indent=2))
        os.makedirs(args.resultsDir, exist_ok=True)
        arrays = {f"samples/{k}": v for k, v in samples.items()}
        arrays.update({f"true_params/{k}": v.detach().cpu().numpy() for k, v in true.items()})
        np.savez_compressed(os.path.join(args.resultsDir, "flagship_samples.npz"), **arrays)
        with open(os.path.join(args.resultsDir, "flagship_summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
            f.write("\n")
    distributed.shutdown()


if __name__ == "__main__":
    main()
