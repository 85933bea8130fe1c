#!/usr/bin/env python3
"""Acceptance config 4's sampler under several chain seeds, on either draw
of its data, one process per seed, all started together on one card.

First prints, for the chosen data, each neuron's firing rate and the Wald z
of its true edges at the generating parameters (|W|·√Fisher, the
exp-Poisson diagonal Fisher information Σ_t λ_t·dt·ψ²): how well the spikes
identify the neuron's row and column of A, and so its block. Then each seed
runs ``scripts/acceptance.sample4`` at full depth, its output in a log file
of its own; the per-chain ARI and its windows go into one JSON file. Run
from the repository root:

    python3 theano_pyglm_torch/tools/sbm_seed_study.py [--data reference|port] [--seeds 123,777]
        [--n_samples 1000] [--n_chains 4] [--T 60000] [--device cuda] [-o DIR]

``--data reference`` is the JAX package's draw of the data (the one its
recorded result comes from, and the acceptance runner's); ``port`` is the
port's own draw. ``--seeds ''`` prints the identifiability table only.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from theano_pyglm_torch.inference.gibbs import compute_psi, rest_current  # noqa: E402
from theano_pyglm_torch.scripts import acceptance  # noqa: E402


@torch.no_grad()
def edge_identifiability(pop, true, S, data) -> list:
    """Per neuron: (rate in Hz, min Wald z over its true in-edges (row of
    A), min over its true out-edges (column)), self-edges excluded, at the
    generating parameters."""
    psi = compute_psi(pop, true, data)  # (T, N_post, N_pre)
    I = rest_current(pop, true, data) + torch.einsum("tnm,nm->tn", psi, true["A"] * true["W"])
    fisher = torch.einsum("tn,tnm->nm", pop.nlin.rate(I) * pop.dt, psi * psi)
    z = (true["W"].abs() * fisher.sqrt()).cpu().numpy()
    edge = (true["A"].cpu().numpy() > 0) & ~np.eye(pop.N, dtype=bool)
    rates = (S.sum(0) / (S.shape[0] * pop.dt)).cpu().numpy()
    z_in = [float(z[n][edge[n]].min(initial=np.inf)) for n in range(pop.N)]
    z_out = [float(z[:, n][edge[:, n]].min(initial=np.inf)) for n in range(pop.N)]
    return [(float(rates[n]), z_in[n], z_out[n]) for n in range(pop.N)]


def _one(args) -> None:
    """One seed's run; its result is the last line of the output."""
    pop, true, S, stim = acceptance.data4(args.device, args.T, reference=args.data == "reference")
    t0 = time.time()
    report, windows = acceptance.sample4(pop, pop.prepare_data(S, stim=stim), true["A"].cpu().numpy(),
                                         args.one, args.n_samples, args.n_chains, label=f"seed {args.one}")
    print(json.dumps({"seed": args.one, "windows": windows, **report, "wall_s": round(time.time() - t0, 1)}))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", choices=("reference", "port"), default="reference")
    p.add_argument("--seeds", default="123,777", help="comma-separated chain seeds, one process each")
    p.add_argument("--n_samples", type=int, default=1000, help="warmup sweeps; twice as many are sampled")
    p.add_argument("--n_chains", type=int, default=4)
    p.add_argument("--T", type=int, default=60_000)
    p.add_argument("--device", default="cuda")
    p.add_argument("-o", "--out", default=os.path.join(REPO, "results", "sbm_seed_study"))
    p.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.one is not None:
        return _one(args)

    card = ""
    if torch.device(args.device).type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()
    pop, true, S, stim = acceptance.data4(args.device, args.T, reference=args.data == "reference")
    print(f"config 4, {args.data} data, T={args.T}: neuron, rate Hz, min Wald z of its true in-edges and "
          f"out-edges at the generating parameters", flush=True)
    for n, (rate, z_in, z_out) in enumerate(edge_identifiability(pop, true, S, pop.prepare_data(S, stim=stim))):
        print(f"  {n:2d} {rate:6.2f} {z_in:7.2f} {z_out:7.2f}", flush=True)
    seeds = [int(s) for s in args.seeds.split(",") if s.strip()]
    if not seeds:
        return
    os.makedirs(args.out, exist_ok=True)
    base = [sys.executable, os.path.abspath(__file__), "--data", args.data, "--n_samples", str(args.n_samples),
            "--n_chains", str(args.n_chains), "--T", str(args.T), "--device", args.device]
    procs = []
    for seed in seeds:
        log = open(os.path.join(args.out, f"{args.data}_seed{seed}.log"), "w")
        procs.append((seed, log, subprocess.Popen(base + ["--one", str(seed)], stdout=log,
                                                  stderr=subprocess.STDOUT, text=True)))
    runs = []
    for seed, log, proc in procs:
        rc = proc.wait()
        log.close()
        with open(log.name) as f:
            lines = f.read().splitlines()
        if rc or not lines:
            raise SystemExit(f"seed {seed} failed (exit {rc}); see {log.name}")
        runs.append(json.loads(lines[-1]))
        print(f"seed {seed}: ARI per chain (second half of the sampling sweeps) "
              f"{runs[-1]['planted_partition_ari_per_chain']}, in four windows {runs[-1]['windows']}; "
              f"{runs[-1]['wall_s']} s [{card}]", flush=True)
    with open(os.path.join(args.out, f"{args.data}.json"), "w") as f:
        json.dump({"data": args.data, "T": args.T, "card": card, "runs": runs,
                   "min_ari_over_all_chains": min(r["planted_partition_ari_min_chain"] for r in runs)}, f, indent=2)
        f.write("\n")


if __name__ == "__main__":
    main()
