#!/usr/bin/env python3
"""The one-chain Gibbs sweep of several checkouts of the repository, timed in
turns on one CUDA card, stage by stage.

Each checkout runs in its own process, with its own kernels, in the order
given (parent, change, change, parent compares two trees in one call). Each
builds the same problem through its own public API: the planted
``sparse_weighted_model`` of ``scripts/stretch_streaming.py`` at N neurons
and T bins, its MAP fit, and the MCMC state there; then it times the full
sweep and each stage alone, one chain, as its ``gibbs_sample`` calls them
(a checkout with ``stack_states`` runs its batched sweep at C = 1), over
``--sweeps`` sweeps after one untimed sweep, and prints ms per sweep, the
device activities of one sweep and the final log-joint. Run from the
repository root on the GPU machine:

    python3 theano_pyglm_torch/tools/sweep_ab.py DIR [DIR ...] [--N 100] [--T 60000] [--row_batch 4]
"""

import argparse
import json
import os
import subprocess
import sys
import time


def _one(tree: str, N: int, T: int, sweeps: int, row_batch) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from theano_pyglm_torch.inference import map_fit, mcmc
    from theano_pyglm_torch.inference.smart_init import smart_initialize
    from theano_pyglm_torch.scripts.stretch_streaming import planted, simulate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _, pop, true, stim = planted(dev, N, T)
    S, _ = simulate(pop, true, T, stim)
    data = pop.prepare_data(S, stim=stim)
    init = smart_initialize(pop, data)
    fit, _, _ = map_fit(pop, data, init)
    batched = hasattr(mcmc, "stack_states")
    state0 = mcmc.init_mcmc_state(pop, mcmc.stack_states([fit]) if batched else fit)
    out = {"tree": tree, "batched": batched, "ms": {}, "activities": {}}
    for stage in (None, *mcmc.SWEEP_STAGES):
        if stage is not None and stage not in ("glm", "imp", "hypers", "adjacency"):
            continue  # the stages of this model
        sweep = mcmc.make_sweep(pop, data, n_leapfrog=10, fisher_params=fit, row_batch=row_batch,
                                stages=None if stage is None else (stage,), diagnostic=stage is not None)
        g = torch.Generator(device=dev).manual_seed(5)
        gen = [g] if batched else g
        st = sweep(gen, state0, False, 1.0)  # first use: lazy set-up, graph capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(sweeps):
            st = sweep(gen, st, False, 1.0)
        torch.cuda.synchronize()
        name = stage or "full sweep"
        out["ms"][name] = 1e3 * (time.perf_counter() - t0) / sweeps
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            st = sweep(gen, st, False, 1.0)
            torch.cuda.synchronize()
        out["activities"][name] = sum(e.count for e in prof.key_averages())
        if stage is None:
            params = mcmc.chain_state(st["params"], 0) if batched else st["params"]
            with torch.no_grad():
                out["log_joint"] = float(pop.log_joint(params, data))
    print(json.dumps(out), flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="+", help="checkouts of the repository, timed in this order")
    p.add_argument("--N", type=int, default=100)
    p.add_argument("--T", type=int, default=60_000)
    p.add_argument("--sweeps", type=int, default=5)
    p.add_argument("--row_batch", type=int, default=None)
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.one:
        return _one(args.trees[0], args.N, args.T, args.sweeps, args.row_batch)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    for tree in args.trees:
        cmd = [sys.executable, os.path.abspath(__file__), tree, "--one", "--N", str(args.N), "--T", str(args.T),
               "--sweeps", str(args.sweeps)]
        if args.row_batch is not None:
            cmd += ["--row_batch", str(args.row_batch)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"{tree} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        stages = ", ".join(f"{k} {v:.1f} ms ({res['activities'][k]} activities)" for k, v in res["ms"].items())
        print(f"{tree} (N={args.N}, T={args.T}, row_batch={args.row_batch}, {args.sweeps} sweeps): {stages}; "
              f"final log-joint {res['log_joint']:.3f} [{card}]", flush=True)


if __name__ == "__main__":
    main()
