#!/usr/bin/env python3
"""The flagship's sampler on several GPUs, one process a GPU, beside one
GPU, in one call; and the dry run of the multi-GPU layer over every card
(k: the machine's card count).

After one short run that pays the machine's first-use costs, for each
chain count of ``--chains`` it runs
``theano_pyglm_torch.scripts.rgc_flagship`` (N=27, 60 s, the MAP start;
``--n_warmup`` + ``--n_iters`` sweeps, no thinning) in one process on
cuda:0 and under ``torchrun --nproc_per_node k`` with the chains split
over the k cards, in turns: one card, k, k, one (other arguments go to
the flagship), and prints each run's sampler wall time, ms per
sweep, AUC and smallest ESS beside the card's name and power limit. Each
run's output goes to ``-o``. Run from the repository root on a machine
with k GPUs:

    python3 theano_pyglm_torch/tools/multi_gpu_run.py [--chains 4,16] [--n_warmup 40] [--n_iters 10]
        [-o results/multi_gpu]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from theano_pyglm_torch.entry import _free_port, dryrun_multichip  # noqa: E402


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().replace("\n", "; ")


def flagship(ranks: int, chains: int, args, out_dir: str) -> dict:
    """One flagship run; its summary, with the command's wall time."""
    flags = ["--n_chains", str(chains), "--n_iters", str(args.n_iters), "--n_warmup", str(args.n_warmup),
             "--thin", "1", "-r", out_dir, *args.flagship_args]
    mod = ["-m", "theano_pyglm_torch.scripts.rgc_flagship"]
    if ranks > 1:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(ranks),
               "--master_port", str(_free_port()), *mod, *flags]
    else:
        cmd = [sys.executable, *mod, *flags]
    env = {**os.environ, "PYTHONPATH": REPO}
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=args.timeout)
    wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, "log.txt"), "w") as f:
        f.write(out.stdout + out.stderr)
    if out.returncode != 0:
        raise RuntimeError(f"{ranks} rank(s), {chains} chains failed:\n{out.stderr[-3000:]}")
    with open(os.path.join(out_dir, "flagship_summary.json")) as f:
        return {**json.load(f), "command_s": wall}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chains", type=str, default="4,16")
    p.add_argument("--n_warmup", type=int, default=40)
    p.add_argument("--n_iters", type=int, default=10)
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument("-o", type=str, default="results/multi_gpu")
    args, args.flagship_args = p.parse_known_args()
    k = torch.cuda.device_count()
    if k < 1:
        raise SystemExit("no CUDA device")
    gpu = card()
    print(f"{k} rank(s): {gpu}", flush=True)
    t0 = time.perf_counter()
    dryrun_multichip(k)
    print(f"dryrun_multichip({k}) passed in {time.perf_counter() - t0:.2f} s [{gpu}]", flush=True)
    sweeps = args.n_warmup + args.n_iters
    warm = argparse.Namespace(**{**vars(args), "n_warmup": 2, "n_iters": 2})
    os.makedirs(os.path.join(args.o, "warm"), exist_ok=True)
    flagship(1, 4, warm, os.path.join(args.o, "warm"))
    for chains in (int(c) for c in args.chains.split(",")):
        for turn, ranks in enumerate((1, k, k, 1)):
            if chains % ranks:
                continue
            d = os.path.join(args.o, f"ranks{ranks}_chains{chains}_{turn}")
            os.makedirs(d, exist_ok=True)
            s = flagship(ranks, chains, args, d)
            ess = min(v["min_ess"] for v in s["convergence"].values())
            print(f"flagship, {chains} chains on {ranks} GPU(s) ({chains // ranks} a GPU), {sweeps} sweeps: sampler "
                  f"and summary {s['wall_clock_s']} s, {s['ms_per_iteration']} ms per sweep of all "
                  f"chains; AUC {s['link_prediction_auc']}, smallest ESS {ess:.2f}; command {s['command_s']:.1f} s "
                  f"[{gpu}]", flush=True)


if __name__ == "__main__":
    main()
