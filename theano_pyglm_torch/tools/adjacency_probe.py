#!/usr/bin/env python3
"""The collapsed adjacency stage with and without CUDA-graph replay of its
row batches, on one CUDA card.

Builds the long-recording model of ``scripts/stretch_streaming.py`` (N=100,
T=600,000, B=5 by default) on Poisson spikes at 10 Hz drawn from a seeded
generator (the stage's work does not depend on where the spikes came from),
then runs ``gibbs.update_adjacency_collapsed`` with ``row_batch`` rows a
batch from the same generator seed, once eagerly and ``--reps`` times with
the row batches replayed as a CUDA graph. Prints the wall time of each call
(synchronized) and the device memory allocated and reserved after it, the
entries of A that differ from the eager call and the largest difference of
W, beside the card's name and power limit; the last line is a JSON object
of the same. Run from the repository
root on the GPU machine:

    python3 theano_pyglm_torch/tools/adjacency_probe.py [--N 100 --T 600000 --row_batch 4]
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

from theano_pyglm_torch.inference import gibbs  # noqa: E402
from theano_pyglm_torch.scripts import stretch_streaming as stretch  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--N", type=int, default=100)
    ap.add_argument("--T", type=int, default=600_000)
    ap.add_argument("--row_batch", type=int, default=4)
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("adjacency_probe needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    _, pop, true, stim = stretch.planted(dev, args.N, args.T)
    g = torch.Generator(device=dev).manual_seed(5)
    S = torch.poisson(torch.full((args.T, args.N), 0.01, device=dev), generator=g)
    data = pop.prepare_data(S, stim=stim)

    def run(graphed: bool):
        gibbs.GRAPH_ROW_BATCHES = graphed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, acc = gibbs.update_adjacency_collapsed(
            torch.Generator(device=dev).manual_seed(6), pop, true, data,
            return_accept=True, row_batch=args.row_batch)
        torch.cuda.synchronize()
        return out, float(acc), time.perf_counter() - t0

    eager, acc_e, t_e = run(False)
    res = {"eager_s": t_e, "graph_s": [], "allocated_gb": [], "reserved_gb": [],
           "A_entries_differ": [], "W_max_abs_diff": []}
    for _ in range(args.reps):
        graph, acc_g, t_g = run(True)
        res["graph_s"].append(t_g)
        res["allocated_gb"].append(torch.cuda.memory_allocated(dev) / 1e9)
        res["reserved_gb"].append(torch.cuda.memory_reserved(dev) / 1e9)
        res["A_entries_differ"].append(int((eager["A"] != graph["A"]).sum()))
        res["W_max_abs_diff"].append(float((eager["W"] - graph["W"]).abs().max()))
    res.update(N=args.N, T=args.T, row_batch=args.row_batch, card=card, accept_eager=acc_e, accept_graph=acc_g)
    print(f"adjacency stage at N={args.N}, T={args.T}, row_batch={args.row_batch}: eager {t_e:.3f} s, "
          f"graph replay {res['graph_s']} s; after each replayed call, GB allocated {res['allocated_gb']}, "
          f"reserved {res['reserved_gb']}; A entries that differ {res['A_entries_differ']}, max |dW| "
          f"{res['W_max_abs_diff']} [{card}]", flush=True)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
