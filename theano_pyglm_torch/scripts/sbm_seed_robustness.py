#!/usr/bin/env python3
"""Sampler-seed robustness of acceptance config 4's block recovery, on the
PyTorch port: the counterpart of ``scripts/sbm_seed_robustness.py``, with
its runs and its JSON keys.

Config 4's data (the JAX package's draw, ``acceptance.data4``) and sampler
(``acceptance.sample4``: 4 chains from the smart init, 1,000 warmup sweeps
with the likelihood annealed over the first half, 2,000 sampling sweeps,
the per-chain ARI against the planted partition over the second half), run
once per ``--keys`` seed, plus once with the first seed and annealing
turned off. If the collapsed type kernel, and not the annealing's luck,
recovers the partition, every chain of every run reaches ARI ≥ 0.9.

  python3 -m theano_pyglm_torch.scripts.sbm_seed_robustness [--quick] [--keys 5 123 777] [-r DIR]
      [--T 60000] [--n_warmup 1000] [--n_samples 2000] [--n_chains 4] [--device cuda]

Writes ``<DIR>/sbm_seed_robustness.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from theano_pyglm_torch.scripts import acceptance

__all__ = ["main"]

#: (T, warmup sweeps, sampling sweeps, chains) in full and with --quick (the JAX script's)
FULL = (60_000, 1_000, 2_000, 4)
QUICK = (3_000, 50, 100, 2)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true", help="the JAX script's quick sizes")
    p.add_argument("--resultsDir", "-r", default="results/acceptance_torch")
    p.add_argument("--keys", type=int, nargs="*", default=[5, 123, 777])
    p.add_argument("--T", type=int, default=None, help="bins of the reference data")
    p.add_argument("--n_warmup", type=int, default=None)
    p.add_argument("--n_samples", type=int, default=None, help="sampling sweeps (even)")
    p.add_argument("--n_chains", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    sizes = QUICK if args.quick else FULL
    T, nw, ns, n_chains = (v if v is not None else d
                           for v, d in zip((args.T, args.n_warmup, args.n_samples, args.n_chains), sizes))
    if ns % 2:
        raise ValueError(f"--n_samples {ns}: the second half is scored, give an even count")

    pop, true, S, stim = acceptance.data4(args.device, T)
    data = pop.prepare_data(S, stim=stim)
    A_true = true["A"].cpu().numpy()

    runs = [(k, 0.5) for k in args.keys] + [(args.keys[0], 0.0)]
    report = {"n_warmup": nw, "n_samples": ns, "n_chains": n_chains, "runs": []}
    for key, anneal in runs:
        t0 = time.time()
        got, windows = acceptance.sample4(pop, data, A_true, key, ns // 2, n_chains,
                                          label=f"key {key}, anneal_frac {anneal}", anneal_frac=anneal,
                                          n_warmup=nw)
        per_chain = got["planted_partition_ari_per_chain"]
        row = {
            "master_key": key,
            "anneal_frac": anneal,
            "per_chain_ari_tail_half": per_chain,
            "min_chain_ari": min(per_chain),
            "per_chain_ari_windows": windows,
            "wall_s": round(time.time() - t0, 1),
        }
        report["runs"].append(row)
        print("run done:", row, flush=True)

    report["min_ari_over_all_chains"] = min(r["min_chain_ari"] for r in report["runs"])
    os.makedirs(args.resultsDir, exist_ok=True)
    with open(os.path.join(args.resultsDir, "sbm_seed_robustness.json"), "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
