#!/usr/bin/env python3
"""The fused Poisson-LL kernels of several checkouts of the repository, timed
in turns on one CUDA card.

Each checkout runs in its own process, with its kernels built from its own
sources into its own ``theano_pyglm_torch/_build/``, in the order given: to
compare two trees, give them as parent, change, change, parent, in one call
on one card. Per checkout and shape it prints the median device time of 50
calls of K1, K2 and K1 on the ``--chains`` chains in turn (and of K3-fwd and
K3-vg on those chains where the checkout has them), warm and with the 50 MB
L2 flushed, timed as ``chip_smoke.py`` times them. With ``--bf16`` the design X_f is rounded to
bf16 and the same calls time the four K4 kernels (K4-fwd, K4-vg,
K4-fwd-chains, K4-vg-chains); a checkout without them reports the shape as
not planned. ``--only NAME`` (repeatable) times just the kernels named
NAME, with what follows their name after a space (e.g. ``--only K4-fwd``:
K4-fwd and K4-fwd on the chains in turn, not K4-fwd-chains). Run from the
repository root on the GPU machine:

    python3 theano_pyglm_torch/tools/kernel_ab.py DIR [DIR ...] [--shape T,NB,N ...] [--chains 4] [--bf16] [--only K3-fwd]
"""

import argparse
import json
import os
import subprocess
import sys

SHAPES = ("60000,135,27", "240000,50,10", "60000,5,1", "600000,500,100")


def _median_ms(fn, flush=None, n: int = 50) -> float:
    import numpy as np
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # the host queues the call before the device reaches it
        if flush is not None:
            flush.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _one(tree: str, shapes, chains: int, bf16: bool, only) -> None:
    """Time the kernels of the checkout at ``tree``; print one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from theano_pyglm_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    flush = torch.empty(40 * 2**20, dtype=torch.float32, device=dev)  # 160 MB
    out = {"tree": tree, "times": {}}
    for shape in shapes:
        T, NB, N = (int(v) for v in shape.split(","))
        r = np.random.RandomState(0)
        f32 = [torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous() for a in
               (0.1 * r.randn(T, NB), 0.3 * r.randn(chains, NB, N), r.randn(chains, T, N) - 3.0,
                r.poisson(0.02, (T, N)))]
        x, u, ir, s = f32
        if bf16:
            x = x.to(torch.bfloat16)
        one, many = ("K4-fwd", "K4-vg"), ("K4-fwd-chains", "K4-vg-chains")
        if not bf16:
            one, many = ("K1", "K2"), ("K3-fwd", "K3-vg")
        calls = {one[0]: lambda: kernels.fused_ll_value(x, u[0], ir[0], s, 1e-3),
                 one[1]: lambda: kernels.fused_ll_value_and_grad(x, u[0], ir[0], s, 1e-3),
                 # the chains one by one, the yardstick of a chain kernel
                 f"{one[0]} on the {chains} chains in turn":
                     lambda: [kernels.fused_ll_value(x, u[c], ir[c], s, 1e-3) for c in range(chains)]}
        if hasattr(kernels, "fused_ll_value_chains"):
            # the launches of one call: K3 per group of chains, K1/K2 for a chain alone (K4-chains for each)
            groups = kernels.chain_groups(NB, N, chains) if hasattr(kernels, "chain_groups") else (chains,)
            tag = "" if groups == (chains,) else f" in groups {groups}"
            calls[f"{many[0]}{tag}"] = lambda: kernels.fused_ll_value_chains(x, u, ir, s, 1e-3)
            calls[f"{many[1]}{tag}"] = lambda: kernels.fused_ll_value_and_grad_chains(x, u, ir, s, 1e-3)
        for k, fn in calls.items():
            if only and not any(k == name or k.startswith(name + " ") for name in only):
                continue
            try:
                out["times"][f"{k} {shape}"] = [_median_ms(fn), _median_ms(fn, flush)]
            except (ValueError, TypeError) as e:  # a shape or dtype the checkout's kernels do not take
                out["times"][f"{k} {shape}"] = str(e)
        del f32, x, u, ir, s
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="+", help="checkouts of the repository, timed in this order")
    p.add_argument("--shape", action="append", help="T,NB,N (repeatable); default: " + " ".join(SHAPES))
    p.add_argument("--chains", type=int, default=4, help="K3's (K4-chains') chains")
    p.add_argument("--bf16", action="store_true", help="a bf16 design: time the K4 kernels")
    p.add_argument("--only", action="append", help="time only the kernels of this name (repeatable)")
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    shapes = args.shape or list(SHAPES)
    if args.one:
        return _one(args.trees[0], shapes, args.chains, args.bf16, args.only)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    for tree in args.trees:
        cmd = [sys.executable, os.path.abspath(__file__), tree, "--one", "--chains", str(args.chains)]
        if args.bf16:
            cmd.append("--bf16")
        for name in args.only or ():
            cmd += ["--only", name]
        for shape in shapes:
            cmd += ["--shape", shape]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"{tree} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        for name, t in res["times"].items():
            shown = f"{t[0]:.4f} ms warm, {t[1]:.4f} ms cold" if isinstance(t, list) else f"not planned: {t}"
            print(f"{tree}: {name}: {shown} [{card}]", flush=True)


if __name__ == "__main__":
    main()
