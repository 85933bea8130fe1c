#!/usr/bin/env python3
"""Where the time of the spatiotemporal or shared glm block goes, on one
CUDA card.

At the shape of ``chip_smoke.py`` phase 7a or 7b (T=60,000 bins, N=27
neurons; 7a: D_stim=25 and a stimulus basis of B=5, 7b: the shared stimulus,
DB=5; float32, random data of that shape), with ``--chains C`` the params of
C chains stacked (C prior draws) and one generator a chain: profiles one
call of the block's update and prints its device kernels by total time,
then times the products of a Newton step. Spatiotemporal: the port's
layout of the per-neuron design, (C·N, T, D) through ``torch.bmm`` (the
gradient and the Hessian with the time axis cut into chunks,
``gibbs._sum_over_time``, and without), and the JAX package's, (T, N, D) through ``torch.einsum`` (one
chain). Shared: sub-block (a)'s gradient and Hessian of each chain's design
and (b)'s pooled Hessian, as one product over T a chain and through
``gibbs._sum_over_time`` (T in chunks). Median of 20 calls between CUDA
events, each preceded by a device sleep so that the events bracket device
time. Run from the repository root on the GPU machine:

    python3 theano_pyglm_torch/tools/glm_probe.py [--variant shared] [--chains 4]
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from theano_pyglm_torch import Population, make_model  # noqa: E402
from theano_pyglm_torch.inference import gibbs  # noqa: E402
from theano_pyglm_torch.inference.mcmc import _glm_theta0, stack_states  # noqa: E402

T, N = 60_000, 27


def median_ms(fn, n: int = 20) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main() -> None:
    ap = argparse.ArgumentParser(description="Where the time of a stimulus variant's glm block goes.")
    ap.add_argument("--variant", choices=("spatiotemporal", "shared"), default="spatiotemporal")
    ap.add_argument("--chains", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("glm_probe.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev, C = torch.device("cuda"), args.chains
    if args.variant == "spatiotemporal":
        spec = make_model("spatiotemporal_glm", N)
        update_fn = gibbs.update_glm_laplace_st
    else:
        spec = make_model("standard_glm", N)
        spec["bkgd"]["type"] = "shared"
        update_fn = gibbs.update_glm_laplace_shared
    pop = Population(spec, device=dev)
    draws = [pop.sample(torch.Generator().manual_seed(c)) for c in range(C)]
    params = stack_states(draws) if C > 1 else draws[0]
    r = np.random.RandomState(0)
    data = pop.prepare_data(r.poisson(0.01, (T, N)).astype(np.float32),
                            stim=r.randn(T, pop.D_stim).astype(np.float32))
    theta0 = _glm_theta0(pop, data, draws[0], args.variant)
    g = ([torch.Generator(device=dev).manual_seed(c) for c in range(C)] if C > 1
         else torch.Generator(device=dev).manual_seed(0))

    def update():
        update_fn(g, pop, params, data, theta0)

    print(f"{update_fn.__name__} on {C} chain(s) at T={T}, N={N}, D_stim={pop.D_stim}, B={pop.B_stim}: "
          f"{median_ms(update):.3f} ms of device time [{card}]")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        update()
        torch.cuda.synchronize()
    on_device = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, t = on_device.get(e.name, (0, 0.0))
            on_device[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    total = sum(t for _, t in on_device.values())
    print(f"device kernels of one call: {sum(n for n, _ in on_device.values())} activities, {total:.3f} ms")
    for name, (n, t) in sorted(on_device.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {t:9.3f} ms {n:5d} x  {name[:110]}")

    I_coup = gibbs._coupling_current(pop, params, data)
    lead = (C,) if C > 1 else ()
    d1, d2 = torch.randn(*lead, T, N, device=dev), -torch.rand(*lead, T, N, device=dev)
    if args.variant == "shared":
        # sub-block (a), a design of each chain (D = 2), and (b)'s pooled Hessian
        Phi = gibbs._shared_block_a(pop, params, data, I_coup)[0]
        P = Phi[..., 0, :, :]
        outer = (P[..., :, None] * P[..., None, :]).flatten(-2)
        X, w = data["X_stim"], -torch.rand(*lead, T, 1, device=dev)
        cases = {
            "(a) gradient: one product over T a chain": lambda: d1.transpose(-1, -2) @ P,
            "(a) gradient: _sum_over_time": lambda: gibbs._sum_over_time(d1, P),
            "(a) Hessian: one product over T a chain": lambda: d2.transpose(-1, -2) @ outer,
            "(a) Hessian: _sum_over_time": lambda: gibbs._sum_over_time(d2, outer),
            "(b) Hessian: one product over T a chain": lambda: X.T @ (X * w),
            "(b) Hessian: _sum_over_time": lambda: gibbs._sum_over_time(X * w, X),
        }
        for name, fn in cases.items():
            print(f"  {name}: {median_ms(fn):.3f} ms [{card}]")
        return

    # one Newton step's products of sub-block (a), D = 1 + D_stim, in the
    # port's (C·N, T, D) layout and, for one chain, in the JAX package's (T, N, D)
    Pn, I0, theta, _, _ = gibbs._st_block_a(pop, params, data, I_coup)
    rows = Pn.reshape(-1, T, Pn.shape[-1])
    d1r, d2r = (d.transpose(-1, -2).reshape(-1, T) for d in (d1, d2))
    cases = {
        "design (C·N,T,D): _st_block_a": lambda: gibbs._st_block_a(pop, params, data, I_coup),
        "currents (C·N,T,D): bmm": lambda: gibbs._design_currents(I0, Pn, theta),
        "gradient (C·N,T,D): bmm": lambda: torch.bmm(d1r[:, None, :], rows)[:, 0],
        "gradient (C·N,T,D): _sum_over_time": lambda: gibbs._sum_over_time(d1r[..., None], rows),
        f"Hessian (C·N,T,D): bmm over C·N x {gibbs._time_chunks(T)} time chunks":
            lambda: gibbs._sum_over_time(rows * d2r[..., None], rows),
        "Hessian (C·N,T,D): bmm over C·N": lambda: torch.bmm((rows * d2r[..., None]).transpose(1, 2), rows),
    }
    if C == 1:
        Pt = Pn.permute(1, 0, 2).contiguous()
        X, w_t = data["X_st"], params["w_stim_t"]
        cases.update({
            "design (T,N,D): einsum tdb,nb->tnd + cat": lambda: torch.cat(
                [torch.ones((T, N, 1), device=dev), torch.einsum("tdb,nb->tnd", X, w_t)], 2),
            "currents (T,N,D): einsum tnd,nd->tn": lambda: I0 + torch.einsum("tnd,nd->tn", Pt, theta),
            "gradient (T,N,D): einsum tn,tnd->nd": lambda: torch.einsum("tn,tnd->nd", d1, Pt),
            "Hessian (T,N,D): einsum tnd,tne->nde": lambda: torch.einsum("tnd,tne->nde", d2[..., None] * Pt, Pt),
        })
    for name, fn in cases.items():
        print(f"  {name}: {median_ms(fn):.3f} ms [{card}]")


if __name__ == "__main__":
    main()
