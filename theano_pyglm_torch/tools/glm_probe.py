#!/usr/bin/env python3
"""Where the time of the spatiotemporal glm block goes, on one CUDA card.

At the shape of ``chip_smoke.py`` phase 7a (T=60,000 bins, N=27 neurons,
D_stim=25, a stimulus basis of B=5, float32, random data of that shape):
profiles one ``update_glm_laplace_st`` call and prints its device kernels by
total time, then times each product of a Newton step in the port's layout
of the per-neuron design, (N, T, D) through ``torch.bmm`` (the Hessian with
the time axis cut into chunks, ``gibbs._weighted_gram``, and without), and
in the JAX package's, (T, N, D) through ``torch.einsum``. Median of 20 calls between
CUDA events, each preceded by a device sleep so that the events bracket
device time. Run from the repository root on the GPU machine:

    python3 theano_pyglm_torch/tools/glm_probe.py
"""

import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from theano_pyglm_torch import Population, make_model  # noqa: E402
from theano_pyglm_torch.inference import gibbs  # noqa: E402
from theano_pyglm_torch.inference.mcmc import _glm_theta0  # noqa: E402

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
    if not torch.cuda.is_available():
        raise SystemExit("glm_probe.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    pop = Population(make_model("spatiotemporal_glm", N), device=dev)
    params = pop.sample(torch.Generator().manual_seed(0))
    r = np.random.RandomState(0)
    data = pop.prepare_data(r.poisson(0.01, (T, N)).astype(np.float32),
                            stim=r.randn(T, pop.D_stim).astype(np.float32))
    theta0 = _glm_theta0(pop, data, params, "spatiotemporal")
    g = torch.Generator(device=dev).manual_seed(0)

    def update():
        gibbs.update_glm_laplace_st(g, pop, params, data, theta0)

    print(f"update_glm_laplace_st at T={T}, N={N}, D_stim={pop.D_stim}, B={pop.B_stim}: "
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

    # one Newton step's products of sub-block (a), D = 1 + D_stim, in the
    # port's (N, T, D) layout and in the JAX package's (T, N, D)
    I_coup = gibbs._coupling_current(pop, params, data)
    Pn, I0, theta, _, _ = gibbs._st_block_a(pop, params, data, I_coup)
    Pt = Pn.permute(1, 0, 2).contiguous()
    d1, d2 = torch.randn(T, N, device=dev), -torch.rand(T, N, device=dev)
    X, w_t = data["X_st"], params["w_stim_t"]
    cases = {
        "design (N,T,D): _st_block_a": lambda: gibbs._st_block_a(pop, params, data, I_coup),
        "design (T,N,D): einsum tdb,nb->tnd + cat": lambda: torch.cat(
            [torch.ones((T, N, 1), device=dev), torch.einsum("tdb,nb->tnd", X, w_t)], 2),
        "currents (N,T,D): bmm": lambda: gibbs._design_currents(I0, Pn, theta),
        "currents (T,N,D): einsum tnd,nd->tn": lambda: I0 + torch.einsum("tnd,nd->tn", Pt, theta),
        "gradient (N,T,D): bmm": lambda: torch.bmm(d1.T[:, None, :], Pn)[:, 0],
        "gradient (T,N,D): einsum tn,tnd->nd": lambda: torch.einsum("tn,tnd->nd", d1, Pt),
        f"Hessian (N,T,D): bmm over N x {gibbs._time_chunks(T)} time chunks": lambda: gibbs._weighted_gram(Pn, d2.T),
        "Hessian (N,T,D): bmm over N": lambda: torch.bmm((Pn * d2.T[..., None]).transpose(1, 2), Pn),
        "Hessian (T,N,D): einsum tnd,tne->nde": lambda: torch.einsum("tnd,tne->nde", d2[..., None] * Pt, Pt),
    }
    for name, fn in cases.items():
        print(f"  {name}: {median_ms(fn):.3f} ms [{card}]")


if __name__ == "__main__":
    main()
