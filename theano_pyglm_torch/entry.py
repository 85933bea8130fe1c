"""Entry points of the port: the flagship's log-joint step and a dry run
of the multi-GPU layer.

The counterpart of the JAX package's root entry module. :func:`entry`
returns the value-and-gradient step of the log-joint at acceptance config
5's model family (N=27 distance-dependent network GLM with a stimulus);
:func:`dryrun_multichip` starts one process a device and runs the two
multi-device paths once at tiny shapes: a full Gibbs sweep with the chains
split over the ranks, and the value and gradient of the log-joint with the
neurons split over them.

  python3 -m theano_pyglm_torch.entry [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from theano_pyglm_torch import Population, make_model
from theano_pyglm_torch.inference.map import split_params, value_and_grad

__all__ = ["entry", "dryrun_multichip"]

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flagship(N: int = 27, T: int = 1000, seed: int = 0, device="cuda", dtype=torch.float32):
    """(pop, params, data): the distance-dependent network GLM at N, a prior
    draw of its parameters (a host generator seeded with ``seed``, the same
    on every device), Poisson(0.02) spikes and a white stimulus from numpy's
    ``seed``."""
    pop = Population(make_model("distance_weighted_model", N), device=device, dtype=dtype)
    params = pop.sample(torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    S = rng.poisson(0.02, size=(T, N)).astype(np.float32)
    stim = rng.randn(T, 1).astype(np.float32)
    return pop, params, pop.prepare_data(S, stim=stim)


def entry(device="cuda", dtype=torch.float32):
    """(fn, (opt, data)): ``fn(opt, data) -> (log_joint, grads)``, the value
    and gradient of the flagship problem's log-joint in its continuous
    parameters (on a CUDA device one K2 launch). ``opt`` may also carry
    other leaves, which replace the fixed ones; ``grads`` covers every
    floating leaf of ``opt``."""
    pop, params, data = _flagship(device=device, dtype=dtype)
    opt, frozen = split_params(params)

    def forward_step(opt_params, data):
        return value_and_grad(lambda x: pop.log_joint({**frozen, **x}, data), opt_params)

    return forward_step, (opt, data)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout: float = 600.0) -> None:
    """Start ``n_devices`` ranks, one process each (NCCL, one GPU each; or
    gloo on the CPU with ``device="cpu"``), and run on every rank: (a) one
    full Gibbs sweep of warmup and one of sampling of
    ``distance_weighted_model`` at N=8, T=64, one chain a rank, the chains
    split over a 'chains' mesh; (b) the value and gradient of the log-joint
    of ``sparse_weighted_model`` at N=4·n_devices, split over a 'neurons'
    mesh. Each rank's output is printed; raises if any rank fails. Every
    process started is ended before this returns."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p)}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c",
             f"from theano_pyglm_torch.entry import _dryrun_rank; _dryrun_rank({r}, {n_devices}, {port}, {device!r})"],
            cwd=_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(n_devices)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, out in enumerate(outs):
        sys.stdout.write(f"--- rank {r} ---\n{out}")
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"dryrun_multichip({n_devices}): ranks {failed} failed")


def _dryrun_rank(rank: int, n: int, port: int, device: str) -> None:
    """One rank of :func:`dryrun_multichip`."""
    from theano_pyglm_torch.parallel import distributed
    from theano_pyglm_torch.parallel.chains import gibbs_sample_chains
    from theano_pyglm_torch.parallel.mesh import chain_mesh, neuron_mesh
    from theano_pyglm_torch.parallel.neurons import make_sharded_value_and_grad

    dev = torch.device("cpu") if device == "cpu" else torch.device("cuda", rank)
    distributed.initialize(f"127.0.0.1:{port}", n, rank, device=dev)
    try:
        # (a) the chains split over the ranks: one full sweep each of warmup and sampling
        pop = Population(make_model("distance_weighted_model", 8, bkgd={"type": "none"}), device=dev)
        rng = np.random.RandomState(0)
        data = pop.prepare_data(rng.poisson(0.02, size=(64, 8)).astype(np.float32))
        samples, _, _ = gibbs_sample_chains(pop, data, 0, n_chains=n, n_samples=1, n_warmup=1, chunk_size=1,
                                            mesh=chain_mesh(n))
        assert samples["W"].shape[1] == n, samples["W"].shape
        assert np.all(np.isfinite(samples["W"]))

        # (b) the neurons split over the ranks: one value and gradient
        N = 4 * n
        pop = Population(make_model("sparse_weighted_model", N, bkgd={"type": "none"}), device=dev)
        params = pop.sample(torch.Generator().manual_seed(1))
        data = pop.prepare_data(rng.poisson(0.02, size=(64, N)).astype(np.float32))
        val, grads = make_sharded_value_and_grad(pop, neuron_mesh(n), params, data)(params, data)
        assert bool(torch.isfinite(val)) and all(bool(torch.isfinite(g).all()) for g in grads.values())
        print(f"dryrun_multichip({n}) rank {rank} on {dev}: chain-sharded sweep + neuron-sharded grad OK "
              f"(value {float(val):.6f})", flush=True)
    finally:
        distributed.shutdown()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    fn, (opt, data) = entry(device=args.device)
    val, _ = fn(opt, data)
    print("entry: log_joint =", float(val))
    dryrun_multichip(torch.cuda.device_count() if args.device != "cpu" else 2, device=args.device)


if __name__ == "__main__":
    main()
