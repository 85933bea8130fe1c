"""One rank of the port's multi-process check (tests/test_torch_parallel.py).

Run as ``python tests/torch_parallel_worker.py IN.npz OUT.npz CKPT_DIR`` under a
two-rank gloo group (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK set). It
imports torch and the port only, never JAX. ``IN.npz`` holds each
problem's parameters, spikes and stimulus (float64) under
``<problem>/...``; the rank writes what it computed to ``OUT.npz`` as flat
keys (:func:`flatten`):

- ``chains/<problem>/...``: ``gibbs_sample_chains`` on a 'chains' mesh
  (the sparse, distance and spatiotemporal models),
  4 chains × (10 warmup + 10 kept) sweeps from the problem's parameters
  with jitter 0.05: samples, diagnostics and final states;
- ``resumed/...``: the sparse problem's run checkpointed every 10 sweeps,
  stopped after sweep 15 and resumed;
- ``vg/<problem>/...``: ``make_sharded_value_and_grad`` on a 'neurons'
  mesh at the problem's parameters;
- ``map/...``: ``parallel_map_fit`` from the map problem's parameters;
- ``raises/...``: 1 where a size that does not split over the ranks
  raised ``ValueError``;
- ``shard``: ``shard_chains`` of arange(8) as (4, 2) rows.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from theano_pyglm_torch import Population, make_model  # noqa: E402
from theano_pyglm_torch.inference.hmc import HMCState  # noqa: E402
from theano_pyglm_torch.utils.convert import params_from_numpy  # noqa: E402

#: name -> (template, N, T, the stimulus background's type)
PROBLEMS = {
    "sparse": ("sparse_weighted_model", 2, 200, "none"),
    "distance": ("distance_weighted_model", 4, 200, "basis"),
    "spatiotemporal": ("spatiotemporal_glm", 2, 200, "spatiotemporal"),
    "vg_sparse": ("sparse_weighted_model", 8, 200, "none"),
    "vg_distance": ("distance_weighted_model", 8, 200, "basis"),
    "vg_shared": ("standard_glm", 8, 200, "shared"),
    "map": ("sparse_weighted_model", 8, 500, "none"),
}
CHAIN_PROBLEMS = ("sparse", "distance", "spatiotemporal")
#: the spatiotemporal problem's stimulus dimensions (the template's 25, cut)
ST_D_STIM = 2
VG_PROBLEMS = ("vg_sparse", "vg_distance", "vg_shared")
#: the chains' sampler: seed and depth
CHAIN_RUN = dict(n_chains=4, n_samples=10, n_warmup=10, chunk_size=5, init_jitter=0.05)
CHAIN_SEED = 11
MAP_ITERS = 150


def spec(name, make=make_model) -> dict:
    """The problem's model spec (``make``: either package's ``make_model``)."""
    template, N, _, bkgd = PROBLEMS[name]
    spec = make(template, N)
    if bkgd == "none":
        spec["bkgd"] = {"type": "none"}
    else:
        spec["bkgd"]["type"] = bkgd
    if bkgd == "spatiotemporal":
        spec["bkgd"]["D_stim"] = ST_D_STIM
    return spec


def problem(name, arrays):
    """(pop, params, data) of a problem on the CPU in float64, from the
    arrays the test wrote."""
    pop = Population(spec(name), device="cpu", dtype=torch.float64)
    pre = f"{name}/params/"
    params = params_from_numpy({k[len(pre):]: arrays[k] for k in arrays if k.startswith(pre)},
                               device="cpu", dtype=torch.float64)
    stim = arrays[f"{name}/stim"] if pop.basis_stim is not None else None
    return pop, params, pop.prepare_data(arrays[f"{name}/S"], stim=stim)


def flatten(prefix, x, out):
    """Every array of a nesting of dicts, lists, HMCState records, tensors,
    arrays and numbers under '/'-joined keys."""
    if isinstance(x, HMCState):
        x = {k: v for k, v in x._asdict().items() if v is not None}
    if isinstance(x, dict):
        for k, v in x.items():
            flatten(f"{prefix}/{k}", v, out)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            flatten(f"{prefix}/{i}", v, out)
    elif isinstance(x, torch.Tensor):
        out[prefix] = x.detach().cpu().numpy()
    else:
        out[prefix] = np.asarray(x)
    return out


def chain_run(pop, params, data, mesh, **kw):
    from theano_pyglm_torch.parallel.chains import gibbs_sample_chains

    samples, diag, states = gibbs_sample_chains(pop, data, CHAIN_SEED, init_params=params, mesh=mesh,
                                                **{**CHAIN_RUN, **kw})
    return {"samples": samples, "diag": diag, "states": states}


class Stop(Exception):
    pass


def main(in_file, out_file, ckpt_dir):
    from theano_pyglm_torch.parallel import distributed
    from theano_pyglm_torch.parallel.map import parallel_map_fit
    from theano_pyglm_torch.parallel.mesh import chain_mesh, neuron_mesh, shard_chains
    from theano_pyglm_torch.parallel.neurons import make_sharded_value_and_grad

    torch.set_num_threads(1)
    assert distributed.initialize(device="cpu")
    arrays = dict(np.load(in_file))
    out = {}
    try:
        mesh = chain_mesh(2)
        assert (mesh.size, mesh.axis) == (2, "chains")
        for name in CHAIN_PROBLEMS:
            pop, params, data = problem(name, arrays)
            flatten(f"chains/{name}", chain_run(pop, params, data, mesh), out)

        # checkpointed every 10 sweeps, stopped after sweep 15, resumed from 10
        pop, params, data = problem("sparse", arrays)

        def stop(phase, done, states):
            if phase == "sample" and done == 5:
                raise Stop

        try:
            chain_run(pop, params, data, mesh, checkpoint_dir=ckpt_dir, checkpoint_every=10, callback=stop)
            raise AssertionError("the run was not stopped")
        except Stop:
            pass
        flatten("resumed", chain_run(pop, params, data, mesh, checkpoint_dir=ckpt_dir, checkpoint_every=10,
                                     resume=True), out)

        nmesh = neuron_mesh(2)
        for name in VG_PROBLEMS:
            pop, params, data = problem(name, arrays)
            value, grads = make_sharded_value_and_grad(pop, nmesh, params, data)(params, data)
            flatten(f"vg/{name}", {"value": value, "grads": grads}, out)

        pop, params, data = problem("map", arrays)
        fit, log_joint, iters = parallel_map_fit(pop, data, params, nmesh, max_iter=MAP_ITERS)
        flatten("map", {"params": fit, "log_joint": log_joint, "iters": iters}, out)

        pop, params, data = problem("sparse", arrays)
        for what, call in (
            ("chains", lambda: chain_run(pop, params, data, mesh, n_chains=3)),
            ("neurons", lambda: make_sharded_value_and_grad(
                Population(make_model("sparse_weighted_model", 3), device="cpu"), nmesh, params, data)),
        ):
            try:
                call()
                out[f"raises/{what}"] = np.asarray(0)
            except ValueError:
                out[f"raises/{what}"] = np.asarray(1)
        out["shard"] = shard_chains(torch.arange(8.0).reshape(4, 2), mesh).numpy()
    finally:
        distributed.shutdown()
    np.savez(out_file, **out)
    assert "jax" not in sys.modules, "a worker imported JAX"


if __name__ == "__main__":
    main(*sys.argv[1:4])
