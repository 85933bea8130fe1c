"""The port's multi-device layer (theano_pyglm_torch/parallel/ and
theano_pyglm_torch/entry.py) on the CPU, against the JAX package and the
port's own one-process runs.

One two-rank gloo run (tests/torch_parallel_worker.py, torch and the port
only) computes, on each rank: the chain-sharded sampler on three models (the
sparse, the distance and the spatiotemporal-stimulus one), a
stopped-and-resumed checkpointed run, the neuron-sharded value and
gradient on three models and the neuron-sharded MAP. Meanwhile this
process computes the references: the port's one-process runs and the JAX
package's sharded (on its 8 virtual CPU devices) and unsharded functions.
Inputs as tests/torch_parity.py builds them: parameters drawn by the JAX
package, numpy spikes and stimulus, float64. The entry module is tested in
tests/test_torch_entry.py.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theano_pyglm_torch as pt
import theano_pyglm_tpu as tpu
import torch_parallel_worker as W
from theano_pyglm_torch.entry import _free_port
from theano_pyglm_torch.inference.map import map_fit
from theano_pyglm_torch.parallel import distributed
from theano_pyglm_torch.parallel.mesh import chain_mesh, neuron_mesh
from theano_pyglm_torch.parallel.neurons import neuron_partition_specs
from torch_parity import to_np

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
SEEDS = {"sparse": 0, "distance": 1, "spatiotemporal": 4, "vg_sparse": 0, "vg_distance": 2, "vg_shared": 3, "map": 7}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    """{problem/...: array}: JAX-drawn parameters, numpy spikes and
    stimulus; the map problem's spikes simulated by the JAX package from
    another prior draw, as tests/test_parallel.py sets it up (on Poisson
    noise the objective is too flat for two L-BFGS codes to stop at the
    same bias)."""
    arrays = {}
    for name, seed in SEEDS.items():
        _, N, T, _ = W.PROBLEMS[name]
        pop_j = tpu.Population(W.spec(name, tpu.make_model))
        params = pop_j.sample(jax.random.PRNGKey(seed))
        arrays.update({f"{name}/params/{k}": np.asarray(v) for k, v in params.items()})
        r = np.random.RandomState(seed)
        arrays[f"{name}/S"] = r.poisson(0.05, size=(T, N)).astype(float)
        arrays[f"{name}/stim"] = r.randn(T, W.spec(name, tpu.make_model)["bkgd"].get("D_stim", 1))
        if name == "map":
            S, _ = pop_j.simulate(jax.random.PRNGKey(1), pop_j.sample(jax.random.PRNGKey(0)), T)
            arrays[f"{name}/S"] = np.asarray(S, dtype=float)
    return arrays


def _jax_problem(name, pop_t, params_t, data_t):
    """The JAX package's population, with the port's parameters and design
    carried over as float64 arrays (JAX's prepare_data is held to the
    port's in test_torch_population.py)."""
    pop_j = tpu.Population(W.spec(name, tpu.make_model))
    return pop_j, {k: jnp.asarray(to_np(v)) for k, v in params_t.items()}, \
        {k: jnp.asarray(to_np(v)) for k, v in data_t.items()}


def _jax_refs(arrays):
    """JAX's sharded (neuron_mesh(2)) and unsharded value+grad of
    −log_joint on each vg problem (sharded: None where it raises), and its
    parallel_map_fit on the map problem."""
    from theano_pyglm_tpu.parallel.map import parallel_map_fit as parallel_map_fit_j
    from theano_pyglm_tpu.parallel.mesh import neuron_mesh as neuron_mesh_j
    from theano_pyglm_tpu.parallel.neurons import make_sharded_value_and_grad as make_vg_j

    refs = {}
    for name in W.VG_PROBLEMS:
        pop_j, params, data = _jax_problem(name, *W.problem(name, arrays))
        unsharded = jax.value_and_grad(lambda p, d: -pop_j.log_joint(p, d))(params, data)
        try:
            sharded = make_vg_j(pop_j, neuron_mesh_j(2), params, data)(params, data)
        except Exception as e:  # the shared background's w_stim_shared, split over the neurons
            sharded = e
        refs[name] = {"unsharded": unsharded, "sharded": sharded}
    pop_j, params, data = _jax_problem("map", *W.problem("map", arrays))
    refs["map"] = parallel_map_fit_j(pop_j, data, params, neuron_mesh_j(2), max_iter=W.MAP_ITERS)
    return refs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the two ranks' outputs, the port's one-process outputs, JAX's
    references): the ranks run while this process computes the rest."""
    d = tmp_path_factory.mktemp("parallel")
    arrays = _inputs()
    np.savez(d / "in.npz", **arrays)
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "2"}
    procs = [
        subprocess.Popen([sys.executable, WORKER, str(d / "in.npz"), str(d / f"out_{r}.npz"), str(d / "ckpt")],
                         env={**env, "RANK": str(r)}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)
    ]
    try:
        one = {}
        for name in W.CHAIN_PROBLEMS:
            pop, params, data = W.problem(name, arrays)
            W.flatten(f"chains/{name}", W.chain_run(pop, params, data, None), one)
        pop, params, data = W.problem("map", arrays)
        one["map"] = map_fit(pop, data, params, max_iter=W.MAP_ITERS)
        jax_refs = _jax_refs(arrays)
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    ranks = []
    for r in range(2):
        with np.load(d / f"out_{r}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    return ranks, one, jax_refs


def _close(got, want, key):
    """A continuous leaf to 1e-9 of its largest magnitude; A, the types and
    integer leaves exactly."""
    assert got.shape == want.shape and got.dtype == want.dtype, key
    if key.endswith(("/A", "/y")) or not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=key)
    else:
        scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-300)
        assert float(np.abs(got - want).max(initial=0.0)) <= 1e-9 * scale, key


def test_both_ranks_return_the_same_bits(run):
    """Everything but shard_chains' blocks, which are each rank's own."""
    ranks, _, _ = run
    assert set(ranks[0]) == set(ranks[1])
    for k in ranks[0]:
        if k != "shard":
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["shard"], np.arange(8.0).reshape(4, 2)[2 * r : 2 * r + 2])


@pytest.mark.parametrize("name", W.CHAIN_PROBLEMS)
def test_chain_sharded_sampler_equals_one_process_run(run, name):
    """4 chains × (10 + 10) with jitter, split over 2 ranks: every chain's
    samples, diagnostics and final state are the one-process run's (the
    batched products over 2 chains and over 4 may round apart)."""
    ranks, one, _ = run
    pre = f"chains/{name}/"
    want = {k: v for k, v in one.items() if k.startswith(pre)}
    got = {k: v for k, v in ranks[0].items() if k.startswith(pre)}
    assert set(got) == set(want)
    assert got[pre + "samples/bias"].shape[:2] == (10, 4)
    assert got[pre + "diag/accept_rate_glm"].shape == (4,)
    assert got[pre + "diag/accept_rate_adjacency"].shape == (4,)
    assert {k.split("/")[3] for k in got if k.startswith(pre + "states/")} == {"0", "1", "2", "3"}
    for k, w in want.items():
        if "/convergence/" in k:  # R̂ and ESS of the samples
            np.testing.assert_allclose(got[k], w, rtol=1e-6, err_msg=k)
        else:
            _close(got[k], w, k)


def test_chain_sharded_resume_is_bit_exact(run):
    """Checkpointed every 10 sweeps, stopped after sweep 15 and resumed from
    the checkpoint at 10: the uninterrupted two-rank run, bit for bit."""
    ranks, _, _ = run
    for r in ranks:
        resumed = {k[len("resumed/"):]: v for k, v in r.items() if k.startswith("resumed/")}
        whole = {k[len("chains/sparse/"):]: v for k, v in r.items() if k.startswith("chains/sparse/")}
        assert set(resumed) == set(whole)
        for k in whole:
            np.testing.assert_array_equal(resumed[k], whole[k], err_msg=k)


@pytest.mark.parametrize("name", ["vg_sparse", "vg_distance"])
def test_neuron_sharded_value_and_grad_matches_jax(run, name):
    """The two ranks' sum against JAX's shard_map objective on 2 devices and
    its unsharded value_and_grad (tests/test_parallel.py's tolerances)."""
    ranks, _, refs = run
    (val_u, grad_u), (val_s, grad_s) = refs[name]["unsharded"], refs[name]["sharded"]
    got = float(ranks[0][f"vg/{name}/value"])
    for val in (val_s, val_u):
        np.testing.assert_allclose(got, float(val), rtol=1e-8)
    for k in grad_u:
        if np.asarray(grad_u[k]).dtype.kind == "f":
            for grad in (grad_s, grad_u):
                np.testing.assert_allclose(ranks[0][f"vg/{name}/grads/{k}"], np.asarray(grad[k]),
                                           rtol=1e-6, atol=1e-8, err_msg=k)


def test_neuron_sharded_shared_background_is_the_unsharded_log_joint(run):
    """The 'shared' background's global w_stim_shared: the JAX package splits
    it over the neurons and its sharded call raises (ROADMAP.md, queue 3);
    the port splits no parameter and gives JAX's unsharded value and
    gradient."""
    ranks, _, refs = run
    assert isinstance(refs["vg_shared"]["sharded"], Exception)
    val_u, grad_u = refs["vg_shared"]["unsharded"]
    np.testing.assert_allclose(float(ranks[0]["vg/vg_shared/value"]), float(val_u), rtol=1e-8)
    for k in ("w_stim_shared", "gain", "bias", "w_ir"):
        np.testing.assert_allclose(ranks[0][f"vg/vg_shared/grads/{k}"], np.asarray(grad_u[k]),
                                   rtol=1e-6, atol=1e-8, err_msg=k)


def test_parallel_map_fit_matches_jax_and_map_fit(run):
    """N=8, T=500, 150 iterations (tests/test_parallel.py's setup): the
    log-joint within 1e-3 relative and the bias within 2e-3 of JAX's
    parallel_map_fit and of the port's map_fit."""
    ranks, one, refs = run
    got_lj, got_bias = float(ranks[0]["map/log_joint"]), ranks[0]["map/params/bias"]
    fit_j, lj_j, _ = refs["map"]
    fit_t, lj_t, _ = one["map"]
    for lj, bias in ((float(lj_j), np.asarray(fit_j["bias"])), (float(lj_t), to_np(fit_t["bias"]))):
        assert abs(got_lj - lj) < 1e-3 * max(1.0, abs(lj))
        np.testing.assert_allclose(got_bias, bias, atol=2e-3)


@pytest.mark.parametrize("what", ["chains", "neurons"])
def test_sizes_that_do_not_split_raise(run, what):
    """3 chains, or N=3, over 2 ranks: ValueError."""
    ranks, _, _ = run
    assert int(ranks[0][f"raises/{what}"]) == 1


def test_single_process_is_a_mesh_of_one(monkeypatch):
    """Without a coordinator nothing is set up; the meshes have size 1 and
    no group; a 'chains' mesh of one gives the run without a mesh bit for
    bit; a mesh of 2 raises."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert not distributed.is_distributed()
    mesh = chain_mesh()
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert neuron_mesh().axis == "neurons"
    p_specs, d_specs = neuron_partition_specs({"bias": 0, "w_stim_shared": 0, "rho": 0}, {"S": 0, "X_imp": 0})
    assert p_specs == {"bias": ("neurons",), "w_stim_shared": (), "rho": ()}
    assert d_specs == {"S": (None, "neurons"), "X_imp": ()}
    with pytest.raises(ValueError):
        chain_mesh(2)
    arrays = _inputs_sparse()
    pop, params, data = W.problem("sparse", arrays)
    a = W.flatten("", W.chain_run(pop, params, data, None), {})
    b = W.flatten("", W.chain_run(pop, params, data, mesh), {})
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _inputs_sparse():
    _, N, T, _ = W.PROBLEMS["sparse"]
    params = pt.Population(W.spec("sparse"), device="cpu", dtype=torch.float64).sample(
        torch.Generator().manual_seed(0))
    r = np.random.RandomState(0)
    return {**{f"sparse/params/{k}": to_np(v) for k, v in params.items()},
            "sparse/S": r.poisson(0.05, size=(T, N)).astype(float), "sparse/stim": r.randn(T, 1)}
