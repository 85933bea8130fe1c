"""Helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Builds the same spec, parameters and data in both packages: parameters are
drawn once by the JAX package and carried into the port with
``params_from_numpy``; spikes and stimulus come from numpy.
"""

import jax
import numpy as np
import torch

import theano_pyglm_torch as pt
import theano_pyglm_tpu as tpu
from theano_pyglm_torch.utils.convert import params_from_numpy


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def build_pair(name, N, T=400, seed=0, dtype=torch.float64, spikes=None, **overrides):
    """(pop_jax, pop_torch, params_jax, params_torch, data_jax, data_torch).

    ``spikes`` replaces the default Poisson(0.05) counts.
    """
    spec = tpu.make_model(name, N, **overrides)
    pop_j = tpu.Population(spec)
    pop_t = pt.Population(spec, device="cpu", dtype=dtype)
    params_j = pop_j.sample(jax.random.PRNGKey(seed))
    r = np.random.RandomState(seed)
    stim = r.randn(T, spec["bkgd"].get("D_stim", 1))
    S = r.poisson(0.05, size=(T, N)).astype(float) if spikes is None else spikes
    data_j = pop_j.prepare_data(S, stim=stim)
    data_t = pop_t.prepare_data(S, stim=stim)
    params_t = params_from_numpy({k: np.asarray(v) for k, v in params_j.items()}, device="cpu", dtype=dtype)
    return pop_j, pop_t, params_j, params_t, data_j, data_t


def build_pair_light(spec, T=300, seed=0, spikes=None):
    """The tuple of :func:`build_pair`, with the parameters drawn by the
    port (a CPU generator seeded with ``seed``) and the design built by the
    port's ``prepare_data`` (held to JAX's in test_torch_population.py),
    both carried into JAX as float64 arrays. JAX's own ``prepare_data``
    compiles for ~20 s per shape on the CPU."""
    import jax.numpy as jnp

    N = spec["N"]
    pop_j = tpu.Population(spec)
    pop_t = pt.Population(spec, device="cpu", dtype=torch.float64)
    params_t = pop_t.sample(torch.Generator().manual_seed(seed))
    r = np.random.RandomState(seed)
    stim = r.randn(T, spec["bkgd"].get("D_stim", 1))
    S = r.poisson(0.05, size=(T, N)).astype(float) if spikes is None else spikes
    data_t = pop_t.prepare_data(S, stim=stim)
    params_j = {k: jnp.asarray(to_np(v)) for k, v in params_t.items()}
    data_j = {k: jnp.asarray(to_np(v)) for k, v in data_t.items()}
    return pop_j, pop_t, params_j, params_t, data_j, data_t


def rel_err(got, want) -> float:
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def jax_config4(T=60_000):
    """Acceptance config 4's data as the JAX package's ``scripts/acceptance.py``
    draws them at full size, in its default float32 (float64 draws other
    spikes): the generating parameters (numpy, float32 or int) and the spike
    counts (T, 16) as uint8. The stimulus is numpy's and is rebuilt by
    ``theano_pyglm_torch.scripts.acceptance.reference_stim4``."""
    from theano_pyglm_torch.scripts.acceptance import BM4, N4, Y4, reference_stim4

    with jax.enable_x64(False):
        spec = tpu.make_model("sbm_weighted_model", N4)
        spec["bias"] = {"mu": 2.8, "sigma": 0.3}
        spec["impulse"]["sigma"] = 0.5
        pop = tpu.Population(spec)
        true = dict(pop.sample(jax.random.PRNGKey(4)))
        r = np.random.RandomState(4)
        A = (r.rand(N4, N4) < BM4[Y4[:, None], Y4[None, :]]).astype(np.float32)
        np.fill_diagonal(A, 1.0)
        W = np.where(r.rand(N4, N4) < 0.7, 2.5, -2.5).astype(np.float32)
        np.fill_diagonal(W, -2.0)
        true.update(y=Y4, Bm=BM4.astype(np.float32), pi=np.full(2, 0.5, np.float32), A=A, W=W * A)
        true = {k: jax.numpy.asarray(v) for k, v in true.items()}
        S, _ = pop.simulate(jax.random.PRNGKey(5), true, T, stim=reference_stim4(T))
        return {k: np.asarray(v) for k, v in true.items()}, np.asarray(S).astype(np.uint8)


if __name__ == "__main__":
    # PYTHONPATH=. python tests/torch_parity.py: rewrite the port's copy of
    # config 4's JAX-drawn data (the test of test_torch_sbm.py holds it)
    from theano_pyglm_torch.scripts.acceptance import REFERENCE4

    jax.config.update("jax_platforms", "cpu")
    true4, S4 = jax_config4()
    np.savez_compressed(REFERENCE4, S=S4, **true4)
    print(REFERENCE4, S4.shape, int(S4.sum()), "spikes")
