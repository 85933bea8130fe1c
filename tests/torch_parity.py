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
