"""The port's entry module (theano_pyglm_torch/entry.py) on the CPU: the
flagship's log-joint step against the JAX package's root entry module, and
the multi-device dry run on two gloo ranks."""

import os
import sys

import jax
import numpy as np
import torch

import theano_pyglm_tpu as tpu
from theano_pyglm_torch.entry import dryrun_multichip, entry
from torch_parity import to_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_matches_jax_entry():
    """The flagship step (N=27, T=1,000) at the JAX package's parameters:
    its log-joint and gradient against the JAX entry's, whose problem is
    built from float32 arrays, to 1e-5 relative (the gradient in L2)."""
    sys.path.insert(0, ROOT)
    import __graft_entry__ as jax_entry

    fn_j, (opt_j, data_j) = jax_entry.entry()
    val_j, grad_j = jax.jit(fn_j)(opt_j, data_j)  # as the JAX module's main runs it
    # the JAX entry's parameters: its prior draw with seed 0
    params_j = tpu.Population(tpu.make_model("distance_weighted_model", 27)).sample(jax.random.PRNGKey(0))
    fn, (opt, data) = entry(device="cpu", dtype=torch.float64)
    assert set(opt) == set(opt_j)
    val, grads = fn({k: torch.as_tensor(np.array(v)) for k, v in params_j.items()}, data)
    np.testing.assert_allclose(float(val), float(val_j), rtol=1e-5)
    for k in opt_j:
        g, w = to_np(grads[k]), np.asarray(grad_j[k])
        assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w), k


def test_entry_step_is_the_population_log_joint():
    """entry()'s value is the population's log-joint at the problem's own
    prior draw, and its gradient autograd's (float64, the CPU)."""
    from theano_pyglm_torch.entry import _flagship
    from theano_pyglm_torch.inference.map import split_params

    fn, (opt, data) = entry(device="cpu", dtype=torch.float64)
    val, grads = fn(opt, data)
    pop, params, data2 = _flagship(device="cpu", dtype=torch.float64)
    assert float(val) == float(pop.log_joint(params, data2))
    q, frozen = split_params(params)
    q = {k: v.clone().requires_grad_() for k, v in q.items()}
    want = torch.autograd.grad(pop.log_joint({**frozen, **q}, data2), list(q.values()))
    for k, w in zip(q, want):
        torch.testing.assert_close(grads[k], w, rtol=0, atol=0)


def test_dryrun_multichip_on_two_cpu_ranks(capfd):
    dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    assert out.count("chain-sharded sweep + neuron-sharded grad OK") == 2
