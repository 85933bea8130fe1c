"""MAP with the neurons split over ranks — port of
:mod:`theano_pyglm_tpu.parallel.map`.

The reference fits each engine's neuron subset and gathers the fits; the
JAX package runs :func:`~theano_pyglm_tpu.inference.map.map_fit`'s joint
L-BFGS on a neuron-sharded objective. So does the port: the same
``lbfgs_minimize`` on the objective of
:mod:`theano_pyglm_torch.parallel.neurons`, where each rank evaluates its
neurons' likelihood (one fused-kernel launch on a CUDA device) and one
all-reduce a evaluation sums the value and the gradient. Every rank gets
the same reduced value and gradient and runs the same line search on
them, so every rank's iterates, and its result, are the same.
"""

from __future__ import annotations

from theano_pyglm_torch.inference.map import lbfgs_minimize, split_params
from theano_pyglm_torch.parallel.mesh import replicate
from theano_pyglm_torch.parallel.neurons import _local_view, sharded_log_likelihood

__all__ = ["parallel_map_fit"]


def parallel_map_fit(pop, data, init_params, mesh, max_iter: int = 500):
    """MAP with the postsynaptic neurons split over a 'neurons' ``mesh``
    (N a multiple of its size). The data and ``init_params`` are broadcast
    from rank 0 first. Returns (params, log_joint, iters) as ``map_fit``
    does: the same objective, evaluated in parts."""
    lo, hi = mesh.block(pop.N)
    data, init_params = replicate((data, init_params), mesh)
    local = _local_view(lo, hi)(data)
    opt0, frozen = split_params(init_params)

    def objective(opt):
        p = {**frozen, **opt}
        return -(sharded_log_likelihood(pop, p, local, mesh) + pop.log_prior(p))

    opt, val, iters = lbfgs_minimize(objective, opt0, max_iter=max_iter)
    return {**frozen, **opt}, -val, iters
