"""Held-out predictive log-likelihood — port of
:mod:`theano_pyglm_tpu.inference.predictive`.

For a MAP fit this is ``pop.log_likelihood(params, data_heldout)``. For
MCMC, the posterior-predictive density averages the likelihood over the
posterior draws in probability space:

    log p(S_ho | S_tr) ≈ logsumexp_k [ LL(S_ho | θ_k) ] − log K

Each block of ``batch`` draws is evaluated in one call with a leading
chain axis, as the JAX package's ``lax.map(..., batch_size)`` ``vmap``s
every block, the remainder included: on the fused path (exp-Poisson,
float32) one K3-fwd launch per group of ``kernels.chain_groups`` of the
block, and with a bf16 design the chain rules (U rounded to bf16,
K4-fwd-chains), not the one-chain semantics.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["predictive_log_likelihood", "map_heldout_log_likelihood"]


def map_heldout_log_likelihood(pop, params, data_heldout):
    return pop.log_likelihood(params, data_heldout)


def _on_population(pop, x) -> torch.Tensor:
    """A stack of sample leaves on the population's device: floating leaves
    in its dtype, integer leaves (SBM types) as int64."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    dtype = pop.dtype if x.is_floating_point() else torch.int64
    return x.to(device=pop.device, dtype=dtype)


@torch.no_grad()
def predictive_log_likelihood(pop, samples: dict, data_heldout, batch: int = 32):
    """Posterior-predictive log-likelihood of ``data_heldout`` from a stack
    of draws ``samples`` (leading axis = draws; fold chain axes in first),
    numpy arrays or tensors. The draws move to the population's device
    ``batch`` at a time, and each block, a remainder of one draw included,
    is one evaluation with a chain axis. Returns a 0-d tensor."""
    K = len(next(iter(samples.values())))
    lls = []
    for start in range(0, K, batch):
        block = {k: _on_population(pop, v[start : start + batch]) for k, v in samples.items()}
        lls.append(pop.log_likelihood(block, data_heldout))
    return torch.logsumexp(torch.cat(lls), 0) - math.log(K)
