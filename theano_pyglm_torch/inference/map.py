"""MAP inference — L-BFGS on the log-joint.

Port of :mod:`theano_pyglm_tpu.inference.map`. The likelihood factorizes
over postsynaptic neurons and the priors are separable, so one joint L-BFGS
run over the full continuous parameter block is the reference's per-neuron
coordinate sweep.

``torch.optim.LBFGS`` (strong-Wolfe line search) takes the place of optax's
L-BFGS with its zoom line search. The two searches pick different steps, so
the port is held to the final objective, not to the iterates. Each
objective evaluation is one value+grad of the log-joint, which runs the
fused kernel K2 on a CUDA device.

``sparse_map_fit`` and ``cross_validate_lambda`` are not ported yet
(ROADMAP.md, queue 1 item 11).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

__all__ = ["CONTINUOUS_KEYS", "split_params", "lbfgs_minimize", "map_fit"]

# Continuous, unconstrained leaves MAP (and HMC) may move. Discrete latents
# (A, y) and conjugate hypers (pi, Bm, rho) are handled by Gibbs updates.
CONTINUOUS_KEYS = ("bias", "w_stim", "w_stim_s", "w_stim_t", "w_stim_shared", "gain", "w_ir", "W", "locs")

_MAX_EVALS_PER_ITER = 25  # objective evaluations one L-BFGS iteration may spend


def split_params(params: dict, keys: Sequence[str] = CONTINUOUS_KEYS):
    """Partition a params dict into (optimized, frozen) sub-dicts by key."""
    opt = {k: v for k, v in params.items() if k in keys}
    frozen = {k: v for k, v in params.items() if k not in keys}
    return opt, frozen


def lbfgs_minimize(fun: Callable, x0: dict, max_iter: int = 500, tol: float = 1e-6):
    """Minimize ``fun`` (dict of tensors -> scalar tensor) with L-BFGS.

    One ``torch.optim.LBFGS`` iteration per step, so the convergence test of
    the JAX package applies between iterations: stop after ``max_iter``, or
    from the third iteration on once the relative change in value is at most
    ``tol``·(1 + |value|) or the gradient norm is at most ``tol``.

    Returns (x_opt as detached tensors, final value, n_iters).
    """
    x = {k: v.detach().clone().requires_grad_(True) for k, v in x0.items()}
    opt = torch.optim.LBFGS(
        list(x.values()),
        lr=1.0,
        max_iter=1,
        max_eval=_MAX_EVALS_PER_ITER,
        tolerance_grad=0.0,
        tolerance_change=0.0,
        history_size=10,
        line_search_fn="strong_wolfe",
    )
    start = []  # (value, grad norm) of each evaluation in the current step

    def closure():
        opt.zero_grad()
        val = fun(x)
        val.backward()
        gnorm = torch.sqrt(sum(torch.sum(v.grad * v.grad) for v in x.values()))
        start.append((float(val.detach()), float(gnorm)))
        return val

    prev_val = math.inf
    iters = 0
    while iters < max_iter:
        start.clear()
        opt.step(closure)  # its first evaluation is at the iterate it starts from
        val, gnorm = start[0]
        iters += 1
        progress = abs(val - prev_val) > tol * (1.0 + abs(val))
        if iters >= 2 and not (progress and gnorm > tol):
            break
        prev_val = val
    x = {k: v.detach() for k, v in x.items()}
    with torch.no_grad():
        final = fun(x)
    return x, final, iters


def map_fit(pop, data, init_params, max_iter: int = 500):
    """MAP-fit all continuous parameters (discrete latents held fixed).

    Returns (params_map, log_joint_at_map, n_iterations).
    """
    opt0, frozen = split_params(init_params)

    def objective(opt_params):
        return -pop.log_joint({**frozen, **opt_params}, data)

    opt, val, iters = lbfgs_minimize(objective, opt0, max_iter=max_iter)
    return {**frozen, **opt}, -val, iters
