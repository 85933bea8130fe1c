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

Sparse network MAP (acceptance config 2) adds an L1 penalty on the
off-diagonal coupling weights, smoothed as √(w² + ε²) so L-BFGS applies,
with λ chosen by held-out log-likelihood (:func:`cross_validate_lambda`).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

__all__ = [
    "CONTINUOUS_KEYS",
    "split_params",
    "value_and_grad",
    "lbfgs_minimize",
    "map_fit",
    "sparse_map_fit",
    "heldout_log_likelihood",
    "cross_validate_lambda",
]

# Continuous, unconstrained leaves MAP (and HMC) may move. Discrete latents
# (A, y) and conjugate hypers (pi, Bm, rho) are handled by Gibbs updates.
CONTINUOUS_KEYS = ("bias", "w_stim", "w_stim_s", "w_stim_t", "w_stim_shared", "gain", "w_ir", "W", "locs")

_MAX_EVALS_PER_ITER = 25  # objective evaluations one L-BFGS iteration may spend


def split_params(params: dict, keys: Sequence[str] = CONTINUOUS_KEYS):
    """Partition a params dict into (optimized, frozen) sub-dicts by key."""
    opt = {k: v for k, v in params.items() if k in keys}
    frozen = {k: v for k, v in params.items() if k not in keys}
    return opt, frozen


def value_and_grad(fn: Callable, params: dict) -> tuple:
    """(value, {leaf: gradient}) of the scalar ``fn(params)`` over the
    floating leaves of ``params``; a leaf ``fn`` does not reach gets zeros."""
    x = {k: v.detach().requires_grad_(True) for k, v in params.items()
         if isinstance(v, torch.Tensor) and v.is_floating_point()}
    val = fn({**params, **x})
    grads = torch.autograd.grad(val, list(x.values()), allow_unused=True)
    return val.detach(), {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(x.items(), grads)}


def lbfgs_minimize(fun: Callable, x0: dict, max_iter: int = 500, tol: float = 1e-6, window: int = 1):
    """Minimize ``fun`` (dict of tensors -> scalar tensor) with L-BFGS.

    One ``torch.optim.LBFGS`` iteration per step, so the convergence test of
    the JAX package applies between iterations: stop after ``max_iter``, or
    once the change in value over the last ``window`` iterations is at most
    ``tol``·(1 + |value|) or the gradient norm is at most ``tol`` (tested
    from iteration ``window`` + 1 on). ``window`` > 1 serves the
    long-recording MAP (``scripts/stretch_streaming.py``: 40), which stops,
    as the JAX script does between its 40-iteration slices, once a window of
    iterations moved the value by less than ``tol``; every other caller
    keeps the per-iteration test (``window`` = 1).

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

    history = []  # the value at the start of each iteration
    iters = 0
    while iters < max_iter:
        start.clear()
        opt.step(closure)  # its first evaluation is at the iterate it starts from
        val, gnorm = start[0]
        history.append(val)
        iters += 1
        if len(history) > window:
            progress = abs(val - history[-1 - window]) > tol * (1.0 + abs(val))
            if not (progress and gnorm > tol):
                break
    x = {k: v.detach() for k, v in x.items()}
    with torch.no_grad():
        final = fun(x)
    return x, final, iters


def map_fit(pop, data, init_params, max_iter: int = 500, tol: float = 1e-6, window: int = 1):
    """MAP-fit all continuous parameters (discrete latents held fixed).
    ``tol`` and ``window``: the stop of :func:`lbfgs_minimize`.

    Returns (params_map, log_joint_at_map, n_iterations).
    """
    return _map_fit_multi(pop, init_params, (data,), max_iter, 0.0, tol=tol, window=window)


def _l1_penalty(W, lam: float, l1_eps: float = 1e-6) -> torch.Tensor:
    """λ·Σ √(off² + ε²) over the (N, N) entries of W with its diagonal
    zeroed: the smoothed lasso on the off-diagonal coupling (the diagonal
    adds the constant λ·N·ε, as in the JAX package)."""
    off = W * (1.0 - torch.eye(W.shape[0], dtype=W.dtype, device=W.device))
    return lam * torch.sqrt(off * off + l1_eps * l1_eps).sum()


def _objective(pop, frozen: dict, datas: Sequence[dict], lam: float, l1_eps: float) -> Callable:
    """The penalized negative log-posterior over disjoint data segments,
    −log_prior − Σ_segments log_likelihood + λ·penalty: the spike
    log-likelihood adds over segments (each has its own zero-padded causal
    design, so there are no seam artifacts) and the prior enters once. With
    λ = 0 and one segment it is −log_joint, the objective of :func:`map_fit`."""

    def objective(opt_params):
        p = {**frozen, **opt_params}
        nlp = -pop.log_prior(p)
        for d in datas:
            nlp = nlp - pop.log_likelihood(p, d)
        return nlp + _l1_penalty(opt_params["W"], lam, l1_eps) if lam else nlp

    return objective


def _map_fit_multi(pop, params0, datas: Sequence[dict], max_iter: int, lam: float, l1_eps: float = 1e-6,
                   **stop):
    """MAP over a sequence of data segments, with the sparse penalty when
    ``lam`` > 0 (see :func:`_objective`); ``stop``: ``tol`` and ``window``
    of :func:`lbfgs_minimize`. Returns (params, penalized log-posterior at
    the fit, n_iterations)."""
    opt0, frozen = split_params(params0)
    opt, val, iters = lbfgs_minimize(_objective(pop, frozen, datas, lam, l1_eps), opt0, max_iter=max_iter,
                                     **stop)
    return {**frozen, **opt}, -val, iters


def sparse_map_fit(pop, data, init_params, lam: float, max_iter: int = 500, l1_eps: float = 1e-6):
    """MAP with the smoothed L1 penalty λ·Σ|W_offdiag| for sparse coupling.
    With ε=1e-6 the minimizer's support is recovered by thresholding |W|
    at ~√ε. Returns (params, penalized log-posterior, n_iterations)."""
    return _map_fit_multi(pop, init_params, (data,), max_iter, float(lam), l1_eps)


@torch.no_grad()
def heldout_log_likelihood(pop, params, data) -> torch.Tensor:
    """The spike log-likelihood of ``params`` on (held-out) ``data``; a
    value-only evaluation (the fused kernel K1 on a CUDA device)."""
    return pop.log_likelihood(params, data)


def _xv_folds(T: int, n_folds: int, train_frac: float) -> list:
    """[(training slices, validation slice)] per fold: one contiguous split
    at ``train_frac`` for ``n_folds <= 1``, else contiguous k-fold with the
    validation block rotating and training on the rest (one or two
    segments)."""
    if n_folds <= 1:
        T_tr = int(T * train_frac)
        return [((slice(0, T_tr),), slice(T_tr, T))]
    edges = [int(round(i * T / n_folds)) for i in range(n_folds + 1)]
    folds = []
    for i in range(n_folds):
        train = tuple(s for s in (slice(0, edges[i]), slice(edges[i + 1], T)) if s.stop > s.start)
        folds.append((train, slice(edges[i], edges[i + 1])))
    return folds


def cross_validate_lambda(
    pop,
    S,
    stim,
    init_params,
    lambdas: Sequence[float],
    train_frac: float = 0.8,
    max_iter: int = 300,
    n_folds: int = 1,
    warm_start: bool = True,
):
    """Grid-search the sparsity penalty λ by held-out predictive
    log-likelihood over contiguous folds (:func:`_xv_folds`); every
    training and validation segment gets its own ``prepare_data``.

    Within a fold the λ's are fitted smallest-first, each warm-started from
    the previous (denser) fit: descending order can warm-start every fit
    from an all-zero-coupling solution whose filters have adapted to no
    coupling, and the nonconvex path never escapes it. Every fold starts
    from ``init_params``: starting fold i+1 from fold i's fit would leak
    its validation block, part of fold i's training data, into the fits
    scored on it.

    Returns (best_lambda, fits, scores): ``fits`` are the fold-0 fits per
    λ, ``scores`` the mean held-out log-likelihood per λ, both in the order
    of ``lambdas``.
    """
    folds = _xv_folds(S.shape[0], n_folds, train_frac)

    def seg_data(sl):
        return pop.prepare_data(S[sl], stim=None if stim is None else stim[sl])

    order = sorted(range(len(lambdas)), key=lambda i: float(lambdas[i]))
    scores_sum = [0.0] * len(lambdas)
    fits_fold0 = [None] * len(lambdas)
    for fold_i, (train_sls, val_sl) in enumerate(folds):
        datas = tuple(seg_data(sl) for sl in train_sls)
        data_val = seg_data(val_sl)
        params = init_params
        for i in order:
            fit, _, _ = _map_fit_multi(pop, params, datas, max_iter, float(lambdas[i]))
            if warm_start:
                params = fit
            scores_sum[i] += float(heldout_log_likelihood(pop, fit, data_val))
            if fold_i == 0:
                fits_fold0[i] = fit
    scores = [s / len(folds) for s in scores_sum]
    return lambdas[int(np.argmax(scores))], fits_fold0, scores
