"""Hamiltonian Monte Carlo — leapfrog, dual averaging, and diagonal
mass-matrix adaptation.

Port of :mod:`theano_pyglm_tpu.inference.hmc`. The target is any
``logp(dict of tensors) -> scalar tensor``; the leapfrog is a Python loop
whose gradients come from ``torch.autograd.grad`` of the target, so on the
population's fused path every kick runs kernel K2 and the end-point
log-density (under ``torch.no_grad``) runs K1. Warmup adapts

  * the global step size ε by Nesterov dual averaging (Hoffman & Gelman 2014
    §3.2) toward the target acceptance, and
  * a per-coordinate scale (diagonal inverse mass) from winsorized Welford
    variances of the position, applied between windows by
    :func:`apply_mass_matrix`.

Leapfrog runs in the rescaled coordinates: kick p += ½·ε·s∘∇logp, drift
q += ε·s∘p with s the coordinate scales — HMC with mass matrix M = diag(1/s²).
Random draws take a ``torch.Generator`` and happen on its device.

Chains: a state whose ``log_prob`` is (C,) holds C independent chains on a
leading axis of every leaf, with a step size, dual-averaging state, Welford
statistics and accept rate per chain; ``logp`` then returns (C,) and the
draws take one generator per chain (a list), each chain's drawn in the
order of a one-chain transition (:func:`~theano_pyglm_torch.ops.distributions.draw`).
Accept and reject are ``torch.where`` per chain: nothing reads back to the
host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from theano_pyglm_torch.ops.distributions import draw

__all__ = ["HMCState", "hmc_init", "hmc", "hmc_adaptive_step", "reset_variance", "apply_mass_matrix"]


class HMCState(NamedTuple):
    """HMC state: position + step-size/mass adaptation statistics."""

    position: dict
    log_prob: torch.Tensor
    step_size: torch.Tensor
    # dual-averaging state (Hoffman & Gelman 2014 §3.2)
    log_eps_avg: torch.Tensor  # iterate-averaged log ε (used once adaptation stops)
    h_avg: torch.Tensor  # running average of (target − accept)
    t: torch.Tensor
    accept_rate: torch.Tensor
    mu: torch.Tensor = None  # dual-averaging shrinkage point log(10·ε₀)
    # diagonal mass adaptation (Welford over warmup positions)
    scale: dict = None  # per-coordinate std estimate (≡ sqrt of inv mass)
    pos_mean: dict = None
    pos_m2: dict = None
    n_var: torch.Tensor = None


def _map(fn, *trees: dict) -> dict:
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def _per_chain(x, leaf):
    """A per-chain value (a number, a scalar or a (C,) tensor) shaped to
    broadcast against a (C, ...) leaf."""
    if not isinstance(x, torch.Tensor):
        return x
    return x.reshape(x.shape + (1,) * (leaf.ndim - x.ndim))


@torch.no_grad()
def hmc_init(position: dict, logp_fn: Callable, step_size: float = 0.01) -> HMCState:
    lp = logp_fn(position)
    full = lambda v: torch.full((), v, dtype=lp.dtype, device=lp.device)  # noqa: E731
    eps = full(step_size)
    return HMCState(
        position=position,
        log_prob=lp,
        step_size=eps,
        log_eps_avg=torch.log(eps),
        h_avg=full(0.0),
        t=full(0.0),
        accept_rate=full(1.0),
        mu=torch.log(10.0 * eps),
        scale=_map(torch.ones_like, position),
        pos_mean=_map(torch.zeros_like, position),
        pos_m2=_map(torch.zeros_like, position),
        n_var=full(0.0),
    )


def _grad(logp_fn: Callable, q: dict) -> dict:
    with torch.enable_grad():
        qq = {k: v.detach().requires_grad_(True) for k, v in q.items()}
        # chains are independent: the gradient of their sum is each chain's own
        grads = torch.autograd.grad(logp_fn(qq).sum(), list(qq.values()), materialize_grads=True)
    return dict(zip(qq, grads))


@torch.no_grad()
def _leapfrog(logp_fn, q, p, eps, scale, n_steps):
    """n_steps preconditioned leapfrog steps; returns (q', p', logp(q'))."""

    def half_kick(p, g):
        return _map(lambda p_, s_, g_: p_ + 0.5 * _per_chain(eps, p_) * s_ * g_, p, scale, g)

    for _ in range(n_steps):
        p = half_kick(p, _grad(logp_fn, q))
        q = _map(lambda q_, s_, p_: q_ + _per_chain(eps, q_) * s_ * p_, q, scale, p)
        p = half_kick(p, _grad(logp_fn, q))
    return q, p, logp_fn(q)


def _kinetic(p: dict, n_lead: int) -> torch.Tensor:
    """½ Σ p², summed within each of the chains on the ``n_lead`` leading axes."""
    return 0.5 * sum((x * x).reshape(x.shape[:n_lead] + (-1,)).sum(-1) for x in p.values())


@torch.no_grad()
def _hmc_transition(logp_fn, q_curr, log_prob_curr, step_size, n_steps, scale, p0, u):
    """One HMC transition from momentum ``p0`` with acceptance uniform ``u``.

    Returns (q_new, log_prob_new, accept_prob).
    """
    q_new, p_new, lp_new = _leapfrog(logp_fn, q_curr, p0, step_size, scale, n_steps)
    n_lead = log_prob_curr.ndim
    h0 = -log_prob_curr + _kinetic(p0, n_lead)
    h1 = -lp_new + _kinetic(p_new, n_lead)
    log_accept = torch.clamp(h0 - h1, max=0.0)
    # Guard NaN trajectories (divergences): always reject.
    log_accept = torch.where(torch.isfinite(log_accept), log_accept, -torch.inf)
    accept_prob = torch.exp(log_accept)
    take = u < accept_prob
    q_out = _map(lambda a, b: torch.where(_per_chain(take, a), a, b), q_new, q_curr)
    lp_out = torch.where(take, lp_new, log_prob_curr)
    return q_out, lp_out, accept_prob


def hmc(
    generator: torch.Generator,
    logp_fn: Callable,
    q_curr: dict,
    log_prob_curr,
    step_size,
    n_steps: int = 10,
    scale: dict | None = None,
):
    """One HMC transition.

    Args:
      generator: draws the momentum (one normal per coordinate, leaves in
        sorted key order) and then the acceptance uniform; for C chains
        (``log_prob_curr`` of shape (C,)), a list of C generators.
      logp_fn: log-density over the position dict.
      q_curr / log_prob_curr: current position and cached log-density.
      step_size: leapfrog step size (float or 0-d tensor).
      n_steps: number of leapfrog steps.
      scale: optional per-coordinate scale dict (diagonal preconditioner).

    Returns:
      (q_new, log_prob_new, accept_prob)
    """
    if scale is None:
        scale = _map(torch.ones_like, q_curr)
    lp = torch.as_tensor(log_prob_curr)
    n_lead = lp.ndim

    def normal(x):
        return lambda g: torch.randn(x.shape[n_lead:], generator=g, dtype=x.dtype, device=g.device)

    p0 = {k: draw(generator, normal(q_curr[k])).to(q_curr[k].device) for k in sorted(q_curr)}
    p0 = {k: p0[k] for k in q_curr}
    u = draw(generator, lambda g: torch.rand((), generator=g, dtype=lp.dtype, device=g.device)).to(lp.device)
    return _hmc_transition(logp_fn, q_curr, lp, step_size, n_steps, scale, p0, u)


@torch.no_grad()
def hmc_adaptive_step(
    generator: torch.Generator,
    logp_fn: Callable,
    state: HMCState,
    n_steps: int = 10,
    target_accept: float = 0.9,
    adapt: bool = True,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> HMCState:
    """HMC transition + dual-averaging ε + Welford statistics collection.

    While ``adapt`` is true ε follows dual averaging and the position stream
    updates the Welford mean/variance per coordinate. The statistics are
    only collected here; the scale is applied between warmup windows by
    :func:`apply_mass_matrix` / :func:`reset_variance`.
    """
    scale = state.scale if state.scale is not None else _map(torch.ones_like, state.position)
    q, lp, acc = hmc(
        generator, logp_fn, state.position, state.log_prob, state.step_size, n_steps, scale
    )
    rate = 0.99 * state.accept_rate + 0.01 * acc
    if not adapt:
        eps = torch.exp(state.log_eps_avg)
        return state._replace(position=q, log_prob=lp, step_size=eps, accept_rate=rate, scale=scale)

    t = state.t + 1.0
    w = 1.0 / (t + t0)
    h_avg = (1.0 - w) * state.h_avg + w * (target_accept - acc)
    log_eps = state.mu - torch.sqrt(t) / gamma * h_avg
    eta = t ** (-kappa)
    log_eps_avg = eta * log_eps + (1.0 - eta) * state.log_eps_avg

    # --- Welford variance of the position stream. Residuals are winsorized
    # at 6 running-σ: coordinates that occasionally jump between a tight
    # conditional and their prior would otherwise inflate the scale.
    n_var = state.n_var + 1.0
    nv = torch.clamp(n_var, min=1.0)

    def winsorize(x, m, m2):
        n = _per_chain(nv, x)
        std = torch.sqrt(m2 / torch.clamp(n - 1.0, min=1.0))
        lim = 6.0 * torch.clamp(std, min=1e-8)
        r = x - m
        r = torch.where(n > 10.0, torch.clamp(r, -lim, lim), r)
        return m + r

    q_w = _map(winsorize, q, state.pos_mean, state.pos_m2)
    mean_new = _map(lambda m, x: m + (x - m) / _per_chain(nv, x), state.pos_mean, q_w)
    m2_new = _map(lambda m2, m_old, m_new, x: m2 + (x - m_old) * (x - m_new),
                  state.pos_m2, state.pos_mean, mean_new, q_w)
    return HMCState(
        q, lp, torch.exp(log_eps), log_eps_avg, h_avg, t, rate, state.mu,
        scale, mean_new, m2_new, n_var,
    )


def reset_variance(state: HMCState) -> HMCState:
    """Zero the Welford statistics (start of a clean variance window)."""
    return state._replace(
        pos_mean=_map(torch.zeros_like, state.position),
        pos_m2=_map(torch.zeros_like, state.position),
        n_var=torch.zeros_like(state.n_var),
    )


def apply_mass_matrix(
    state: HMCState, scale_floor: float = 1e-4, eps_restart: float = 0.1
) -> HMCState:
    """Set the leapfrog scale from the collected window variance and restart
    dual averaging at ``eps_restart`` (in the rescaled space every direction
    is ~unit variance, so the natural ε is O(0.1)). Regularizes the variance
    toward a small floor when the window is short."""
    n = torch.clamp(state.n_var, min=1.0)

    def mk(m2):
        nn = _per_chain(n, m2)
        w = nn / (nn + 5.0)
        var = m2 / torch.clamp(nn - 1.0, min=1.0)
        var = w * var + (1.0 - w) * 1e-3  # shrink toward a small floor scale
        return torch.sqrt(torch.clamp(var, min=scale_floor**2))

    eps = torch.full_like(state.step_size, eps_restart)
    return state._replace(
        scale=_map(mk, state.pos_m2),
        step_size=eps,
        mu=torch.log(10.0 * eps),
        log_eps_avg=torch.log(eps),
        h_avg=torch.zeros_like(state.h_avg),
        t=torch.zeros_like(state.t),
    )
