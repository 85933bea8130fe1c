"""Model components — port of :mod:`theano_pyglm_tpu.models.components`.

Each component is a record of functions over a shared params dict:

  sample(generator, dtype) -> dict of this component's parameter leaves
  log_prior(params)        -> scalar log p(component params)
  current(params, data)    -> (T, N) additive current for every neuron

``log_prior`` and ``current`` also take params with a leading chain axis
(every leaf (C, ...), as the sampler's batched state holds them): they then
give (C,) and (C, T, N), chain by chain what they give for one chain (the
JAX package's ``vmap`` over chains, written out).

Draws happen on the generator's device; the population moves them to its
own. The population sums currents, applies the nonlinearity and adds the
observation log-likelihood (models/population.py).

Component catalog (as in the JAX package):
  bias:    'constant'
  bkgd:    'none' | 'basis' | 'shared' | 'spatiotemporal'
  impulse: 'basis' | 'normalized'  (normalized: softmax of logits, so every
           coupling filter has unit area and W carries the magnitude, with a
           logistic-normal prior on the logits)
  nlin:    'exp' | 'softplus'
  observation: 'poisson' | 'bernoulli'
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from theano_pyglm_torch.ops.clipping import clip_exponent, exp_clipped
from theano_pyglm_torch.ops.distributions import gaussian_logpdf, sample_gaussian
from theano_pyglm_torch.utils.dtypes import bf16_rounded

__all__ = [
    "CurrentComponent",
    "combined_weights",
    "make_bias",
    "make_bkgd",
    "make_impulse",
    "make_nlin",
    "make_observation",
]


class CurrentComponent(NamedTuple):
    name: str
    sample: Callable  # (generator, dtype) -> dict of param leaves
    log_prior: Callable  # (params) -> scalar
    current: Callable  # (params, data) -> (T, N)
    effective: Callable = None  # impulse only: params -> (N, N, B) filter weights


def _hyper(value):
    """A hyperparameter as ``ref -> value``: a number stays a number; a list
    (e.g. per-basis-column means) becomes a tensor once per device and dtype,
    not once per evaluation."""
    if not isinstance(value, (list, tuple)):
        return lambda ref: float(value)
    cache = {}

    def get(ref):
        key = (ref.device, ref.dtype)
        if key not in cache:
            cache[key] = torch.as_tensor(value, dtype=ref.dtype, device=ref.device)
        return cache[key]

    return get


def _zero_current(params, data):
    return torch.zeros_like(data["S"])


def _zero(params):
    """A zero log-prior, one per chain: A is (N, N) or (C, N, N)."""
    A = params["A"]
    return torch.zeros(A.shape[:-2], dtype=A.dtype, device=A.device)


# --- bias -----------------------------------------------------------------


def make_bias(spec: dict, N: int) -> CurrentComponent:
    """Constant bias current per neuron, Gaussian prior."""
    mu, sigma = float(spec.get("mu", 2.0)), float(spec.get("sigma", 1.0))

    def sample(generator, dtype):
        return {"bias": sample_gaussian(generator, mu, sigma, (N,), dtype)}

    def log_prior(params):
        return gaussian_logpdf(params["bias"], mu, sigma).sum(-1)

    def current(params, data):
        b = params["bias"]
        return b.unsqueeze(-2).expand(*b.shape[:-1], *data["S"].shape)

    return CurrentComponent("bias", sample, log_prior, current)


# --- background / stimulus ------------------------------------------------


# Per-neuron gain prior of the shared-tuning background, N(mu, sd) — the
# values of the JAX package.
GAIN_PRIOR_MU = 1.0
GAIN_PRIOR_SD = 0.3


def make_bkgd(spec: dict, N: int, B_stim: int, D_stim: int) -> CurrentComponent:
    """Stimulus-driven current.

    'none':  no stimulus term.
    'basis': per-neuron weights over the (stim-dim × temporal-basis) design
             X_stim (T, D·B); I = X_stim @ w_stim.T.
    'shared': one population-level filter w_stim_shared (D·B,) scaled by a
             per-neuron gain (N,).
    'spatiotemporal': separable low-rank receptive field, spatial weights
             w_stim_s (N, D) and temporal weights w_stim_t (N, B) contract
             the (T, D, B) design X_st.
    """
    typ = spec.get("type", "none")
    mu, sigma = float(spec.get("mu", 0.0)), float(spec.get("sigma", 1.0))

    if typ == "none":
        return CurrentComponent("bkgd", lambda generator, dtype: {}, _zero, _zero_current)

    if typ == "basis":
        DB = D_stim * B_stim

        def sample(generator, dtype):
            return {"w_stim": sample_gaussian(generator, mu, sigma, (N, DB), dtype)}

        def log_prior(params):
            return gaussian_logpdf(params["w_stim"], mu, sigma).sum((-2, -1))

        def current(params, data):
            return data["X_stim"] @ params["w_stim"].transpose(-1, -2)  # (T,DB)@([C,]DB,N)

        return CurrentComponent("bkgd", sample, log_prior, current)

    if typ == "shared":
        DB = D_stim * B_stim

        def sample(generator, dtype):
            return {
                "w_stim_shared": sample_gaussian(generator, mu, sigma, (DB,), dtype),
                "gain": sample_gaussian(generator, GAIN_PRIOR_MU, GAIN_PRIOR_SD, (N,), dtype),
            }

        def log_prior(params):
            return gaussian_logpdf(params["w_stim_shared"], mu, sigma).sum(-1) + gaussian_logpdf(
                params["gain"], GAIN_PRIOR_MU, GAIN_PRIOR_SD
            ).sum(-1)

        def current(params, data):
            drive = params["w_stim_shared"] @ data["X_stim"].T  # ([C,] T)
            return drive.unsqueeze(-1) * params["gain"].unsqueeze(-2)

        return CurrentComponent("bkgd", sample, log_prior, current)

    if typ == "spatiotemporal":

        def sample(generator, dtype):
            return {
                "w_stim_s": sample_gaussian(generator, mu, sigma, (N, D_stim), dtype),
                "w_stim_t": sample_gaussian(generator, mu, sigma, (N, B_stim), dtype),
            }

        def log_prior(params):
            return gaussian_logpdf(params["w_stim_s"], mu, sigma).sum((-2, -1)) + gaussian_logpdf(
                params["w_stim_t"], mu, sigma
            ).sum((-2, -1))

        def current(params, data):
            return torch.einsum(
                "tdb,...nd,...nb->...tn", data["X_st"], params["w_stim_s"], params["w_stim_t"]
            )

        return CurrentComponent("bkgd", sample, log_prior, current)

    raise ValueError(f"unknown bkgd type {typ!r}")


# --- impulse (spike-history / coupling filters) ---------------------------


def combined_weights(w_eff: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """U = (G ∘ w_eff) laid out as (N_pre·B, N_post), so that the coupling
    current is one matmul of the flattened (T, N_pre·B) design with U.

    U[p·B + b, n] = G[n, p] · w_eff[n, p, b] — the operand of the fused
    Poisson log-likelihood kernels (ops/kernels.py). With a leading chain
    axis, (C, N_pre·B, N_post). Rows of G and w_eff give those
    postsynaptic neurons' columns (the neuron-sharded likelihood).
    """
    n_post = G.shape[-2]
    return (w_eff * G[..., None]).movedim(-3, -1).reshape(*G.shape[:-2], -1, n_post)


def make_impulse(spec: dict, N: int, B_imp: int) -> CurrentComponent:
    """Coupling/spike-history filters.

    Parameter ``w_ir`` has shape (N_post, N_pre, B). The coupling current
    into postsynaptic neuron n is

        I_net[t, n] = Σ_pre G[n, pre] · (X_imp[t, pre, :] · w_eff[n, pre, :])

    where G = A∘W comes from the network component (the population supplies
    it as ``data['_G']``) and X_imp (T, N, B) is the presynaptic design. A
    bfloat16 X_imp meets w_eff and G each rounded to bfloat16.

    'basis':      w_eff = w_ir, iid Gaussian prior.
    'normalized': w_eff = softmax(w_ir, axis=-1), a unit-sum filter.
    """
    typ = spec.get("type", "basis")
    # mu may be scalar or per-basis-column (length-B list)
    mu, sigma = spec.get("mu", 0.0), spec.get("sigma", 1.0)
    mu_of, sigma_of = _hyper(mu), _hyper(sigma)

    def sample(generator, dtype):
        return {"w_ir": sample_gaussian(generator, mu, sigma, (N, N, B_imp), dtype)}

    def log_prior(params):
        w = params["w_ir"]
        return gaussian_logpdf(w, mu_of(w), sigma_of(w)).sum((-3, -2, -1))

    if typ == "basis":

        def effective(params):
            return params["w_ir"]

    elif typ == "normalized":

        def effective(params):
            return torch.softmax(params["w_ir"], dim=-1)

    else:
        raise ValueError(f"unknown impulse type {typ!r}")

    def current(params, data):
        X = data["X_imp"]
        w_eff, G = effective(params), data["_G"]
        U = combined_weights(w_eff, G)
        if X.dtype == torch.bfloat16:
            # the JAX package's bf16 branch: w_eff and G rounded to bf16
            # apart, their product (exact in float32) against the widened
            # design, accumulated in the parameters' dtype
            U_x = combined_weights(bf16_rounded(w_eff), bf16_rounded(G))
            I = X.reshape(X.shape[0], -1).to(U.dtype) @ U_x
        else:
            I = X.reshape(X.shape[0], -1) @ U
        mean = data.get("_X_imp_mean")
        if mean is not None:
            # the centered-out column means re-enter as a constant current
            # (unrounded weights, as in JAX)
            I = I + (mean.reshape(-1) @ U).unsqueeze(-2)
        return I

    return CurrentComponent("impulse", sample, log_prior, current, effective)


# --- nonlinearity ---------------------------------------------------------


class Nonlinearity(NamedTuple):
    name: str
    rate: Callable  # I -> λ  (spikes/s)
    log_rate: Callable  # I -> log λ  (stable form for the Poisson LL)


def make_nlin(spec: dict) -> Nonlinearity:
    """Rate nonlinearity: 'exp' (clipped, ops/clipping.py: log λ is the same
    clip(I) as λ) or 'softplus' / 'explinear' (log(1+e^x))."""
    typ = spec.get("type", "exp")
    if typ == "exp":
        return Nonlinearity("exp", exp_clipped, clip_exponent)
    if typ in ("softplus", "explinear"):

        def log_rate(I):
            return torch.log(torch.clamp(F.softplus(I), min=1e-30))

        return Nonlinearity("softplus", F.softplus, log_rate)
    raise ValueError(f"unknown nlin type {typ!r}")


# --- observation model ----------------------------------------------------


class Observation(NamedTuple):
    name: str
    log_likelihood: Callable  # (S, I, nlin, dt) -> (T, N) per-bin LL
    sample: Callable  # (generator, rate, dt) -> spike counts, same shape as rate


def make_observation(spec: dict) -> Observation:
    """Per-bin spike likelihood.

    Poisson:   S_t ~ Poisson(λ_t·dt);  LL = S·log(λdt) − λdt − log S!
    Bernoulli: S_t ∈ {0,1} = 1{≥1 spike}; p = 1 − exp(−λ·dt);
               LL = S·log(p) + (1−S)·(−λ·dt).
    Samples are drawn with the generator, which must live on rate's device.
    """
    typ = spec.get("type", "poisson")
    if typ == "poisson":

        def ll(S, I, nlin, dt):
            return S * (nlin.log_rate(I) + math.log(dt)) - nlin.rate(I) * dt - torch.lgamma(S + 1.0)

        def sample(generator, rate, dt):
            return torch.poisson(rate * dt, generator=generator)

        return Observation("poisson", ll, sample)

    if typ == "bernoulli":

        def ll(S, I, nlin, dt):
            lam_dt = nlin.rate(I) * dt
            log_p = torch.log(-torch.expm1(-torch.clamp(lam_dt, min=1e-10)))
            return S * log_p + (1.0 - S) * (-lam_dt)

        def sample(generator, rate, dt):
            return torch.bernoulli(-torch.expm1(-rate * dt), generator=generator)

        return Observation("bernoulli", ll, sample)

    raise ValueError(f"unknown observation type {typ!r}")
