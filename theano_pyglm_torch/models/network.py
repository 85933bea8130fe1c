"""Network component — graph (adjacency) and weight priors.

Port of :mod:`theano_pyglm_tpu.models.network`. The network contributes the
effective coupling matrix G = A ∘ W used by the impulse component, plus
log-priors over the binary adjacency A, the real weights W and any latent
variables of the graph prior.

Orientation convention: **A[n, m] is the edge m → n** (row = postsynaptic,
column = presynaptic), matching the (N_post, N_pre, B) impulse weights.

Graph priors:
  'complete'     A ≡ 1, no latents.
  'erdos_renyi'  A[n,m] ~ Bern(ρ); ρ fixed, or Beta(a,b)-distributed when
                 spec['infer_rho'] is true.
  'sbm'          y_n ~ Cat(π), π ~ Dir(α0·1_K), B[k,k'] ~ Beta(b0,b1) iid,
                 A[n,m] ~ Bern(B[y_n, y_m]).
  'distance'     ℓ_n ~ N(0, σ_ℓ² I_D); A[n,m] ~ Bern(σ(η0 − ‖ℓ_n−ℓ_m‖²/τ²)).

Weight priors:
  'constant'     W ≡ value (default 1), no parameters.
  'gaussian'     W[n,m] ~ N(μ, σ²), with a distinct diagonal (refractory
                 self-coupling) mean/scale μ_self, σ_self, and an optional
                 Normal–Inverse-Gamma hyperprior on the off-diagonal (μ, σ²).

Samplers draw on the generator's device in the dtype they are given; the SBM
types ``y`` are int64. ``log_prior``, ``edge_prob``, ``effective_W`` and
``prior_mu_sigma`` also take params with a leading chain axis (A (C, N, N),
every latent (C, ...)) and then give one value, or one (N, N) matrix, per
chain (``prior_mu_sigma`` broadcasts: it stays (N, N) where it does not
depend on the params).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from theano_pyglm_torch.ops.distributions import (
    bernoulli_logpmf,
    beta_logpdf,
    categorical_logpmf,
    dirichlet_logpdf,
    gaussian_logpdf,
    sample_bernoulli,
    sample_beta,
    sample_categorical,
    sample_dirichlet,
    sample_gamma,
    sample_gaussian,
)

__all__ = ["GraphComponent", "WeightComponent", "make_graph", "make_weights"]


class GraphComponent(NamedTuple):
    name: str
    sample: Callable  # (generator, dtype) -> dict of param leaves (incl. 'A')
    log_prior: Callable  # params -> scalar (latents + A | latents)
    edge_prob: Callable  # params -> (N, N) p(A=1 | latents)
    fixed_A: bool  # True ⇒ A is deterministically all-ones
    continuous_keys: tuple  # latent leaves HMC may update
    discrete_keys: tuple  # latent leaves Gibbs updates (besides 'A')


class WeightComponent(NamedTuple):
    name: str
    sample: Callable  # (generator, dtype) -> dict of param leaves
    log_prior: Callable  # params -> scalar
    effective_W: Callable  # params -> (N, N)
    prior_mu_sigma: Callable  # params -> ((N,N) mu, (N,N) sigma), or None if constant
    has_W: bool


def _zero(params):
    """A zero log-prior, one per chain: A is (N, N) or (C, N, N)."""
    A = params["A"]
    return torch.zeros(A.shape[:-2], dtype=A.dtype, device=A.device)


def _sum_nn(x):
    """Sum over the trailing (N, N) axes: a scalar, or one value per chain."""
    return x.sum((-2, -1))


# --- graph priors ---------------------------------------------------------


def make_graph(spec: dict, N: int) -> GraphComponent:
    typ = spec.get("type", "complete")

    if typ == "complete":

        def sample(generator, dtype):
            return {"A": torch.ones((N, N), dtype=dtype, device=generator.device)}

        def edge_prob(params):
            return torch.ones_like(params["A"])

        return GraphComponent("complete", sample, _zero, edge_prob, True, (), ())

    if typ == "erdos_renyi":
        rho0 = float(spec.get("rho", 0.2))
        infer_rho = bool(spec.get("infer_rho", False))
        a0, b0 = [float(v) for v in spec.get("rho_prior", (1.0, 1.0))]

        def sample(generator, dtype):
            if infer_rho:
                rho = sample_beta(generator, a0, b0, dtype=dtype)
            else:
                rho = torch.tensor(rho0, dtype=dtype, device=generator.device)
            out = {"A": sample_bernoulli(generator, rho, (N, N), dtype)}
            if infer_rho:
                out["rho"] = rho
            return out

        def edge_prob(params):
            if infer_rho:
                rho = params["rho"]
                return rho[..., None, None].expand(*rho.shape, N, N)
            return torch.full_like(params["A"], rho0)

        def log_prior(params):
            lp = _sum_nn(bernoulli_logpmf(params["A"], edge_prob(params)))
            if infer_rho:
                lp = lp + beta_logpdf(params["rho"], a0, b0)
            return lp

        return GraphComponent("erdos_renyi", sample, log_prior, edge_prob, False, (), ())

    if typ == "sbm":
        K = int(spec.get("K", 2))
        alpha0 = float(spec.get("alpha0", 1.0))
        b0, b1 = [float(v) for v in spec.get("B_prior", (1.0, 1.0))]

        def sample(generator, dtype):
            pi = sample_dirichlet(generator, alpha0 * torch.ones(K), dtype)
            y = sample_categorical(generator, torch.log(pi), (N,))
            Bm = sample_beta(generator, b0, b1, (K, K), dtype)
            A = sample_bernoulli(generator, Bm[y[:, None], y[None, :]])
            return {"A": A, "y": y, "pi": pi, "Bm": Bm}

        def edge_prob(params):
            # B[y_n, y_m] of each chain, gathered from the flattened K × K blocks
            y, Bm = params["y"], params["Bm"]
            idx = y[..., :, None] * K + y[..., None, :]
            return torch.gather(Bm.flatten(-2), -1, idx.flatten(-2)).view(idx.shape)

        def log_prior(params):
            pi, y, Bm = params["pi"], params["y"], params["Bm"]
            lp = dirichlet_logpdf(pi, alpha0 * torch.ones(K, dtype=pi.dtype, device=pi.device))
            lp = lp + categorical_logpmf(y, torch.log(pi).unsqueeze(-2).expand(*y.shape, K)).sum(-1)
            lp = lp + _sum_nn(beta_logpdf(Bm, b0, b1))
            lp = lp + _sum_nn(bernoulli_logpmf(params["A"], edge_prob(params)))
            return lp

        return GraphComponent("sbm", sample, log_prior, edge_prob, False, (), ("y",))

    if typ == "distance":
        D = int(spec.get("D", 2))
        sigma_l = float(spec.get("sigma_l", 1.0))
        tau = float(spec.get("tau", 1.0))
        eta0 = float(spec.get("eta0", 0.0))

        def _logits(locs):
            d2 = ((locs[..., :, None, :] - locs[..., None, :, :]) ** 2).sum(-1)
            return eta0 - d2 / (tau * tau)

        def sample(generator, dtype):
            locs = sample_gaussian(generator, 0.0, sigma_l, (N, D), dtype)
            A = sample_bernoulli(generator, torch.sigmoid(_logits(locs)))
            return {"A": A, "locs": locs}

        def edge_prob(params):
            return torch.sigmoid(_logits(params["locs"]))

        def log_prior(params):
            lp = _sum_nn(gaussian_logpdf(params["locs"], 0.0, sigma_l))
            lp = lp + _sum_nn(bernoulli_logpmf(params["A"], edge_prob(params)))
            return lp

        return GraphComponent("distance", sample, log_prior, edge_prob, False, ("locs",), ())

    raise ValueError(f"unknown graph type {typ!r}")


# --- weight priors --------------------------------------------------------


def make_weights(spec: dict, N: int) -> WeightComponent:
    typ = spec.get("type", "constant")

    if typ == "constant":
        value = float(spec.get("value", 1.0))

        def effective_W(params):
            return torch.full_like(params["A"], value)

        return WeightComponent(
            "constant", lambda generator, dtype: {}, _zero, effective_W, lambda params: None, False
        )

    if typ == "gaussian":
        mu = float(spec.get("mu", 0.0))
        sigma = float(spec.get("sigma", 1.0))
        mu_self = float(spec.get("mu_self", spec.get("mu_refractory", mu)))
        sigma_self = float(spec.get("sigma_self", spec.get("sigma_refractory", sigma)))
        infer_hypers = bool(spec.get("infer_hypers", False))
        # Normal–Inverse-Gamma hyperprior on the off-diagonal (μ_W, σ_W²):
        # μ_W | σ² ~ N(m0, σ²/k0), σ² ~ InvGamma(a0, b0).
        m0, k0 = float(spec.get("m0", 0.0)), float(spec.get("k0", 1.0))
        a0, b0 = float(spec.get("a0", 2.0)), float(spec.get("b0", 2.0))

        def mu_sig(params, dtype=None, device=None):
            ref = params.get("W", params.get("W_sigma"))
            dtype = dtype or ref.dtype
            device = device or ref.device
            eye = torch.eye(N, dtype=dtype, device=device)
            mu_od = params.get("W_mu", mu) if infer_hypers else mu
            sig_od = params.get("W_sigma", sigma) if infer_hypers else sigma
            if isinstance(mu_od, torch.Tensor):  # one value per chain, or a scalar
                mu_od, sig_od = mu_od[..., None, None], sig_od[..., None, None]
            MU = mu_od * (1 - eye) + mu_self * eye
            SIG = sig_od * (1 - eye) + sigma_self * eye
            return MU, SIG

        def sample(generator, dtype):
            out = {}
            if infer_hypers:
                var = b0 / sample_gamma(generator, a0, 1.0, dtype=dtype)  # InvGamma(a0, b0)
                out["W_sigma"] = torch.sqrt(var)
                out["W_mu"] = m0 + torch.sqrt(var / k0) * sample_gaussian(generator, 0.0, 1.0, (), dtype)
            MU, SIG = mu_sig(out, dtype, generator.device)
            out["W"] = MU + SIG * sample_gaussian(generator, 0.0, 1.0, (N, N), dtype)
            return out

        def log_prior(params):
            MU, SIG = mu_sig(params)
            lp = _sum_nn(gaussian_logpdf(params["W"], MU, SIG))
            if infer_hypers:
                var = params["W_sigma"] ** 2
                # InvGamma(a0,b0) density in σ² plus N(m0, σ²/k0) on μ
                lp = lp + (-(a0 + 1.0) * torch.log(var) - b0 / var)
                lp = lp + gaussian_logpdf(params["W_mu"], m0, params["W_sigma"] / k0**0.5)
            return lp

        def effective_W(params):
            return params["W"]

        return WeightComponent("gaussian", sample, log_prior, effective_W, mu_sig, True)

    raise ValueError(f"unknown weight type {typ!r}")
