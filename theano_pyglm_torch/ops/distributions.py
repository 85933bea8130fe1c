"""Log-densities and samplers for the prior/conjugate machinery.

Port of :mod:`theano_pyglm_tpu.ops.distributions`. The log-densities are
written directly in torch (``gammaln`` → ``torch.lgamma``, ``xlogy`` →
``torch.special.xlogy``) so the same expressions run in float32 on the GPU
and in float64 for the CPU verification mode. Hyperparameters may be Python
numbers or tensors on the argument's device.

Every sampler takes a ``torch.Generator`` and draws on that generator's
device. ``dtype`` defaults to :func:`~theano_pyglm_torch.utils.dtypes.default_float`.
:func:`draw` makes one draw for each of several chains, each from its own
generator.
"""

from __future__ import annotations

import math

import torch

from theano_pyglm_torch.utils.dtypes import default_float

__all__ = [
    "gaussian_logpdf",
    "gamma_logpdf",
    "beta_logpdf",
    "dirichlet_logpdf",
    "bernoulli_logpmf",
    "categorical_logpmf",
    "poisson_logpmf",
    "sample_gaussian",
    "sample_gamma",
    "sample_beta",
    "sample_dirichlet",
    "sample_bernoulli",
    "sample_categorical",
    "draw",
]

_LOG2PI = 1.8378770664093453

# Scalar hyperparameters stay Python numbers: turning one into a CUDA tensor
# on every evaluation would be a host-to-device copy that waits for the
# stream, once per density term.


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


def _lgamma(v):
    return torch.lgamma(v) if isinstance(v, torch.Tensor) else math.lgamma(v)


def _xlogy(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.special.xlogy(a, b)
    return a * math.log(b) if a != 0 else 0.0


def gaussian_logpdf(x, mu, sigma):
    """Elementwise N(x | mu, sigma²) log-density."""
    z = (x - mu) / sigma
    return -0.5 * (z * z + _LOG2PI) - _log(sigma)


def gamma_logpdf(x, alpha, beta):
    """Gamma(shape=alpha, rate=beta) log-density."""
    return _xlogy(alpha, beta) - _lgamma(alpha) + _xlogy(alpha - 1.0, x) - beta * x


def beta_logpdf(x, a, b):
    return (
        _lgamma(a + b)
        - _lgamma(a)
        - _lgamma(b)
        + _xlogy(a - 1.0, x)
        + _xlogy(b - 1.0, 1.0 - x)
    )


def dirichlet_logpdf(x, alpha):
    """Dirichlet log-density; x, alpha: (..., K), reduces over the last axis."""
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    return (
        torch.lgamma(alpha.sum(-1))
        - torch.lgamma(alpha).sum(-1)
        + torch.special.xlogy(alpha - 1.0, x).sum(-1)
    )


def bernoulli_logpmf(k, p):
    """Numerically-safe Bernoulli log-pmf (p may hit 0/1 under hard priors)."""
    if isinstance(p, torch.Tensor):
        p = torch.clamp(p, 1e-12, 1.0 - 1e-12)
    else:
        p = min(max(p, 1e-12), 1.0 - 1e-12)
    return torch.special.xlogy(k, p) + torch.special.xlogy(1.0 - k, 1.0 - p)


def categorical_logpmf(k, log_pi):
    """k: int tensor (...,); log_pi: (..., K) normalized log-probabilities."""
    return torch.gather(log_pi, -1, k[..., None].long())[..., 0]


def poisson_logpmf(k, rate):
    """Poisson log-pmf for counts k with mean ``rate`` (= λ·dt in the GLM)."""
    return torch.special.xlogy(k, rate) - rate - torch.lgamma(k + 1.0)


# --- samplers -------------------------------------------------------------


def _param(v, generator: torch.Generator, dtype) -> torch.Tensor:
    """``v`` on the generator's device; a floating tensor keeps its dtype
    unless one is given."""
    if dtype is None:
        floating = isinstance(v, torch.Tensor) and v.is_floating_point()
        dtype = v.dtype if floating else default_float()
    if isinstance(v, (int, float)):
        # a fill, not a host-to-device copy that would wait for the stream
        return torch.full((), float(v), dtype=dtype, device=generator.device)
    return torch.as_tensor(v, dtype=dtype, device=generator.device)


def sample_gaussian(generator, mu, sigma, shape=None, dtype=None):
    mu, sigma = _param(mu, generator, dtype), _param(sigma, generator, dtype)
    if shape is None:
        shape = torch.broadcast_shapes(mu.shape, sigma.shape)
    z = torch.randn(shape, generator=generator, dtype=mu.dtype, device=mu.device)
    return mu + sigma * z


def sample_gamma(generator, alpha, beta, shape=None, dtype=None):
    """Gamma(shape=alpha, rate=beta) draws."""
    alpha, beta = _param(alpha, generator, dtype), _param(beta, generator, dtype)
    if shape is not None:
        alpha = alpha.expand(shape)
    return torch._standard_gamma(alpha.contiguous(), generator=generator) / beta


def sample_beta(generator, a, b, shape=None, dtype=None):
    a, b = _param(a, generator, dtype), _param(b, generator, dtype)
    if shape is None:
        shape = torch.broadcast_shapes(a.shape, b.shape)
    ga = sample_gamma(generator, a, 1.0, shape, a.dtype)
    gb = sample_gamma(generator, b, 1.0, shape, a.dtype)
    return ga / (ga + gb)


def sample_dirichlet(generator, alpha, dtype=None):
    g = sample_gamma(generator, alpha, 1.0, dtype=dtype)
    return g / g.sum(-1, keepdim=True)


def sample_bernoulli(generator, p, shape=None, dtype=None):
    p = _param(p, generator, dtype)
    if shape is not None:
        p = p.expand(shape)
    return torch.bernoulli(p.contiguous(), generator=generator)


def sample_categorical(generator, log_pi, shape=()):
    """Integer draws from Cat(softmax(log_pi)) with the given batch shape."""
    log_pi = torch.as_tensor(log_pi, device=generator.device)
    probs = torch.softmax(log_pi.to(torch.float64), -1)
    n = 1
    for s in shape:
        n *= int(s)
    draws = torch.multinomial(probs, n, replacement=True, generator=generator)
    return draws.reshape(tuple(shape))


def draw(generator, fn, *args):
    """``fn(generator, *args)`` for one generator. For a sequence of C
    generators, one per chain: ``fn(generators[c], *(a[c] for a in args))``
    for each chain c in turn, stacked on a leading chain axis, so each
    chain's generator makes the draws a one-chain call would make, in the
    same order. ``args`` carry the chain axis first when there are chains.
    It costs C draws, one per chain, where one chain costs one (and, for
    C = 1, no copy: the draw gains the axis as a view)."""
    if isinstance(generator, torch.Generator):
        return fn(generator, *args)
    if len(generator) == 1:
        return fn(generator[0], *(a[0] for a in args))[None]
    return torch.stack([fn(g, *(a[c] for a in args)) for c, g in enumerate(generator)])
