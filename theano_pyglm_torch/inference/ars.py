"""Adaptive rejection sampling — port of :mod:`theano_pyglm_tpu.inference.ars`.

Gilks & Wild (1992) tangent-based ARS for log-concave 1-D densities, a
numpy copy of the JAX package's. It backs :func:`update_bias_ars`, an exact
Gibbs draw of each neuron's bias from its full conditional (log-concave for
the exp-Poisson GLM). It is host code by design, as in the JAX package: the
algorithm is sequential and data-dependent (hull refinement). One pass
copies the currents' per-neuron sums to the host once and the new biases
back once.
"""

from __future__ import annotations

import numpy as np
import torch

from theano_pyglm_torch.ops.clipping import clip_exponent

__all__ = ["adaptive_rejection_sample", "update_bias_ars"]


def adaptive_rejection_sample(
    h,
    h_prime,
    x_init,
    domain=(-np.inf, np.inf),
    rng: np.random.RandomState | None = None,
    max_points: int = 50,
    max_iter: int = 500,
):
    """Draw one sample from the log-concave density ∝ exp(h(x)).

    Args:
      h, h_prime: log-density and its derivative (callables on floats).
      x_init: sequence of ≥2 starting abscissae. For an unbounded domain they
        must bracket the mode (h'(x_0) > 0 > h'(x_last)); a ValueError is
        raised otherwise.
      domain: (lower, upper) support bounds (may be infinite).
    """
    rng = rng or np.random.RandomState()
    lo, hi = domain
    xs = sorted(float(x) for x in x_init)
    hs = [float(h(x)) for x in xs]
    dhs = [float(h_prime(x)) for x in xs]

    if not np.isfinite(lo) and dhs[0] <= 0:
        raise ValueError("leftmost abscissa must have h' > 0 on unbounded-left domain")
    if not np.isfinite(hi) and dhs[-1] >= 0:
        raise ValueError("rightmost abscissa must have h' < 0 on unbounded-right domain")

    def hull():
        """Abscissae zs of the piecewise-linear upper hull's breaks (the
        tangents at xs), the domain bounds included."""
        zs = [lo]
        for i in range(len(xs) - 1):
            d = dhs[i] - dhs[i + 1]
            if abs(d) < 1e-12:
                z = 0.5 * (xs[i] + xs[i + 1])
            else:
                z = (hs[i + 1] - hs[i] - xs[i + 1] * dhs[i + 1] + xs[i] * dhs[i]) / d
            zs.append(min(max(z, xs[i]), xs[i + 1]))
        zs.append(hi)
        return zs

    def sample_hull(zs):
        """Sample from the normalized piecewise-exponential upper hull."""
        # segment i: tangent at xs[i] over (zs[i], zs[i+1])
        log_masses = []
        for i in range(len(xs)):
            a, b = zs[i], zs[i + 1]
            m, c = dhs[i], hs[i] - dhs[i] * xs[i]  # line m·x + c
            if abs(m) < 1e-12:
                lm = c + np.log(b - a) if b > a else -np.inf
            else:
                # log ∫_a^b e^{m x + c} dx, stable for either sign of m
                top, bot = (b, a) if m > 0 else (a, b)
                lm = c + m * top + np.log1p(-np.exp(m * (bot - top))) - np.log(abs(m))
            log_masses.append(lm)
        log_masses = np.array(log_masses)
        M = log_masses.max()
        w = np.exp(log_masses - M)
        probs = w / w.sum()
        i = rng.choice(len(xs), p=probs)
        a, b = zs[i], zs[i + 1]
        m = dhs[i]
        u = rng.rand()
        if abs(m) < 1e-12:
            x = a + u * (b - a)
        elif m > 0:
            x = b + np.log(u + (1 - u) * np.exp(m * (a - b))) / m
        else:
            x = a + np.log(1 - u + u * np.exp(m * (b - a))) / m
        # hull value at x
        hx = hs[i] + m * (x - xs[i])
        return float(x), float(hx)

    for _ in range(max_iter):
        zs = hull()
        x, hux = sample_hull(zs)
        hx = float(h(x))
        if np.log(rng.rand() + 1e-300) <= hx - hux:
            return x
        # refine hull with the rejected point
        if len(xs) < max_points:
            j = np.searchsorted(xs, x)
            xs.insert(j, x)
            hs.insert(j, hx)
            dhs.insert(j, float(h_prime(x)))
    raise RuntimeError("ARS failed to accept within max_iter")


def update_bias_ars(rng, pop, params, data):
    """Exact Gibbs update of every neuron's bias from its full conditional.

    For the exp-Poisson GLM the bias conditional is log-concave:

        h(b) = b·Σ_t S[t,n] − dt·e^b·Σ_t e^{clip(I₋ᵦ[t,n])} − (b−μ)²/(2σ²)

    with I₋ᵦ the total current minus the bias, so ARS samples it exactly. As
    in the JAX package the conditional uses the unclipped e^b (the clipped
    one is not log-concave at the clamp's kink): the draw is exact while
    max(I₋ᵦ) + b stays inside ±EXP_CLIP.

    The two per-neuron sums are formed on the population's device and come
    to the host in one copy; the new biases go back in one. Returns a new
    params dict with 'bias' replaced.
    """
    if pop.nlin.name != "exp" or pop.observation.name != "poisson":
        raise ValueError("exact bias conditional requires exp nonlinearity + Poisson")
    rng = rng or np.random.RandomState()
    bias = params["bias"]
    with torch.no_grad():
        I_wo = pop.total_current(params, data) - bias[None, :]
        sums = torch.stack([data["S"].sum(0), torch.exp(clip_exponent(I_wo)).sum(0) * pop.dt])
    c1, c2 = sums.cpu().double().numpy()  # the pass's one copy to the host
    bspec = pop.spec.get("bias", {})
    mu = float(bspec.get("mu", 2.0))
    sigma = float(bspec.get("sigma", 1.0))

    new_bias = np.empty(bias.shape[0])
    for n in range(bias.shape[0]):
        a, c = float(c1[n]), float(c2[n])

        def h(b, a=a, c=c):
            z = (b - mu) / sigma
            return a * b - c * np.exp(b) - 0.5 * z * z

        def h_prime(b, a=a, c=c):
            return a - c * np.exp(b) - (b - mu) / (sigma * sigma)

        # Newton to the (unique) mode of the concave h, then bracket it.
        b0 = np.log(max(a, 0.5) / max(c, 1e-12))
        b0 = min(max(b0, mu - 10 * sigma), mu + 10 * sigma)
        for _ in range(50):
            d1 = h_prime(b0)
            d2 = -c * np.exp(b0) - 1.0 / (sigma * sigma)
            step = d1 / d2
            b0 -= step
            if abs(step) < 1e-10:
                break
        span = 2.0
        while h_prime(b0 - span) <= 0:
            span *= 2.0
        lo_x = b0 - span
        span = 2.0
        while h_prime(b0 + span) >= 0:
            span *= 2.0
        hi_x = b0 + span
        new_bias[n] = adaptive_rejection_sample(h, h_prime, [lo_x, b0, hi_x], rng=rng)
    # and the one copy back
    return {**params, "bias": torch.as_tensor(new_bias, dtype=bias.dtype, device=bias.device)}
