"""The generic (autograd) branches of the port's Gibbs stages, taken by
every model that is not exp-Poisson, on the CPU in float64.

The per-bin derivatives of softplus and Bernoulli models match the JAX
package's nested grads to 1e-6, and the generic birth–death move (the exact
full-T ΔLL, Newton by autograd) targets the exact law of a 2×2 adjacency,
found by enumeration with quadrature over W (TV < 0.08, the bar of
tests/test_gibbs.py).
"""

import itertools
import math

import numpy as np
import pytest
import torch
from scipy.special import logsumexp

import theano_pyglm_torch as pt
import theano_pyglm_torch.inference.gibbs as gibbs_t
import theano_pyglm_tpu as tpu
import theano_pyglm_tpu.inference.gibbs as gibbs_j
from torch_parity import build_pair_light, to_np


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the other
    test workers (many times slower under pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("nlin,obs", [("softplus", "poisson"), ("exp", "bernoulli"), ("softplus", "bernoulli")])
def test_generic_bin_ll_derivs_match_jax(nlin, obs):
    """d1, d2 by autograd against JAX's nested grads: 1e-6, on currents
    over ±9, an underflowing rate on a spiking bin (I = −800, S = 1) and a
    clipped one (I = 60); all finite after the sanitizer."""
    r = np.random.RandomState(0)
    I = 3.0 * r.randn(80, 3)
    S = r.poisson(0.5, (80, 3)).astype(float)
    if obs == "bernoulli":
        S = np.minimum(S, 1.0)
    I[5], S[5], I[6] = -800.0, 1.0, 60.0
    spec = tpu.make_model("sparse_weighted_model", 3, nlin={"type": nlin}, observation={"type": obs})
    pop_j, pop_t = tpu.Population(spec), pt.Population(spec, device="cpu", dtype=torch.float64)
    d1_j, d2_j = gibbs_j._bin_ll_derivs(S, I, pop_j.observation, pop_j.nlin, 1e-3)
    d1_t, d2_t = gibbs_t._bin_ll_derivs(torch.tensor(S), torch.tensor(I), pop_t.observation, pop_t.nlin, 1e-3)
    for got, want in ((d1_t, d1_j), (d2_t, d2_j)):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6, atol=1e-12)


def _tv(p, q):
    return 0.5 * np.abs(p - q).sum()


def test_generic_birth_death_targets_exact_law():
    """The softplus birth–death move (exact full-T ΔLL, autograd Newton) on
    a 2×2 adjacency: the empirical law of A over 1,500 sweeps against
    enumeration with quadrature over W (161² grid per row): TV < 0.08."""
    spec = tpu.make_model("sparse_weighted_model", 2, bkgd={"type": "none"}, nlin={"type": "softplus"})
    spec["network"]["graph"]["rho"] = 0.3
    T = 300
    spikes = np.random.RandomState(5).poisson(0.08, (T, 2)).astype(float)
    pop_t, p_t, d_t = (build_pair_light(spec, T=T, spikes=spikes)[i] for i in (1, 3, 5))
    psi = gibbs_t.compute_psi(pop_t, p_t, d_t)  # (T, N, N)
    I_rest = gibbs_t.rest_current(pop_t, p_t, d_t)
    MU, SIG = (to_np(x) for x in pop_t.weights.prior_mu_sigma(p_t))
    S, G = d_t["S"], 161
    row_laws = []
    for n in range(2):
        grids = [np.linspace(MU[n, m] - 8 * SIG[n, m], MU[n, m] + 8 * SIG[n, m], G) for m in range(2)]
        w0, w1 = torch.tensor(grids[0])[:, None, None], torch.tensor(grids[1])[None, :, None]
        log_prior_w = sum(
            -0.5 * ((g - MU[n, m]) / SIG[n, m]) ** 2 - math.log(SIG[n, m] * math.sqrt(2 * math.pi))
            for m, g in ((0, grids[0][:, None]), (1, grids[1][None, :]))
        ) + math.log((grids[0][1] - grids[0][0]) * (grids[1][1] - grids[1][0]))
        logw = []
        for a in itertools.product([0.0, 1.0], repeat=2):
            I = I_rest[:, n] + a[0] * w0 * psi[:, n, 0] + a[1] * w1 * psi[:, n, 1]
            ll = to_np(pop_t.observation.log_likelihood(S[:, n], I, pop_t.nlin, pop_t.dt).sum(-1))
            lp_a = sum(math.log(0.3) if ai else math.log(0.7) for ai in a)
            logw.append(lp_a + logsumexp(ll + log_prior_w))
        logw = np.array(logw)
        row_laws.append(np.exp(logw - logsumexp(logw)))
    exact = np.array([row_laws[0][i // 4] * row_laws[1][i % 4] for i in range(16)])

    n, burn = 1500, 100
    g = torch.Generator().manual_seed(1)
    p, configs, accs = p_t, [], []
    for _ in range(n):
        p, acc = gibbs_t.update_adjacency_collapsed(g, pop_t, p, d_t, return_accept=True)
        configs.append(int((to_np(p["A"]).reshape(4) * np.array([8, 4, 2, 1])).sum()))
        accs.append(float(acc))
    emp = np.bincount(configs[burn:], minlength=16) / (n - burn)
    assert np.isfinite(to_np(p["W"])).all() and 0.2 < np.mean(accs) <= 1.0
    assert _tv(emp, exact) < 0.08, (emp, exact)
