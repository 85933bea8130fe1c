"""The port's Gibbs sweep stages (theano_pyglm_torch/inference/gibbs.py)
against the JAX package and against exact answers, in float64 on the CPU.

Deterministic pieces (ψ, currents, the per-bin derivatives, the Laplace
mode) match the JAX functions to 1e-6 relative and a numpy Newton solve to
1e-8. The random streams of the two packages differ, so each stochastic
stage is held to an exact law: brute-force enumeration with quadrature for
the adjacency moves (TV < 0.08, the bar of tests/test_gibbs.py, with JAX's
function run on the same problem), 1-D quadrature for the Laplace-MH bias
draw, the Normal–Inverse-Gamma closed form for the weight hypers, the Haar
law for the rotation and the prior for disconnected weights.
"""

import itertools
import math

import jax
import numpy as np
import pytest
import torch
from scipy.special import gammaln, logsumexp

import theano_pyglm_torch.inference.gibbs as gibbs_t
import theano_pyglm_tpu as tpu
import theano_pyglm_tpu.inference.gibbs as gibbs_j
from theano_pyglm_tpu.ops.clipping import EXP_CLIP
from torch_parity import build_pair_light, rel_err, to_np


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the other
    test workers (many times slower under pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, N, T=300, seed=0, spikes=None, **overrides):
    return build_pair_light(tpu.make_model(name, N, **overrides), T, seed, spikes)


def _tv(p, q):
    return 0.5 * np.abs(p - q).sum()


# ---------------------------------------------------------------------------
# deterministic pieces against the JAX package
# ---------------------------------------------------------------------------


def test_psi_and_currents_match_jax():
    """compute_psi, _psi_from_X (one row and a block of rows, with and
    without the centering correction) and rest_current: 1e-6 relative."""
    pop_j, pop_t, p_j, p_t, d_j, d_t = _pair("distance_weighted_model", 4, T=300)
    psi_j = gibbs_j.compute_psi(pop_j, p_j, d_j)
    psi_t = gibbs_t.compute_psi(pop_t, p_t, d_t)
    assert psi_t.shape == (300, 4, 4) and rel_err(psi_t, psi_j) < 1e-6
    assert rel_err(gibbs_t.rest_current(pop_t, p_t, d_t), gibbs_j.rest_current(pop_j, p_j, d_j)) < 1e-6

    w_j, w_t = pop_j.impulse.effective(p_j), pop_t.impulse.effective(p_t)
    for use_mean in (False, True):
        mean_j = d_j["_X_imp_mean"] if use_mean else None
        mean_t = d_t["_X_imp_mean"] if use_mean else None
        for n in range(4):  # one row: (N_pre, T') is the transpose of JAX's (T', N_pre)
            row_t = gibbs_t._psi_from_X(d_t["X_imp"], mean_t, w_t[n])
            row_j = gibbs_j._psi_from_X(d_j["X_imp"], mean_j, w_j[n])
            assert rel_err(row_t.T, row_j) < 1e-6, (use_mean, n)
        block = gibbs_t._psi_from_X(d_t["X_imp"], mean_t, w_t[1:3])  # (N_pre, R, T')
        for r, n in enumerate((1, 2)):
            assert rel_err(block[:, r].T, gibbs_j._psi_from_X(d_j["X_imp"], mean_j, w_j[n])) < 1e-6
    # with the correction the rows are compute_psi's
    rows = gibbs_t._row_psi(pop_t, d_t, w_t)  # (N_pre, N_post, T)
    assert rel_err(rows.permute(2, 1, 0), psi_j) < 1e-6


def test_bin_ll_derivs_match_jax_with_clipped_entries():
    r = np.random.RandomState(0)
    S = r.poisson(0.3, (50, 3)).astype(float)
    I = r.randn(50, 3)
    I[::7, 0] = EXP_CLIP + 5.0
    I[3::7, 1] = -EXP_CLIP - 5.0
    pop_j, pop_t = _pair("standard_glm", 3, T=50)[:2]
    d1_j, d2_j = gibbs_j._bin_ll_derivs(S, I, pop_j.observation, pop_j.nlin, 1e-3)
    d1_t, d2_t = gibbs_t._bin_ll_derivs(torch.tensor(S), torch.tensor(I), pop_t.observation, pop_t.nlin, 1e-3)
    np.testing.assert_allclose(to_np(d1_t), np.asarray(d1_j), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(to_np(d2_t), np.asarray(d2_j), rtol=1e-6, atol=1e-12)
    assert float(d1_t[::7, 0].abs().max()) == 0.0 and float(d2_t[3::7, 1].abs().max()) == 0.0


def test_non_exp_poisson_paths_raise():
    """The autodiff branches, which raised until they were ported, now run:
    softplus per-bin derivatives equal JAX's (tests/test_torch_generic.py
    holds them and the birth–death law in full), and the generic birth–death
    update keeps A binary and W finite."""
    pop_j, pop_t, p_j, p_t, d_j, d_t = _pair("sparse_weighted_model", 3, T=60, nlin={"type": "softplus"})
    d1, d2 = gibbs_t._bin_ll_derivs(d_t["S"], d_t["S"], pop_t.observation, pop_t.nlin, pop_t.dt)
    want = gibbs_j._bin_ll_derivs(d_j["S"], d_j["S"], pop_j.observation, pop_j.nlin, pop_j.dt)
    for got, w in zip((d1, d2), want):
        np.testing.assert_allclose(to_np(got), np.asarray(w), rtol=1e-6, atol=1e-12)
    out, acc = gibbs_t.update_adjacency_collapsed(torch.Generator().manual_seed(0), pop_t, p_t, d_t,
                                                  return_accept=True)
    assert bool(((out["A"] == 0) | (out["A"] == 1)).all()) and bool(torch.isfinite(out["W"]).all())
    assert 0.0 <= float(acc) <= 1.0


@pytest.mark.parametrize("name", ["distance_weighted_model", "standard_glm"])
def test_glm_prior_rows_match_jax(name):
    pop_j, pop_t = _pair(name, 3, T=50, bias={"mu": 3.0, "sigma": 0.4})[:2]
    assert gibbs_t._bias_bkgd_scalars(pop_t) == gibbs_j._bias_bkgd_scalars(pop_j)
    for D in (1, 6):
        for a, b in zip(gibbs_t._glm_prior_rows(pop_t, D), gibbs_j._glm_prior_rows(pop_j, D)):
            np.testing.assert_array_equal(to_np(a), np.asarray(b))


def _glm_problem(T=600, seed=0):
    pop_j, pop_t, p_j, p_t, d_j, d_t = _pair(
        "distance_weighted_model", 3, T=T, seed=seed, bias={"mu": 3.0, "sigma": 0.4},
        spikes=np.random.RandomState(seed).poisson(0.02, (T, 3)).astype(float),
    )
    return pop_j, pop_t, p_j, p_t, d_j, d_t


def test_laplace_fit_matches_jax_math_and_numpy_newton():
    """θ* of the glm block: the port's 6 Newton steps equal the JAX package's
    formulation of the same steps to 1e-6 relative; run to convergence they
    equal a numpy Newton solve to 1e-8, and C Cᵀ is the numpy −H*."""
    import jax.numpy as jnp

    pop_j, pop_t, p_j, p_t, d_j, d_t = _glm_problem()
    Phi, I0, theta_cur, mu, sd = gibbs_t._glm_block(pop_t, p_t, d_t)
    theta0 = theta_cur + 0.3  # a seed off the mode
    th6, _ = gibbs_t.glm_laplace_fit(pop_t, p_t, d_t, theta0)

    # the JAX package's Newton (_laplace_mh_block's grad_negH), shared design
    S_j, Phi_j, I0_j = d_j["S"], jnp.asarray(to_np(Phi)), jnp.asarray(to_np(I0))
    prec = 1.0 / jnp.asarray(to_np(sd)) ** 2
    th = jnp.asarray(to_np(theta0))
    for _ in range(6):
        d1, d2 = gibbs_j._bin_ll_derivs(S_j, I0_j + Phi_j @ th.T, pop_j.observation, pop_j.nlin, pop_j.dt)
        d2 = jnp.minimum(d2, 0.0)
        g = jnp.einsum("tn,td->nd", d1, Phi_j) - (th - jnp.asarray(to_np(mu))) * prec
        nH = -jnp.einsum("tn,td,te->nde", d2, Phi_j, Phi_j) + jax.vmap(jnp.diag)(jnp.broadcast_to(prec, th.shape))
        th = th + jnp.linalg.solve(nH, g[..., None])[..., 0]
    assert rel_err(th6, th) < 1e-6

    # numpy Newton to convergence
    S, P, I0n = to_np(d_t["S"]), to_np(Phi), to_np(I0)
    mu_n, prec_n = to_np(mu), 1.0 / to_np(sd) ** 2
    th_np = to_np(theta0).copy()
    for _ in range(60):
        lam = np.exp(np.clip(I0n + P @ th_np.T, -EXP_CLIP, EXP_CLIP)) * pop_t.dt
        g = (S - lam).T @ P - (th_np - mu_n) * prec_n
        H = np.einsum("tn,td,te->nde", lam, P, P) + np.stack([np.diag(prec_n)] * 3)
        th_np = th_np + np.linalg.solve(H, g[..., None])[..., 0]
    th_conv, C = gibbs_t.glm_laplace_fit(pop_t, p_t, d_t, theta0, n_newton=30)
    assert rel_err(th_conv, th_np) < 1e-8
    lam = np.exp(np.clip(I0n + P @ th_np.T, -EXP_CLIP, EXP_CLIP)) * pop_t.dt
    H = np.einsum("tn,td,te->nde", lam, P, P) + np.stack([np.diag(prec_n)] * 3)
    C = to_np(C)
    assert rel_err(C @ C.transpose(0, 2, 1), H) < 1e-8


def test_cholesky_nan_escape_hatch():
    """A −H* that is not positive definite: the port's factor is NaN for that
    neuron only, exactly where ``jnp.linalg.cholesky`` is, decided on the
    device (no raise); the MH step then never moves that neuron and never
    lets a NaN into the state, while the other neurons sample as usual."""
    import jax.numpy as jnp

    pop_j, pop_t, p_j, p_t, d_j, d_t = _glm_problem()
    Phi, I0, theta_cur, mu, sd = gibbs_t._glm_block(pop_t, p_t, d_t)
    theta_star, C = gibbs_t.glm_laplace_fit(pop_t, p_t, d_t, theta_cur)
    negH = C @ C.transpose(1, 2)
    bad = negH.clone()
    bad[1] = -bad[1]  # negative definite: not a Hessian of a concave conditional
    C_bad = gibbs_t._cholesky_or_nan(bad)
    C_jax = np.asarray(jnp.linalg.cholesky(jnp.asarray(to_np(bad))))
    np.testing.assert_array_equal(np.isnan(to_np(C_bad)), np.isnan(C_jax))
    assert bool(torch.isnan(C_bad[1].tril()).sum() == 21) and bool(torch.isfinite(C_bad[[0, 2]]).all())
    np.testing.assert_allclose(to_np(C_bad[[0, 2]]), C_jax[[0, 2]], rtol=1e-10)

    g = torch.Generator().manual_seed(0)
    moved = np.zeros(3, bool)
    for _ in range(40):
        th_new, acc = gibbs_t._laplace_mh_step(
            g, d_t["S"], pop_t.dt, pop_t.observation, pop_t.nlin, I0, Phi, theta_cur, theta_star,
            C_bad, mu, sd,
        )
        assert bool(torch.isfinite(th_new).all())
        assert torch.equal(th_new[1], theta_cur[1]) and not bool(acc[1])
        moved |= to_np(acc)
    assert moved[0] and moved[2]


# ---------------------------------------------------------------------------
# stochastic stages against exact answers
# ---------------------------------------------------------------------------


def _poisson_ll(S, I, dt):
    Ic = np.clip(I, -EXP_CLIP, EXP_CLIP)
    return S * (Ic + math.log(dt)) - np.exp(Ic) * dt - gammaln(S + 1.0)


def _collapsed_exact_law(pop_j, p_j, d_j, rho, G=161):
    """p(A) of the 2×2 adjacency with W integrated out: per row, each of the
    four A rows weighted by its prior and by a 2-D quadrature over (W[n,0],
    W[n,1]) of prior × likelihood; rows are independent given the rest."""
    psi = np.asarray(gibbs_j.compute_psi(pop_j, p_j, d_j))  # (T, N, N)
    I_rest = np.asarray(gibbs_j.rest_current(pop_j, p_j, d_j))
    S = np.asarray(d_j["S"])
    MU, SIG = (np.asarray(x) for x in pop_j.weights.prior_mu_sigma(p_j))
    row_laws = []
    for n in range(2):
        grids = [np.linspace(MU[n, m] - 8 * SIG[n, m], MU[n, m] + 8 * SIG[n, m], G) for m in range(2)]
        w0, w1 = grids[0][:, None, None], grids[1][None, :, None]
        log_prior_w = sum(
            -0.5 * ((g - MU[n, m]) / SIG[n, m]) ** 2 - math.log(SIG[n, m] * math.sqrt(2 * math.pi))
            for m, g in ((0, w0[..., 0]), (1, w1[..., 0]))
        ) + math.log((grids[0][1] - grids[0][0]) * (grids[1][1] - grids[1][0]))
        logw = []
        for a in itertools.product([0.0, 1.0], repeat=2):
            I = I_rest[None, None, :, n] + a[0] * w0 * psi[None, None, :, n, 0] + a[1] * w1 * psi[None, None, :, n, 1]
            ll = _poisson_ll(S[None, None, :, n], I, pop_j.dt).sum(-1)
            lp_a = sum(math.log(rho) if ai else math.log(1 - rho) for ai in a)
            logw.append(lp_a + logsumexp(ll + log_prior_w))
        logw = np.array(logw)
        row_laws.append(np.exp(logw - logsumexp(logw)))
    # configs big-endian over (A00, A01, A10, A11)
    return np.array([row_laws[0][i // 4] * row_laws[1][i % 4] for i in range(16)])


def _config_index(A):  # (n, 2, 2) -> (n,)
    return (A.reshape(-1, 4) * np.array([8, 4, 2, 1])).sum(1).astype(int)


def _adjacency_problem(T=300):
    spec = tpu.make_model("sparse_weighted_model", 2, bkgd={"type": "none"})
    spec["network"]["graph"]["rho"] = 0.3
    return build_pair_light(spec, T=T, spikes=np.random.RandomState(5).poisson(0.08, (T, 2)).astype(float))


@pytest.mark.parametrize("subsample", [False, True])
def test_collapsed_adjacency_targets_exact_law(subsample, monkeypatch):
    """The empirical law of A under repeated birth–death sweeps of both
    packages against enumeration with quadrature over W: TV < 0.08. With
    ``subsample`` the proposal is shaped on 8 random blocks of 8 bins of the
    T=300 (the flagship's path, shrunk as tests/test_subsample.py does)."""
    if subsample:
        for mod in (gibbs_t, gibbs_j):
            monkeypatch.setattr(mod, "SUBSAMPLE_T", 64)
            monkeypatch.setattr(mod, "SUBSAMPLE_BLK", 8)
    pop_j, pop_t, p_j, p_t, d_j, d_t = _adjacency_problem()
    exact = _collapsed_exact_law(pop_j, p_j, d_j, rho=0.3)
    n, burn = 2500, 200

    g = torch.Generator().manual_seed(1)
    p, As, accs = p_t, [], []
    for _ in range(n):
        p, acc = gibbs_t.update_adjacency_collapsed(g, pop_t, p, d_t, return_accept=True)
        As.append(to_np(p["A"]))
        accs.append(float(acc))
    emp_t = np.bincount(_config_index(np.stack(As)[burn:]), minlength=16) / (n - burn)
    assert np.isfinite(to_np(p["W"])).all() and 0.2 < np.mean(accs) <= 1.0

    @jax.jit
    def run_j(params, keys):
        def step(q, k):
            q = gibbs_j.update_adjacency_collapsed(k, pop_j, q, d_j)
            return q, q["A"]
        return jax.lax.scan(step, params, keys)[1]

    A_j = np.asarray(run_j(p_j, jax.random.split(jax.random.PRNGKey(2), n)))
    emp_j = np.bincount(_config_index(A_j[burn:]), minlength=16) / (n - burn)
    assert _tv(emp_j, exact) < 0.08, (emp_j, exact)
    assert _tv(emp_t, exact) < 0.08, (emp_t, exact)


def test_plain_adjacency_targets_exact_law():
    """update_adjacency (W held, the collapsed update's path for models
    without W) against enumeration of the 16 configurations, mirroring
    tests/test_gibbs.py; JAX's function on the same problem too."""
    pop_j, pop_t, p_j, p_t, d_j, d_t = _adjacency_problem(T=150)
    logw = []
    for c in itertools.product([0.0, 1.0], repeat=4):
        A = np.array(c).reshape(2, 2)
        ll = float(pop_t.log_likelihood({**p_t, "A": torch.tensor(A)}, d_t))
        logw.append(ll + np.sum(np.where(A > 0, np.log(0.3), np.log(0.7))))
    exact = np.exp(np.array(logw) - logsumexp(logw))
    n, burn = 4000, 200
    g = torch.Generator().manual_seed(3)
    p, As = p_t, []
    for _ in range(n):
        p = gibbs_t.update_adjacency(g, pop_t, p, d_t)
        As.append(to_np(p["A"]))
    emp_t = np.bincount(_config_index(np.stack(As)[burn:]), minlength=16) / (n - burn)

    @jax.jit
    def run_j(params, keys):
        def step(q, k):
            q = gibbs_j.update_adjacency(k, pop_j, q, d_j)
            return q, q["A"]
        return jax.lax.scan(step, params, keys)[1]

    A_j = np.asarray(run_j(p_j, jax.random.split(jax.random.PRNGKey(4), n)))
    emp_j = np.bincount(_config_index(A_j[burn:]), minlength=16) / (n - burn)
    assert _tv(emp_j, exact) < 0.08, (emp_j, exact)
    assert _tv(emp_t, exact) < 0.08, (emp_t, exact)


def test_row_batch_gives_the_same_update():
    """Rows all at once or two at a time: the same draws, the same update."""
    pop_t, p_t, d_t = (_pair("sparse_weighted_model", 5, T=200, bkgd={"type": "none"})[i] for i in (1, 3, 5))
    full = gibbs_t.update_adjacency_collapsed(torch.Generator().manual_seed(7), pop_t, p_t, d_t)
    rows = gibbs_t.update_adjacency_collapsed(torch.Generator().manual_seed(7), pop_t, p_t, d_t, row_batch=2)
    assert torch.equal(full["A"], rows["A"])
    np.testing.assert_allclose(to_np(rows["W"]), to_np(full["W"]), rtol=1e-12)
    plain = [gibbs_t.update_adjacency(torch.Generator().manual_seed(8), pop_t, p_t, d_t, row_batch=rb)["A"]
             for rb in (None, 3)]
    assert torch.equal(*plain)


def test_laplace_mh_bias_matches_quadrature():
    """Repeated Laplace-MH draws of the bias alone (no stimulus) against the
    exact 1-D conditional by quadrature: mean within 4 standard errors, sd
    within 10 %, KS distance < 0.06 (2,000 draws), acceptance > 0.5."""
    T = 300
    pop_j, pop_t, p_j, p_t, d_j, d_t = _pair(
        "sparse_weighted_model", 2, T=T, bkgd={"type": "none"},
        spikes=np.random.RandomState(1).poisson(0.05, (T, 2)).astype(float),
    )
    Phi, I0, theta_cur, mu, sd = gibbs_t._glm_block(pop_t, p_t, d_t)
    assert Phi.shape == (T, 1)
    g = torch.Generator().manual_seed(0)
    p, draws, accs = p_t, [], []
    for _ in range(2000):
        p, acc = gibbs_t.update_glm_laplace(g, pop_t, p, d_t, theta_cur, return_accept=True)
        draws.append(to_np(p["bias"]))
        accs.append(float(acc))
    draws = np.stack(draws)
    assert np.mean(accs) > 0.5

    S, I0n = to_np(d_t["S"]), to_np(I0)
    b_mu, b_sd = gibbs_t._bias_bkgd_scalars(pop_t)[:2]
    grid = np.linspace(-10.0, 10.0, 20001)
    for n in range(2):
        logp = _poisson_ll(S[None, :, n], I0n[None, :, n] + grid[:, None], pop_t.dt).sum(1)
        logp = logp - 0.5 * ((grid - b_mu) / b_sd) ** 2
        w = np.exp(logp - logp.max())
        w /= w.sum()
        m = (w * grid).sum()
        s = math.sqrt((w * (grid - m) ** 2).sum())
        x = draws[:, n]
        assert abs(x.mean() - m) < 4 * s / math.sqrt(len(x)), (n, x.mean(), m)
        assert abs(x.std() - s) < 0.1 * s, (n, x.std(), s)
        cdf = np.interp(np.sort(x), grid, np.cumsum(w))
        ks = np.max(np.abs(cdf - (np.arange(len(x)) + 0.5) / len(x)))
        assert ks < 0.06, (n, ks)


def test_weight_hypers_match_closed_form():
    """The Normal–Inverse-Gamma posterior of (μ_W, σ_W²) given the
    off-diagonal W: draw means within 5 standard errors of E[μ] = m_n and
    E[σ²] = b_n/(a_n−1), and near the empirical moments as
    tests/test_gibbs.py checks the JAX package."""
    spec = tpu.make_model("sparse_weighted_model", 6, bkgd={"type": "none"})
    spec["network"]["weight"]["infer_hypers"] = True
    pop_t, p_t = (build_pair_light(spec, T=50)[i] for i in (1, 3))
    W = np.random.RandomState(0).normal(1.3, 0.7, (6, 6))
    p_t = {**p_t, "W": torch.tensor(W)}
    off = ~np.eye(6, dtype=bool)
    w, n = W[off], 30
    k_n, a_n = 1.0 + n, 2.0 + n / 2.0
    m_n = n * w.mean() / k_n
    b_n = 2.0 + 0.5 * ((w - w.mean()) ** 2).sum() + n * w.mean() ** 2 / (2.0 * k_n)
    g = torch.Generator().manual_seed(0)
    draws = [gibbs_t.update_weight_hypers(g, pop_t, p_t) for _ in range(3000)]
    mus = np.array([float(d["W_mu"]) for d in draws])
    var = np.array([float(d["W_sigma"]) ** 2 for d in draws])
    e_var = b_n / (a_n - 1)
    sd_mu = math.sqrt(e_var / k_n)
    sd_var = e_var / math.sqrt(a_n - 2)
    assert abs(mus.mean() - m_n) < 5 * sd_mu / math.sqrt(3000)
    assert abs(var.mean() - e_var) < 5 * sd_var / math.sqrt(3000)
    assert abs(mus.mean() - w.mean()) < 0.15 and abs(np.sqrt(var).mean() - w.std()) < 0.2
    # without infer_hypers the stage is the identity
    pop2, p2 = (_pair("sparse_weighted_model", 3, T=50)[i] for i in (1, 3))
    assert gibbs_t.update_weight_hypers(g, pop2, p2) is p2


def test_latent_rotation_is_a_haar_gauge_move():
    """Pairwise distances kept to 1e-12; the recovered Q is orthogonal, its
    angle uniform on [0, 2π) (KS < 0.05 over 2,000 draws) and a reflection
    half of the time; a graph without locations is left alone."""
    pop_t, p_t = (_pair("distance_weighted_model", 6, T=50)[i] for i in (1, 3))
    locs0 = to_np(p_t["locs"])
    d0 = np.linalg.norm(locs0[:, None] - locs0[None], axis=-1)
    lp0 = float(pop_t.graph.log_prior(p_t))
    g = torch.Generator().manual_seed(0)
    angles, dets = [], []
    for i in range(2000):
        out = gibbs_t.update_latent_rotation(g, pop_t, p_t)
        locs1 = to_np(out["locs"])
        np.testing.assert_allclose(np.linalg.norm(locs1[:, None] - locs1[None], axis=-1), d0, rtol=0, atol=1e-12)
        Q = np.linalg.lstsq(locs0, locs1, rcond=None)[0]
        if i < 20:
            np.testing.assert_allclose(Q.T @ Q, np.eye(2), atol=1e-10)
            np.testing.assert_allclose(float(pop_t.graph.log_prior(out)), lp0, rtol=1e-12)
        angles.append(math.atan2(Q[1, 0], Q[0, 0]) % (2 * math.pi))
        dets.append(np.linalg.det(Q))
    u = np.sort(np.array(angles)) / (2 * math.pi)
    assert np.max(np.abs(u - (np.arange(2000) + 0.5) / 2000)) < 0.05
    assert abs(np.mean(np.array(dets) < 0) - 0.5) < 0.05
    pop2, p2 = (_pair("sparse_weighted_model", 3, T=50)[i] for i in (1, 3))
    assert gibbs_t.update_latent_rotation(g, pop2, p2) is p2


def test_disconnected_weights_come_from_the_prior():
    pop_t, p_t = (_pair("sparse_weighted_model", 5, T=50)[i] for i in (1, 3))
    A = (np.random.RandomState(0).rand(5, 5) < 0.4).astype(float)
    p_t = {**p_t, "A": torch.tensor(A)}
    MU, SIG = (to_np(x) for x in pop_t.weights.prior_mu_sigma(p_t))
    g = torch.Generator().manual_seed(0)
    z = []
    for _ in range(1000):
        out = gibbs_t.refresh_disconnected_weights(g, pop_t, p_t)
        assert torch.equal(out["W"][A > 0], p_t["W"][A > 0])
        z.append(((to_np(out["W"]) - MU) / SIG)[A == 0])
    z = np.concatenate(z)
    assert abs(z.mean()) < 0.03 and abs(z.std() - 1.0) < 0.03
    pop2, p2 = (_pair("standard_glm", 3, T=50)[i] for i in (1, 3))
    assert gibbs_t.refresh_disconnected_weights(g, pop2, p2) is p2


def test_discrete_stages_identity_or_raise():
    """SBM types/hypers and the ER density are the identity where JAX's are:
    on the distance and complete graphs, on the ER graph with a fixed ρ,
    and (the SBM stages) on an ER graph with an inferred ρ; the ER stage on
    the SBM graph."""
    g = torch.Generator().manual_seed(0)
    stages = (gibbs_t.update_sbm_types_collapsed, gibbs_t.update_sbm_hypers, gibbs_t.update_er_rho)
    for name in ("distance_weighted_model", "standard_glm", "sparse_weighted_model"):
        pop_t, p_t = (_pair(name, 3, T=50)[i] for i in (1, 3))
        for fn in stages:
            assert fn(g, pop_t, p_t) is p_t, (name, fn.__name__)
    pop_t, p_t = (_pair("sbm_weighted_model", 3, T=50)[i] for i in (1, 3))
    assert gibbs_t.update_er_rho(g, pop_t, p_t) is p_t
    spec = tpu.make_model("sparse_weighted_model", 3)
    spec["network"]["graph"]["infer_rho"] = True
    pop_t, p_t = (build_pair_light(spec, T=50)[i] for i in (1, 3))
    for fn in stages[:2]:
        assert fn(g, pop_t, p_t) is p_t, fn.__name__
