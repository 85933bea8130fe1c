"""The port's glm blocks of the stimulus variants and its glm HMC fallback
against the JAX package and against exact answers, in float64 on the CPU.

Deterministic pieces match the JAX functions to 1e-6 relative: the Newton
modes and Cholesky factors of the spatiotemporal and shared glm sub-blocks
(read from the JAX functions themselves while they run), also on 3 chains'
params at once against the JAX update on each chain's, the whitening
factor of the glm HMC fallback (from JAX's sweep closure, to 1e-12) and a
whitened leapfrog trajectory from the same momentum. The stochastic updates
are held to exact laws: the spatiotemporal sub-block (b) and the shared
global filter, each 1-D, to quadrature of their conditionals. Every variant
samples through ``gibbs_sample``.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theano_pyglm_torch as pt
import theano_pyglm_torch.inference.gibbs as gibbs_t
import theano_pyglm_torch.inference.mcmc as mcmc_t
import theano_pyglm_tpu as tpu
import theano_pyglm_tpu.inference.gibbs as gibbs_j
import theano_pyglm_tpu.inference.mcmc as mcmc_j
from theano_pyglm_torch.inference.mcmc import gibbs_sample
from torch_parity import build_pair_light, rel_err, to_np

hmc_t = importlib.import_module("theano_pyglm_torch.inference.hmc")
hmc_j = importlib.import_module("theano_pyglm_tpu.inference.hmc")

SHARED_BKGD = {
    "type": "shared", "D_stim": 1, "dt_max": 0.3, "mu": 0.0, "sigma": 0.5,
    "basis": {"type": "cosine", "n_bas": 3, "a": 1.0, "b": 1.0, "norm": True},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the other
    test workers (many times slower under pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(name, N, D_stim=None, n_bas=None, **overrides):
    spec = tpu.make_model(name, N, **overrides)
    if D_stim is not None:
        spec["bkgd"]["D_stim"] = D_stim
    if n_bas is not None:
        spec["bkgd"]["basis"]["n_bas"] = n_bas
    return spec


def _capture_jax_fits(monkeypatch):
    """Record, while a JAX glm update runs, each Newton scan's final θ* and
    each Cholesky factorization's input −H*, in call order."""
    modes, neg_h = [], []
    scan, cholesky = jax.lax.scan, jnp.linalg.cholesky

    def scan_rec(f, init, xs=None, length=None, **kw):
        out = scan(f, init, xs, length=length, **kw)
        modes.append(np.asarray(out[0]))
        return out

    def cholesky_rec(a, *args, **kw):
        neg_h.append(np.asarray(a))
        return cholesky(a, *args, **kw)

    monkeypatch.setattr(jax.lax, "scan", scan_rec)
    monkeypatch.setattr(jnp.linalg, "cholesky", cholesky_rec)
    return modes, neg_h


def _cell(fn, name):
    """The value of the variable ``name`` in the closure of ``fn``."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def _assert_fit(fit_t, mode_j, neg_h_j):
    theta, C = fit_t
    assert rel_err(theta.reshape(mode_j.shape), mode_j) < 1e-6
    assert rel_err((C @ C.transpose(-1, -2)).reshape(neg_h_j.shape), neg_h_j) < 1e-6


# ---------------------------------------------------------------------------
# deterministic pieces against the JAX package
# ---------------------------------------------------------------------------


def test_st_subblock_fits_match_jax(monkeypatch):
    """Both spatiotemporal sub-blocks (D_stim=4, B=5): θ* and −H* of the
    port's glm_laplace_fit_st against the JAX update's own Newton modes and
    Cholesky inputs; (b) at JAX's post-(a) [bias, w_s]."""
    pop_j, pop_t, p_j, p_t, d_j, d_t = build_pair_light(_spec("spatiotemporal_glm", 3, D_stim=4), T=300)
    th0_t = {k: p_t[k] + 0.2 for k in ("bias", "w_stim_s", "w_stim_t")}
    th0_j = {k: jnp.asarray(to_np(v)) for k, v in th0_t.items()}
    modes, neg_h = _capture_jax_fits(monkeypatch)
    out_j = gibbs_j.update_glm_laplace_st(jax.random.PRNGKey(0), pop_j, p_j, d_j, th0_j)
    monkeypatch.undo()
    assert len(modes) == len(neg_h) == 2 and modes[0].shape == (3, 5) and modes[1].shape == (3, 5)
    fit_a, _ = gibbs_t.glm_laplace_fit_st(pop_t, p_t, d_t, th0_t)
    _assert_fit(fit_a, modes[0], neg_h[0])
    p_b = {**p_t, **{k: torch.tensor(np.asarray(out_j[k])) for k in ("bias", "w_stim_s")}}
    _, fit_b = gibbs_t.glm_laplace_fit_st(pop_t, p_b, d_t, th0_t)
    _assert_fit(fit_b, modes[1], neg_h[1])


def test_shared_subblock_fits_match_jax(monkeypatch):
    """Both shared-stimulus sub-blocks (DB=3): [bias, gain] θ* and −H*, and
    the pooled global-filter mode and −H*, against the JAX update's own; (b)
    at JAX's post-(a) [bias, gain]."""
    pop_j, pop_t, p_j, p_t, d_j, d_t = build_pair_light(_spec("standard_glm", 3, bkgd=SHARED_BKGD), T=300)
    th0_t = {"bias": p_t["bias"] - 0.3, "gain": p_t["gain"] + 0.2, "w_stim_shared": p_t["w_stim_shared"] + 0.2}
    th0_j = {k: jnp.asarray(to_np(v)) for k, v in th0_t.items()}
    modes, neg_h = _capture_jax_fits(monkeypatch)
    out_j = gibbs_j.update_glm_laplace_shared(jax.random.PRNGKey(0), pop_j, p_j, d_j, th0_j)
    monkeypatch.undo()
    assert [m.shape for m in modes] == [(3, 2), (3,)] and [h.shape for h in neg_h] == [(3, 2, 2), (3, 3)]
    fit_a, _ = gibbs_t.glm_laplace_fit_shared(pop_t, p_t, d_t, th0_t)
    _assert_fit(fit_a, modes[0], neg_h[0])
    p_b = {**p_t, **{k: torch.tensor(np.asarray(out_j[k])) for k in ("bias", "gain")}}
    _, fit_b = gibbs_t.glm_laplace_fit_shared(pop_t, p_b, d_t, th0_t)
    _assert_fit(fit_b, modes[1], neg_h[1])


def _jax_fits_per_chain(monkeypatch, update_j, pop_j, chains, d_j, th0_j, post_a):
    """For each chain's params, the JAX update's own Newton modes and −H*
    (:func:`_capture_jax_fits`) and its post-(a) values of the leaves
    ``post_a``, stacked on a leading chain axis."""
    modes, neg_h, after_a = [], [], []
    for p in chains:
        m, h = _capture_jax_fits(monkeypatch)
        out = update_j(jax.random.PRNGKey(0), pop_j, {k: jnp.asarray(to_np(v)) for k, v in p.items()}, d_j, th0_j)
        monkeypatch.undo()
        modes.append(m)
        neg_h.append(h)
        after_a.append({k: torch.tensor(np.asarray(out[k])) for k in post_a})
    stack = lambda xs: [np.stack(x) for x in zip(*xs)]  # noqa: E731
    return stack(modes), stack(neg_h), mcmc_t.stack_states(after_a)


def _chains(pop_t, p_t, C=3):
    """C chains' params: ``p_t`` and C − 1 more prior draws."""
    return [p_t] + [pop_t.sample(torch.Generator().manual_seed(c)) for c in range(1, C)]


def test_batched_st_subblock_fits_match_jax(monkeypatch):
    """glm_laplace_fit_st on 3 chains' params stacked (D_stim=4, B=5, the
    seeds shared): each chain's θ* and −H* of both sub-blocks against the
    JAX update's own on that chain's params, 1e-6; (b) at JAX's post-(a)
    [bias, w_s] of each chain."""
    pop_j, pop_t, _, p_t, d_j, d_t = build_pair_light(_spec("spatiotemporal_glm", 3, D_stim=4), T=300)
    chains = _chains(pop_t, p_t)
    th0_t = {k: p_t[k] + 0.2 for k in ("bias", "w_stim_s", "w_stim_t")}
    th0_j = {k: jnp.asarray(to_np(v)) for k, v in th0_t.items()}
    modes, neg_h, after_a = _jax_fits_per_chain(monkeypatch, gibbs_j.update_glm_laplace_st, pop_j, chains, d_j,
                                                th0_j, ("bias", "w_stim_s"))
    assert [m.shape for m in modes] == [(3, 3, 5), (3, 3, 5)]
    batched = mcmc_t.stack_states(chains)
    fit_a, _ = gibbs_t.glm_laplace_fit_st(pop_t, batched, d_t, th0_t)
    _, fit_b = gibbs_t.glm_laplace_fit_st(pop_t, {**batched, **after_a}, d_t, th0_t)
    for fit, mode, nh in ((fit_a, modes[0], neg_h[0]), (fit_b, modes[1], neg_h[1])):
        assert fit[0].shape == (3, 3, 5) and fit[1].shape == (3, 3, 5, 5)
        for c in range(3):
            _assert_fit((fit[0][c], fit[1][c]), mode[c], nh[c])


def test_batched_shared_subblock_fits_match_jax(monkeypatch):
    """glm_laplace_fit_shared on 3 chains' params stacked (DB=3, the seeds
    shared): each chain's [bias, gain] θ* and −H*, and its pooled
    global-filter mode and −H*, against the JAX update's own on that
    chain's params, 1e-6; (b) at JAX's post-(a) [bias, gain] of each
    chain."""
    pop_j, pop_t, _, p_t, d_j, d_t = build_pair_light(_spec("standard_glm", 3, bkgd=SHARED_BKGD), T=300)
    chains = _chains(pop_t, p_t)
    th0_t = {"bias": p_t["bias"] - 0.3, "gain": p_t["gain"] + 0.2, "w_stim_shared": p_t["w_stim_shared"] + 0.2}
    th0_j = {k: jnp.asarray(to_np(v)) for k, v in th0_t.items()}
    modes, neg_h, after_a = _jax_fits_per_chain(monkeypatch, gibbs_j.update_glm_laplace_shared, pop_j, chains,
                                                d_j, th0_j, ("bias", "gain"))
    assert [m.shape for m in modes] == [(3, 3, 2), (3, 3)] and [h.shape for h in neg_h] == [(3, 3, 2, 2), (3, 3, 3)]
    batched = mcmc_t.stack_states(chains)
    fit_a, _ = gibbs_t.glm_laplace_fit_shared(pop_t, batched, d_t, th0_t)
    _, fit_b = gibbs_t.glm_laplace_fit_shared(pop_t, {**batched, **after_a}, d_t, th0_t)
    assert fit_a[0].shape == (3, 3, 2) and fit_b[0].shape == (3, 1, 3) and fit_b[1].shape == (3, 1, 3, 3)
    for fit, mode, nh in ((fit_a, modes[0], neg_h[0]), (fit_b, modes[1], neg_h[1])):
        for c in range(3):
            _assert_fit((fit[0][c], fit[1][c]), mode[c], nh[c])


def test_whitening_factor_and_whitened_leapfrog_match_jax():
    """glm_update='hmc': the port's R against JAX's sweep closure (Rᵀ and
    R⁻ᵀ) to 1e-12, the whitened start position, then 5 leapfrog steps of
    the whitened glm log-density from the same momentum and scales: 1e-6."""
    pop_j, pop_t, p_j, p_t, d_j, d_t = build_pair_light(_spec("distance_weighted_model", 3), T=200)
    whiten_j = _cell(mcmc_j.make_sweep(pop_j, d_j, glm_update="hmc"), "_whiten")
    R_T, R_inv_T = np.asarray(_cell(whiten_j, "R_T")), np.asarray(_cell(whiten_j, "R_inv_T"))
    R = mcmc_t.whitening_factor(d_t["X_stim"])
    assert rel_err(R.T, R_T) < 1e-12
    w = torch.tensor(np.random.RandomState(1).randn(3, 5))
    assert rel_err(mcmc_t._whitened({"w_stim": w}, R, inverse=True)["w_stim"], to_np(w) @ R_inv_T) < 1e-12
    assert rel_err(mcmc_t._whitened({"w_stim": w}, R)["w_stim"], to_np(w) @ R_T) < 1e-12

    beta = 0.7
    q_t, logp_t = mcmc_t._glm_hmc_target(pop_t, p_t, d_t, R, beta)
    frozen = {k: v for k, v in p_j.items() if k not in ("bias", "w_stim")}
    d_g = {**d_j, "_G": pop_j.coupling(p_j)}
    I_coupling = pop_j.impulse.current(p_j, d_g)

    def logp_j(o):  # the glm branch of JAX's sweep with its closure's R⁻ᵀ
        p = {**frozen, **o, "w_stim": o["w_stim"] @ R_inv_T}
        I = pop_j.bias.current(p, d_j) + pop_j.bkgd.current(p, d_j) + I_coupling
        ll = jnp.sum(pop_j.observation.log_likelihood(d_j["S"], I, pop_j.nlin, pop_j.dt))
        return beta * ll + pop_j.bias.log_prior(p) + pop_j.bkgd.log_prior(p)

    q_j = {"bias": p_j["bias"], "w_stim": p_j["w_stim"] @ R_T}
    for k in q_j:
        assert rel_err(q_t[k], q_j[k]) < 1e-12
    r = np.random.RandomState(2)
    mom = {k: r.randn(*np.shape(v)) for k, v in q_j.items()}
    scale = {k: r.uniform(0.5, 1.5, np.shape(v)) for k, v in q_j.items()}
    assert rel_err(logp_t(q_t), logp_j(q_j)) < 1e-10
    out_t = hmc_t._leapfrog(logp_t, q_t, {k: torch.tensor(v) for k, v in mom.items()}, 0.05,
                            {k: torch.tensor(v) for k, v in scale.items()}, 5)
    out_j = hmc_j._leapfrog(logp_j, q_j, {k: jnp.asarray(v) for k, v in mom.items()}, 0.05,
                            {k: jnp.asarray(v) for k, v in scale.items()}, 5)
    for got, want in zip(out_t[:2], out_j[:2]):
        for k in want:
            assert rel_err(got[k], want[k]) < 1e-6, k
    assert rel_err(out_t[2], out_j[2]) < 1e-6


# ---------------------------------------------------------------------------
# stochastic updates against exact laws
# ---------------------------------------------------------------------------


def _assert_matches_quadrature(draws, grid, logp):
    """Mean within 4 standard errors, sd within 10 %, KS distance < 0.06."""
    w = np.exp(logp - logp.max())
    w /= w.sum()
    m = (w * grid).sum()
    s = math.sqrt((w * (grid - m) ** 2).sum())
    assert abs(draws.mean() - m) < 4 * s / math.sqrt(len(draws)), (draws.mean(), m)
    assert abs(draws.std() - s) < 0.1 * s, (draws.std(), s)
    cdf = np.interp(np.sort(draws), grid, np.cumsum(w))
    assert np.max(np.abs(cdf - (np.arange(len(draws)) + 0.5) / len(draws))) < 0.06


def test_st_subblock_b_matches_quadrature():
    """Sub-block (b) alone (D_stim=1, one basis column, so w_t[n] is 1-D),
    [bias, w_s] held: 2,000 Laplace-MH draws per neuron against quadrature
    of the exact conditional."""
    T = 300
    spec = _spec("spatiotemporal_glm", 2, D_stim=1, n_bas=1)
    spikes = np.random.RandomState(1).poisson(0.05, (T, 2)).astype(float)
    pop_t, p_t, d_t = (build_pair_light(spec, T=T, spikes=spikes)[i] for i in (1, 3, 5))
    Phi, I0, theta, mu, sd = gibbs_t._st_block_b(pop_t, p_t, d_t, gibbs_t._coupling_current(pop_t, p_t, d_t))
    assert Phi.shape == (2, T, 1) and theta.shape == (2, 1)
    g, draws, accs = torch.Generator().manual_seed(0), [], []
    for _ in range(2000):
        theta, acc = gibbs_t._laplace_mh_block(g, d_t["S"], pop_t.dt, pop_t.observation, pop_t.nlin, I0, Phi,
                                               theta, p_t["w_stim_t"], mu, sd)
        draws.append(to_np(theta[:, 0]))
        accs.append(to_np(acc))
    draws = np.stack(draws)
    assert np.mean(accs) > 0.5
    grid = np.linspace(-6.0, 6.0, 24001)
    S, I0n, Phin = to_np(d_t["S"]), to_np(I0), to_np(Phi)
    for n in range(2):
        I = torch.tensor(I0n[None, :, n] + grid[:, None] * Phin[None, n, :, 0])
        ll = to_np(pop_t.observation.log_likelihood(torch.tensor(S[:, n]), I, pop_t.nlin, pop_t.dt).sum(1))
        _assert_matches_quadrature(draws[:, n], grid, ll - 0.5 * ((grid - float(mu[0])) / float(sd[0])) ** 2)


def test_shared_global_filter_matches_quadrature():
    """Sub-block (b) alone with DB=1 (D_stim=1, one basis column), bias and
    gain held: 2,000 draws of the pooled global filter against quadrature
    of its exact conditional."""
    T = 300
    bkgd = {**SHARED_BKGD, "basis": {**SHARED_BKGD["basis"], "n_bas": 1}}
    spikes = np.random.RandomState(2).poisson(0.05, (T, 3)).astype(float)
    pop_t, p_t, d_t = (build_pair_light(_spec("standard_glm", 3, bkgd=bkgd), T=T, spikes=spikes)[i] for i in (1, 3, 5))
    X, I0, gain, s_mu, s_sd = gibbs_t._shared_filter_inputs(pop_t, p_t, d_t, gibbs_t._coupling_current(pop_t, p_t, d_t))
    assert X.shape == (T, 1)
    g, w, draws, accs = torch.Generator().manual_seed(0), p_t["w_stim_shared"], [], []
    for _ in range(2000):
        w, acc = gibbs_t._shared_filter_mh(g, pop_t, d_t, X, I0, gain, s_mu, s_sd, w, p_t["w_stim_shared"])
        draws.append(float(w[0]))
        accs.append(float(acc))
    assert np.mean(accs) > 0.5
    grid = np.linspace(-5.0, 5.0, 20001)
    I = I0[None] + torch.tensor(grid)[:, None, None] * (X[:, 0, None] * gain)[None]
    ll = to_np(pop_t.observation.log_likelihood(d_t["S"][None], I, pop_t.nlin, pop_t.dt).sum((1, 2)))
    _assert_matches_quadrature(np.array(draws), grid, ll - 0.5 * ((grid - s_mu) / s_sd) ** 2)


def test_glm_laplace_shared_escapes_remote_state():
    """The JAX regression carried over: from a global filter parked ~200
    prior sds out, under softplus (whose likelihood stays finite and nearly
    flat there), the defensive prior mixture of the single global MH must
    free the filter within five sweeps."""
    spec = _spec("sparse_weighted_model", 3, nlin={"type": "softplus"}, bkgd=SHARED_BKGD)
    pop = pt.Population(spec, device="cpu", dtype=torch.float64)
    params = pop.sample(torch.Generator().manual_seed(0))
    stim = np.random.RandomState(0).randn(400, 1)
    S, _ = pop.simulate(torch.Generator().manual_seed(1), params, 400, stim=stim)
    S[50, :] = 1.0  # spiking bins exist
    data = pop.prepare_data(S, stim=stim)
    DB = data["X_stim"].shape[1]
    params["w_stim_shared"] = torch.full((DB,), -100.0, dtype=torch.float64)
    theta0 = {"bias": torch.full((3,), 1.5, dtype=torch.float64), "gain": torch.ones(3, dtype=torch.float64),
              "w_stim_shared": torch.zeros(DB, dtype=torch.float64)}
    p, moved = params, False
    for i in range(5):
        p = gibbs_t.update_glm_laplace_shared(torch.Generator().manual_seed(10 + i), pop, p, data, theta0)
        assert bool(torch.isfinite(p["w_stim_shared"]).all())
        moved = moved or not np.allclose(to_np(p["w_stim_shared"]), -100.0)
    assert moved, "global shared-filter MH frozen at the remote state"


@pytest.mark.parametrize("name,spec_kw,kw", [
    ("spatiotemporal_glm", {"D_stim": 4}, {}),
    ("standard_glm", {"bkgd": SHARED_BKGD}, {}),
    ("sparse_weighted_model", {"nlin": {"type": "softplus"}}, {}),
    ("sparse_weighted_model", {"observation": {"type": "bernoulli"}}, {}),
    ("distance_weighted_model", {}, {"glm_update": "hmc"}),
])
def test_variant_samplers_run(name, spec_kw, kw):
    """gibbs_sample on each variant (N=3, T=300, float64): JAX's sample
    shapes, finite draws, A binary, accept rates in (0, 1]."""
    pop_j, pop_t, p_j, p_t, d_j, d_t = build_pair_light(_spec(name, 3, **spec_kw), T=300)
    samples, diag, _ = gibbs_sample(pop_t, d_t, torch.Generator().manual_seed(0), n_samples=4, n_warmup=6,
                                    init_params=p_t, n_leapfrog=3, chunk_size=5, **kw)
    assert {k: v.shape for k, v in samples.items()} == {k: (4,) + tuple(v.shape) for k, v in p_t.items()}
    assert all(np.isfinite(v).all() for v in samples.values()) and np.isin(samples["A"], (0.0, 1.0)).all()
    for k, v in diag.items():
        if k.startswith("accept_rate"):
            assert 0.0 < v <= 1.0, (k, v)
