"""The port's inference (smart init, L-BFGS MAP, HMC) against the JAX
package, and the flagship slice end to end at a small size on the CPU."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theano_pyglm_torch as pt
import theano_pyglm_tpu as tpu
from theano_pyglm_torch.inference.map import lbfgs_minimize, map_fit, split_params
from theano_pyglm_torch.inference.smart_init import smart_initialize
from theano_pyglm_torch.ops import kernels
from theano_pyglm_torch.utils.convert import params_from_numpy
from theano_pyglm_tpu.inference.map import map_fit as map_fit_j
from theano_pyglm_tpu.inference.map import split_params as split_j
from theano_pyglm_tpu.inference.smart_init import smart_initialize as smart_init_j
from torch_parity import build_pair, rel_err, to_np

F64 = torch.float64
# the modules (the packages' ``inference.hmc`` attribute is the function)
hmc_t = importlib.import_module("theano_pyglm_torch.inference.hmc")
hmc_j = importlib.import_module("theano_pyglm_tpu.inference.hmc")


def test_split_params():
    p = {"bias": 1, "W": 2, "A": 3, "y": 4, "locs": 5}
    opt, frozen = split_params(p)
    assert opt == {"bias": 1, "W": 2, "locs": 5} and frozen == {"A": 3, "y": 4}
    assert split_params(p, ("A",)) == ({"A": 3}, {"bias": 1, "W": 2, "y": 4, "locs": 5})


@pytest.mark.parametrize("name,N", [("distance_weighted_model", 4), ("standard_glm", 3), ("sbm_weighted_model", 6)])
def test_smart_initialize_matches_jax(name, N):
    """The data-driven leaves do not depend on the base draw: 1e-9 relative
    in float64 (same least squares and correlations, other summation order)."""
    S = np.random.RandomState(4).poisson(0.08, (2000, N)).astype(float)
    pop_j, pop_t, _, _, d_j, d_t = build_pair(name, N, T=2000, spikes=S)
    init_j = smart_init_j(pop_j, d_j, jax.random.PRNGKey(0))
    init_t = smart_initialize(pop_t, d_t, torch.Generator().manual_seed(0))
    assert set(init_t) == set(init_j)
    for k in ("bias", "w_stim", "w_ir", "W", "A", "y", "pi", "Bm"):
        if k in init_j:
            np.testing.assert_allclose(to_np(init_t[k]), np.asarray(init_j[k]), rtol=1e-9, atol=1e-12, err_msg=k)


def _hmc_pair(seed=0):
    """Log-joints over the continuous block of one model, in both packages."""
    pop_j, pop_t, p_j, p_t, d_j, d_t = build_pair("distance_weighted_model", 3, T=400, seed=seed)
    q_j, fr_j = split_j(p_j)
    q_t, fr_t = split_params(p_t)
    logp_j = lambda q: pop_j.log_joint({**fr_j, **q}, d_j)  # noqa: E731
    logp_t = lambda q: pop_t.log_joint({**fr_t, **q}, d_t)  # noqa: E731
    return logp_j, logp_t, q_j, q_t


def test_leapfrog_matches_jax():
    """Same momentum (numpy), step size and scales: the trajectory's end
    point, momentum and log-density agree to 1e-6 relative in float64."""
    logp_j, logp_t, q_j, q_t = _hmc_pair()
    r = np.random.RandomState(7)
    p = {k: r.randn(*np.shape(v)) for k, v in q_j.items()}
    scale = {k: r.uniform(0.5, 1.5, np.shape(v)) for k, v in q_j.items()}
    eps, n = 2e-3, 6
    qj, pj, lpj = hmc_j._leapfrog(
        logp_j, q_j, {k: jnp.asarray(v) for k, v in p.items()}, eps,
        {k: jnp.asarray(v) for k, v in scale.items()}, n,
    )
    qt, pt_, lpt = hmc_t._leapfrog(
        logp_t, q_t, params_from_numpy(p, dtype=F64), eps, params_from_numpy(scale, dtype=F64), n
    )
    assert abs(float(lpt) - float(lpj)) <= 1e-6 * abs(float(lpj))
    for k in q_j:
        assert rel_err(qt[k], qj[k]) < 1e-6, k
        assert rel_err(pt_[k], pj[k]) < 1e-6, k


def test_hmc_accept_prob_matches_jax():
    """JAX's ``hmc`` with a key and the port's transition fed the momentum and
    uniform that key gives: the same accept probability and outcome (1e-6)."""
    logp_j, logp_t, q_j, q_t = _hmc_pair(seed=1)
    lp_j, lp_t = logp_j(q_j), logp_t(q_t)
    key = jax.random.PRNGKey(3)
    for eps in (1e-3, 2e-2):  # a likely accept and a likely reject
        qj, lpj, acc_j = hmc_j.hmc(key, logp_j, q_j, lp_j, eps, 5)
        # the draws hmc_j.hmc makes from that key
        k_mom, k_acc = jax.random.split(key)
        leaves, treedef = jax.tree.flatten(q_j)
        p0 = treedef.unflatten([
            jax.random.normal(k, x.shape, x.dtype)
            for k, x in zip(jax.random.split(k_mom, len(leaves)), leaves)
        ])
        u = float(jax.random.uniform(k_acc))
        scale = {k: torch.ones_like(v) for k, v in q_t.items()}
        qt, lpt, acc_t = hmc_t._hmc_transition(
            logp_t, q_t, lp_t, eps, 5, scale, params_from_numpy(p0, dtype=F64), torch.tensor(u, dtype=F64)
        )
        assert abs(float(acc_t) - float(acc_j)) <= 1e-6 * max(float(acc_j), 1e-3), eps
        assert abs(float(lpt) - float(lpj)) <= 1e-6 * abs(float(lpj))
        for k in q_j:
            assert rel_err(qt[k], qj[k]) < 1e-6, k


def test_mass_matrix_bookkeeping_matches_jax():
    """apply_mass_matrix / reset_variance on the same statistics: 1e-12."""
    r = np.random.RandomState(0)
    pos = {"a": r.randn(3), "b": r.randn(2, 2)}
    m2 = {k: r.uniform(0.1, 2.0, v.shape) for k, v in pos.items()}
    st_j = hmc_j.hmc_init({k: jnp.asarray(v) for k, v in pos.items()}, lambda q: -jnp.sum(q["a"] ** 2), 0.05)
    st_j = st_j._replace(pos_m2={k: jnp.asarray(v) for k, v in m2.items()}, n_var=jnp.asarray(12.0))
    st_t = hmc_t.hmc_init(params_from_numpy(pos, dtype=F64), lambda q: -torch.sum(q["a"] ** 2), 0.05)
    st_t = st_t._replace(pos_m2=params_from_numpy(m2, dtype=F64), n_var=torch.tensor(12.0, dtype=F64))
    a_j, a_t = hmc_j.apply_mass_matrix(st_j), hmc_t.apply_mass_matrix(st_t)
    for k in pos:
        np.testing.assert_allclose(to_np(a_t.scale[k]), np.asarray(a_j.scale[k]), rtol=1e-12)
    for f in ("step_size", "mu", "log_eps_avg", "h_avg", "t"):
        np.testing.assert_allclose(float(getattr(a_t, f)), float(getattr(a_j, f)), rtol=1e-12)
    z = hmc_t.reset_variance(st_t)
    assert float(z.n_var) == 0.0 and all(float(v.abs().sum()) == 0.0 for v in z.pos_m2.values())


def test_hmc_gaussian_target_moments():
    """Adaptive HMC on N(mu, diag sig²): sample moments within 0.2 (mean)
    and 20 % (sd) after 300 warmup and 2000 draws. Four leapfrog steps keep
    every coordinate's trajectory well short of a full period (with ten,
    the adapted step makes the unit-sd coordinate nearly return to its start
    and the chain mixes it slowly)."""
    mu = torch.tensor([1.0, -2.0, 0.5], dtype=F64)
    sig = torch.tensor([0.5, 2.0, 1.0], dtype=F64)

    def logp(q):
        z = (q["x"] - mu) / sig
        return -0.5 * torch.sum(z * z)

    g = torch.Generator().manual_seed(0)
    state = hmc_t.hmc_init({"x": torch.zeros(3, dtype=F64)}, logp, step_size=0.1)
    for _ in range(300):
        state = hmc_t.hmc_adaptive_step(g, logp, state, n_steps=4, target_accept=0.8)
    draws = []
    for _ in range(2000):
        state = hmc_t.hmc_adaptive_step(g, logp, state, n_steps=4, target_accept=0.8, adapt=False)
        draws.append(state.position["x"])
    x = torch.stack(draws).numpy()
    assert 0.5 < float(state.accept_rate) <= 1.0
    np.testing.assert_allclose(x.mean(0), mu.numpy(), atol=0.2)
    np.testing.assert_allclose(x.std(0), sig.numpy(), rtol=0.2)


def test_hmc_divergence_rejected():
    def logp(q):
        return -torch.sum(q["x"] ** 4) * 1e8

    q0 = {"x": torch.ones(2, dtype=F64)}
    q, lp, acc = hmc_t.hmc(torch.Generator().manual_seed(0), logp, q0, logp(q0), 10.0, 5)
    assert torch.all(torch.isfinite(q["x"])) and float(acc) == 0.0
    np.testing.assert_allclose(q["x"].numpy(), 1.0)


def test_lbfgs_minimize_quadratic():
    A = torch.tensor([[3.0, 0.5], [0.5, 1.0]], dtype=F64)
    b = torch.tensor([1.0, -2.0], dtype=F64)

    def f(x):
        v = x["v"]
        return 0.5 * v @ A @ v - b @ v + (x["w"] - 3.0).pow(2).sum()

    x, val, iters = lbfgs_minimize(f, {"v": torch.zeros(2, dtype=F64), "w": torch.zeros(3, dtype=F64)})
    np.testing.assert_allclose(x["v"].numpy(), torch.linalg.solve(A, b).numpy(), atol=1e-6)
    np.testing.assert_allclose(x["w"].numpy(), 3.0, atol=1e-6)
    assert 2 <= iters < 50 and not x["v"].requires_grad


def test_map_fit_matches_jax():
    """JAX-simulated spikes (N=4, T=2,000), the same init: the port's MAP
    log-joint is no lower than at init and within 1e-4 relative of JAX's
    (different line searches reach the same optimum to that precision)."""
    spec = tpu.make_model("distance_weighted_model", 4)
    spec["bias"] = {"mu": 3.0, "sigma": 0.4}
    pop_j = tpu.Population(spec)
    true = pop_j.sample(jax.random.PRNGKey(2))
    stim = np.random.RandomState(0).randn(2000, 1)
    S, _ = pop_j.simulate(jax.random.PRNGKey(3), true, 2000, stim=stim)
    d_j = pop_j.prepare_data(S, stim=stim)
    init_j = smart_init_j(pop_j, d_j, jax.random.PRNGKey(1))
    fit_j, lp_j, _ = map_fit_j(pop_j, d_j, init_j, max_iter=300)

    pop_t = pt.Population(spec, dtype=F64)
    d_t = pop_t.prepare_data(np.array(S), stim=stim)
    init_t = params_from_numpy({k: np.asarray(v) for k, v in init_j.items()}, dtype=F64)
    lp_init = float(pop_t.log_joint(init_t, d_t))
    fit_t, lp_t, iters = map_fit(pop_t, d_t, init_t, max_iter=300)
    lp_t = float(lp_t)
    assert np.isfinite(lp_t) and lp_t >= lp_init
    assert abs(lp_t - float(lp_j)) <= 1e-4 * abs(float(lp_j)), (lp_t, float(lp_j), iters)
    np.testing.assert_allclose(lp_t, float(pop_t.log_joint(fit_t, d_t)), rtol=1e-12)


def test_flagship_slice_small_float32():
    """The chip smoke's main path at N=4, T=2,000 in float32 on the CPU:
    simulate → prepare → smart init → MAP → 5 HMC transitions with A fixed.
    Finite throughout, MAP no worse than the smart init; the CPU path
    launches no kernel."""
    before = dict(kernels.LAUNCHES)
    spec = pt.make_model("distance_weighted_model", 4, bias={"mu": 3.0, "sigma": 0.4})
    pop = pt.Population(spec)
    assert pop.dtype == torch.float32 and pop.use_fused
    g = torch.Generator().manual_seed(0)
    true = pop.sample(g)
    stim = torch.randn((2000, 1), generator=g)
    S, rates = pop.simulate(g, true, 2000, stim=stim)
    assert torch.isfinite(rates).all() and 0 < float(rates.mean()) < 1000.0
    data = pop.prepare_data(S, stim=stim)
    init = smart_initialize(pop, data, g)
    with torch.no_grad():
        lp_init = float(pop.log_joint(init, data))
    fit, lp_map, iters = map_fit(pop, data, init, max_iter=200)
    assert np.isfinite(float(lp_map)) and float(lp_map) >= lp_init and iters >= 2

    q0, frozen = split_params(fit)
    logp = lambda q: pop.log_joint({**frozen, **q}, data)  # noqa: E731
    state = hmc_t.hmc_init(q0, logp, step_size=1e-3)
    for _ in range(5):
        state = hmc_t.hmc_adaptive_step(g, logp, state, n_steps=10)
    assert torch.isfinite(state.log_prob) and all(torch.isfinite(v).all() for v in state.position.values())
    assert kernels.LAUNCHES == before
