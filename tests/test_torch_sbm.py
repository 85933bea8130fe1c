"""The port's SBM and Erdős–Rényi Gibbs stages
(theano_pyglm_torch/inference/gibbs.py) against exact answers, and the SBM
model through the sampler, on the CPU.

The collapsed type conditionals equal brute-force log-marginal ratios to
1e-10 in float64. The random streams of the port and the JAX package
differ, so the stochastic stages are held to exact laws, mirroring
tests/test_gibbs.py: exact enumeration of p(y | A) (TV < 0.05), the mobility
regression from a parked partial assignment (mean ARI ≥ 0.9), and
Kolmogorov–Smirnov tests of the conjugate draws against scipy's Beta laws
(p > 1e-3 each).
"""

import itertools

import jax
import numpy as np
import pytest
import torch
from scipy import stats
from scipy.special import betaln, gammaln

import theano_pyglm_torch as pt
import theano_pyglm_torch.inference.gibbs as gibbs_t
import theano_pyglm_tpu as tpu
from theano_pyglm_torch.inference.mcmc import gibbs_sample
from theano_pyglm_torch.scripts import acceptance
from theano_pyglm_torch.utils.convert import params_from_numpy
from theano_pyglm_torch.utils.diagnostics import adjusted_rand_index
from torch_parity import jax_config4, rel_err, to_np

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the other
    test workers (many times slower under pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sbm_pop(N, K=2, **graph):
    spec = pt.make_model("sbm_weighted_model", N, bkgd={"type": "none"})
    spec["network"]["graph"].update(K=K, **graph)
    return pt.Population(spec, device="cpu", dtype=F64)


def _log_marginal(A, y, K, alpha0, b0, b1):
    """log p(y, A) up to a constant, (π, B) integrated out: Dirichlet–
    multinomial class counts and Beta–Bernoulli block edges over all N²
    ordered pairs, self-pairs included."""
    cnt = np.bincount(y, minlength=K).astype(float)
    onehot = np.eye(K)[y]
    E = onehot.T @ A @ onehot
    P = np.outer(cnt, cnt)
    return gammaln(alpha0 + cnt).sum() + betaln(b0 + E, b1 + (P - E)).sum()


def _tv(p, q):
    return 0.5 * np.abs(p - q).sum()


@pytest.mark.parametrize("K,alpha0,b_prior", [(2, 1.0, (1.0, 1.0)), (3, 0.7, (2.0, 0.5))])
def test_collapsed_type_logits_are_log_marginal_ratios(K, alpha0, b_prior):
    """For every neuron n and class k, logits[k] − logits[0] equals
    log p(y_n=k, y_−n, A) − log p(y_n=0, y_−n, A) to 1e-10 (float64)."""
    r = np.random.RandomState(K)
    N = 7
    A = (r.rand(N, N) < 0.4).astype(float)
    y = r.randint(0, K, N)
    b0, b1 = b_prior
    A_t, y_t = torch.tensor(A, dtype=F64), torch.tensor(y)
    for n in range(N):
        logits = gibbs_t._collapsed_type_logits(A_t, y_t, n, K, alpha0, b0, b1).numpy()
        assert logits.shape == (K,)
        want = []
        for k in range(K):
            yk = y.copy()
            yk[n] = k
            want.append(_log_marginal(A, yk, K, alpha0, b0, b1))
        np.testing.assert_allclose(logits - logits[0], np.array(want) - want[0], rtol=0, atol=1e-10)


def test_collapsed_type_kernel_targets_exact_marginal():
    """The collapsed type kernel iterated alone targets p(y | A): brute-force
    enumeration of y ∈ {0,1}³ (mirrors tests/test_gibbs.py:108)."""
    pop = _sbm_pop(3)
    params = pop.sample(torch.Generator().manual_seed(0))
    A = to_np(params["A"])
    exact = np.array([_log_marginal(A, np.array(y), 2, 1.0, 1.0, 1.0)
                      for y in itertools.product(range(2), repeat=3)])
    exact = np.exp(exact - exact.max())
    exact /= exact.sum()
    g = torch.Generator().manual_seed(3)
    ys = []
    for _ in range(8000):
        params = gibbs_t.update_sbm_types_collapsed(g, pop, params)
        ys.append(to_np(params["y"]))
    ys = np.array(ys[2000:])
    assert ys.dtype == np.int64
    emp = np.bincount(ys[:, 0] * 4 + ys[:, 1] * 2 + ys[:, 2], minlength=8) / len(ys)
    assert _tv(emp, exact) < 0.05, (emp, exact)


def test_collapsed_types_escape_adapted_B_mode():
    """From a parked partial assignment (5 of 16 neurons misassigned, B
    adapted to it), the collapsed (types, then hypers) pair recovers the
    planted partition: mean ARI ≥ 0.9 over sweeps 20–39 (mirrors
    tests/test_gibbs.py:154)."""
    N = 16
    pop = _sbm_pop(N)
    params = pop.sample(torch.Generator().manual_seed(0))
    y_true = np.array([0] * (N // 2) + [1] * (N - N // 2))
    Bm = np.array([[0.7, 0.05], [0.05, 0.7]])
    r = np.random.RandomState(0)
    A = (r.rand(N, N) < Bm[y_true[:, None], y_true[None, :]]).astype(float)
    np.fill_diagonal(A, 1.0)
    y_bad = y_true.copy()
    y_bad[[0, 3, 5, 9, 12]] = 1 - y_bad[[0, 3, 5, 9, 12]]
    g = torch.Generator().manual_seed(1)
    params = {**params, "A": torch.tensor(A, dtype=F64), "y": torch.tensor(y_bad)}
    params = gibbs_t.update_sbm_hypers(g, pop, params)
    aris = []
    for it in range(40):
        params = gibbs_t.update_sbm_hypers(g, pop, gibbs_t.update_sbm_types_collapsed(g, pop, params))
        if it >= 20:
            aris.append(adjusted_rand_index(to_np(params["y"]), y_true))
    assert np.mean(aris) >= 0.9, aris


def _ks(draws, dist):
    return stats.kstest(draws, dist.cdf).pvalue


def test_sbm_hypers_conjugate_posterior():
    """π ~ Dir(α0 + counts): each component's marginal Beta(α_k, Σα − α_k);
    B[k,k'] ~ Beta(b0 + edges, b1 + pairs − edges), clipped to
    [1e-6, 1 − 1e-6]. KS p > 1e-3 for every entry over 2,000 draws (mirrors
    tests/test_gibbs.py:208)."""
    pop = _sbm_pop(6, K=3, alpha0=0.8, B_prior=(2.0, 1.5))
    params = pop.sample(torch.Generator().manual_seed(0))
    params = {**params, "y": torch.tensor([0, 0, 1, 2, 2, 2])}
    A, y = to_np(params["A"]), to_np(params["y"])
    onehot = np.eye(3)[y]
    counts = onehot.sum(0)
    edges = onehot.T @ A @ onehot
    pairs = np.outer(counts, counts)
    g = torch.Generator().manual_seed(1)
    draws = [gibbs_t.update_sbm_hypers(g, pop, params) for _ in range(2000)]
    pis = np.stack([to_np(d["pi"]) for d in draws])
    Bs = np.stack([to_np(d["Bm"]) for d in draws])
    assert np.allclose(pis.sum(1), 1.0) and (pis > 0).all()
    assert (Bs >= 1e-6).all() and (Bs <= 1 - 1e-6).all()
    alpha = 0.8 + counts
    for k in range(3):
        assert _ks(pis[:, k], stats.beta(alpha[k], alpha.sum() - alpha[k])) > 1e-3, k
        for j in range(3):
            assert _ks(Bs[:, k, j], stats.beta(2.0 + edges[k, j], 1.5 + pairs[k, j] - edges[k, j])) > 1e-3, (k, j)
    assert all(torch.equal(d["y"], params["y"]) and d["A"] is params["A"] for d in draws[:5])


def test_er_rho_conjugate_posterior():
    """ρ ~ Beta(a0 + edges, b0 + N² − edges), the diagonal counted, clipped:
    KS p > 1e-3 over 2,000 draws (mirrors tests/test_gibbs.py:194)."""
    spec = pt.make_model("sparse_weighted_model", 5, bkgd={"type": "none"})
    spec["network"]["graph"].update({"infer_rho": True, "rho_prior": (2.0, 3.0)})
    pop = pt.Population(spec, device="cpu", dtype=F64)
    params = pop.sample(torch.Generator().manual_seed(0))
    e = float(params["A"].sum())
    g = torch.Generator().manual_seed(1)
    rhos = np.array([float(gibbs_t.update_er_rho(g, pop, params)["rho"]) for _ in range(2000)])
    assert _ks(rhos, stats.beta(2.0 + e, 3.0 + 25 - e)) > 1e-3
    assert gibbs_t.update_er_rho(g, pop, params)["rho"].shape == params["rho"].shape


def test_gibbs_sample_sbm_model():
    """The full sweep on sbm_weighted_model, N=4, T=300 (mirrors
    tests/test_mcmc.py:32): finite leaves, int types in range, π on the
    simplex, B in (0, 1), binary A."""
    spec = pt.make_model("sbm_weighted_model", 4, bkgd={"type": "none"})
    pop = pt.Population(spec, device="cpu")
    g = torch.Generator().manual_seed(0)
    true = pop.sample(g)
    S, _ = pop.simulate(g, true, 300)
    data = pop.prepare_data(S)
    samples, diag, state = gibbs_sample(pop, data, g, n_samples=25, n_warmup=25, chunk_size=25)
    assert samples["y"].shape == (25, 4) and samples["y"].dtype.kind == "i"
    assert ((samples["y"] >= 0) & (samples["y"] < 2)).all()
    assert samples["Bm"].shape == (25, 2, 2) and ((samples["Bm"] > 0) & (samples["Bm"] < 1)).all()
    np.testing.assert_allclose(samples["pi"].sum(1), 1.0, rtol=1e-6)
    assert ((samples["pi"] > 0) & (samples["pi"] < 1)).all()
    assert all(np.isfinite(v).all() for v in samples.values()) and np.isin(samples["A"], (0.0, 1.0)).all()
    assert state["params"]["y"].dtype == torch.int64 and 0.05 < diag["accept_rate_glm"] <= 1.0


def test_params_from_numpy_carries_a_jax_sbm_draw():
    """A JAX SBM draw crosses with int types and the same values; the port's
    log-prior at it equals JAX's to 1e-10 relative."""
    spec = tpu.make_model("sbm_weighted_model", 5)
    pop_j = tpu.Population(spec)
    p_j = pop_j.sample(jax.random.PRNGKey(3))
    p_t = params_from_numpy({k: np.asarray(v) for k, v in p_j.items()}, device="cpu", dtype=F64)
    assert p_t["y"].dtype == torch.int64 and p_t["pi"].dtype == F64
    for k, v in p_j.items():
        np.testing.assert_array_equal(to_np(p_t[k]), np.asarray(v), err_msg=k)
    pop_t = pt.Population(spec, device="cpu", dtype=F64)
    assert rel_err(pop_t.log_prior(p_t), pop_j.log_prior(p_j)) < 1e-10


def test_config4_reference_data_are_the_jax_recipe():
    """The port's copy of acceptance config 4's data (the npz of the
    acceptance runner) is what the JAX package's script draws at T=60,000,
    bit for bit; ``data4`` gives its first T bins with the script's
    stimulus, and the port's own draw plants the same A and W."""
    true_j, S_j = jax_config4()
    with np.load(acceptance.REFERENCE4) as ref:
        assert sorted(ref.files) == sorted(["S", *true_j])
        np.testing.assert_array_equal(ref["S"], S_j)
        for k, v in true_j.items():
            np.testing.assert_array_equal(ref[k], v, err_msg=k)
    pop, true, S, stim = acceptance.data4("cpu", 2_000)
    np.testing.assert_array_equal(to_np(S), S_j[:2_000])
    assert stim.shape == (2_000, 1) and true["y"].dtype == torch.int64
    for k, v in true_j.items():
        np.testing.assert_allclose(to_np(true[k]), v, rtol=1e-7, err_msg=k)
    _, own, _, _ = acceptance.data4("cpu", 200, reference=False)
    for k in ("A", "W", "y"):
        np.testing.assert_allclose(to_np(own[k]), true_j[k], rtol=1e-7, err_msg=k)
