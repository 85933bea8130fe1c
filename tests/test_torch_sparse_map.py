"""The port's sparse MAP with cross-validated λ
(theano_pyglm_torch/inference/map.py) against the JAX package, and the
port's acceptance runner (theano_pyglm_torch/scripts/acceptance.py), on the
CPU.

The penalized objective and its gradient equal JAX's to 1e-6 relative in
float64, with one data segment and with two; the fold slices are JAX's
formula. The two packages' L-BFGS line searches take different steps, so
the fits are held to outcomes: the lasso shrinks the coupling, and on the
same spikes cross-validation picks JAX's λ with held-out scores within
1e-3 relative of JAX's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theano_pyglm_torch as pt
import theano_pyglm_tpu as tpu
from theano_pyglm_torch.inference import cross_validate_lambda, sparse_map_fit
from theano_pyglm_torch.inference.map import (
    _objective,
    _xv_folds,
    heldout_log_likelihood,
    map_fit,
    split_params,
)
from theano_pyglm_torch.scripts import acceptance
from theano_pyglm_torch.utils.convert import params_from_numpy
from theano_pyglm_tpu.inference import cross_validate_lambda as xv_j
from theano_pyglm_tpu.inference.map import heldout_log_likelihood as heldout_j
from theano_pyglm_tpu.inference.map import split_params as split_j
from torch_parity import build_pair_light, rel_err, to_np

F64 = torch.float64
LAM, EPS = 2.5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the other
    test workers (many times slower under pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_data(pop_t, S, stim):
    """JAX's data dict from the port's prepare_data (held to JAX's in
    tests/test_torch_population.py; JAX's own compiles ~20 s per shape)."""
    return {k: jnp.asarray(to_np(v)) for k, v in pop_t.prepare_data(S, stim=stim).items()}


@pytest.mark.parametrize("n_segments", [1, 2])
def test_penalized_objective_and_gradient_match_jax(n_segments):
    """−log_joint + λ·Σ√(off² + ε²) (one segment, JAX's _map_fit_jit) and
    −log_prior − Σ_seg log_likelihood + penalty (two, _map_fit_multi_jit):
    value and gradient over the continuous block, 1e-6 relative."""
    spec = tpu.make_model("sparse_weighted_model", 3)
    pop_j, pop_t, p_j, p_t, d_j, d_t = build_pair_light(spec, T=400, seed=1)
    if n_segments == 1:
        datas_t, datas_j = (d_t,), (d_j,)
    else:
        r = np.random.RandomState(5)
        S, stim = r.poisson(0.05, (400, 3)).astype(float), r.randn(400, 1)
        datas_t = tuple(pop_t.prepare_data(S[sl], stim=stim[sl]) for sl in (slice(0, 150), slice(250, 400)))
        datas_j = tuple({k: jnp.asarray(to_np(v)) for k, v in d.items()} for d in datas_t)

    q_j, fr_j = split_j(p_j)

    def obj_j(q):
        p = {**fr_j, **q}
        if n_segments == 1:
            nlp = -pop_j.log_joint(p, datas_j[0])
        else:
            nlp = -pop_j.log_prior(p) - sum(pop_j.log_likelihood(p, d) for d in datas_j)
        off = q["W"] * (1.0 - jnp.eye(3))
        return nlp + LAM * jnp.sum(jnp.sqrt(off * off + EPS * EPS))

    val_j, grad_j = jax.value_and_grad(obj_j)(q_j)
    q_t, fr_t = split_params(p_t)
    q_t = {k: v.clone().requires_grad_(True) for k, v in q_t.items()}
    val_t = _objective(pop_t, fr_t, datas_t, LAM, EPS)(q_t)
    val_t.backward()
    assert rel_err(val_t.detach(), val_j) < 1e-6
    for k in q_j:
        assert rel_err(q_t[k].grad, grad_j[k]) < 1e-6, k


def test_heldout_log_likelihood_is_the_log_likelihood():
    pop_j, pop_t, p_j, p_t, d_j, d_t = build_pair_light(tpu.make_model("sparse_weighted_model", 4), T=300)
    ll = heldout_log_likelihood(pop_t, p_t, d_t)
    assert not ll.requires_grad and float(ll) == float(pop_t.log_likelihood(p_t, d_t))
    assert rel_err(ll, heldout_j(pop_j, p_j, d_j)) < 1e-10


def _jax_folds(T, n_folds, train_frac):
    """The fold slices of the JAX package's cross_validate_lambda
    (theano_pyglm_tpu/inference/map.py:174-187), verbatim."""
    if n_folds <= 1:
        T_tr = int(T * train_frac)
        return [((slice(0, T_tr),), slice(T_tr, T))]
    edges = [int(round(i * T / n_folds)) for i in range(n_folds + 1)]
    folds = []
    for i in range(n_folds):
        val = slice(edges[i], edges[i + 1])
        train = tuple(s for s in (slice(0, edges[i]), slice(edges[i + 1], T)) if s.stop > s.start)
        folds.append((train, val))
    return folds


def test_fold_slices_are_jax_formula():
    """Same slices as JAX's for every (T, n_folds, train_frac); each fold's
    training segments and validation block tile [0, T) without overlap."""
    for T in (7, 100, 3_000, 3_001, 240_000):
        for n_folds in (0, 1, 2, 3, 5):
            for frac in (0.8, 0.5):
                folds = _xv_folds(T, n_folds, frac)
                assert folds == _jax_folds(T, n_folds, frac), (T, n_folds, frac)
                for train, val in folds:
                    covered = sorted([(s.start, s.stop) for s in train] + [(val.start, val.stop)])
                    assert covered[0][0] == 0 and covered[-1][1] == T
                    assert all(a[1] == b[0] for a, b in zip(covered, covered[1:]))


def test_sparse_map_shrinks_weights():
    """λ=50 cuts the off-diagonal L1 of the dense MAP by more than half
    (mirrors tests/test_map.py:49): N=4, T=4,000, A all ones."""
    spec = pt.make_model("sparse_weighted_model", 4)
    pop = pt.Population(spec, device="cpu", dtype=F64)
    g = torch.Generator().manual_seed(5)
    true = pop.sample(g)
    stim = np.random.RandomState(0).randn(4000, 1)
    S, _ = pop.simulate(g, true, 4000, stim=stim)
    data = pop.prepare_data(S, stim=stim)
    init = {**true, "A": torch.ones_like(true["A"])}
    fit0, _, _ = map_fit(pop, data, init, max_iter=200)
    fit1, logp1, _ = sparse_map_fit(pop, data, init, lam=50.0, max_iter=200)
    off = ~torch.eye(4, dtype=torch.bool)
    l1_0, l1_1 = float(fit0["W"][off].abs().sum()), float(fit1["W"][off].abs().sum())
    assert l1_1 < 0.5 * l1_0, (l1_0, l1_1)
    assert torch.isfinite(logp1) and torch.equal(fit1["A"], init["A"])


def test_cross_validate_lambda_matches_jax():
    """JAX-simulated spikes (N=3, T=3,000, tests/test_map.py:67), the same
    init, λ ∈ {0.1, 10}, one 80/20 split: both packages pick the same λ and
    the port's held-out scores are within 1e-3 relative of JAX's. JAX's
    function runs as it is, with its population's prepare_data built from
    the port's."""
    spec = tpu.make_model("sparse_weighted_model", 3)
    pop_j = tpu.Population(spec)
    true = pop_j.sample(jax.random.PRNGKey(5))
    stim = np.random.RandomState(0).randn(3000, 1)
    S, _ = pop_j.simulate(jax.random.PRNGKey(6), true, 3000, stim=stim)
    S = np.array(S)
    pop_t = pt.Population(spec, device="cpu", dtype=F64)
    pop_j.prepare_data = lambda S_, stim=None: _jax_data(pop_t, S_, stim)
    init_j = {**true, "A": jnp.ones((3, 3))}
    best_j, _, scores_j = xv_j(pop_j, S, stim, init_j, lambdas=[0.1, 10.0], max_iter=100)

    init_t = params_from_numpy({k: np.asarray(v) for k, v in init_j.items()}, device="cpu", dtype=F64)
    best_t, fits_t, scores_t = cross_validate_lambda(pop_t, S, stim, init_t, [0.1, 10.0], max_iter=100)
    assert best_t == best_j and len(fits_t) == 2 and all(f is not None for f in fits_t)
    np.testing.assert_allclose(scores_t, scores_j, rtol=1e-3)


REPORT_JAX = os.path.join(os.path.dirname(__file__), "..", "results", "acceptance_r5", "acceptance_report.json")

#: CPU-sized keyword arguments of the acceptance configs (below --quick)
TINY = {
    1: dict(T=1_000),
    2: dict(T=1_500, lambdas=(0.1, 10.0), n_folds=2, xv_iter=20, map_iter=20, refit_iter=20, n_post=4,
            post_warmup=2),
    3: dict(T=800, map_iter=20, n_samples=4, n_warmup=2),
    4: dict(T=800, n_samples=3, n_chains=2),
}


@pytest.mark.parametrize("c", sorted(TINY))
def test_acceptance_config_report_keys(c):
    """Each of configs 1–4 on the CPU at a tiny size gives the keys of the
    JAX package's report for that config."""
    with open(REPORT_JAX) as f:
        want = json.load(f)[acceptance.REPORT_KEYS[c]]
    got = acceptance.CONFIGS[c]("cpu", **TINY[c])
    assert set(got) == set(want)
    if c == 1:
        assert got["map_beats_truth"] and np.isfinite(got["log_joint"])
    if c == 4:
        assert len(got["planted_partition_ari_per_chain"]) == 2 and 1 <= got["types_used"] <= 2


def test_acceptance_main_writes_the_report(tmp_path):
    """The command line: --quick --device cpu --configs 1 writes
    acceptance_report.json with the device and config 1's entry."""
    acceptance.main(["--quick", "--device", "cpu", "--configs", "1", "-r", str(tmp_path)])
    with open(tmp_path / "acceptance_report.json") as f:
        report = json.load(f)
    assert set(report) == {"device", "config1_standard_glm_map"} and report["device"] == {"platform": "cpu"}
    with pytest.raises(ValueError, match="unknown configs"):
        acceptance.main(["--device", "cpu", "--configs", "6"])
