"""The port's Population against the JAX package: design tensors, log-joint
and its gradient (float64 on the CPU, the 1e-6 bar of tests/test_loglik.py),
and the simulator's own consistency (the random streams differ)."""

import jax
import numpy as np
import pytest
import torch

import theano_pyglm_torch as pt
from theano_pyglm_tpu.inference.map import split_params as split_j
from theano_pyglm_torch.inference.map import split_params
from torch_parity import build_pair, rel_err, to_np

F64 = torch.float64

MODELS = [
    ("distance_weighted_model", 3),
    ("sparse_weighted_model", 3),
    ("standard_glm", 2),
    ("simple_weighted_model", 3),
    ("sbm_weighted_model", 4),
    ("spatiotemporal_glm", 2),
]


@pytest.mark.parametrize("name,N", MODELS[:3])
def test_prepare_data_matches_jax(name, N):
    """Same convolutions and normalizer in float64: 1e-10 relative."""
    _, _, _, _, d_j, d_t = build_pair(name, N)
    assert set(d_t) == set(d_j)
    for k in d_j:
        np.testing.assert_allclose(to_np(d_t[k]), np.asarray(d_j[k]), rtol=1e-10, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("name,N", MODELS)
def test_log_joint_and_grad_match_jax(name, N):
    """Log-joint and its gradient over the continuous block: 1e-6 relative
    in float64 (tests/test_loglik.py's bar)."""
    pop_j, pop_t, p_j, p_t, d_j, d_t = build_pair(name, N)
    want = float(pop_j.log_joint(p_j, d_j))
    got = float(pop_t.log_joint(p_t, d_t))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)

    opt_j, fr_j = split_j(p_j)
    g_j = jax.grad(lambda o: pop_j.log_joint({**fr_j, **o}, d_j))(opt_j)
    opt_t, fr_t = split_params(p_t)
    opt_t = {k: v.clone().requires_grad_(True) for k, v in opt_t.items()}
    pop_t.log_joint({**fr_t, **opt_t}, d_t).backward()
    assert set(opt_t) == set(g_j)
    for k in g_j:
        assert rel_err(opt_t[k].grad, g_j[k]) < 1e-6, k


def test_log_joint_saturated_regime():
    """|I| > 40 on every bin: the clipped-exp spec must match and stay finite."""
    pop_j, pop_t, p_j, p_t, d_j, d_t = build_pair("sparse_weighted_model", 3)
    for bias_val in (55.0, -55.0):
        pj = dict(p_j, bias=jax.numpy.full_like(p_j["bias"], bias_val))
        pt_ = dict(p_t, bias=torch.full_like(p_t["bias"], bias_val))
        want = float(pop_j.log_joint(pj, d_j))
        got = float(pop_t.log_joint(pt_, d_t))
        assert np.isfinite(got)
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (bias_val, got, want)


def test_currents_and_filters_match_jax():
    """Per-component currents, per-neuron LL and coupling filters: 1e-10."""
    pop_j, pop_t, p_j, p_t, d_j, d_t = build_pair("distance_weighted_model", 3)
    c_j, c_t = pop_j.currents(p_j, d_j), pop_t.currents(p_t, d_t)
    for k in c_j:
        np.testing.assert_allclose(to_np(c_t[k]), np.asarray(c_j[k]), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        to_np(pop_t.log_likelihood_per_neuron(p_t, d_t)),
        np.asarray(pop_j.log_likelihood_per_neuron(p_j, d_j)), rtol=1e-10,
    )
    np.testing.assert_allclose(
        to_np(pop_t.effective_filters(p_t)), np.asarray(pop_j.effective_filters(p_j)),
        rtol=1e-10, atol=1e-14,
    )


def test_sample_matches_jax_structure():
    """Prior draws differ by stream but have the same leaves, shapes and kinds."""
    for name, N in MODELS:
        spec = pt.make_model(name, N)
        p_t = pt.Population(spec, device="cpu", dtype=F64).sample(torch.Generator().manual_seed(0))
        from theano_pyglm_tpu import Population as PopJ

        p_j = PopJ(spec).sample(jax.random.PRNGKey(0))
        assert set(p_t) == set(p_j), name
        for k in p_j:
            assert tuple(p_t[k].shape) == tuple(p_j[k].shape), (name, k)
            assert p_t[k].is_floating_point() == np.issubdtype(np.asarray(p_j[k]).dtype, np.floating)


def test_fused_branch_runs_in_float32_only():
    """use_fused picks the fused op in float32 and the plain path in float64,
    and both give the same log-likelihood (float32: 1e-5 relative)."""
    spec = pt.make_model("sparse_weighted_model", 3)
    S = np.random.RandomState(0).poisson(0.05, (500, 3)).astype(float)
    stim = np.random.RandomState(1).randn(500, 1)
    pop32 = pt.Population(spec, device="cpu")
    assert pop32.dtype == torch.float32 and pop32.use_fused
    p = pop32.sample(torch.Generator().manual_seed(1))
    d32 = pop32.prepare_data(S, stim=stim)
    assert pop32._fused_active(d32)
    pop64 = pt.Population(spec, device="cpu", dtype=F64)
    assert not pop64._fused_active(pop64.prepare_data(S, stim=stim))
    plain = pt.Population(spec, device="cpu", use_fused=False)
    assert not plain._fused_active(d32)
    a, b = float(pop32.log_likelihood(p, d32)), float(plain.log_likelihood(p, d32))
    assert abs(a - b) <= 1e-5 * abs(b)


def _cuda_bytes() -> int:
    return torch.cuda.memory_allocated() if torch.cuda.is_available() else 0


def test_population_defaults_to_the_card():
    """Population(spec) lives on the current CUDA device and
    Population(spec, device="cpu") on the CPU; constructing either allocates
    no tensor. Without a card the first tensor op raises: no fall-back."""
    spec = pt.make_model("standard_glm", 2)
    before = _cuda_bytes()
    pop, pop_cpu = pt.Population(spec), pt.Population(spec, device="cpu")
    assert pop.device == torch.device("cuda") and pop_cpu.device == torch.device("cpu")
    assert _cuda_bytes() == before
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            pop.prepare_data(np.zeros((10, 2)), stim=np.zeros((10, 1)))
    assert pop_cpu.prepare_data(np.zeros((10, 2)), stim=np.zeros((10, 1)))["S"].device.type == "cpu"


def test_params_from_numpy_defaults_to_the_card():
    """The weight carrier's default is the card too; an empty dict allocates
    nothing, and without a card a leaf raises instead of landing on the CPU."""
    from theano_pyglm_torch.utils.convert import params_from_numpy

    before = _cuda_bytes()
    assert params_from_numpy({}) == {}
    assert _cuda_bytes() == before
    leaf = {"w": np.ones(3)}
    if torch.cuda.is_available():
        assert params_from_numpy(leaf)["w"].device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            params_from_numpy(leaf)
    assert params_from_numpy(leaf, device="cpu")["w"].device.type == "cpu"


def test_unported_options_raise():
    """(``time_chunk`` and the streamed design are ported; their tests are
    in test_torch_streaming.py.)"""
    with pytest.raises(ValueError, match="stim"):
        pt.Population(pt.make_model("standard_glm", 2), device="cpu").prepare_data(np.zeros((10, 2)))
    with pytest.raises(ValueError, match="available"):
        pt.make_model("bogus", 2)


# --- simulation (no random stream shared with JAX) ----------------------


def test_simulate_rates_match_design_path():
    """The rates emitted while simulating equal exp(clip(total current)) of
    the design path on the simulated spikes, clipped at rate_max: 1e-6
    relative in float64 (the two paths sum the same terms in another order)."""
    spec = pt.make_model("distance_weighted_model", 4)
    spec["bias"] = {"mu": 3.0, "sigma": 0.4}
    pop = pt.Population(spec, device="cpu", dtype=F64)
    g = torch.Generator().manual_seed(5)
    params = pop.sample(g)
    T = 800
    stim = np.random.RandomState(0).randn(T, 1)
    rate_max = 20.0  # about the baseline rate, so the clip is active on some bins
    S, rates = pop.simulate(g, params, T, stim=stim, rate_max=rate_max)
    assert S.shape == (T, 4) and torch.all(S == torch.round(S)) and torch.all(S >= 0)
    I = pop.total_current(params, pop.prepare_data(S, stim=stim))
    want = torch.clamp(torch.exp(torch.clamp(I, -40.0, 40.0)), max=rate_max)
    assert (want >= rate_max).any() and (want < rate_max).any()
    np.testing.assert_allclose(rates.numpy(), want.numpy(), rtol=1e-6)


def test_simulate_poisson_moments():
    """No stimulus, zero coupling: homogeneous Poisson at exp(bias); counts
    within 4 Poisson standard deviations of 20 Hz·T·dt."""
    spec = pt.make_model("standard_glm", 2, bkgd={"type": "none"})
    pop = pt.Population(spec, device="cpu", dtype=F64)
    params = pop.sample(torch.Generator().manual_seed(0))
    params["w_ir"] = torch.zeros_like(params["w_ir"])
    params["bias"] = torch.full((2,), float(np.log(20.0)), dtype=F64)
    T = 20_000
    S, rates = pop.simulate(torch.Generator().manual_seed(2), params, T)
    np.testing.assert_allclose(rates.numpy(), 20.0, rtol=1e-12)
    expected = 20.0 * T * pop.dt
    assert np.all(np.abs(S.sum(0).numpy() - expected) < 4 * np.sqrt(expected))


def test_simulate_is_strictly_causal():
    spec = pt.make_model("standard_glm", 1, bkgd={"type": "none"})
    pop = pt.Population(spec, device="cpu", dtype=F64)
    params = pop.sample(torch.Generator().manual_seed(0))
    params["bias"] = torch.tensor([np.log(20.0)], dtype=F64)
    params["w_ir"] = 3.0 * torch.ones_like(params["w_ir"])
    S, rates = pop.simulate(torch.Generator().manual_seed(3), params, 1000)
    S, rates = S.numpy(), rates.numpy()
    assert S[:, 0].sum() > 0
    first = int(np.argmax(S[:, 0] > 0))
    np.testing.assert_allclose(rates[: first + 1, 0], 20.0, rtol=1e-12)
    assert rates[first + 1, 0] > 20.0
