"""The port's adaptive rejection sampler (theano_pyglm_torch/inference/ars.py)
against the JAX package's, on the CPU.

Both are numpy: with the same ``RandomState`` the port's sampler gives the
JAX package's draws to 1e-12, draw for draw, and ``update_bias_ars`` gives
the same biases from the port's currents (float64). The sampler's ARS pass
reseeds its RandomState from the generator's seed and the iteration.
"""

import numpy as np
import pytest
import torch

import theano_pyglm_tpu as tpu
from theano_pyglm_torch.inference import ars as ars_t
from theano_pyglm_torch.inference.mcmc import _ars_random_state, gibbs_sample
from theano_pyglm_tpu.inference import ars as ars_j
from torch_parity import build_pair_light, to_np

DENSITIES = {
    "normal": (lambda x: -0.5 * x * x, lambda x: -x, [-1.0, 1.0], (-np.inf, np.inf)),
    "gamma": (lambda x: 2.0 * np.log(x) - 2.0 * x, lambda x: 2.0 / x - 2.0, [0.5, 3.0], (1e-9, np.inf)),
    "logistic": (lambda x: x - 2.0 * np.log1p(np.exp(x)), lambda x: 1.0 - 2.0 / (1.0 + np.exp(-x)), [-3.0, 0.2, 4.0],
                 (-np.inf, np.inf)),
    "bias": (lambda b: 30.0 * b - 2.5 * np.exp(b) - 0.5 * (b - 2.0) ** 2,
             lambda b: 30.0 - 2.5 * np.exp(b) - (b - 2.0), [0.0, 2.5, 6.0], (-np.inf, np.inf)),
}


@pytest.mark.parametrize("name", sorted(DENSITIES))
def test_ars_matches_jax_draw_for_draw(name):
    h, hp, x0, domain = DENSITIES[name]
    rng_t, rng_j = np.random.RandomState(3), np.random.RandomState(3)
    got = [ars_t.adaptive_rejection_sample(h, hp, x0, domain=domain, rng=rng_t) for _ in range(300)]
    want = [ars_j.adaptive_rejection_sample(h, hp, x0, domain=domain, rng=rng_j) for _ in range(300)]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert rng_t.rand() == rng_j.rand()  # the same number of uniforms consumed


def test_ars_requires_mode_bracketing():
    h, hp = DENSITIES["normal"][:2]
    for mod in (ars_t, ars_j):
        with pytest.raises(ValueError):
            mod.adaptive_rejection_sample(h, hp, [1.0, 2.0])
        with pytest.raises(ValueError):
            mod.adaptive_rejection_sample(h, hp, [-2.0, -1.0])


def _bias_problem(T=400, **overrides):
    spec = tpu.make_model("sparse_weighted_model", 3, bkgd={"type": "none"}, **overrides)
    spikes = np.random.RandomState(4).poisson(0.06, (T, 3)).astype(float)
    return build_pair_light(spec, T=T, spikes=spikes)


def test_update_bias_ars_matches_jax():
    """Five passes with the same RandomState: the port's biases (from its
    currents, summed on the device) equal JAX's to 1e-12; the other leaves
    are untouched."""
    pop_j, pop_t, p_j, p_t, d_j, d_t = _bias_problem()
    rng_t, rng_j = np.random.RandomState(0), np.random.RandomState(0)
    for _ in range(5):
        out_t = ars_t.update_bias_ars(rng_t, pop_t, p_t, d_t)
        out_j = ars_j.update_bias_ars(rng_j, pop_j, p_j, d_j)
        np.testing.assert_allclose(to_np(out_t["bias"]), np.asarray(out_j["bias"]), rtol=1e-12)
        assert out_t["bias"].dtype == torch.float64 and not np.allclose(to_np(out_t["bias"]), to_np(p_t["bias"]))
        for k in p_t:
            if k != "bias":
                assert out_t[k] is p_t[k]


def test_update_bias_ars_requires_exp_poisson():
    pop_t, p_t, d_t = (_bias_problem(T=50, nlin={"type": "softplus"})[i] for i in (1, 3, 5))
    with pytest.raises(ValueError, match="exp nonlinearity"):
        ars_t.update_bias_ars(np.random.RandomState(0), pop_t, p_t, d_t)


def test_ars_bias_pass_in_the_sampler():
    """bias_update='ars': the pass runs at the end of each chunk with a
    RandomState that is a function of (seed, iteration) only, so two runs
    from one seed agree bit for bit and the pass moved the biases."""
    pop_t, p_t, d_t = (_bias_problem(T=200)[i] for i in (1, 3, 5))
    a, b = _ars_random_state(7, 10).rand(3), _ars_random_state(7, 10).rand(3)
    assert np.array_equal(a, b) and not np.array_equal(a, _ars_random_state(7, 20).rand(3))
    kw = dict(n_samples=6, n_warmup=4, init_params=p_t, n_leapfrog=3, chunk_size=2, bias_update="ars")
    runs = [gibbs_sample(pop_t, d_t, torch.Generator().manual_seed(5), **kw) for _ in range(2)]
    for k in runs[0][0]:
        np.testing.assert_array_equal(runs[0][0][k], runs[1][0][k])
    plain, _, _ = gibbs_sample(pop_t, d_t, torch.Generator().manual_seed(5), **{**kw, "bias_update": "default"})
    assert not np.array_equal(plain["bias"], runs[0][0]["bias"])
