"""Foundation of the PyTorch port against the JAX package: the copied numpy
modules, densities, the clip spec, samplers, parameter conversion and the
causal basis convolution. Float64 on the CPU."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import theano_pyglm_tpu.ops.basis as basis_j
import theano_pyglm_tpu.ops.clipping as clip_j
import theano_pyglm_tpu.ops.convolve as conv_j
import theano_pyglm_tpu.ops.distributions as dist_j
from theano_pyglm_torch.models import spec as spec_t
from theano_pyglm_torch.models import zoo as zoo_t
from theano_pyglm_torch.ops import basis as basis_t
from theano_pyglm_torch.ops import clipping as clip_t
from theano_pyglm_torch.ops import convolve as conv_t
from theano_pyglm_torch.ops import distributions as dist_t
from theano_pyglm_torch.utils.convert import params_from_numpy, params_to_numpy
from theano_pyglm_tpu.models import spec as spec_j
from theano_pyglm_tpu.models import zoo as zoo_j

REPO = Path(__file__).resolve().parents[1]
F64 = torch.float64


def test_port_imports_without_jax():
    code = "import sys, theano_pyglm_torch; assert 'jax' not in sys.modules"
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_port_sources_never_import_jax():
    for path in (REPO / "theano_pyglm_torch").rglob("*.py"):
        if "_build" in path.parts:  # build outputs, not sources
            continue
        for line in path.read_text().splitlines():
            words = line.split()
            assert words[:2] not in (["import", "jax"], ["from", "jax"]), path
            assert "theano_pyglm_tpu" not in words[:2], path


# --- copied numpy modules: identical outputs ----------------------------


@pytest.mark.parametrize("name", sorted(zoo_j.TEMPLATES))
def test_zoo_template_identical(name):
    assert zoo_t.make_model(name, 5) == zoo_j.make_model(name, 5)
    over = {"bias": {"mu": 3.0, "sigma": 0.4}}
    assert zoo_t.make_model(name, 27, **over) == zoo_j.make_model(name, 27, **over)


@pytest.mark.parametrize("prms", [
    {"type": "cosine", "n_bas": 5, "dt_max": 0.1},
    {"type": "cosine", "n_bas": 4, "n_eye": 2, "dt_max": 0.05, "orth": True},
    {"type": "exp", "n_bas": 3, "dt_max": 0.2},
    {"type": "gaussian", "n_bas": 6, "dt_max": 0.3},
    {"type": "identity", "dt_max": 0.01},
])
def test_basis_identical(prms):
    np.testing.assert_array_equal(basis_t.create_basis(prms), basis_j.create_basis(prms))
    f = np.random.RandomState(0).randn(basis_j.create_basis(prms).shape[0])
    np.testing.assert_array_equal(
        basis_t.project_onto_basis(f, basis_t.create_basis(prms)),
        basis_j.project_onto_basis(f, basis_j.create_basis(prms)),
    )


@pytest.mark.parametrize("bad", [
    {},
    {"N": 0},
    {"N": 2, "dt": 2.0},
    {"N": 2, "bogus": {}},
    {"N": 2, "bkgd": {"type": "wavelet"}},
    {"N": 2, "network": {"graph": {"type": "erdos_renyi", "rho": 1.5}}},
])
def test_spec_validation_identical(bad):
    with pytest.raises(ValueError) as ej:
        spec_j.validate_spec(bad)
    with pytest.raises(ValueError) as et:
        spec_t.validate_spec(bad)
    assert str(et.value) == str(ej.value)


# --- densities and the clip spec: 1e-12 in float64 ----------------------


def _pos(r, *shape):
    return r.uniform(0.05, 0.95, size=shape)


@pytest.mark.parametrize("name", [
    "gaussian_logpdf", "gamma_logpdf", "beta_logpdf", "dirichlet_logpdf",
    "bernoulli_logpmf", "categorical_logpmf", "poisson_logpmf",
])
def test_density_matches_jax(name):
    """Same closed forms in both packages; 1e-12 covers float64 rounding of
    lgamma/xlogy implementations."""
    r = np.random.RandomState(1)
    args = {
        "gaussian_logpdf": (r.randn(7), 0.3, 1.7),
        "gamma_logpdf": (r.gamma(2.0, size=7), 2.5, 1.3),
        "beta_logpdf": (_pos(r, 7), 2.0, 0.7),
        "dirichlet_logpdf": (np.array([0.2, 0.3, 0.5]), np.array([1.5, 2.0, 0.7])),
        "bernoulli_logpmf": (np.array([0.0, 1.0, 1.0, 0.0]), np.array([0.2, 0.9, 0.0, 1.0])),
        "categorical_logpmf": (np.array([0, 2, 1]), np.log(np.array([[0.2, 0.3, 0.5]] * 3))),
        "poisson_logpmf": (np.array([0.0, 1.0, 3.0, 7.0]), np.array([0.1, 1.0, 2.5, 4.0])),
    }[name]
    want = np.asarray(getattr(dist_j, name)(*[jnp.asarray(a) for a in args]))
    t_args = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
    got = getattr(dist_t, name)(*t_args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_clipping_matches_jax():
    assert clip_t.EXP_CLIP == clip_j.EXP_CLIP == 40.0
    x = np.array([-60.0, -40.0, -39.5, 0.0, 12.3, 40.0, 41.0, 1e3])
    for fn in ("clip_exponent", "exp_clipped", "exponent_active"):
        np.testing.assert_allclose(
            getattr(clip_t, fn)(torch.as_tensor(x)).numpy(),
            np.asarray(getattr(clip_j, fn)(jnp.asarray(x))), rtol=1e-12,
        )


# --- samplers: the random streams differ, so moments against scipy ------


@pytest.mark.parametrize("name", ["gaussian", "gamma", "beta", "dirichlet", "bernoulli", "categorical"])
def test_sampler_moments(name):
    """20k draws: the sample mean lies within 5 standard errors of the exact
    mean (a false failure has probability < 1e-6)."""
    g = torch.Generator().manual_seed(3)
    n = 20_000
    if name == "gaussian":
        x, mean, sd = dist_t.sample_gaussian(g, 1.5, 0.5, (n,), F64), 1.5, 0.5
    elif name == "gamma":
        x = dist_t.sample_gamma(g, 3.0, 2.0, (n,), F64)
        mean, sd = st.gamma(3.0, scale=0.5).mean(), st.gamma(3.0, scale=0.5).std()
    elif name == "beta":
        x = dist_t.sample_beta(g, 2.0, 5.0, (n,), F64)
        mean, sd = st.beta(2.0, 5.0).mean(), st.beta(2.0, 5.0).std()
    elif name == "dirichlet":
        x = dist_t.sample_dirichlet(g, torch.tensor([2.0, 3.0, 5.0]).expand(n, 3), F64)[:, 0]
        np.testing.assert_allclose(
            dist_t.sample_dirichlet(g, torch.ones(4)).sum().item(), 1.0, rtol=1e-6
        )
        mean, sd = st.beta(2.0, 8.0).mean(), st.beta(2.0, 8.0).std()
    elif name == "bernoulli":
        x, mean, sd = dist_t.sample_bernoulli(g, 0.3, (n,), F64), 0.3, np.sqrt(0.21)
    else:
        x = dist_t.sample_categorical(g, torch.log(torch.tensor([0.2, 0.5, 0.3])), (n,))
        assert x.dtype == torch.int64
        x = x.double()
        mean = 0.5 + 2 * 0.3
        sd = np.sqrt(0.5 + 4 * 0.3 - mean**2)
    assert x.shape[0] == n
    assert abs(x.mean().item() - mean) < 5 * sd / np.sqrt(n)


def test_params_round_trip_keeps_integer_leaves():
    p = {"W": np.eye(3), "y": np.array([0, 1, 1], dtype=np.int32), "A": np.ones((3, 3), np.float32)}
    t = params_from_numpy(p, device="cpu", dtype=F64)
    assert t["y"].dtype == torch.int64 and t["W"].dtype == F64 and t["A"].dtype == F64
    back = params_to_numpy(t)
    for k in p:
        np.testing.assert_array_equal(back[k], p[k])


# --- causal basis convolution: 1e-10 in float64 -------------------------


@pytest.mark.parametrize("shape,block", [((300,), 2048), ((300, 3), 2048), ((1000, 4), 128)])
def test_convolve_matches_jax(shape, block):
    """Exact same sums in another order: 1e-10 relative in float64."""
    r = np.random.RandomState(0)
    x = r.poisson(0.3, size=shape).astype(float)
    basis = basis_j.create_basis({"type": "cosine", "n_bas": 5, "dt_max": 0.1})
    want = np.asarray(conv_j.convolve_with_basis(jnp.asarray(x), jnp.asarray(basis), block=block))
    got = conv_t.convolve_with_basis(torch.as_tensor(x), torch.as_tensor(basis), block=block)
    assert got.dtype == F64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    # strictly causal: a spike at t reaches the output from t+1 on
    e = np.zeros(50)
    e[10] = 1.0
    out = conv_t.convolve_with_basis(torch.as_tensor(e), torch.as_tensor(basis)).numpy()
    assert np.all(out[:11] == 0.0)
    np.testing.assert_allclose(out[11:50], basis[:39], rtol=1e-12)


def test_upsample_stim_matches_jax():
    r = np.random.RandomState(2)
    stim = r.randn(40, 2)
    want = np.asarray(conv_j.upsample_stim(jnp.asarray(stim), 0.01, 1e-3, 450))
    got = conv_t.upsample_stim(torch.as_tensor(stim), 0.01, 1e-3, 450).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    got1 = conv_t.upsample_stim(torch.as_tensor(stim[:, 0]), 0.01, 1e-3, 450).numpy()
    np.testing.assert_allclose(got1, want[:, 0], rtol=1e-12, atol=1e-12)


def test_default_float_setting():
    """float32 by default; float64 for CPU verification; nothing else."""
    from theano_pyglm_torch import Population, make_model
    from theano_pyglm_torch.utils import dtypes

    assert dtypes.default_float() == torch.float32
    try:
        dtypes.set_default_float(F64)
        pop = Population(make_model("standard_glm", 2), device="cpu")
        assert pop.dtype == F64
        assert all(v.dtype == F64 for v in pop.sample(torch.Generator().manual_seed(0)).values())
        assert conv_t.convolve_with_basis(torch.ones(5, dtype=torch.int64), np.ones((2, 1))).dtype == F64
    finally:
        dtypes.set_default_float(torch.float32)
    with pytest.raises(ValueError):
        dtypes.set_default_float(torch.float16)
