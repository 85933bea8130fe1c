"""The port's sampling loop (theano_pyglm_torch/inference/mcmc.py) against
the JAX package, on the CPU.

The deterministic helpers (Newton seed, schedules, thinning, the boundary
actions of the adaptation windows, the initial state) match JAX's to 1e-12
in float64. The sweep refuses a partial kernel as JAX's does, a small
``gibbs_sample`` run has the right shapes and finite draws, and on the same
JAX-simulated spikes the two packages' posterior edge probabilities agree
within a stated Monte Carlo tolerance.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theano_pyglm_torch.inference.mcmc as mcmc_t
import theano_pyglm_tpu as tpu
import theano_pyglm_tpu.inference.mcmc as mcmc_j
from theano_pyglm_torch.inference.mcmc import SWEEP_STAGES, gibbs_sample, init_mcmc_state, make_sweep
from torch_parity import build_pair_light, to_np

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


def _pair(name, N, T=200, seed=0, spikes=None, **overrides):
    return build_pair_light(tpu.make_model(name, N, **overrides), T, seed, spikes)


@pytest.mark.parametrize("name,overrides,bk", [
    ("distance_weighted_model", {}, "basis"),
    ("sparse_weighted_model", {"bkgd": {"type": "none"}}, "none"),
    ("standard_glm", {"bkgd": SHARED_BKGD}, "shared"),
])
def test_glm_theta0_matches_jax(name, overrides, bk):
    """The Newton seed from fit parameters and from the prior means."""
    pop_j, pop_t, p_j, p_t, d_j, d_t = _pair(name, 3, T=120, **overrides)
    for fisher_j, fisher_t in ((None, None), (p_j, p_t), ({"W": p_j["W"]} if "W" in p_j else None, None)):
        got = mcmc_t._glm_theta0(pop_t, d_t, fisher_t, bk)
        want = mcmc_j._glm_theta0(pop_j, d_j, fisher_j, bk)
        if isinstance(want, dict):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]), rtol=1e-12)
        else:
            assert got.shape == want.shape and got.dtype == torch.float64
            np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-12)
    with pytest.raises(ValueError, match="unknown bkgd"):
        mcmc_t._glm_theta0(pop_t, d_t, None, "bogus")


def test_glm_theta0_spatiotemporal_matches_jax():
    pop_j, pop_t, p_j, p_t, d_j, d_t = _pair("spatiotemporal_glm", 2, T=60)
    for fj, ft in ((None, None), (p_j, p_t)):
        got = mcmc_t._glm_theta0(pop_t, d_t, ft, "spatiotemporal")
        want = mcmc_j._glm_theta0(pop_j, d_j, fj, "spatiotemporal")
        for k in want:
            np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]), rtol=1e-12)


def test_schedules_match_jax():
    for n in (0, 10, 39, 40, 41, 100, 999, 1000, 1234):
        assert mcmc_t.warmup_schedule(n) == mcmc_j.warmup_schedule(n)
        for frac in (0.0, -1.0, 0.05, 0.3, 1.0):
            a, b = mcmc_t.anneal_schedule(n, frac), mcmc_j.anneal_schedule(n, frac)
            assert (a is None) == (b is None)
            if a is not None:
                assert [a(i) for i in range(n + 2)] == [b(i) for i in range(n + 2)]


@pytest.mark.parametrize("thin", [1, 2, 3, 5, 10])
def test_thin_chunk_matches_jax(thin):
    r = np.random.RandomState(thin)
    for length in (1, 7, 10, 23):
        chunk = {"a": r.randn(length, 2), "b": np.arange(length)}
        for phase in range(13):
            got = mcmc_t.thin_chunk({k: torch.as_tensor(v) for k, v in chunk.items()}, thin, phase)
            want = mcmc_j.thin_chunk(chunk, thin, phase)
            for k in chunk:
                np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]))


def _state_pair(seed=0):
    """One chain's MCMC state in both packages with the same random
    adaptation statistics in every HMC block."""
    pop_j, pop_t, p_j, p_t = _pair("distance_weighted_model", 3, T=60, seed=seed)[:4]
    st_j = mcmc_j.init_mcmc_state(pop_j, p_j, step_size=0.03)
    st_t = init_mcmc_state(pop_t, p_t, step_size=0.03)
    r = np.random.RandomState(seed)
    for name in ("glm", "imp", "latent"):
        pos = {k: np.asarray(v) for k, v in st_j[name].position.items()}
        stats = {
            "scale": {k: r.uniform(0.1, 2.0, v.shape) for k, v in pos.items()},
            "pos_mean": {k: r.randn(*v.shape) for k, v in pos.items()},
            "pos_m2": {k: r.uniform(0.1, 3.0, v.shape) for k, v in pos.items()},
        }
        scalars = {"n_var": float(r.randint(1, 30)), "step_size": r.uniform(0.01, 0.5),
                   "log_eps_avg": r.randn(), "h_avg": r.randn(), "t": float(r.randint(1, 50)),
                   "accept_rate": r.uniform(), "mu": r.randn()}
        st_j[name] = st_j[name]._replace(
            **{k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in stats.items()},
            **{k: jnp.asarray(v) for k, v in scalars.items()},
        )
        st_t[name] = st_t[name]._replace(
            **{k: {kk: torch.tensor(vv) for kk, vv in v.items()} for k, v in stats.items()},
            **{k: torch.tensor(v, dtype=torch.float64) for k, v in scalars.items()},
        )
    return st_j, st_t


def _assert_hmc_state_close(got, want):
    for f in hmc_j.HMCState._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, dict):
            assert set(a) == set(b), f
            for k in b:
                np.testing.assert_allclose(to_np(a[k]), np.asarray(b[k]), rtol=1e-12, atol=1e-300, err_msg=f)
        else:
            np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-12, err_msg=f)


def test_init_mcmc_state_matches_jax():
    pop_j, pop_t, p_j, p_t = _pair("distance_weighted_model", 3, T=60)[:4]
    st_j = mcmc_j.init_mcmc_state(pop_j, p_j, step_size=0.05)
    st_t = init_mcmc_state(pop_t, p_t, step_size=0.05)
    assert set(st_t) == set(st_j) == {"params", "glm", "imp", "latent"}
    for name in ("glm", "imp", "latent"):
        _assert_hmc_state_close(st_t[name], st_j[name])


@pytest.mark.parametrize("action", ["reset", "apply_reset", "apply"])
def test_adapt_boundary_matches_jax(action):
    """The three window-boundary actions on the same statistics (mirrors
    tests/test_adaptation.py's direct checks)."""
    st_j, st_t = _state_pair(seed=1)
    out_j = mcmc_j.adapt_boundary(st_j, action)
    out_t = mcmc_t.adapt_boundary(st_t, action)
    assert out_t["params"] is st_t["params"]
    for name in ("glm", "imp", "latent"):
        _assert_hmc_state_close(out_t[name], out_j[name])


def test_make_sweep_refuses_a_partial_sweep():
    pop_j, pop_t, p_j, p_t, d_j, d_t = _pair("distance_weighted_model", 3, T=80)
    for mod, pop, d in ((mcmc_t, pop_t, d_t), (mcmc_j, pop_j, d_j)):
        with pytest.raises(ValueError, match="diagnostic=True"):
            mod.make_sweep(pop, d, stages=("adjacency",))
        with pytest.raises(ValueError, match="unknown sweep stages"):
            mod.make_sweep(pop, d, stages=("glm", "bogus"), diagnostic=True)
        with pytest.raises(ValueError, match="unknown glm_update"):
            mod.make_sweep(pop, d, glm_update="bogus")
    make_sweep(pop_t, d_t, stages=SWEEP_STAGES)  # the full set needs no acknowledgment
    # the whitened glm HMC and the spatiotemporal glm block, which raised
    # until they were ported, build sweeps that run
    st = make_sweep(pop_t, d_t, glm_update="hmc")(torch.Generator().manual_seed(0), init_mcmc_state(pop_t, p_t), True)
    assert 0.0 <= float(st["glm"].accept_rate) <= 1.0
    pop_s, p_s, d_s = (_pair("spatiotemporal_glm", 2, T=60)[i] for i in (1, 3, 5))
    st = make_sweep(pop_s, d_s)(torch.Generator().manual_seed(0), init_mcmc_state(pop_s, p_s), True)
    assert all(bool(torch.isfinite(v).all()) for v in st["params"].values())


def test_diagnostic_stage_subset_passes_state_through():
    """A one-stage sweep runs only that stage: the rotation moves the
    locations alone, the other blocks' states pass through untouched."""
    pop_t, p_t, d_t = (_pair("distance_weighted_model", 3, T=80)[i] for i in (1, 3, 5))
    st = init_mcmc_state(pop_t, p_t)
    out = make_sweep(pop_t, d_t, stages=("rotation",), diagnostic=True)(torch.Generator().manual_seed(0), st, True)
    for name in ("glm", "imp", "latent"):
        assert out[name] is st[name]
    changed = {k for k in p_t if not torch.equal(out["params"][k], p_t[k])}
    assert changed == {"locs"}


def test_sweep_repeats_with_the_same_generator_seed():
    pop_t, p_t, d_t = (_pair("distance_weighted_model", 3, T=150)[i] for i in (1, 3, 5))
    sweep = make_sweep(pop_t, d_t, n_leapfrog=3, fisher_params=p_t)
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(11)
        st = init_mcmc_state(pop_t, p_t)
        for _ in range(3):
            st = sweep(g, st, True, 0.5)
        outs.append(st)
    for k in p_t:
        assert torch.equal(outs[0]["params"][k], outs[1]["params"][k]), k
    assert torch.equal(outs[0]["accept_adjacency"], outs[1]["accept_adjacency"])


def test_gibbs_sample_small_run():
    """N=4, T=1,000, float32 like the card: 40 warmup sweeps (adaptation
    windows engaged, annealed), 6 thinned draws; shapes, finiteness, the
    diagnostics' keys and ranges, and the callback's iteration counts."""
    spec = tpu.make_model("distance_weighted_model", 4, bias={"mu": 3.0, "sigma": 0.4})
    import theano_pyglm_torch as pt

    pop = pt.Population(spec, device="cpu")
    g = torch.Generator().manual_seed(0)
    true = pop.sample(g)
    stim = np.random.RandomState(0).randn(1000, 1)
    S, _ = pop.simulate(g, true, 1000, stim=stim)
    data = pop.prepare_data(S, stim=stim)
    calls = []
    samples, diag, state = gibbs_sample(
        pop, data, g, n_samples=6, n_warmup=40, init_params=true, thin=2, n_leapfrog=4, chunk_size=5,
        anneal_frac=0.3, callback=lambda ph, it, st: calls.append((ph, it)),
    )
    shapes = {k: v.shape for k, v in samples.items()}
    assert shapes == {k: (6,) + tuple(v.shape) for k, v in true.items()}
    assert all(np.isfinite(v).all() and v.dtype == np.float32 for v in samples.values())
    assert np.isin(samples["A"], (0.0, 1.0)).all()
    assert set(diag) == {f"{a}_{b}" for a in ("accept_rate", "step_size") for b in ("glm", "imp", "latent")} | {
        "accept_rate_adjacency"}
    assert 0.0 < diag["accept_rate_glm"] <= 1.0 and 0.0 < diag["accept_rate_adjacency"] <= 1.0
    assert calls == [("warmup", i) for i in (5, 10, 15, 20, 25, 30, 35, 40)] + [("sample", 45), ("sample", 50), ("sample", 52)]
    for k, v in state["params"].items():
        np.testing.assert_array_equal(to_np(v), samples[k][-1])


def test_gibbs_sample_raises_for_unported_options(tmp_path):
    """An unknown bias update still raises. Checkpoints, resume and the ARS
    bias update raised until they were ported; now they run (the checkpoint
    lands in the directory; resume without a checkpoint starts afresh)."""
    pop_t, p_t, d_t = (_pair("distance_weighted_model", 3, T=60)[i] for i in (1, 3, 5))
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="bias_update"):
        gibbs_sample(pop_t, d_t, g, n_samples=1, n_warmup=0, init_params=p_t, bias_update="bogus")
    ck = str(tmp_path / "ck")
    for kw in ({"checkpoint_dir": ck}, {"resume": True}, {"checkpoint_dir": ck, "resume": True},
               {"bias_update": "ars"}):
        samples, _, _ = gibbs_sample(pop_t, d_t, g, n_samples=1, n_warmup=0, init_params=p_t, n_leapfrog=2, **kw)
        assert samples["bias"].shape == (1, 3) and np.isfinite(samples["bias"]).all(), kw
    assert sorted(os.listdir(ck)) == ["ckpt_000000001.pt", "samples_000000001.npz"]


def test_edge_probabilities_match_jax_on_jax_spikes():
    """Cross-package statistic: JAX-simulated spikes of an Erdős–Rényi
    network (N=3, T=500, no latent variables, so A mixes fast), both
    samplers from the generating parameters, 400 sweeps each with no warmup.
    The posterior edge probabilities agree within 0.25 per entry (about 3.5
    standard errors of the difference for 400 near-independent draws), and
    the diagnostics carry JAX's keys plus the port's birth–death acceptance."""
    import theano_pyglm_torch as pt
    from theano_pyglm_torch.utils.convert import params_from_numpy

    spec = tpu.make_model("sparse_weighted_model", 3, bkgd={"type": "none"}, bias={"mu": 3.0, "sigma": 0.4})
    spec["network"]["graph"]["rho"] = 0.5
    pop_j = tpu.Population(spec)
    true_j = pop_j.sample(jax.random.PRNGKey(3))
    S, _ = pop_j.simulate(jax.random.PRNGKey(4), true_j, 500)
    pop_t = pt.Population(spec, device="cpu", dtype=torch.float64)
    d_t = pop_t.prepare_data(np.asarray(S))
    d_j = {k: jnp.asarray(to_np(v)) for k, v in d_t.items()}
    true_t = params_from_numpy({k: np.asarray(v) for k, v in true_j.items()}, device="cpu", dtype=torch.float64)

    kw = dict(n_samples=400, n_warmup=0, n_leapfrog=3, chunk_size=400)
    s_j, diag_j, _ = mcmc_j.gibbs_sample(pop_j, d_j, jax.random.PRNGKey(5), init_params=true_j, **kw)
    s_t, diag_t, _ = gibbs_sample(pop_t, d_t, torch.Generator().manual_seed(5), init_params=true_t, **kw)
    p_j, p_t = np.asarray(s_j["A"]).mean(0), s_t["A"].mean(0)
    assert np.abs(p_j - p_t).max() < 0.25, (p_j, p_t)
    assert set(diag_t) == set(diag_j) | {"accept_rate_adjacency"}
    for k in diag_j:
        assert np.isfinite(diag_t[k])


def test_fixed_graph_leaves_w_frozen_as_the_reference_does():
    """A fault of the reference, kept on purpose in both packages: under a
    fixed-A graph (simple_weighted_model) W never moves, because the
    birth-death move returns at once when A is fixed (JAX gibbs.py:208-209,
    the port's update_adjacency_collapsed) and W is in no HMC block. This
    test documents the behaviour; it does not endorse it (ROADMAP.md,
    queue 3)."""
    import theano_pyglm_torch as pt

    pop = pt.Population(tpu.make_model("simple_weighted_model", 3), device="cpu", dtype=torch.float64)
    params = pop.sample(torch.Generator().manual_seed(0))
    S = np.random.RandomState(0).poisson(0.05, (800, 3)).astype(float)
    stim = np.random.RandomState(1).randn(800, 1)
    data = pop.prepare_data(S, stim=stim)
    assert pop.graph.fixed_A
    samples, _, state = gibbs_sample(pop, data, torch.Generator().manual_seed(1), n_samples=5,
                                     n_warmup=5, init_params=params)
    W0 = params["W"].numpy()
    assert samples["W"].shape == (5, 3, 3)
    for w in samples["W"]:
        np.testing.assert_array_equal(w, W0)
    np.testing.assert_array_equal(state["params"]["W"].numpy(), W0)
    # the sampler does run: the impulse weights move
    assert not np.array_equal(samples["w_ir"][-1], params["w_ir"].numpy())
