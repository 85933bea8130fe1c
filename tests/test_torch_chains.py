"""The port's multi-chain sampler (theano_pyglm_torch/parallel/chains.py),
its copied numpy diagnostics and the flagship entry point, on the CPU.

The copies of ``utils/diagnostics.py`` and ``utils/ks.py`` give JAX's
outputs exactly on the same arrays (the KS copy keeps the reference's
multi-spike-bin fault, documented below); ``_share_adaptation`` gives the
JAX package's consensus on the same adaptation statistics; a small
``gibbs_sample_chains`` run has JAX's shapes and diagnostics keys.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theano_pyglm_torch as pt
import theano_pyglm_torch.utils.diagnostics as diag_t
import theano_pyglm_torch.utils.ks as ks_t
import theano_pyglm_tpu as tpu
import theano_pyglm_tpu.utils.diagnostics as diag_j
import theano_pyglm_tpu.utils.ks as ks_j
from theano_pyglm_torch.inference.mcmc import chain_state, init_mcmc_state, stack_states
from theano_pyglm_torch.parallel.chains import _share_adaptation, gibbs_sample_chains
from theano_pyglm_torch.scripts import rgc_flagship
from theano_pyglm_tpu.parallel.chains import _share_adaptation as share_j
from theano_pyglm_tpu.parallel.chains import gibbs_sample_chains as chains_j
from torch_parity import build_pair_light, to_np


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the other
    test workers (many times slower under pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("shape", [(40, 4, 3), (41, 1, 2, 2), (3, 4), (200, 2), (17, 3, 1)])
def test_diagnostics_identical_to_jax(shape):
    r = np.random.RandomState(len(shape))
    x = np.cumsum(r.randn(*shape), axis=0)  # autocorrelated draws
    if len(shape) > 2:
        x[..., 0] = 1.5  # a constant parameter: R̂ is NaN
    _same(diag_t.split_rhat(x), diag_j.split_rhat(x))
    _same(diag_t.ess(x), diag_j.ess(x))
    samples = {"a": x, "b": x[:, :1] * 2.0, "y": np.zeros(shape[:2], dtype=np.int64)}
    np.testing.assert_equal(diag_t.summarize_chains(samples), diag_j.summarize_chains(samples))


def test_partition_and_support_metrics_identical_to_jax():
    r = np.random.RandomState(0)
    for _ in range(5):
        a, b = r.randint(0, 3, 20), r.randint(0, 4, 20)
        assert diag_t.adjusted_rand_index(a, b) == diag_j.adjusted_rand_index(a, b)
        W, A = r.randn(6, 6) * 0.1, (r.rand(6, 6) < 0.3).astype(float)
        assert diag_t.support_metrics(W, A) == diag_j.support_metrics(W, A)


def test_time_rescaling_ks_identical_to_jax_with_the_reference_fault():
    """Same statistics, p-values and rescaled quantiles. The copy keeps the
    reference's fault (ROADMAP.md queue 3): the second spike of a bin that
    holds two repeats the bin's cumulative value, so its interval is z = 0
    and u = 0, where spreading the spikes over the bin would give u > 0."""
    r = np.random.RandomState(1)
    rates = np.exp(r.randn(3000, 3) * 0.3 + 3.0)
    S = r.poisson(rates * 1e-3).astype(float)
    S[100, 1], S[200, 1] = 2.0, 3.0
    out_t, out_j = ks_t.time_rescaling_ks(rates, S, 1e-3), ks_j.time_rescaling_ks(rates, S, 1e-3)
    _same(out_t[0], out_j[0])
    _same(out_t[1], out_j[1])
    for u_t, u_j in zip(out_t[2], out_j[2]):
        _same(u_t, u_j)
    assert np.sum(out_t[2][1] == 0.0) >= 3  # 1 + 2 zero intervals from the multi-spike bins


def _chain_states(n_chains, seed=0):
    """Per-chain states in the port and the same values as JAX's
    chain-batched state."""
    spec = tpu.make_model("sparse_weighted_model", 3, bkgd={"type": "none"})
    pop_j, pop_t = tpu.Population(spec), pt.Population(spec, device="cpu", dtype=torch.float64)
    g = torch.Generator().manual_seed(seed)
    states_t = [init_mcmc_state(pop_t, pop_t.sample(g), step_size=0.02) for _ in range(n_chains)]
    r = np.random.RandomState(seed)
    for s in states_t:
        for name in ("glm", "imp"):
            h = s[name]
            s[name] = h._replace(
                log_eps_avg=torch.tensor(r.randn() - 3.0, dtype=torch.float64),
                scale={k: torch.tensor(r.uniform(0.1, 2.0, v.shape)) for k, v in h.scale.items()},
            )
    states_t[0]["glm"] = states_t[0]["glm"]._replace(
        log_eps_avg=torch.tensor(-20.0, dtype=torch.float64),
        scale={k: torch.full_like(v, 1e-6) for k, v in states_t[0]["glm"].scale.items()},
    )

    def stack(xs):
        if isinstance(xs[0], dict):
            return {k: stack([x[k] for x in xs]) for k in xs[0]}
        if isinstance(xs[0], tuple):
            return type(xs[0])(*(stack([x[i] for x in xs]) for i in range(len(xs[0]))))
        return jnp.asarray(np.stack([to_np(x) for x in xs]))

    states_j = {k: stack([s[k] for s in states_t]) for k in states_t[0]}
    return pop_j, states_j, states_t


@pytest.mark.parametrize("n_chains", [4, 3])
def test_share_adaptation_matches_jax(n_chains):
    """One chain ends warmup with an absurd ε and mass scale; after sharing
    every chain carries JAX's across-chain median (the mean of the middle
    two for an even count) in log_eps_avg, step_size and each scale
    (mirrors tests/test_adaptation.py)."""
    _, states_j, states_t = _chain_states(n_chains)
    out_j = share_j(states_j)
    batched = stack_states(states_t)
    shared = _share_adaptation(batched)
    out_t = [chain_state(shared, c) for c in range(n_chains)]
    assert len(out_t) == n_chains
    for c, st in enumerate(out_t):
        for name in ("glm", "imp"):
            h, hj = st[name], out_j[name]
            np.testing.assert_allclose(float(h.log_eps_avg), float(hj.log_eps_avg[c]), rtol=1e-12)
            np.testing.assert_allclose(float(h.step_size), float(hj.step_size[c]), rtol=1e-12)
            for k in h.scale:
                np.testing.assert_allclose(to_np(h.scale[k]), np.asarray(hj.scale[k][c]), rtol=1e-12)
    for k in shared["params"]:
        assert shared["params"][k] is batched["params"][k]


def _small_problem(N=4, T=1000):
    spec = tpu.make_model("distance_weighted_model", N, bias={"mu": 3.0, "sigma": 0.4})
    pop = pt.Population(spec, device="cpu")
    g = torch.Generator().manual_seed(0)
    true = pop.sample(g)
    stim = np.random.RandomState(0).randn(T, 1)
    S, _ = pop.simulate(g, true, T, stim=stim)
    return spec, pop, true, S, stim, pop.prepare_data(S, stim=stim)


def test_gibbs_sample_chains_small_run():
    """N=4, T=1,000 in float32: 3 chains of 40 warmup and 5 sampling
    sweeps. Shapes (n_samples, n_chains, ...), finite draws, binary A, the
    keys of JAX's diagnostics (from a JAX run on the same problem) plus the
    birth–death acceptance; the same seed repeats, chains differ."""
    spec, pop, true, S, stim, data = _small_problem()
    kw = dict(n_chains=3, n_samples=5, n_warmup=40, init_params=true, init_jitter=0.05, n_leapfrog=3)
    samples, diag, states = gibbs_sample_chains(pop, data, 7, **kw)
    assert {k: v.shape for k, v in samples.items()} == {k: (5, 3) + tuple(v.shape) for k, v in true.items()}
    assert all(np.isfinite(v).all() for v in samples.values()) and np.isin(samples["A"], (0.0, 1.0)).all()
    assert len(states) == 3 and not np.array_equal(samples["W"][:, 0], samples["W"][:, 1])
    for name in ("glm", "imp", "latent", "adjacency"):
        assert diag[f"accept_rate_{name}"].shape == (3,) and (diag[f"accept_rate_{name}"] > 0).all()

    # JAX's keys on the same problem (its compile dominates: keep it tiny)
    pop_j = tpu.Population(spec)
    d_j = {k: jnp.asarray(to_np(v).astype(np.float64)) for k, v in data.items()}
    true_j = {k: jnp.asarray(to_np(v).astype(np.float64)) for k, v in true.items()}
    s_j, diag_jax, _ = chains_j(pop_j, d_j, jax.random.PRNGKey(0), n_chains=2, n_samples=4, n_warmup=0,
                                init_params=true_j, n_leapfrog=2, chunk_size=4)
    assert set(diag) == set(diag_jax) | {"accept_rate_adjacency"}
    assert set(diag["convergence"]) == set(diag_jax["convergence"])
    assert {k: v.shape[2:] for k, v in samples.items()} == {k: np.shape(v)[2:] for k, v in s_j.items()}

    again, _, _ = gibbs_sample_chains(pop, data, 7, **kw)
    for k in samples:
        np.testing.assert_array_equal(samples[k], again[k])


def test_init_jitter_and_unported_options(tmp_path):
    """With no sweeps the returned states are the chains' starting points:
    the MAP-like init plus init_jitter·N(0,1) on the continuous leaves (the
    locations twice, as in JAX), A untouched. mesh raises; checkpoints and
    resume, which raised until they were ported, run."""
    pop_t, p_t, d_t = (build_pair_light(tpu.make_model("distance_weighted_model", 5), T=100)[i] for i in (1, 3, 5))
    _, diag, states = gibbs_sample_chains(pop_t, d_t, 1, n_chains=4, n_samples=0, n_warmup=0,
                                          init_params=p_t, init_jitter=0.05)
    dev = {k: np.concatenate([(to_np(s["params"][k]) - to_np(p_t[k])).ravel() for s in states])
           for k in p_t}
    assert np.all(dev["A"] == 0.0)
    pooled = np.concatenate([dev[k] for k in ("bias", "w_stim", "W", "w_ir")])
    assert abs(pooled.std() - 0.05) < 0.005
    assert abs(dev["locs"].std() - 0.05 * math.sqrt(2.0)) < 0.02
    assert "accept_rate_adjacency" not in diag
    with pytest.raises(NotImplementedError, match="item 14"):
        gibbs_sample_chains(pop_t, d_t, 1, n_chains=2, n_samples=1, n_warmup=0, mesh=object())
    ck = str(tmp_path / "ck")
    for kw in ({"checkpoint_dir": ck}, {"resume": True}):
        samples, _, _ = gibbs_sample_chains(pop_t, d_t, 1, n_chains=2, n_samples=1, n_warmup=0, n_leapfrog=2, **kw)
        assert samples["W"].shape == (1, 2, 5, 5), kw
    assert sorted(os.listdir(ck)) == ["ckpt_000000001.pt", "samples_000000001.npz"]


def test_link_prediction_auc_is_the_rank_statistic():
    r = np.random.RandomState(2)
    A_true = (r.rand(9, 9) < 0.3).astype(float)
    A_post = r.rand(9, 9)
    pos, neg = A_post[A_true == 1], A_post[A_true == 0]
    want = np.mean(pos[:, None] > neg[None, :])
    assert abs(rgc_flagship.link_prediction_auc(A_post, A_true) - want) < 1e-12


def test_flagship_script_on_the_cpu(tmp_path):
    """The entry point end to end at N=3, 0.5 s, on the CPU: simulate, MAP,
    2 chains, and the JAX script's summary keys in its JSON, with the
    pairwise-distance diagnostics."""
    rgc_flagship.main(["--N", "3", "--T_sec", "0.5", "--n_iters", "4", "--n_warmup", "0", "--n_chains", "2",
                       "--thin", "2", "-r", str(tmp_path), "--device", "cpu"])
    with open(os.path.join(tmp_path, "flagship_summary.json")) as f:
        summary = json.load(f)
    assert set(summary) == {"wall_clock_s", "iters", "n_chains", "ms_per_iteration", "link_prediction_auc",
                            "convergence"}
    assert summary["iters"] == 4 and summary["n_chains"] == 2 and "locs_pairwise_dist" in summary["convergence"]
    with np.load(os.path.join(tmp_path, "flagship_samples.npz")) as z:
        assert z["samples/A"].shape == (2, 2, 3, 3) and z["true_params/A"].shape == (3, 3)
