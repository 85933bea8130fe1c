"""Checkpoints and exact resume of the port's samplers
(theano_pyglm_torch/utils/checkpoints.py, inference/mcmc.py,
parallel/chains.py) on the CPU, mirroring tests/test_checkpoints.py.

A run that stops and resumes from its checkpoint directory reproduces the
uninterrupted run bit for bit: the kept draws, every leaf of the final
states (params, HMC adaptation) and the diagnostics.
"""

import os

import numpy as np
import pytest
import torch

import theano_pyglm_torch as pt
from theano_pyglm_torch.inference.hmc import HMCState
from theano_pyglm_torch.inference.mcmc import gibbs_sample, init_mcmc_state
from theano_pyglm_torch.parallel import gibbs_sample_chains
from theano_pyglm_torch.utils.checkpoints import latest_step, restore_checkpoint, save_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the other
    test workers (many times slower under pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    spec = pt.make_model("sparse_weighted_model", 2, bkgd={"type": "none"})
    pop = pt.Population(spec, device="cpu", dtype=torch.float64)
    true = pop.sample(torch.Generator().manual_seed(0))
    S, _ = pop.simulate(torch.Generator().manual_seed(1), true, 200)
    return pop, true, pop.prepare_data(S)


def _assert_same(a, b, where="state"):
    """Equal to the last bit, through dicts, lists and HMCState records."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_roundtrip_exact(tmp_path, problem):
    pop, true, _ = problem
    state = init_mcmc_state(pop, true)
    gens = [torch.Generator().manual_seed(123), torch.Generator().manual_seed(9)]
    torch.rand(3, generator=gens[1])
    d = os.path.join(tmp_path, "ckpt")
    assert latest_step(d) is None
    for step in (3, 7, 11, 15):
        save_checkpoint(d, step, [state, {"extra": None}], gens, max_to_keep=2)
    assert latest_step(d) == 15 and sorted(os.listdir(d)) == ["ckpt_000000011.pt", "ckpt_000000015.pt"]
    restored, gen_states, step = restore_checkpoint(d)
    assert step == 15 and isinstance(restored[0]["glm"], HMCState)
    _assert_same(restored, [state, {"extra": None}])
    for g, st in zip(gens, gen_states):
        fresh = torch.Generator()
        fresh.set_state(st)
        assert torch.equal(torch.rand(5, generator=fresh), torch.rand(5, generator=g))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(os.path.join(tmp_path, "none"))


@pytest.mark.parametrize("every", [0, 10, 15, 100])
def test_gibbs_resume_continues_exactly(tmp_path, problem, every):
    """Stop after 10 sampling sweeps, resume to 30: the same draws, final
    state and diagnostics as one uninterrupted run, whether checkpoint_every
    divides the chunks (0, 10), crosses them (15) or never fires before the
    forced final checkpoint (100); every chunk's draws are kept on disk."""
    pop, true, data = problem
    kw = dict(n_warmup=10, chunk_size=10, init_params=true, n_leapfrog=3, checkpoint_every=every)
    full = gibbs_sample(pop, data, torch.Generator().manual_seed(7), n_samples=30, **kw)
    d = os.path.join(tmp_path, "ck")
    gibbs_sample(pop, data, torch.Generator().manual_seed(7), n_samples=10, checkpoint_dir=d, **kw)
    assert latest_step(d) == 20 and sorted(f for f in os.listdir(d) if f.startswith("samples_")) == [
        "samples_000000020.npz"]
    # another seed: the restored generator state, not the seed, decides the draws
    calls = []
    resumed = gibbs_sample(pop, data, torch.Generator().manual_seed(99), n_samples=30, checkpoint_dir=d,
                           resume=True, callback=lambda ph, it, st: calls.append(it), **kw)
    assert calls == [30, 40] and resumed[0]["W"].shape[0] == 30
    _assert_same(resumed, full)


def test_resume_from_mid_warmup_replays_windows_and_ars(tmp_path, problem):
    """An interrupted run (stopped by its callback at warmup sweep 20 of 40,
    after the checkpoint there) resumes, from a generator of another seed,
    through the adaptation windows and the ARS bias passes exactly: the ARS
    RandomState comes from the restored generator's seed."""
    pop, true, data = problem

    class Stop(Exception):
        pass

    def stop_at_20(phase, it, state):
        if it == 20:
            raise Stop

    kw = dict(n_samples=6, n_warmup=40, chunk_size=5, init_params=true, n_leapfrog=3, checkpoint_every=10,
              bias_update="ars")
    full = gibbs_sample(pop, data, torch.Generator().manual_seed(3), **kw)
    d = os.path.join(tmp_path, "ck")
    with pytest.raises(Stop):
        gibbs_sample(pop, data, torch.Generator().manual_seed(3), checkpoint_dir=d, callback=stop_at_20, **kw)
    assert latest_step(d) == 20
    resumed = gibbs_sample(pop, data, torch.Generator().manual_seed(4), checkpoint_dir=d, resume=True, **kw)
    _assert_same(resumed, full)


def test_chains_resume_continues_exactly(tmp_path, problem):
    """Two chains: stop at the warmup/sampling boundary (before the chains
    share their adaptation), resume to 30 sampling sweeps from another
    seed, which only the restored generator states may overrule."""
    pop, true, data = problem
    kw = dict(n_chains=2, n_warmup=10, chunk_size=10, init_params=true, n_leapfrog=3, init_jitter=0.05)
    full = gibbs_sample_chains(pop, data, 11, n_samples=30, **kw)
    d = os.path.join(tmp_path, "ckc")
    gibbs_sample_chains(pop, data, 11, n_samples=0, checkpoint_dir=d, **kw)
    assert latest_step(d) == 10
    resumed = gibbs_sample_chains(pop, data, 12, n_samples=30, checkpoint_dir=d, resume=True, **kw)
    assert resumed[0]["W"].shape[:2] == (30, 2)
    _assert_same(resumed[0], full[0])
    _assert_same(resumed[2], full[2])
    for k in ("accept_rate_glm", "accept_rate_imp", "accept_rate_adjacency"):
        np.testing.assert_array_equal(resumed[1][k], full[1][k])
