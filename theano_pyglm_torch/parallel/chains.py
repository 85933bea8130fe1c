"""Multi-chain MCMC — port of :mod:`theano_pyglm_tpu.parallel.chains`.

Chains are independent runs of the sweep of
:mod:`theano_pyglm_torch.inference.mcmc`, each with its own
``torch.Generator`` derived from the caller's seed. As the JAX package
``vmap``s the sweep over a leading chain axis, the port runs one sweep over
the chains' batched state: every tensor of the state carries the chain axis
first, every stage updates all chains at once, and the likelihood of all
chains is one launch of the chain-batched kernel K3 (ops/kernels.py; one
per group of chains where K3 does not take all of them). Each
chain's generator makes the draws that chain would make alone, so the
chains equal independent one-chain runs draw for draw.

Chains over several GPUs (``mesh``, a 'chains' mesh of
:mod:`theano_pyglm_torch.parallel.mesh`): each rank runs its contiguous
block of the chains, with the generators those chains have in a
one-process run, so chain c of a k-rank run is chain c of the one-process
run. The ranks meet only where the chains do: the across-chain median of
the adaptation at the end of warmup, each chunk's kept draws, checkpoints
and the returned states and diagnostics, each gathered in chain order, so
every rank returns every chain (the JAX package's
``process_allgather(tiled=True)``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as torch_dist

from theano_pyglm_torch.inference.hmc import HMCState
from theano_pyglm_torch.inference.mcmc import (
    _GLM_KEYS,
    _run,
    _Store,
    chain_state,
    init_mcmc_state,
    make_sweep,
    stack_states,
)
from theano_pyglm_torch.parallel.mesh import _tree_map, barrier, gather_chains, replicate
from theano_pyglm_torch.utils.checkpoints import save_checkpoint
from theano_pyglm_torch.utils.diagnostics import summarize_chains

__all__ = ["gibbs_sample_chains"]


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the leading (chain) axis, the mean of the two middle
    values for an even count, as ``jnp.median`` (``torch.median`` takes the
    lower one)."""
    s = torch.sort(x, dim=0).values
    n = s.shape[0]
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _share_adaptation(state: dict, mesh=None) -> dict:
    """Consensus adaptation at the warmup→sampling boundary: every chain
    samples with the across-chain median step size and diagonal mass.

    Chains are exchangeable runs of one kernel, so sharing a fixed
    post-warmup step size and mass is valid MCMC, and it removes the failure
    where one chain's dual averaging ends at a step size the post-warmup
    region rejects outright. ``state`` is the chains' batched state (under
    a ``mesh``, this rank's block of them: the medians are over every
    chain, gathered first); the params pass through."""
    out = dict(state)
    for name, h in state.items():
        if not isinstance(h, HMCState):
            continue
        # sampling derives ε from log_eps_avg each step, so that is what is
        # shared; step_size follows for the diagnostics
        every = gather_chains((h.log_eps_avg, h.scale), mesh)
        med = _median(every[0]).expand_as(h.log_eps_avg).clone()
        scale = {k: _median(every[1][k]).expand_as(v).clone() for k, v in h.scale.items()}
        out[name] = h._replace(step_size=torch.exp(med), log_eps_avg=med, scale=scale)
    return out


def _resolved(device) -> torch.device:
    """``device`` with a bare "cuda" resolved to the current CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _chain_seeds(seed: int, n: int) -> list:
    """``n`` 62-bit seeds drawn from ``seed`` by a host generator."""
    g = torch.Generator().manual_seed(int(seed))
    return [int(s) for s in torch.randint(0, 2**62, (n,), generator=g)]


class _ShardedStore(_Store):
    """The checkpoints of a chain-sharded run, in the one-process layout:
    at a checkpoint every rank's block of the state and of its generators'
    states is gathered and rank 0 writes them; a restore gives each rank
    its block [lo, hi) of the chains. Rank 0 writes the kept draws."""

    def __init__(self, directory, every, generators, device, mesh, lo: int, hi: int):
        super().__init__(directory, every, generators, device)
        self.mesh, self.lo, self.hi = mesh, lo, hi

    def _own(self, saved, gen_states):
        return _tree_map(lambda t: t[self.lo : self.hi].clone(), saved), gen_states[self.lo : self.hi]

    def persist(self, it, kept):
        if self.mesh.rank == 0:
            super().persist(it, kept)

    def checkpoint(self, prev_it, it, last, state, acc_sum):
        if not self.due(prev_it, it, last):
            return
        state, acc_sum = gather_chains((state, acc_sum), self.mesh)
        gen_states = [g.get_state() for g in self.generators]
        if self.mesh.group is not None:
            parts = [None] * self.mesh.size
            torch_dist.all_gather_object(parts, gen_states, group=self.mesh.group)
            gen_states = [st for part in parts for st in part]
        if self.mesh.rank == 0:
            save_checkpoint(self.directory, it, {"states": state, "accept_sum": acc_sum}, gen_states)
        barrier(self.mesh)  # no rank reads the directory before rank 0 has written it


def gibbs_sample_chains(
    pop,
    data,
    seed: int,
    n_chains: int = 4,
    n_samples: int = 1000,
    n_warmup: Optional[int] = None,
    init_params=None,
    thin: int = 1,
    n_leapfrog: int = 10,
    chunk_size: int = 100,
    step_size: float = 0.02,
    target_accept: float = 0.9,
    mesh=None,
    callback=None,
    init_jitter: float = 0.0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    row_batch: Optional[int] = None,
    anneal_frac: float = 0.0,
    glm_update: str = "auto",
):
    """Run ``n_chains`` independent Gibbs/HMC chains on the population's
    device, or sharded over the ranks of a 'chains' ``mesh`` (this rank's
    block of the chains on the population's device, which must be the
    rank's; ``n_chains`` a multiple of the mesh's size).

    Chain c draws from its own generator; every generator, and the one that
    draws the init jitter, is seeded from ``seed``. Without ``init_params``
    each chain starts from ``pop.sample`` of its generator; with them (e.g.
    a MAP fit) every chain starts there, plus ``init_jitter`` times a
    standard normal on the continuous leaves. At the warmup→sampling
    boundary every chain takes the across-chain median step size and mass.

    Returns (samples, diagnostics, states): samples is a dict of numpy
    arrays shaped (n_samples, n_chains, ...); diagnostics has the per-leaf
    split-R̂ and ESS under ``convergence``, and per-chain accept rates and
    step sizes of each block, with ``accept_rate_adjacency`` the birth–death
    move's mean acceptance over all sweeps; states is a list of per-chain
    views of the final batched state (``states[c]`` is
    :func:`~theano_pyglm_torch.inference.mcmc.chain_state` of chain c).
    ``callback(phase, sweeps done in the phase, states)`` runs every
    ``chunk_size`` sweeps with such a list.

    Checkpoints as in :func:`theano_pyglm_torch.inference.mcmc.gibbs_sample`:
    with ``checkpoint_dir`` the chains' batched state and every generator's
    state are saved where a chunk crosses a multiple of ``checkpoint_every`` (0: every
    chunk) and at the end, each sampling chunk's draws are kept as
    ``samples_*.npz``, and ``resume=True`` continues exactly from the latest
    checkpoint, the generators set to their saved states.

    Under a ``mesh`` every rank returns what the one-process run returns:
    the samples, diagnostics and states of every chain. The data and
    ``init_params`` are broadcast from rank 0 first, so the ranks start
    from the same values.
    """
    if n_warmup is None:
        n_warmup = max(100, n_samples // 5)
    lo, hi = (0, n_chains) if mesh is None else mesh.block(n_chains)
    if mesh is not None:
        if mesh.device is not None and _resolved(mesh.device) != _resolved(pop.device):
            raise ValueError(f"the population is on {pop.device}, this rank's device is {mesh.device}")
        data = replicate(data, mesh)
        init_params = replicate(init_params, mesh)

    sweep = make_sweep(pop, data, n_leapfrog=n_leapfrog, target_accept=target_accept,
                       row_batch=row_batch, fisher_params=init_params, glm_update=glm_update)
    seeds = _chain_seeds(seed, n_chains + 1)
    gens = [torch.Generator(device=pop.device).manual_seed(s) for s in seeds[lo:hi]]
    if init_params is None:
        inits = stack_states([pop.sample(g) for g in gens])
    else:
        inits = {k: v.expand(hi - lo, *v.shape).clone() for k, v in init_params.items()}
        if init_jitter > 0:
            g_jit = torch.Generator(device=pop.device).manual_seed(seeds[-1])
            # 'locs' is both a block key and named again, so it is jittered
            # twice, as in the JAX package. The noise is drawn for every
            # chain and a rank keeps its block's rows, so its chains start
            # where they do in a one-process run.
            for name in list(_GLM_KEYS) + ["locs", "W"]:
                if name in init_params:
                    x = init_params[name]
                    noise = torch.randn((n_chains,) + tuple(x.shape), generator=g_jit,
                                        dtype=x.dtype, device=x.device)
                    inits[name] = inits[name] + init_jitter * noise[lo:hi]
    state = init_mcmc_state(pop, inits, step_size=step_size)

    def step(state, adapt, beta):
        return sweep(gens, state, adapt, beta)

    def gather(tree, dim=0):
        return gather_chains(tree, mesh, dim)

    def views(state):
        return [chain_state(state, c) for c in range(n_chains)]

    cb = None if callback is None else (lambda phase, done, state: callback(phase, done, views(state)))
    store = None
    if checkpoint_dir is not None:
        store = (_Store(checkpoint_dir, checkpoint_every, gens, pop.device) if mesh is None
                 else _ShardedStore(checkpoint_dir, checkpoint_every, gens, pop.device, mesh, lo, hi))
    state, samples, acc = _run(
        step, state, n_warmup, n_samples, thin, chunk_size, anneal_frac, cb,
        end_of_warmup=lambda st: _share_adaptation(st, mesh), store=store, resume=resume,
        gather=gather,
    )
    state = gather(state)
    diagnostics = {"convergence": summarize_chains(samples)}
    for name in ("glm", "imp", "latent"):
        if name in state:
            diagnostics[f"accept_rate_{name}"] = state[name].accept_rate.cpu().double().numpy()
            diagnostics[f"step_size_{name}"] = state[name].step_size.cpu().double().numpy()
    if acc is not None:
        diagnostics["accept_rate_adjacency"] = acc
    return samples, diagnostics, views(state)
