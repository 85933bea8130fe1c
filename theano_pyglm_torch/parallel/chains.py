"""Multi-chain MCMC — port of :mod:`theano_pyglm_tpu.parallel.chains`.

Chains are independent runs of the sweep of
:mod:`theano_pyglm_torch.inference.mcmc`, each with its own
``torch.Generator`` derived from the caller's seed. In this port they run
as a loop over per-chain states on one device; the JAX package ``vmap``s
the sweep over a leading chain axis, which needs the chain-batched fused
kernel K3 (ROADMAP.md, queue 2) and a chain dimension through every stage.
Sharding chains over several devices (``mesh``) is not ported yet (queue 1
item 14).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from theano_pyglm_torch.inference.hmc import HMCState
from theano_pyglm_torch.inference.mcmc import (
    _GLM_KEYS,
    _run,
    _Store,
    init_mcmc_state,
    make_sweep,
)
from theano_pyglm_torch.utils.diagnostics import summarize_chains

__all__ = ["gibbs_sample_chains"]


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the leading (chain) axis, the mean of the two middle
    values for an even count, as ``jnp.median`` (``torch.median`` takes the
    lower one)."""
    s = torch.sort(x, dim=0).values
    n = s.shape[0]
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _share_adaptation(states: list) -> list:
    """Consensus adaptation at the warmup→sampling boundary: every chain
    samples with the across-chain median step size and diagonal mass.

    Chains are exchangeable runs of one kernel, so sharing a fixed
    post-warmup step size and mass is valid MCMC, and it removes the failure
    where one chain's dual averaging ends at a step size the post-warmup
    region rejects outright. ``states`` is one state dict per chain."""
    out = [dict(s) for s in states]
    for name, first in states[0].items():
        if not isinstance(first, HMCState):
            continue
        blocks = [s[name] for s in states]
        # sampling derives ε from log_eps_avg each step, so that is what is
        # shared; step_size follows for the diagnostics
        med = _median(torch.stack([h.log_eps_avg for h in blocks]))
        scale = {k: _median(torch.stack([h.scale[k] for h in blocks])) for k in first.scale}
        for o, h in zip(out, blocks):
            o[name] = h._replace(step_size=torch.exp(med), log_eps_avg=med, scale=dict(scale))
    return out


def _chain_seeds(seed: int, n: int) -> list:
    """``n`` 62-bit seeds drawn from ``seed`` by a host generator."""
    g = torch.Generator().manual_seed(int(seed))
    return [int(s) for s in torch.randint(0, 2**62, (n,), generator=g)]


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
    device.

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
    move's mean acceptance over all sweeps; states is the list of the
    chains' final states. ``callback(phase, sweeps done in the phase,
    states)`` runs every ``chunk_size`` sweeps.

    Checkpoints as in :func:`theano_pyglm_torch.inference.mcmc.gibbs_sample`:
    with ``checkpoint_dir`` every chain's state and generator state are
    saved where a chunk crosses a multiple of ``checkpoint_every`` (0: every
    chunk) and at the end, each sampling chunk's draws are kept as
    ``samples_*.npz``, and ``resume=True`` continues exactly from the latest
    checkpoint, the generators set to their saved states.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh: sharding chains over devices is not ported yet (ROADMAP.md, queue 1 item 14)"
        )
    if n_warmup is None:
        n_warmup = max(100, n_samples // 5)

    sweep = make_sweep(pop, data, n_leapfrog=n_leapfrog, target_accept=target_accept,
                       row_batch=row_batch, fisher_params=init_params, glm_update=glm_update)
    seeds = _chain_seeds(seed, n_chains + 1)
    gens = [torch.Generator(device=pop.device).manual_seed(s) for s in seeds[:n_chains]]
    if init_params is None:
        inits = [pop.sample(g) for g in gens]
    else:
        inits = [dict(init_params) for _ in range(n_chains)]
        if init_jitter > 0:
            g_jit = torch.Generator(device=pop.device).manual_seed(seeds[-1])
            # 'locs' is both a block key and named again, so it is jittered
            # twice, as in the JAX package
            for name in list(_GLM_KEYS) + ["locs", "W"]:
                if name in init_params:
                    x = init_params[name]
                    noise = torch.randn((n_chains,) + tuple(x.shape), generator=g_jit,
                                        dtype=x.dtype, device=x.device)
                    for c in range(n_chains):
                        inits[c][name] = inits[c][name] + init_jitter * noise[c]
    states = [init_mcmc_state(pop, p, step_size=step_size) for p in inits]

    def step(states, adapt, beta):
        return [sweep(g, s, adapt, beta) for g, s in zip(gens, states)]

    store = None if checkpoint_dir is None else _Store(checkpoint_dir, checkpoint_every, gens, pop.device)
    states, samples, acc = _run(
        step, states, n_warmup, n_samples, thin, chunk_size, anneal_frac, callback,
        end_of_warmup=_share_adaptation, store=store, resume=resume,
    )
    diagnostics = {"convergence": summarize_chains(samples)}
    for name in ("glm", "imp", "latent"):
        if name in states[0]:
            diagnostics[f"accept_rate_{name}"] = np.array([float(s[name].accept_rate) for s in states])
            diagnostics[f"step_size_{name}"] = np.array([float(s[name].step_size) for s in states])
    if acc is not None:
        diagnostics["accept_rate_adjacency"] = acc
    return samples, diagnostics, states
