"""MCMC — the Gibbs sweep and its sampling loop.

Port of :mod:`theano_pyglm_tpu.inference.mcmc`. Each sweep interleaves
  1. the glm block (bias, stimulus weights) by Laplace independence-MH, and
     HMC on the impulse logits and on the latent locations, each HMC block
     with its own dual-averaged step size and diagonal preconditioner;
  2. conjugate weight-hyperparameter resampling and the prior refresh of
     disconnected weights;
  3. the row-parallel joint (A, W) birth–death sweep over the adjacency;
  4. the discrete graph stages (SBM types and hypers, ER density);
  5. the Haar rotation of the latent locations.

The sweep is a plain function ``sweep(generator, state, adapt, beta)`` run
eagerly on the population's device; :func:`gibbs_sample` loops over it.
Warmup follows Stan-style expanding adaptation windows
(:func:`warmup_schedule`). The JAX package's chunk-length alignment
(``warmup_chunk``/``sampling_chunk``) and its traced ``data`` argument exist
only for XLA compiles and have no counterpart here: ``chunk_size`` paces the
callbacks and the host copies of the samples. Not ported yet:
``glm_update='hmc'`` with stimulus whitening and ``bias_update='ars'``
(ROADMAP.md, queue 1 item 10), checkpoints and resume (item 8), and the glm
blocks of the spatiotemporal and shared stimulus variants (item 10).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from theano_pyglm_torch.inference.gibbs import (
    refresh_disconnected_weights,
    update_adjacency_collapsed,
    update_er_rho,
    update_glm_laplace,
    update_latent_rotation,
    update_sbm_hypers,
    update_sbm_types_collapsed,
    update_weight_hypers,
)
from theano_pyglm_torch.inference.hmc import (
    HMCState,
    apply_mass_matrix,
    hmc_adaptive_step,
    reset_variance,
)

__all__ = [
    "SWEEP_STAGES",
    "make_sweep",
    "gibbs_sample",
    "init_mcmc_state",
    "warmup_schedule",
    "anneal_schedule",
    "adapt_boundary",
    "thin_chunk",
]

_ITEM8 = "not ported yet (ROADMAP.md, queue 1 item 8: utils/checkpoints.py)"
_ITEM10 = "not ported yet (ROADMAP.md, queue 1 item 10: other model variants and samplers)"


def _glm_theta0(pop, data, fisher_params, bk_type):
    """State-independent Newton seed for the glm Laplace-MH block: the
    init/MAP values if available, else the prior means. An (N, D) tensor for
    the none/basis stimulus, a dict of the block's leaves for
    spatiotemporal/shared."""
    f, dev = pop.dtype, pop.device
    N = pop.N
    bmu = float(pop.spec.get("bias", {}).get("mu", 2.0))
    smu = float(pop.spec.get("bkgd", {}).get("mu", 0.0))
    have = fisher_params is not None and "bias" in fisher_params

    def leaf(name, default):
        if have and name in fisher_params:
            return torch.as_tensor(fisher_params[name], device=dev).to(f)
        return default

    if bk_type in ("none", "basis"):
        D = 1 + (data["X_stim"].shape[1] if "X_stim" in data else 0)
        if have:
            th = leaf("bias", None)[:, None]
            if D > 1:
                th = torch.cat([th, leaf("w_stim", None)], 1)
            return th
        return torch.cat([torch.full((N, 1), bmu, dtype=f, device=dev),
                          torch.full((N, D - 1), smu, dtype=f, device=dev)], 1)
    if bk_type == "spatiotemporal":
        Ds, B = data["X_st"].shape[1], data["X_st"].shape[2]
        return {
            "bias": leaf("bias", torch.full((N,), bmu, dtype=f, device=dev)),
            "w_stim_s": leaf("w_stim_s", torch.full((N, Ds), smu, dtype=f, device=dev)),
            "w_stim_t": leaf("w_stim_t", torch.full((N, B), smu, dtype=f, device=dev)),
        }
    if bk_type == "shared":
        DB = data["X_stim"].shape[1]
        return {
            "bias": leaf("bias", torch.full((N,), bmu, dtype=f, device=dev)),
            "gain": leaf("gain", torch.ones((N,), dtype=f, device=dev)),
            "w_stim_shared": leaf("w_stim_shared", torch.full((DB,), smu, dtype=f, device=dev)),
        }
    raise ValueError(f"unknown bkgd type {bk_type!r}")


def warmup_schedule(n_warmup: int):
    """Stan-style expanding warmup windows:
    [0,b1) ε-only · [b1,b2) variance window 1 · apply+reset at b2 ·
    [b2,b3) variance window 2 · apply at b3 · [b3,n) final ε adaptation.
    Mass adaptation is skipped for warmups shorter than 40 sweeps."""
    if n_warmup < 40:
        return []
    b1 = max(1, int(0.15 * n_warmup))
    b2 = max(b1 + 1, int(0.50 * n_warmup))
    b3 = max(b2 + 1, int(0.85 * n_warmup))
    return [(b1, "reset"), (b2, "apply_reset"), (b3, "apply")]


def adapt_boundary(state: dict, action: str) -> dict:
    """Apply a warmup-window boundary action to every HMC block of one
    chain's state."""

    def fn(s):
        if action == "reset":
            return reset_variance(s)
        if action == "apply_reset":
            return reset_variance(apply_mass_matrix(s))
        return apply_mass_matrix(s)

    out = dict(state)
    for k, _ in _HMC_BLOCKS:
        if k in out:
            out[k] = fn(out[k])
    return out


# One block per component group, each with its own step size and diagonal
# preconditioner. W is in no block: the birth–death move re-proposes every
# (A, W) entry each sweep.
_HMC_BLOCKS = (
    ("glm", ("bias", "w_stim", "w_stim_s", "w_stim_t", "w_stim_shared", "gain")),
    ("imp", ("w_ir",)),
    ("latent", ("locs",)),
)
_GLM_KEYS = tuple(k for _, ks in _HMC_BLOCKS for k in ks)


def _partition(params, keys):
    inblock = {k: v for k, v in params.items() if k in keys}
    rest = {k: v for k, v in params.items() if k not in keys}
    return inblock, rest


def _fresh_block_state(prev: HMCState, position, log_prob) -> HMCState:
    """Reuse the adaptation statistics, re-anchor position and log-prob (the
    frozen complement changed since the last sweep)."""
    return prev._replace(position=position, log_prob=log_prob)


def init_mcmc_state(pop, params, step_size: float = 0.02) -> dict:
    """The MCMC state of one chain: params plus one HMCState per continuous
    block present in ``params``, on the population's device and dtype. The
    cached log_prob is a placeholder: the sweep re-anchors it."""

    def full(v):
        return torch.full((), v, dtype=pop.dtype, device=pop.device)

    eps = full(step_size)

    def block(position):
        return HMCState(
            position=position,
            log_prob=full(0.0),
            step_size=eps,
            log_eps_avg=torch.log(eps),
            h_avg=full(0.0),
            t=full(0.0),
            accept_rate=full(1.0),
            mu=torch.log(10.0 * eps),
            scale={k: torch.ones_like(v) for k, v in position.items()},
            pos_mean={k: torch.zeros_like(v) for k, v in position.items()},
            pos_m2={k: torch.zeros_like(v) for k, v in position.items()},
            n_var=full(0.0),
        )

    state = {"params": params}
    for name, keys in _HMC_BLOCKS:
        pos, _ = _partition(params, keys)
        if pos:
            state[name] = block(pos)
    return state


#: update groups accepted by ``make_sweep(stages=...)``, in sweep order
SWEEP_STAGES = ("glm", "imp", "latent", "hypers", "adjacency", "discrete", "rotation")


def make_sweep(pop, data, n_leapfrog: int = 10, target_accept: float = 0.9,
               row_batch=None, fisher_params: Optional[dict] = None,
               glm_update: str = "auto", stages=None,
               diagnostic: bool = False):
    """Build the one-iteration Gibbs sweep (see module docstring).

    Returns ``sweep(generator, state, adapt, beta=1.0) -> state``: ``adapt``
    (a Python bool) enables step-size adaptation and the Welford statistics
    (warmup); ``beta`` tempers the likelihood (annealed warmup). The new
    state also holds ``accept_adjacency``, the birth–death move's mean
    acceptance in that sweep.

    ``row_batch``: run the adjacency stage ``row_batch`` postsynaptic rows
    at a time (bounded ψ memory). ``fisher_params``: the parameters at which
    the glm Laplace block seeds its Newton iterations (typically the MAP).
    ``stages``: a subset of :data:`SWEEP_STAGES` to run, the others passing
    their state through. A strict subset is not a valid posterior kernel
    and needs ``diagnostic=True`` (per-stage timing and A/B diagnostics
    only); without it ``make_sweep`` raises.
    """
    if stages is not None:
        unknown = set(stages) - set(SWEEP_STAGES)
        if unknown:
            raise ValueError(f"unknown sweep stages {sorted(unknown)}")
        if set(stages) != set(SWEEP_STAGES) and not diagnostic:
            raise ValueError(
                "make_sweep(stages=...) with a strict subset of "
                f"SWEEP_STAGES {sorted(set(SWEEP_STAGES) - set(stages))} "
                "omitted builds a PARTIAL sweep that is not a valid "
                "posterior kernel (e.g. adjacency depends on the hypers "
                "stage's disconnected-weight refresh). Pass "
                "diagnostic=True if this is for per-stage timing or A/B "
                "diagnostics only."
            )

    def _on(stage):
        return stages is None or stage in stages

    if glm_update not in ("auto", "laplace", "hmc"):
        raise ValueError(f"unknown glm_update {glm_update!r}")
    if glm_update == "hmc":
        raise NotImplementedError(f"glm_update='hmc' (whitened HMC on the glm block) is {_ITEM10}")
    bk_type = pop.spec.get("bkgd", {}).get("type", "none")
    theta0 = _glm_theta0(pop, data, fisher_params, bk_type)
    if bk_type not in ("none", "basis"):
        raise NotImplementedError(f"the glm Laplace block of the {bk_type!r} stimulus is {_ITEM10}")
    zero = torch.zeros((), dtype=pop.dtype, device=pop.device)

    def sweep(generator, state, adapt: bool, beta: float = 1.0):
        params = state["params"]
        new_state = {}
        for name, keys in _HMC_BLOCKS:
            if name not in state:
                continue
            if not _on(name):
                new_state[name] = state[name]
                continue
            if name == "glm":
                params, acc = update_glm_laplace(
                    generator, pop, params, data, theta0, beta=beta, return_accept=True
                )
                opt, _ = _partition(params, keys)
                new_state["glm"] = _fresh_block_state(state["glm"], opt, zero)._replace(accept_rate=acc)
                continue
            opt, frozen = _partition(params, keys)
            if name == "latent":
                # the likelihood does not touch the latents; the graph prior does
                def logp(o, frozen=frozen):
                    return pop.graph.log_prior({**frozen, **o})
            else:  # 'imp': the full likelihood, through the fused kernels K1/K2
                def logp(o, frozen=frozen):
                    p = {**frozen, **o}
                    return beta * pop.log_likelihood(p, data) + pop.impulse.log_prior(p)
            with torch.no_grad():
                h = _fresh_block_state(state[name], opt, logp(opt))
            h = hmc_adaptive_step(
                generator, logp, h, n_steps=n_leapfrog, target_accept=target_accept, adapt=adapt
            )
            params = {**frozen, **h.position}
            new_state[name] = h

        if _on("hypers"):
            params = update_weight_hypers(generator, pop, params)
            params = refresh_disconnected_weights(generator, pop, params)
        if _on("adjacency"):
            params, new_state["accept_adjacency"] = update_adjacency_collapsed(
                generator, pop, params, data, return_accept=True, row_batch=row_batch, beta=beta
            )
        elif "accept_adjacency" in state:
            new_state["accept_adjacency"] = state["accept_adjacency"]
        if _on("discrete"):
            params = update_sbm_types_collapsed(generator, pop, params)
            params = update_sbm_hypers(generator, pop, params)
            params = update_er_rho(generator, pop, params)
        if _on("rotation"):
            params = update_latent_rotation(generator, pop, params)
        new_state["params"] = params
        return new_state

    return sweep


def thin_chunk(samples, thin: int, phase: int):
    """Slice one chunk of samples onto the *global* thinning grid: index i
    of the chunk is kept iff (phase + i) % thin == thin-1, where ``phase``
    is the number of sampling iterations before the chunk."""
    if thin <= 1:
        return samples
    start = (thin - 1 - phase) % thin
    return {k: v[start::thin] for k, v in samples.items()}


def anneal_schedule(n_warmup: int, anneal_frac: float):
    """Likelihood-tempering warmup schedule: β ramps linearly from ~0 to 1
    over the first ``anneal_frac`` of warmup, then stays at 1 (0.0 disables;
    sampling always runs at β=1)."""
    if anneal_frac <= 0.0:
        return None
    ramp = max(1, int(round(anneal_frac * n_warmup)))

    def beta_at(it):  # global warmup iteration index
        return min(1.0, (it + 1) / ramp)

    return beta_at


def _stack_chunk(chunk) -> dict:
    """[sweep][chain] params dicts → {leaf: (n_sweeps, n_chains, ...)} on the device."""
    return {k: torch.stack([torch.stack([p[k] for p in per_chain]) for per_chain in chunk])
            for k in chunk[0][0]}


def _run(step, states, n_warmup, n_samples, thin, chunk_size, anneal_frac, callback,
         end_of_warmup=None):
    """Drive ``step(states, adapt, beta) -> states`` (one state per chain)
    through warmup, its adaptation windows and then sampling.

    ``callback(phase, sweeps done in the phase, states)`` runs every
    ``chunk_size`` sweeps and at the end of each phase; the retained draws
    are copied to the host at the same points. Returns (states, samples
    {leaf: (n_samples, n_chains, ...) numpy}, per-chain mean acceptance of
    the birth–death move over all sweeps, or None).
    """
    boundaries = warmup_schedule(n_warmup)
    beta_at = anneal_schedule(n_warmup, anneal_frac)
    acc_sum = None

    def track(states):
        nonlocal acc_sum
        if "accept_adjacency" in states[0]:
            acc = torch.stack([s["accept_adjacency"] for s in states])
            acc_sum = acc if acc_sum is None else acc_sum + acc

    for it in range(n_warmup):
        states = step(states, True, 1.0 if beta_at is None else beta_at(it))
        track(states)
        for b, action in boundaries:
            if b == it + 1:
                states = [adapt_boundary(s, action) for s in states]
        if callback is not None and ((it + 1) % chunk_size == 0 or it + 1 == n_warmup):
            callback("warmup", it + 1, states)
    if end_of_warmup is not None:
        states = end_of_warmup(states)

    total = n_samples * thin
    host, chunk, phase = [], [], 0
    for it in range(total):
        states = step(states, False, 1.0)
        track(states)
        chunk.append([s["params"] for s in states])
        if (it + 1) % chunk_size == 0 or it + 1 == total:
            kept = thin_chunk(_stack_chunk(chunk), thin, phase)
            host.append({k: v.cpu().numpy() for k, v in kept.items()})
            phase, chunk = it + 1, []
            if callback is not None:
                callback("sample", it + 1, states)
    samples = {k: np.concatenate([h[k] for h in host], 0) for k in host[0]} if host else {}
    n_sweeps = n_warmup + total
    acc = None if acc_sum is None or n_sweeps == 0 else (acc_sum / n_sweeps).cpu().numpy()
    return states, samples, acc


def _check_unported(checkpoint_dir, resume):
    if checkpoint_dir is not None or resume:
        raise NotImplementedError(f"checkpoint_dir/resume are {_ITEM8}")


def gibbs_sample(
    pop,
    data,
    generator: torch.Generator,
    n_samples: int = 1000,
    n_warmup: Optional[int] = None,
    init_params: Optional[dict] = None,
    thin: int = 1,
    n_leapfrog: int = 10,
    chunk_size: int = 100,
    step_size: float = 0.02,
    target_accept: float = 0.9,
    callback=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    row_batch: Optional[int] = None,
    anneal_frac: float = 0.0,
    bias_update: str = "default",
    glm_update: str = "auto",
):
    """Full Bayesian inference with one chain: ``n_warmup`` adaptation
    sweeps, then ``n_samples·thin`` sampling sweeps keeping every
    ``thin``-th params dict. Every draw comes from ``generator``, which
    lives on the population's device.

    Returns (samples, diagnostics, final_state): ``samples`` is a dict of
    numpy arrays with leading axis n_samples; ``diagnostics`` holds each
    block's accept rate and step size and ``accept_rate_adjacency``, the
    birth–death move's mean acceptance over all sweeps. ``callback(phase,
    iteration, state)`` gets the global iteration count.
    """
    _check_unported(checkpoint_dir, resume)
    if bias_update not in ("default", "ars"):
        raise ValueError(f"unknown bias_update {bias_update!r}")
    if bias_update == "ars":
        raise NotImplementedError(f"bias_update='ars' is {_ITEM10}")
    if n_warmup is None:
        n_warmup = max(100, n_samples // 5)
    if init_params is None:
        init_params = pop.sample(generator)
    sweep = make_sweep(pop, data, n_leapfrog=n_leapfrog, target_accept=target_accept,
                       row_batch=row_batch, fisher_params=init_params, glm_update=glm_update)

    def step(states, adapt, beta):
        return [sweep(generator, states[0], adapt, beta)]

    cb = None
    if callback is not None:
        def cb(phase, it, states):
            callback(phase, it if phase == "warmup" else n_warmup + it, states[0])

    (state,), samples, acc = _run(
        step, [init_mcmc_state(pop, init_params, step_size=step_size)],
        n_warmup, n_samples, thin, chunk_size, anneal_frac, cb,
    )
    samples = {k: v[:, 0] for k, v in samples.items()}
    diagnostics = {}
    for name, _ in _HMC_BLOCKS:
        if name in state:
            diagnostics[f"accept_rate_{name}"] = float(state[name].accept_rate)
            diagnostics[f"step_size_{name}"] = float(state[name].step_size)
    if acc is not None:
        diagnostics["accept_rate_adjacency"] = float(acc[0])
    return samples, diagnostics, state
