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
eagerly on the population's device; :func:`gibbs_sample` loops over it. It
takes one chain's state and generator, or the state of C chains on a
leading axis of every tensor with a list of C generators (the JAX package's
``vmap`` of the sweep, written out): every stage then updates all chains at
once, and each chain's generator makes the draws it would make alone.
:func:`gibbs_sample` is that batched sweep at C = 1.
Warmup follows Stan-style expanding adaptation windows
(:func:`warmup_schedule`). The JAX package's chunk-length alignment
(``warmup_chunk``/``sampling_chunk``) and its traced ``data`` argument exist
only for XLA compiles and have no counterpart here: ``chunk_size`` paces the
callbacks, the host copies of the samples, the ARS bias pass and the
checkpoints. Every draw of a sweep comes from the chain's generator, so the
chunk layout does not change the draws of the sweeps, and a run restored
from a checkpoint (the states, the generators' states and the iteration;
:mod:`theano_pyglm_torch.utils.checkpoints`) continues exactly.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from theano_pyglm_torch.inference.gibbs import (
    _coupling_current,
    refresh_disconnected_weights,
    update_adjacency_collapsed,
    update_er_rho,
    update_glm_laplace,
    update_glm_laplace_shared,
    update_glm_laplace_st,
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
from theano_pyglm_torch.utils.checkpoints import latest_step, restore_checkpoint, save_checkpoint

__all__ = [
    "SWEEP_STAGES",
    "chain_state",
    "stack_states",
    "make_sweep",
    "gibbs_sample",
    "init_mcmc_state",
    "warmup_schedule",
    "anneal_schedule",
    "adapt_boundary",
    "thin_chunk",
    "whitening_factor",
]


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
    """Apply a warmup-window boundary action to every HMC block of a state
    (one chain's, or all chains' at once)."""

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
    """The MCMC state: params plus one HMCState per continuous block present
    in ``params``, on the population's device and dtype. ``params`` of one
    chain give one chain's state; params of C chains (every leaf (C, ...))
    the chains' batched state, with a step size, dual-averaging state and
    accept rate per chain. The cached log_prob is a placeholder: the sweep
    re-anchors it."""
    lead = params["A"].shape[:-2]

    def full(v):
        return torch.full(lead, v, dtype=pop.dtype, device=pop.device)

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


def _map_state(fn, x):
    """``fn`` on every tensor of a state (dicts, HMCState records)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, HMCState):
        return HMCState(*(None if v is None else _map_state(fn, v) for v in x))
    if isinstance(x, dict):
        return {k: _map_state(fn, v) for k, v in x.items()}
    return x


def chain_state(state: dict, c: int) -> dict:
    """Chain c of a batched state: every tensor indexed at c on its leading
    axis (views, no copy), the state one chain alone would have."""
    return _map_state(lambda t: t[c], state)


def stack_states(states) -> dict:
    """The batched state of a list of one-chain states (or params dicts):
    every tensor stacked on a new leading chain axis."""

    def stack(xs):
        first = xs[0]
        if isinstance(first, torch.Tensor):
            return torch.stack(xs)
        if isinstance(first, HMCState):
            return HMCState(*(None if v is None else stack([x[i] for x in xs]) for i, v in enumerate(first)))
        if isinstance(first, dict):
            return {k: stack([x[k] for x in xs]) for k in first}
        return first

    return stack(list(states))


#: update groups accepted by ``make_sweep(stages=...)``, in sweep order
SWEEP_STAGES = ("glm", "imp", "latent", "hypers", "adjacency", "discrete", "rotation")


def make_sweep(pop, data, n_leapfrog: int = 10, target_accept: float = 0.9,
               row_batch=None, fisher_params: Optional[dict] = None,
               glm_update: str = "auto", stages=None,
               diagnostic: bool = False):
    """Build the one-iteration Gibbs sweep (see module docstring).

    Returns ``sweep(generator, state, adapt, beta=1.0) -> state``: one
    chain's state and generator, or C chains' batched state
    (:func:`init_mcmc_state` of batched params) and a list of C generators,
    one per chain. ``adapt`` (a Python bool) enables step-size adaptation
    and the Welford statistics (warmup); ``beta`` tempers the likelihood
    (annealed warmup). The new state also holds ``accept_adjacency``, the
    birth–death move's mean acceptance in that sweep (of each chain).

    ``row_batch``: run the adjacency stage ``row_batch`` postsynaptic rows
    at a time (bounded ψ memory). ``fisher_params``: the parameters at which
    the glm Laplace block seeds its Newton iterations (typically the MAP).
    ``glm_update``: 'auto' or 'laplace' sample the glm block by the
    Laplace-MH update of the stimulus variant (:data:`_GLM_LAPLACE`);
    'hmc' by HMC with the stimulus weights whitened (:func:`whitening_factor`).
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
    glm_laplace = glm_update != "hmc"
    bk_type = pop.spec.get("bkgd", {}).get("type", "none")
    if glm_laplace:
        theta0 = _glm_theta0(pop, data, fisher_params, bk_type)
        glm_laplace_fn = _GLM_LAPLACE[bk_type]
    # The HMC fallback samples the stimulus weights whitened, w̃ = w Rᵀ with
    # R = chol(XᵀX/T + 1e-6·I): overlapping basis columns correlate X_stim's
    # columns, which a diagonal preconditioner cannot undo. An exact change
    # of variables with a constant Jacobian; model and prior are untouched.
    R = whitening_factor(data["X_stim"]) if "X_stim" in data and not glm_laplace else None

    def sweep(generator, state, adapt: bool, beta: float = 1.0):
        params = state["params"]
        new_state = {}
        for name, keys in _HMC_BLOCKS:
            if name not in state:
                continue
            if not _on(name):
                new_state[name] = state[name]
                continue
            if name == "glm" and glm_laplace:
                params, acc = glm_laplace_fn(generator, pop, params, data, theta0, beta=beta, return_accept=True)
                opt, _ = _partition(params, keys)
                new_state["glm"] = _fresh_block_state(state["glm"], opt, torch.zeros_like(acc))._replace(
                    accept_rate=acc)
                continue
            opt, frozen = _partition(params, keys)
            if name == "latent":
                # the likelihood does not touch the latents; the graph prior does
                def logp(o, frozen=frozen):
                    return pop.graph.log_prior({**frozen, **o})
            elif name == "glm":
                opt, logp = _glm_hmc_target(pop, params, data, R, beta)
            else:  # 'imp': the full likelihood, through the fused kernels K1/K2
                def logp(o, frozen=frozen):
                    p = {**frozen, **o}
                    return beta * pop.log_likelihood(p, data) + pop.impulse.log_prior(p)
            with torch.no_grad():
                h = _fresh_block_state(state[name], opt, logp(opt))
            h = hmc_adaptive_step(
                generator, logp, h, n_steps=n_leapfrog, target_accept=target_accept, adapt=adapt
            )
            out = _whitened(h.position, R, inverse=True) if name == "glm" else h.position
            params = {**frozen, **out}
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


#: the glm block's Laplace-MH update of each stimulus variant
_GLM_LAPLACE = {
    "none": update_glm_laplace,
    "basis": update_glm_laplace,
    "spatiotemporal": update_glm_laplace_st,
    "shared": update_glm_laplace_shared,
}


def whitening_factor(X) -> torch.Tensor:
    """R = chol(XᵀX/T + 1e-6·I), lower, of a (T, DB) stimulus design: the
    glm HMC block samples w̃ = w Rᵀ in place of the stimulus weights w."""
    eye = torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
    return torch.linalg.cholesky(X.T @ X / X.shape[0] + 1e-6 * eye)


def _whitened(opt: dict, R, inverse: bool = False) -> dict:
    """``opt`` with its 'w_stim' whitened (w Rᵀ) or, with ``inverse``,
    de-whitened (w̃ R⁻ᵀ, a triangular solve); unchanged without R or
    'w_stim'."""
    if R is None or "w_stim" not in opt:
        return opt
    w = opt["w_stim"]
    if inverse:
        w = torch.linalg.solve_triangular(R.T, w, upper=True, left=False)
    else:
        w = w @ R.T
    return {**opt, "w_stim": w}


def _glm_hmc_target(pop, params, data, R, beta):
    """(the glm block's whitened position, its log-density) for the HMC
    fallback: β·LL + the bias and stimulus priors, with the coupling current
    computed once outside the leapfrog. The likelihood is the plain one: the
    fused kernels take the coupling weights, which this block holds fixed."""
    opt, frozen = _partition(params, _HMC_BLOCKS[0][1])
    I_coupling = _coupling_current(pop, params, data)

    def logp(o):
        p = {**frozen, **_whitened(o, R, inverse=True)}
        I = pop.bias.current(p, data) + pop.bkgd.current(p, data) + I_coupling
        ll = pop.observation.log_likelihood(data["S"], I, pop.nlin, pop.dt).sum((-2, -1))
        return beta * ll + pop.bias.log_prior(p) + pop.bkgd.log_prior(p)

    return _whitened(opt, R), logp


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
    """[sweep] batched params dicts → {leaf: (n_sweeps, n_chains, ...)} on the device."""
    return {k: torch.stack([p[k] for p in chunk]) for k in chunk[0]}


class _Store:
    """The checkpoints and persisted sample chunks of one sampler run in
    ``directory``: the chains' batched state, their generators' states and
    the summed birth–death acceptance, saved at the end of a chunk that
    crosses a multiple of ``every`` (every chunk when 0) and at the very
    end; each sampling chunk's kept draws as ``samples_<iteration>.npz``."""

    def __init__(self, directory: str, every: int, generators, device):
        self.directory, self.every, self.generators, self.device = directory, every, generators, device

    def restore(self):
        """(iteration, state, summed acceptance, kept sample chunks) of the
        latest checkpoint, with the generators set to their saved states;
        None without one. Only the sample chunks at or before the restored
        iteration count: later ones are made again."""
        step = latest_step(self.directory)
        if step is None:
            return None
        saved, gen_states, step = restore_checkpoint(self.directory, step, map_location=self.device)
        saved, gen_states = self._own(saved, gen_states)
        for g, st in zip(self.generators, gen_states):
            g.set_state(st)
        chunks = []
        for f in sorted(os.listdir(self.directory)):
            if f.startswith("samples_") and f.endswith(".npz") and int(f[8:-4]) <= step:
                with np.load(os.path.join(self.directory, f)) as z:
                    chunks.append({k: z[k] for k in z.files})
        return step, saved["states"], saved["accept_sum"], chunks

    def _own(self, saved: dict, gen_states: list) -> tuple:
        """The part of a restored checkpoint that this process runs: all of
        it (a chain-sharded run takes its block of the chains)."""
        return saved, gen_states

    def persist(self, it: int, kept: dict) -> None:
        os.makedirs(self.directory, exist_ok=True)
        np.savez_compressed(os.path.join(self.directory, f"samples_{it:09d}.npz"), **kept)

    def due(self, prev_it: int, it: int, last: bool) -> bool:
        """A checkpoint is written at the end of a chunk that crosses a
        multiple of ``every`` (every chunk when 0) and at the very end."""
        return last or not self.every or prev_it // self.every != it // self.every

    def checkpoint(self, prev_it: int, it: int, last: bool, state, acc_sum) -> None:
        if self.due(prev_it, it, last):
            save_checkpoint(self.directory, it, {"states": state, "accept_sum": acc_sum}, self.generators)


def _run(step, state, n_warmup, n_samples, thin, chunk_size, anneal_frac, callback,
         end_of_warmup=None, after_chunk=None, store: Optional[_Store] = None, resume: bool = False,
         gather=None):
    """Drive ``step(state, adapt, beta) -> state`` (the chains' batched
    state) through warmup, its adaptation windows and then sampling.

    A chunk ends every ``chunk_size`` sweeps of a phase and at the end of
    each phase. There, in order: ``after_chunk(iteration, state, beta)``
    may replace the state (the ARS bias pass); the chunk's kept draws are
    copied to the host (sampling); ``store`` persists them and checkpoints;
    ``callback(phase, sweeps done in the phase, state)`` runs. With
    ``resume`` the run starts from the store's latest checkpoint, if any.
    ``gather(tree, dim)``: where this process runs a block of the chains (a
    chain-sharded run), every chain's tensors from this block's, along the
    chain axis ``dim``; the kept draws, the callback's state and the
    acceptance are gathered (None: the identity).
    Returns (state, samples {leaf: (n_samples, n_chains, ...) numpy},
    per-chain mean acceptance of the birth–death move over all sweeps, or
    None).
    """
    if gather is None:
        def gather(tree, dim=0):
            return tree

    boundaries = warmup_schedule(n_warmup)
    beta_at = anneal_schedule(n_warmup, anneal_frac)
    total = n_samples * thin
    start, acc_sum, host = 0, None, []
    restored = store.restore() if store is not None and resume else None
    if restored is not None:
        start, state, acc_sum, host = restored

    def track(state):
        nonlocal acc_sum
        if "accept_adjacency" in state:
            acc = state["accept_adjacency"]
            acc_sum = acc if acc_sum is None else acc_sum + acc

    def chunk_end(phase, done, prev_it, it, state, beta, kept=None):
        if after_chunk is not None:
            state = after_chunk(it, state, beta)
        if kept is not None:
            kept = {k: v.cpu().numpy() for k, v in gather(kept, 1).items()}
            host.append(kept)
        if store is not None:
            if kept is not None:
                store.persist(it, kept)
            store.checkpoint(prev_it, it, it == n_warmup + total, state, acc_sum)
        if callback is not None:
            callback(phase, done, gather(state))
        return state

    prev = start
    for it in range(start, n_warmup):
        beta = 1.0 if beta_at is None else beta_at(it)
        state = step(state, True, beta)
        track(state)
        for b, action in boundaries:
            if b == it + 1:
                state = adapt_boundary(state, action)
        if (it + 1) % chunk_size == 0 or it + 1 == n_warmup:
            state = chunk_end("warmup", it + 1, prev, it + 1, state, beta)
            prev = it + 1
    if end_of_warmup is not None and start <= n_warmup:
        state = end_of_warmup(state)

    chunk = []
    for it in range(max(start - n_warmup, 0), total):
        state = step(state, False, 1.0)
        track(state)
        chunk.append(state["params"])
        if (it + 1) % chunk_size == 0 or it + 1 == total:
            kept = thin_chunk(_stack_chunk(chunk), thin, it + 1 - len(chunk))
            state = chunk_end("sample", it + 1, prev, n_warmup + it + 1, state, 1.0, kept)
            prev, chunk = n_warmup + it + 1, []
    samples = {k: np.concatenate([h[k] for h in host], 0) for k in host[0]} if host else {}
    n_sweeps = n_warmup + total
    acc = None if acc_sum is None or n_sweeps == 0 else (gather(acc_sum) / n_sweeps).cpu().numpy()
    return state, samples, acc


def _ars_random_state(seed: int, it: int) -> np.random.RandomState:
    """The host RandomState of the ARS pass at global iteration ``it``,
    seeded from (the generator's seed, the iteration): a restored run
    replays the same ARS draws."""
    return np.random.RandomState(np.random.SeedSequence([seed, 7, it]).generate_state(1)[0])


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

    Checkpoints: with ``checkpoint_dir``, the state, the generator's state
    and the iteration are saved at the end of every chunk that crosses a
    multiple of ``checkpoint_every`` (0: every chunk) and at the end, and
    each sampling chunk's draws are kept there as ``samples_*.npz``;
    ``resume=True`` continues exactly from the latest checkpoint, with the
    generator set to its saved state (pass the first run's ``init_params``:
    the glm block's Newton seed comes from them, or, without them, from a
    prior draw of ``generator``).

    ``bias_update='ars'`` also redraws every neuron's bias from its exact
    conditional by adaptive rejection sampling at the end of each chunk
    (:func:`theano_pyglm_torch.inference.ars.update_bias_ars`; exp-Poisson
    only; skipped while annealed warmup tempers the likelihood). It is host
    code: one copy of the currents' sums to the host and of the new biases
    back per pass. Its host RandomState is seeded from the generator's seed
    and the iteration, so a resumed run replays it.
    """
    if bias_update not in ("default", "ars"):
        raise ValueError(f"unknown bias_update {bias_update!r}")
    if n_warmup is None:
        n_warmup = max(100, n_samples // 5)
    if init_params is None:
        init_params = pop.sample(generator)
    sweep = make_sweep(pop, data, n_leapfrog=n_leapfrog, target_accept=target_accept,
                       row_batch=row_batch, fisher_params=init_params, glm_update=glm_update)
    gens = [generator]  # the batched sweep at C = 1

    def step(state, adapt, beta):
        return sweep(gens, state, adapt, beta)

    after_chunk = None
    if bias_update == "ars":
        from theano_pyglm_torch.inference.ars import update_bias_ars

        def after_chunk(it, state, beta):
            if beta < 1.0:  # ARS targets the untempered conditional
                return state
            # the generator's seed, read now: after a restore it is the first run's
            rng = _ars_random_state(generator.initial_seed(), it)
            params = update_bias_ars(rng, pop, chain_state(state["params"], 0), data)
            return {**state, "params": {k: v[None] for k, v in params.items()}}

    cb = None
    if callback is not None:
        def cb(phase, it, state):
            callback(phase, it if phase == "warmup" else n_warmup + it, chain_state(state, 0))

    store = None if checkpoint_dir is None else _Store(checkpoint_dir, checkpoint_every, gens, pop.device)
    state, samples, acc = _run(
        step, init_mcmc_state(pop, stack_states([init_params]), step_size=step_size),
        n_warmup, n_samples, thin, chunk_size, anneal_frac, cb,
        after_chunk=after_chunk, store=store, resume=resume,
    )
    state = chain_state(state, 0)
    samples = {k: v[:, 0] for k, v in samples.items()}
    diagnostics = {}
    for name, _ in _HMC_BLOCKS:
        if name in state:
            diagnostics[f"accept_rate_{name}"] = float(state[name].accept_rate)
            diagnostics[f"step_size_{name}"] = float(state[name].step_size)
    if acc is not None:
        diagnostics["accept_rate_adjacency"] = float(acc[0])
    return samples, diagnostics, state
