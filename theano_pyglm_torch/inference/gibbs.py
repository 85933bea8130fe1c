"""Gibbs sweep stages — adjacency, the glm Laplace block, conjugate hypers,
SBM types and hypers, the ER density, the latent-rotation gauge move.

Port of :mod:`theano_pyglm_tpu.inference.gibbs`. Flipping A[n, m] only
perturbs neuron n's current by W[n,m]·ψ[:, n, m], where

    ψ[t, n, m] = X_imp[t, m, :] · w_eff[n, m, :]

so the adjacency stages update all N postsynaptic rows at once (rows are a
batch dimension of every tensor) and the entries of a row in sequence (a
Python loop of fixed length over m, carrying the rows' running currents).
Inside a stage nothing reads a device value on the host: accept/reject,
clipping and the escape hatches are tensor ops, and every random number of
a stage is drawn up front from the caller's ``torch.Generator``, so
``row_batch`` changes the memory held, not the draws.

The SBM type stage is a loop over neurons in the same way: each neuron's
class is drawn by Gumbel-max from noise drawn up front, and written back
with ``torch.where``, so no draw reads back to the host.

The exp-Poisson model takes closed forms (per-bin derivatives, the
birth–death ΔLL on a time subsample). Every other (observation,
nonlinearity) pair takes the generic branches, with derivatives by
autograd: ``_bin_ll_derivs`` differentiates the per-bin log-likelihood
twice, and the birth–death Newton fit differentiates the exact full-T ΔLL
of the entry twice. The glm block has one Laplace-MH update per stimulus
variant: ``update_glm_laplace`` (none, basis), ``update_glm_laplace_st``
(spatiotemporal: two bilinear sub-blocks) and ``update_glm_laplace_shared``
(shared: per-neuron [bias, gain], then the global filter).

A bfloat16 spike design (``Population(design_dtype=torch.bfloat16)``) takes
the JAX package's bf16 branches: ψ from w_eff rounded to bfloat16 against
the widened design, the float32 mean term added, and the adjacency stages'
ψ rows carried in bfloat16 (:func:`_psi_from_X`), widened where a product
reads them.

Chains: every stage also takes params with a leading chain axis (every leaf
(C, ...)) and a list of C generators, one per chain, and updates all chains
at once: the adjacency stages treat chains × rows as C·N rows of one batch
(X_imp and S shared), the glm Laplace block C·N independent neurons, the
conjugate, discrete and rotation stages the chains as a batch dimension.
Each random draw is C draws, each from its chain's generator
(:func:`~theano_pyglm_torch.ops.distributions.draw`) in the order of the
one-chain stage, so C chains updated together equal C one-chain updates
draw for draw. The spatiotemporal and shared glm blocks are not batched:
the sweep runs them chain by chain (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import math

import torch

from theano_pyglm_torch.models.components import GAIN_PRIOR_MU, GAIN_PRIOR_SD
from theano_pyglm_torch.ops.clipping import clip_exponent, exp_clipped, exponent_active
from theano_pyglm_torch.ops.distributions import (
    draw,
    sample_beta,
    sample_dirichlet,
    sample_gamma,
    sample_gaussian,
)
from theano_pyglm_torch.utils.dtypes import bf16_rounded

# Proposal-shaping time-subsample geometry of the collapsed (A, W) update.
# Module-level so tests can shrink them and drive the subsample path on
# CPU-sized problems.
SUBSAMPLE_T = 16384  # Newton fits run on at most this many bins
SUBSAMPLE_BLK = 2048  # contiguous bins per block

_LOG2PI = 1.8378770664093453
_HALF_LOG2PI = 0.9189385332046727

__all__ = [
    "compute_psi",
    "rest_current",
    "update_adjacency",
    "update_adjacency_collapsed",
    "glm_laplace_fit",
    "glm_laplace_fit_st",
    "glm_laplace_fit_shared",
    "update_glm_laplace",
    "update_glm_laplace_st",
    "update_glm_laplace_shared",
    "refresh_disconnected_weights",
    "update_weight_hypers",
    "update_sbm_types_collapsed",
    "update_sbm_hypers",
    "update_er_rho",
    "update_latent_rotation",
]


# ---------------------------------------------------------------------------
# currents and ψ
# ---------------------------------------------------------------------------


def compute_psi(pop, params, data) -> torch.Tensor:
    """Unit-coupling currents ψ (T, N_post, N_pre) (see module docstring),
    in the parameters' dtype also for a bfloat16 design (w_eff rounded to
    bfloat16 for the product, as in JAX)."""
    w_eff = pop.impulse.effective(params)  # (N, N, B)
    X = data["X_imp"]
    if X.dtype == torch.bfloat16:
        psi = torch.einsum("tmb,nmb->tnm", X.to(w_eff.dtype), bf16_rounded(w_eff))
    else:
        psi = torch.einsum("tmb,nmb->tnm", X, w_eff)
    mean = data.get("_X_imp_mean")
    if mean is not None:
        psi = psi + torch.einsum("mb,nmb->nm", mean, w_eff)[None]
    return psi


def _psi_from_X(X, mean, w_eff_n) -> torch.Tensor:
    """ψ of postsynaptic rows from an explicit design block X (T', N, B).

    ``w_eff_n`` is one row's effective filter weights (N_pre, B), giving
    (N_pre, T'), or a block of R rows (R, N_pre, B), giving (N_pre, R, T').
    Entry-major: one entry's column of every row is a contiguous (R, T')
    block. (The JAX function returns one row as (T', N_pre).) ``mean`` is
    the optional mean-centering correction ``_X_imp_mean`` (N, B).

    A bfloat16 X gives bfloat16 ψ, as in JAX: the widened design against
    the rows' w_eff rounded to bfloat16, the mean term (unrounded weights)
    added, then the sum rounded to bfloat16.
    """
    rows = w_eff_n.reshape(-1, *w_eff_n.shape[-2:])  # (R, M, B)
    bf16 = X.dtype == torch.bfloat16
    if bf16:
        X = X.to(rows.dtype)
    psi = torch.bmm((bf16_rounded(rows) if bf16 else rows).transpose(0, 1), X.permute(1, 2, 0))  # (M, R, T')
    if mean is not None:
        psi = psi + (mean[None] * rows).sum(-1).T[:, :, None]
    if bf16:
        psi = psi.to(torch.bfloat16)
    return psi[:, 0] if w_eff_n.ndim == 2 else psi


def _row_psi(pop, data, w_eff_n) -> torch.Tensor:
    """ψ of postsynaptic rows from X_imp (see :func:`_psi_from_X`),
    computed inside the row update so that with ``row_batch`` the full
    (T, N, N) tensor is never held."""
    X = data.get("X_imp")
    if X is None:
        raise ValueError(
            "adjacency updates need a materialized spike design "
            "(prepare_data(materialize_design=True))"
        )
    return _psi_from_X(X, data.get("_X_imp_mean"), w_eff_n)


def _map_rows(row_fn, args: tuple, row_batch, graph: bool = False):
    """Run ``row_fn`` on all postsynaptic rows as one batch dimension
    (default), or on ``row_batch`` rows at a time (bounded memory for long
    recordings or large N). Every argument has rows as its leading
    dimension; ``row_fn`` returns a tuple of such tensors.

    ``graph``: on a CUDA device with more than one full batch, and with
    ``GRAPH_ROW_BATCHES`` on, the full batches after the first replay a CUDA
    graph of ``row_fn`` (see :func:`_replay_rows`). ``row_fn`` must then read
    nothing on the host and keep the tensors it closes over alive."""
    if row_batch is None:
        return row_fn(*args)
    n, step = args[0].shape[0], int(row_batch)
    if graph and GRAPH_ROW_BATCHES and args[0].is_cuda and n // step > 1:
        parts = _replay_rows(row_fn, args, step)
    else:
        parts = [row_fn(*(a[i : i + step] for a in args)) for i in range(0, n, step)]
    return tuple(torch.cat(p, 0) for p in zip(*parts))


# Replay the row batches of the collapsed adjacency stage as a CUDA graph.
# Module-level so a probe can time the stage with and without it.
GRAPH_ROW_BATCHES = True
# Per device: the capture stream, and the last call's graph, whose memory
# pool the next capture shares before the last graph is freed. (With a new
# stream and pool per call, 50 sweeps at N=100 ran an 80 GB card out of
# memory in private pools.)
_GRAPH_STATE: dict = {}


def _replay_rows(row_fn, args: tuple, step: int) -> list:
    """The row batches of :func:`_map_rows` with the host's launch cost paid
    twice a call instead of once a batch. A row update is hundreds of small
    kernels per entry (the Newton fit, the MH step), so with a few rows a
    batch it is bound by host launches (N=100, ``row_batch=4``: ~35,000
    launches a batch). The first batch runs eagerly (it also initializes
    whatever the kernels create lazily), is captured once on a side stream
    from static copies of its inputs, and every later full batch copies its
    rows into those inputs and replays the capture: the same kernels on the
    same shapes. A ragged last batch runs eagerly. The capture shares the
    previous call's memory pool, so the memory held does not grow with the
    calls."""
    n = args[0].shape[0]
    full = n - n % step
    parts = [row_fn(*(a[:step] for a in args))]
    static = [a[:step].clone() for a in args]
    dev = args[0].device
    side, prev = _GRAPH_STATE.get(dev) or (torch.cuda.Stream(dev), None)
    main = torch.cuda.current_stream(dev)
    side.wait_stream(main)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        g.capture_begin(pool=None if prev is None else prev.pool())
        try:
            out = row_fn(*static)
        finally:
            g.capture_end()
    if prev is not None:
        prev.reset()
    _GRAPH_STATE[dev] = (side, g)
    main.wait_stream(side)
    for i in range(step, full, step):
        for s, a in zip(static, args):
            s.copy_(a[i : i + step])
        g.replay()
        parts.append(tuple(o.clone() for o in out))
    if full < n:
        parts.append(row_fn(*(a[full:] for a in args)))
    return parts


def rest_current(pop, params, data) -> torch.Tensor:
    """(T, N) currents from everything except the coupling term."""
    return pop.bias.current(params, data) + pop.bkgd.current(params, data)


def _logit_prior(P) -> torch.Tensor:
    return torch.log(torch.clamp(P, 1e-12, 1.0)) - torch.log(torch.clamp(1.0 - P, 1e-12, 1.0))


# ---------------------------------------------------------------------------
# adjacency
# ---------------------------------------------------------------------------


def update_adjacency(generator, pop, params, data, row_batch=None, beta=1.0):
    """Gibbs sweep over all N² adjacency entries with W held.

    p(A[n,m]=1 | rest) ∝ p_prior(n,m) · exp(β·LL_n(I_rest + ψ·W added)),
    rows in parallel, entries of a row in sequence. ``beta`` tempers the
    likelihood only (annealed warmup; 1.0 = exact posterior).
    """
    if pop.graph.fixed_A:
        return params
    S, dt, nlin, obs = data["S"], pop.dt, pop.nlin, pop.observation
    N = pop.N
    lead = params["A"].shape[:-2]  # (C,) for chains: their rows are C·N rows
    w_eff = pop.impulse.effective(params)  # ([C,] N_post, N_pre, B)
    I_rest = rest_current(pop, params, data)  # ([C,] T, N)
    W = pop.weights.effective_W(params)
    logit_prior = _logit_prior(pop.graph.edge_prob(params))
    u = draw(generator, lambda g: torch.rand((N, N), generator=g, dtype=S.dtype, device=S.device))

    def ll_of(S_n, I_n):  # (R, T) -> (R,)
        return obs.log_likelihood(S_n, I_n, nlin, dt).sum(-1)

    def row_update(A_n, W_n, w_eff_n, S_n, I_rest_n, logit_n, u_n):
        psi_n = _row_psi(pop, data, w_eff_n)  # (M, R, T); bfloat16 for a bfloat16 design
        I_n = I_rest_n + torch.einsum("mrt,rm->rt", psi_n.to(I_rest_n.dtype), A_n * W_n)
        cols = []
        for m in range(N):
            contrib = W_n[:, m, None] * psi_n[m]
            I_wo = I_n - A_n[:, m, None] * contrib
            delta = beta * (ll_of(S_n, I_wo + contrib) - ll_of(S_n, I_wo))
            a_new = (u_n[:, m] < torch.sigmoid(delta + logit_n[:, m])).to(A_n.dtype)
            I_n = I_wo + a_new[:, None] * contrib
            cols.append(a_new)
        return (torch.stack(cols, 1),)

    (A_new,) = _map_rows(
        row_update,
        (_rows(params["A"], lead), _rows(W, lead), _rows(w_eff, lead), _time_rows(S, lead),
         _time_rows(I_rest, lead), _rows(logit_prior, lead), _rows(u, lead)),
        row_batch,
    )
    return {**params, "A": A_new.view(*lead, N, N)}


def _rows(x, lead):
    """The (C·N, ...) rows of a (*lead, N, ...) per-row tensor."""
    return x.reshape(-1, *x.shape[len(lead) + 1 :])


def _time_rows(x, lead):
    """The (C·N, T) rows of a ([C,] T, N) time-major tensor; one without the
    chain axis (the spikes) serves every chain."""
    xt = x.transpose(-1, -2)
    return xt.expand(*lead, *xt.shape[-2:]).reshape(-1, xt.shape[-1])


def _grad_and_curvature(fn, x):
    """(d/dx, d²/dx²) of ``fn`` at x, elementwise, by autograd twice: each
    element of fn(x) depends on the same element of x alone, so the gradient
    of the sum is the elementwise derivative."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        (d1,) = torch.autograd.grad(fn(x).sum(), x, create_graph=True)
        (d2,) = torch.autograd.grad(d1.sum(), x)
    return d1.detach(), d2


def update_adjacency_collapsed(
    generator, pop, params, data, n_newton: int = 8, return_accept: bool = False,
    row_batch=None, beta=1.0,
):
    """Joint (A[n,m], W[n,m]) birth–death update (the JAX function's
    docstring has the full argument): per entry, Newton on the 1-D weight
    from the prior mean gives a Laplace fit of the edge's collapsed
    conditional; its evidence shapes a birth probability (clipped to
    [σ(−3.5), σ(3.5)]), the weight is proposed from the defensive mixture
    0.8·N(w*, s²) + 0.2·prior, and an exact independence-MH step on the
    full-T likelihood accepts or rejects the pair.

    The exp-Poisson model shapes its proposal (Newton, evidence) by closed
    forms on a time subsample of at most ``SUBSAMPLE_T`` bins:
    ``SUBSAMPLE_T // SUBSAMPLE_BLK`` contiguous blocks at random offsets
    drawn once per call (per chain), gathered as one index. Every other
    model uses the exact ΔLL over the full T, with Newton's derivatives by
    autograd. Returns the new params, and with ``return_accept`` also the
    mean acceptance over all N² entries (of each chain).
    """
    f, dev = pop.dtype, pop.device
    lead = params["A"].shape[:-2]  # (C,) for chains: their rows are C·N rows
    if pop.graph.fixed_A:
        one = torch.ones(lead, dtype=f, device=dev)
        return (params, one) if return_accept else params
    if not pop.weights.has_W:
        out = update_adjacency(generator, pop, params, data, row_batch=row_batch, beta=beta)
        one = torch.ones(lead, dtype=f, device=dev)
        return (out, one) if return_accept else out

    S, dt, nlin, obs = data["S"], pop.dt, pop.nlin, pop.observation
    N = pop.N
    w_eff_all = pop.impulse.effective(params)  # ([C,] N_post, N_pre, B)
    I_rest = rest_current(pop, params, data)
    MU, SIG = (x.expand_as(params["W"]) for x in pop.weights.prior_mu_sigma(params))
    logit_prior = _logit_prior(pop.graph.edge_prob(params))
    fast = nlin.name == "exp" and obs.name == "poisson"

    T_full = int(S.shape[0])
    T_sub = min(T_full, SUBSAMPLE_T)
    use_sub = fast and T_sub < T_full
    sub_rows = ()
    if use_sub:
        if "X_imp" not in data:
            _row_psi(pop, data, w_eff_all.reshape(-1, N, pop.B_imp)[0])  # raises the designed message
        blk = SUBSAMPLE_BLK
        n_blk = T_sub // blk
        offs = draw(generator, lambda g: torch.randint(0, T_full - blk, (n_blk,), generator=g, device=dev))
        idx = (offs[..., :, None] + torch.arange(blk, device=dev)).reshape(*lead, -1)
        # each row gathers its chain's subsample from its full-T ψ, S and I_rest
        sub_rows = (_rows(idx[..., None, :].expand(*lead, N, T_sub), lead),)
        scale_sub = T_full / T_sub
    else:
        scale_sub = 1.0
    # every draw of the sweep, entry-indexed: birth, mixture, MH uniforms and
    # the one normal shared by the mutually exclusive weight proposals
    u3 = draw(generator, lambda g: torch.rand((3, N, N), generator=g, dtype=f, device=dev))
    u_a, u_mix, u_acc = u3.unbind(-3)
    z = draw(generator, lambda g: torch.randn((N, N), generator=g, dtype=f, device=dev))

    def row_update(A_n, W_n, w_eff_n, S_n, I_rest_n, mu_n, sig_n, logit_n, ua_n, umix_n, uacc_n, z_n, *idx_n):
        psi_n = _row_psi(pop, data, w_eff_n)  # (M, R, T); bfloat16 for a bfloat16 design
        I_n = I_rest_n + torch.einsum("mrt,rm->rt", psi_n.to(I_rest_n.dtype), A_n * W_n)
        if fast:
            if use_sub:
                (idx_n,) = idx_n  # (R, T_sub) bins of each row's chain
                psi_sub = psi_n.gather(-1, idx_n.expand(psi_n.shape[0], *idx_n.shape))
                S_sub_n, I_rest_sub_n = S_n.gather(-1, idx_n), I_rest_n.gather(-1, idx_n)
                I_sub = I_rest_sub_n + torch.einsum("mrt,rm->rt", psi_sub.to(I_rest_n.dtype), A_n * W_n)
            else:
                psi_sub, S_sub_n = psi_n, S_n
            a_sub_all = torch.einsum("rt,mrt->rm", S_sub_n, psi_sub.to(S_sub_n.dtype)) * scale_sub  # Σ S·ψ
            # the carried current's likelihood scalars Σ S·clip(I_n), Σ e^{clip(I_n)}
            I_c = clip_exponent(I_n)
            sS, sE = (S_n * I_c).sum(-1), torch.exp(I_c).sum(-1)
        A_cols, W_cols, acc_cols = [], [], []
        for m in range(N):
            a_cur, w_cur = A_n[:, m], W_n[:, m]
            g_cur = (a_cur * w_cur)[:, None]
            psi_m = psi_n[m]
            I_wo = I_n - g_cur * psi_m
            mu, sig, logit = mu_n[:, m], sig_n[:, m], logit_n[:, m]
            prec = 1.0 / (sig * sig)
            if fast:
                if use_sub:
                    psi_s = psi_sub[m]
                    I_s = I_sub - g_cur * psi_s
                else:
                    psi_s, I_s = psi_m, I_wo
                a_sub = a_sub_all[:, m]
                I0s_c = clip_exponent(I_s)
                sum_E0s = torch.exp(I0s_c).sum(-1)
                sum_S_I0s = (S_sub_n * I0s_c).sum(-1)

                def dll_grad_hess(w):
                    # subsampled ΔLL derivatives, by the closed form
                    up = exp_clipped(I_s + w[:, None] * psi_s) * psi_s
                    return beta * (a_sub - dt * scale_sub * up.sum(-1)), beta * (-dt * scale_sub * (up * psi_s).sum(-1))

                def dll_star_of(w):
                    I1 = clip_exponent(I_s + w[:, None] * psi_s)
                    return beta * scale_sub * (
                        ((S_sub_n * I1).sum(-1) - sum_S_I0s) - dt * (torch.exp(I1).sum(-1) - sum_E0s)
                    )
            else:
                ll_wo = obs.log_likelihood(S_n, I_wo, nlin, dt).sum(-1)

                def dll_fit(w, I_wo=I_wo, psi_m=psi_m, ll_wo=ll_wo):
                    # the exact full-T ΔLL of the edge at weight w
                    return beta * (obs.log_likelihood(S_n, I_wo + w[:, None] * psi_m, nlin, dt).sum(-1) - ll_wo)

                def dll_grad_hess(w):
                    return _grad_and_curvature(dll_fit, w)

                dll_star_of = dll_fit

            def g_grad_hess(w):
                # ΔLL derivatives plus the Gaussian prior's
                d1, d2 = dll_grad_hess(w)
                return d1 - (w - mu) * prec, d2 - prec

            # Newton from the prior mean: a state-independent seed, so the
            # proposal is a genuine independence proposal (the JAX package's
            # A/B seed switch _SEED_MODE='state' is not ported)
            w_star = mu
            for _ in range(n_newton):
                d1, d2 = g_grad_hess(w_star)
                w_star = w_star - d1 / torch.minimum(d2, -0.1 * prec)
            h_star = torch.minimum(g_grad_hess(w_star)[1], -0.1 * prec)
            s = torch.sqrt(-1.0 / h_star)

            zs = (w_star - mu) / sig
            log_z1 = dll_star_of(w_star) - 0.5 * (zs * zs + _LOG2PI) - torch.log(sig) + 0.5 * _LOG2PI + torch.log(s)
            p_birth = torch.sigmoid(torch.clamp(logit + log_z1, -3.5, 3.5))

            a_prop = (ua_n[:, m] < p_birth).to(f)
            w_prior = mu + sig * z_n[:, m]
            w_birth = torch.where(umix_n[:, m] < 0.8, w_star + s * z_n[:, m], w_prior)
            w_prop = torch.where(a_prop > 0, w_birth, w_prior)

            if fast:
                # exact full-T ΔLL at the proposal; the current state's is free
                # from the carried scalars (multiplied by a=0 when A[n,m]=0)
                I_wo_c = clip_exponent(I_wo)
                I1p_c = clip_exponent(I_wo + w_prop[:, None] * psi_m)
                sum_S_Iwo = (S_n * I_wo_c).sum(-1)
                sum_E_wo = torch.exp(I_wo_c).sum(-1)
                dll_prop = beta * (((S_n * I1p_c).sum(-1) - sum_S_Iwo) - dt * (torch.exp(I1p_c).sum(-1) - sum_E_wo))
                dll_cur = beta * ((sS - sum_S_Iwo) - dt * (sE - sum_E_wo))
            else:
                dll_prop, dll_cur = dll_fit(w_prop), dll_fit(w_cur)

            def log_target(a, w, dll_w):
                zp = (w - mu) / sig
                return -0.5 * (zp * zp + _LOG2PI) - torch.log(sig) + a * (dll_w + logit)

            def log_proposal(a, w):
                zq = (w - w_star) / s
                lq_hat = -0.5 * (zq * zq + _LOG2PI) - torch.log(s)
                zp = (w - mu) / sig
                lq0 = -0.5 * (zp * zp + _LOG2PI) - torch.log(sig)
                lq1 = torch.logaddexp(math.log(0.8) + lq_hat, math.log(0.2) + lq0)
                return torch.where(a > 0, torch.log(p_birth) + lq1, torch.log1p(-p_birth) + lq0)

            log_alpha = (
                log_target(a_prop, w_prop, dll_prop) - log_proposal(a_prop, w_prop)
                - log_target(a_cur, w_cur, dll_cur) + log_proposal(a_cur, w_cur)
            )
            accept = torch.log(uacc_n[:, m]) < log_alpha
            a_new = torch.where(accept, a_prop, a_cur)
            w_new = torch.where(accept, w_prop, w_cur)
            g_new = (a_new * w_new)[:, None]
            I_n = I_wo + g_new * psi_m
            if fast:
                I_c = clip_exponent(I_n)
                sS, sE = (S_n * I_c).sum(-1), torch.exp(I_c).sum(-1)
            if use_sub:
                I_sub = (I_sub - g_cur * psi_s) + g_new * psi_s
            A_cols.append(a_new)
            W_cols.append(w_new)
            acc_cols.append(accept)
        acc = torch.stack(acc_cols, 1).to(f).mean(1)
        return torch.stack(A_cols, 1), torch.stack(W_cols, 1), acc

    A_new, W_new, acc = _map_rows(
        row_update,
        tuple(_rows(x, lead) for x in (params["A"], params["W"], w_eff_all)) + (
            _time_rows(S, lead), _time_rows(I_rest, lead)) + tuple(
            _rows(x, lead) for x in (MU, SIG, logit_prior, u_a, u_mix, u_acc, z)) + sub_rows,
        row_batch,
        graph=fast,  # the autograd branches are not captured
    )
    out = {**params, "A": A_new.view(*lead, N, N), "W": W_new.view(*lead, N, N)}
    return (out, acc.view(*lead, N).mean(-1)) if return_accept else out


# ---------------------------------------------------------------------------
# the glm Laplace block
# ---------------------------------------------------------------------------


def _bin_ll_derivs(S, I, obs, nlin, dt):
    """Elementwise (d/dI, d²/dI²) of the per-bin log-likelihood at I.

    The exp-Poisson clipped-exp model by its closed form; any other
    (observation, nonlinearity) pair by autograd of the per-bin
    log-likelihood (:func:`_grad_and_curvature`). The derivatives shape
    proposals only (every MH ratio evaluates the likelihood itself), so
    non-finite values are replaced as in the JAX package: d1 nan→0,
    ±inf→±1e6; d2 nan→0, +inf→0, −inf→−1e6. Autograd gives them where, for
    instance, the softplus rate underflows on a spiking bin; left in, they
    would make the Laplace fit and the reverse density NaN every sweep.
    """
    if obs.name == "poisson" and nlin.name == "exp":
        lam_dt = exp_clipped(I) * dt
        mask = exponent_active(I).to(I.dtype)
        return (S - lam_dt) * mask, -lam_dt * mask
    d1, d2 = _grad_and_curvature(lambda i: obs.log_likelihood(S, i, nlin, dt), I)
    d1 = torch.nan_to_num(d1, nan=0.0, posinf=1e6, neginf=-1e6)
    d2 = torch.nan_to_num(d2, nan=0.0, posinf=0.0, neginf=-1e6)
    return d1, d2


def _cholesky_or_nan(M) -> torch.Tensor:
    """Batched lower Cholesky factor. A matrix that is not positive definite
    gives NaN in its factor's lower triangle, as ``jnp.linalg.cholesky``
    does, decided on the device: ``cholesky_ex`` reports ``info`` without a
    host check."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info != 0)[..., None, None], torch.full_like(L, torch.nan).tril(), L)


def _design_currents(I0, Phi, theta) -> torch.Tensor:
    """(T, N) currents I0 + Φ θ_n of a linear block: Φ is (T, D), shared by
    the neurons, or (N, T, D), one design per neuron (the transpose of the
    JAX package's (T, N, D): each neuron's design is contiguous, so its
    products are plain batched matrix products); θ is (N, D). With a shared
    Φ, θ may be (C, N, D), C chains, giving (C, T, N)."""
    if Phi.ndim == 3:
        return I0 + torch.bmm(Phi, theta[:, :, None])[..., 0].T
    return I0 + Phi @ theta.transpose(-1, -2)


def _time_chunks(T: int) -> int:
    """The most chunks, at most 64 and of at least 512 bins each, that cut
    T bins evenly; 1 when none does."""
    return max([c for c in range(1, 65) if T % c == 0 and T // c >= 512] or [1])


def _weighted_gram(Phi, w) -> torch.Tensor:
    """Σ_t w[n, t]·φ[n, t] φ[n, t]ᵀ (N, D, D) of a per-neuron design Φ
    (N, T, D) with weights w (N, T). Each neuron's sum over T is cut into
    :func:`_time_chunks` chunks that form a batch of N·C products, summed
    after. One product per neuron reduces all T in N thread blocks: in the
    spatiotemporal glm update at N=27, T=60,000 those products took 27.7 of
    its 37.1 ms of device time on an H100 (``tools/glm_probe.py``)."""
    N, T, D = Phi.shape
    C = _time_chunks(T)
    weighted = (Phi * w[..., None]).view(N * C, T // C, D)
    return torch.bmm(weighted.transpose(1, 2), Phi.view(N * C, T // C, D)).view(N, C, D, D).sum(1)


def _laplace_fit(S, dt, obs, nlin, I0, Phi, theta0, prior_mu, prior_sd, beta=1.0, n_newton: int = 6):
    """The deterministic part of the Laplace block: ``n_newton`` Newton
    steps from ``theta0`` to each neuron's conditional mode θ*, then the
    Cholesky factor C of −H* (C Cᵀ = −H*, NaN where −H* is not positive
    definite). The design Φ is (T, D) or (N, T, D) (:func:`_design_currents`);
    ``prior_mu``/``prior_sd`` broadcast to θ's (N, D). Returns (θ* (N, D),
    C (N, D, D)); with a shared Φ and I0 of C chains (C, T, N), each with a
    leading chain axis."""
    prior_prec = 1.0 / (prior_sd * prior_sd)
    eye_prec = torch.diag_embed(prior_prec.expand_as(theta0))
    if Phi.ndim == 2:
        T, D = Phi.shape
        # φ_t φ_tᵀ of every bin, flattened: with the (chain ×) neuron rows of
        # d2 as the other operand, all Hessians are one matrix product that
        # reduces T (a batched product per neuron reduces T in one thread
        # block each, ~10× slower on an H100 at the flagship)
        outer = (Phi[:, :, None] * Phi[:, None, :]).reshape(T, D * D)

        def rows(x):  # ([C,] T, N) -> (C·N, T)
            return x.transpose(-1, -2).reshape(-1, T)

    def grad_negH(theta):
        d1, d2 = _bin_ll_derivs(S, _design_currents(I0, Phi, theta), obs, nlin, dt)
        # curvature clamp (proposal shaping only; the MH ratio is exact)
        d2 = torch.clamp(d2, max=0.0)
        if Phi.ndim == 3:
            grad = torch.bmm(d1.T[:, None, :], Phi)[:, 0]
            negH = -_weighted_gram(Phi, d2.T)
        else:
            lead, N = d1.shape[:-2], d1.shape[-1]
            grad = (rows(d1) @ Phi).view(*lead, N, D)
            negH = -(rows(d2) @ outer).view(*lead, N, D, D)  # Σ_t d2·φφᵀ per neuron (of each chain)
        return beta * grad - (theta - prior_mu) * prior_prec, beta * negH + eye_prec

    theta = theta0
    for _ in range(n_newton):
        g, nH = grad_negH(theta)
        theta = theta + torch.linalg.solve_ex(nH, g[..., None])[0][..., 0]
    _, negH = grad_negH(theta)
    return theta, _cholesky_or_nan(negH)


def _independence_mh(generator, log_target, theta_cur, theta_star, C, prior_mu, prior_sd):
    """Independence MH of K independent D-vectors (the neurons of a block,
    or one global filter) from their Laplace fits (θ*, C): the proposal is
    the defensive mixture 0.9·N(θ*, (−H*)⁻¹) + 0.1·prior. ``log_target``
    maps (K, D) to (K,). Returns (θ_new (K, D), accept (K,) bool). With a
    list of C generators, every argument but the priors carries a leading
    chain axis, (C, K, D), and so do the results.

    A non-finite current target or reverse density is an escape hatch
    (accept any finite proposal); a non-finite proposal is rejected. All of
    it is tensor arithmetic, so a NaN factor never reaches the host.
    """
    K, D = theta_cur.shape[-2:]
    f, dev = theta_cur.dtype, theta_cur.device
    log_det_C = torch.log(torch.diagonal(C, dim1=-2, dim2=-1)).sum(-1)
    z = draw(generator, lambda g: torch.randn((K, D), generator=g, dtype=f, device=dev))
    u_mix, u_acc = draw(generator, lambda g: torch.rand((2, K), generator=g, dtype=f, device=dev)).unbind(-2)
    # θ' = θ* + C⁻ᵀ z  ⇒  cov = C⁻ᵀ C⁻¹ = (−H*)⁻¹
    delta = torch.linalg.solve_triangular(C.transpose(-1, -2), z[..., None], upper=True)[..., 0]
    # z serves both mutually exclusive branches: each alone is the right draw
    theta_prop = torch.where((u_mix < 0.9)[..., None], theta_star + delta, prior_mu + prior_sd * z)

    def log_q(theta):
        r = torch.einsum("...ij,...i->...j", C, theta - theta_star)  # Cᵀ(θ−θ*)
        lq_hat = log_det_C - 0.5 * (r * r).sum(-1) - D * _HALF_LOG2PI
        zp = (theta - prior_mu) / prior_sd
        lq_prior = (-0.5 * zp * zp - torch.log(prior_sd) - _HALF_LOG2PI).sum(-1)
        return torch.logaddexp(math.log(0.9) + lq_hat, math.log(0.1) + lq_prior)

    t_prop = log_target(theta_prop)
    t_cur = log_target(theta_cur)
    t_cur = torch.where(torch.isfinite(t_cur), t_cur, -torch.inf)
    t_prop = torch.where(torch.isfinite(t_prop), t_prop, -torch.inf)
    lq_cur, lq_prop = log_q(theta_cur), log_q(theta_prop)
    log_alpha = t_prop - lq_prop - t_cur + lq_cur
    fixable = ~torch.isfinite(lq_cur) & torch.isfinite(t_prop - lq_prop)
    log_alpha = torch.where(fixable, torch.inf, log_alpha)
    log_alpha = torch.where(torch.isnan(log_alpha), -torch.inf, log_alpha)
    accept = torch.log(u_acc) < log_alpha
    return torch.where(accept[..., None], theta_prop, theta_cur), accept


def _laplace_mh_step(
    generator, S, dt, obs, nlin, I0, Phi, theta_cur, theta_star, C, prior_mu, prior_sd, beta=1.0,
):
    """:func:`_independence_mh` of a linear current block I_n = I0_n + Φ θ_n
    from its Laplace fit (θ*, C), with the block's exact conditional
    β·LL_n + log prior as the target. Returns (θ_new (N, D), accept (N,))."""

    def log_target(theta):
        ll = obs.log_likelihood(S, _design_currents(I0, Phi, theta), nlin, dt).sum(-2)  # ([C,] N)
        zp = (theta - prior_mu) / prior_sd
        return beta * ll - 0.5 * (zp * zp).sum(-1)

    return _independence_mh(generator, log_target, theta_cur, theta_star, C, prior_mu, prior_sd)


def _laplace_mh_block(
    generator, S, dt, obs, nlin, I0, Phi, theta_cur, theta0,
    prior_mu, prior_sd, beta=1.0, n_newton: int = 6,
):
    """Per-neuron Laplace independence-MH on a linear current block
    I_n = I0_n + Φ θ_n (the JAX function's docstring has the argument):
    :func:`_laplace_fit`, then :func:`_laplace_mh_step`. ``prior_mu`` and
    ``prior_sd`` are tensors that broadcast to (N, D). Returns
    (θ_new (N, D), accept (N,) bool)."""
    theta_star, C = _laplace_fit(S, dt, obs, nlin, I0, Phi, theta0, prior_mu, prior_sd, beta, n_newton)
    return _laplace_mh_step(
        generator, S, dt, obs, nlin, I0, Phi, theta_cur, theta_star, C, prior_mu, prior_sd, beta
    )


def _bias_bkgd_scalars(pop):
    """(b_mu, b_sd, s_mu, s_sd) from the spec — the one extraction every glm
    Laplace variant uses (defaults match models.zoo)."""
    bspec = pop.spec.get("bias", {})
    kspec = pop.spec.get("bkgd", {})
    return (
        float(bspec.get("mu", 2.0)),
        float(bspec.get("sigma", 1.0)),
        float(kspec.get("mu", 0.0)),
        float(kspec.get("sigma", 1.0)),
    )


def _fills(pop, *runs) -> torch.Tensor:
    """A row on the population's device and dtype from (count, value) runs,
    made by fills: a host-to-device copy, as item assignment of a Python
    number makes, would wait for the stream."""
    return torch.cat([torch.full((n,), v, dtype=pop.dtype, device=pop.device) for n, v in runs])


def _glm_prior_rows(pop, D):
    """(prior_mu, prior_sd) rows [bias; stimulus-weights×(D−1)]."""
    b_mu, b_sd, s_mu, s_sd = _bias_bkgd_scalars(pop)
    return _fills(pop, (1, b_mu), (D - 1, s_mu)), _fills(pop, (1, b_sd), (D - 1, s_sd))


def _coupling_current(pop, params, data) -> torch.Tensor:
    """(T, N) coupling current, the frozen offset of the glm blocks."""
    d = dict(data)
    d["_G"] = pop.coupling(params)
    return pop.impulse.current(params, d)


def _glm_block(pop, params, data):
    """The glm block as a linear current block: (Φ (T, D) = [1, X_stim],
    I0 (T, N) the coupling current, θ_cur (N, D) = [bias, w_stim],
    prior_mu (D,), prior_sd (D,))."""
    S = data["S"]
    ones = torch.ones((S.shape[0], 1), dtype=S.dtype, device=S.device)
    Phi = torch.cat([ones, data["X_stim"].to(S.dtype)], 1) if "X_stim" in data else ones
    D = Phi.shape[1]
    theta_cur = params["bias"][..., None]
    if D > 1:
        theta_cur = torch.cat([theta_cur, params["w_stim"]], -1)
    return (Phi, _coupling_current(pop, params, data), theta_cur, *_glm_prior_rows(pop, D))


def glm_laplace_fit(pop, params, data, theta0, beta=1.0, n_newton: int = 6):
    """The glm Laplace block's deterministic part at ``params``: θ* (N, D)
    of [bias, w_stim] and the Cholesky factor of −H* (N, D, D), from the
    Newton seed ``theta0`` (N, D)."""
    Phi, I0, _, prior_mu, prior_sd = _glm_block(pop, params, data)
    return _laplace_fit(
        data["S"], pop.dt, pop.observation, pop.nlin, I0, Phi, theta0, prior_mu, prior_sd, beta, n_newton
    )


def update_glm_laplace(
    generator, pop, params, data, theta0, beta=1.0, n_newton: int = 6,
    return_accept: bool = False,
):
    """Laplace independence-MH for the (bias, w_stim) block of the none and
    basis stimulus variants (design φ_t = [1, x_t]); chains are C·N
    independent neurons. With ``return_accept`` also the fraction of
    neurons that accepted (of each chain)."""
    Phi, I0, theta_cur, prior_mu, prior_sd = _glm_block(pop, params, data)
    theta_new, accept = _laplace_mh_block(
        generator, data["S"], pop.dt, pop.observation, pop.nlin, I0, Phi, theta_cur, theta0,
        prior_mu, prior_sd, beta=beta, n_newton=n_newton,
    )
    out = {**params, "bias": theta_new[..., 0]}
    if Phi.shape[1] > 1:
        out["w_stim"] = theta_new[..., 1:]
    if return_accept:
        return out, accept.to(theta_new.dtype).mean(-1)
    return out


def _st_block_a(pop, params, data, I_coup):
    """Sub-block (a) of the spatiotemporal glm block, θ_n = [bias_n, w_s[n]]
    given w_t: (Φ (N, T, 1+D) with Φ[n, t] = [1, X_st[t]·w_t[n]], I0 the
    coupling current, θ_cur (N, 1+D), prior_mu, prior_sd (1+D,))."""
    X = data["X_st"]  # (T, D, B)
    T, D, B = X.shape
    phi = (params["w_stim_t"] @ X.reshape(T * D, B).T).view(-1, T, D)
    Phi = torch.cat([torch.ones_like(phi[..., :1]), phi], 2)
    theta = torch.cat([params["bias"][:, None], params["w_stim_s"]], 1)
    return (Phi, I_coup, theta, *_glm_prior_rows(pop, Phi.shape[2]))


def _st_block_b(pop, params, data, I_coup):
    """Sub-block (b), θ_n = w_t[n] given [bias, w_s]: (Φ (N, T, B) with
    Φ[n, t] = X_st[t]ᵀ·w_s[n], I0 = coupling current + bias, θ_cur (N, B),
    prior_mu, prior_sd (B,))."""
    X = data["X_st"]  # (T, D, B)
    T, D, B = X.shape
    Phi = (params["w_stim_s"] @ X.transpose(0, 1).reshape(D, T * B)).view(-1, T, B)
    _, _, s_mu, s_sd = _bias_bkgd_scalars(pop)
    return Phi, I_coup + params["bias"][None, :], params["w_stim_t"], _fills(pop, (B, s_mu)), _fills(pop, (B, s_sd))


def _st_seeds(theta0):
    """The sub-blocks' Newton seeds from the dict ``theta0``."""
    return torch.cat([theta0["bias"][:, None], theta0["w_stim_s"]], 1), theta0["w_stim_t"]


def glm_laplace_fit_st(pop, params, data, theta0, beta=1.0, n_newton: int = 6):
    """The deterministic parts of both spatiotemporal sub-blocks at
    ``params`` (each sub-block's design from the other's current values):
    [(θ*_a (N, 1+D), C_a), (θ*_b (N, B), C_b)]."""
    I_coup = _coupling_current(pop, params, data)
    out = []
    for block, th0 in zip((_st_block_a, _st_block_b), _st_seeds(theta0)):
        Phi, I0, _, mu, sd = block(pop, params, data, I_coup)
        out.append(_laplace_fit(data["S"], pop.dt, pop.observation, pop.nlin, I0, Phi, th0, mu, sd, beta, n_newton))
    return out


def update_glm_laplace_st(
    generator, pop, params, data, theta0, beta=1.0, n_newton: int = 6,
    return_accept: bool = False,
):
    """Laplace independence-MH for the spatiotemporal-stimulus glm block.

    The separable receptive field I_stim[t,n] = Σ_db w_s[n,d]·w_t[n,b]·
    X_st[t,d,b] is bilinear in (w_s, w_t), so the block splits into two
    conditionally linear sub-blocks updated in turn, each an exact MH on its
    conditional (:func:`_laplace_mh_block` with a per-neuron design):
    (a) [bias, w_s] given w_t, then (b) w_t given the new [bias, w_s].
    ``theta0``: dict with 'bias' (N,), 'w_stim_s' (N, D), 'w_stim_t' (N, B),
    the state-independent Newton seeds. With ``return_accept`` also the
    mean of the two sub-blocks' accept rates.
    """
    S, dt, obs, nlin = data["S"], pop.dt, pop.observation, pop.nlin
    I_coup = _coupling_current(pop, params, data)
    seed_a, seed_b = _st_seeds(theta0)
    Phi, I0, theta, mu, sd = _st_block_a(pop, params, data, I_coup)
    theta, acc_a = _laplace_mh_block(generator, S, dt, obs, nlin, I0, Phi, theta, seed_a, mu, sd, beta, n_newton)
    params = {**params, "bias": theta[:, 0], "w_stim_s": theta[:, 1:]}
    Phi, I0, theta, mu, sd = _st_block_b(pop, params, data, I_coup)
    theta, acc_b = _laplace_mh_block(generator, S, dt, obs, nlin, I0, Phi, theta, seed_b, mu, sd, beta, n_newton)
    params = {**params, "w_stim_t": theta}
    if return_accept:
        return params, 0.5 * (acc_a.to(theta.dtype).mean() + acc_b.to(theta.dtype).mean())
    return params


def _shared_block_a(pop, params, data, I_coup):
    """Sub-block (a) of the shared-stimulus glm block, per-neuron
    θ_n = [bias_n, gain_n] given w_shared: (Φ (T, 2) = [1, x_tᵀ w_shared],
    I0 the coupling current, θ_cur (N, 2), and the prior rows of the bias
    and of the gain, whose prior is :data:`GAIN_PRIOR_MU`/``_SD``)."""
    drive = data["X_stim"] @ params["w_stim_shared"]
    Phi = torch.stack([torch.ones_like(drive), drive], 1)
    theta = torch.stack([params["bias"], params["gain"]], 1)
    b_mu, b_sd = _bias_bkgd_scalars(pop)[:2]
    return Phi, I_coup, theta, _fills(pop, (1, b_mu), (1, GAIN_PRIOR_MU)), _fills(pop, (1, b_sd), (1, GAIN_PRIOR_SD))


def _shared_filter_fit(S, dt, obs, nlin, X, I0, gain, w0, s_mu, s_sd, beta=1.0, n_newton: int = 6):
    """Sub-block (b)'s deterministic part: the global filter w (DB,) given
    (bias, gain) is one concave GLM pooled over all bins of all neurons,
    with current I0 + gain_n·(x_tᵀ w). ``n_newton`` pooled Newton steps
    (gradient Σ_tn d1·gain_n x_t, Hessian Σ_tn d2·gain_n² x_t x_tᵀ) from
    ``w0``, then the Cholesky factor of −H*. Returns (w* (1, DB),
    C (1, DB, DB)), the one-row form of :func:`_laplace_fit`'s."""
    prec = 1.0 / (s_sd * s_sd)
    eye = prec * torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
    g2 = gain * gain

    def grad_negH(w):
        d1, d2 = _bin_ll_derivs(S, I0 + (X @ w)[:, None] * gain, obs, nlin, dt)
        d2 = torch.clamp(d2, max=0.0)
        g = beta * (X.T @ (d1 @ gain)) - (w - s_mu) * prec
        return g, beta * (X.T @ (X * (-(d2 @ g2))[:, None])) + eye

    w = w0
    for _ in range(n_newton):
        g, nH = grad_negH(w)
        w = w + torch.linalg.solve_ex(nH, g[:, None])[0][:, 0]
    _, nH = grad_negH(w)
    return w[None], _cholesky_or_nan(nH[None])


def _shared_filter_inputs(pop, params, data, I_coup):
    """(X_stim, I0 = coupling current + bias, gain, s_mu, s_sd) of
    sub-block (b) at ``params``."""
    _, _, s_mu, s_sd = _bias_bkgd_scalars(pop)
    return data["X_stim"], I_coup + params["bias"][None, :], params["gain"], s_mu, s_sd


def glm_laplace_fit_shared(pop, params, data, theta0, beta=1.0, n_newton: int = 6):
    """The deterministic parts of both shared-stimulus sub-blocks at
    ``params``: [(θ*_a (N, 2) of [bias, gain], C_a), (w* (1, DB), C_b)]."""
    S, dt, obs, nlin = data["S"], pop.dt, pop.observation, pop.nlin
    I_coup = _coupling_current(pop, params, data)
    Phi, I0, _, mu, sd = _shared_block_a(pop, params, data, I_coup)
    seed_a = torch.stack([theta0["bias"], theta0["gain"]], 1)
    fit_a = _laplace_fit(S, dt, obs, nlin, I0, Phi, seed_a, mu, sd, beta, n_newton)
    X, I0, gain, s_mu, s_sd = _shared_filter_inputs(pop, params, data, I_coup)
    return [fit_a, _shared_filter_fit(S, dt, obs, nlin, X, I0, gain, theta0["w_stim_shared"], s_mu, s_sd,
                                      beta, n_newton)]


def update_glm_laplace_shared(
    generator, pop, params, data, theta0, beta=1.0, n_newton: int = 6,
    return_accept: bool = False,
):
    """Laplace independence-MH for the shared-tuning-curve glm block.

    The shared stimulus current I_stim[t,n] = gain_n·(x_tᵀ w_shared) couples
    all neurons through the global filter, so the block splits into
    (a) per-neuron [bias, gain] given w_shared (:func:`_laplace_mh_block`)
    and (b) the global w_shared given (bias, gain): one pooled Newton
    (:func:`_shared_filter_fit`) and a single MH accept, with the same
    defensive prior mixture and escape hatches as the per-neuron blocks.
    With ``return_accept`` also the mean of the two sub-blocks' accept rates.
    """
    S, dt, obs, nlin = data["S"], pop.dt, pop.observation, pop.nlin
    I_coup = _coupling_current(pop, params, data)
    Phi, I0, theta, mu, sd = _shared_block_a(pop, params, data, I_coup)
    seed_a = torch.stack([theta0["bias"], theta0["gain"]], 1)
    theta, acc_a = _laplace_mh_block(generator, S, dt, obs, nlin, I0, Phi, theta, seed_a, mu, sd, beta, n_newton)
    params = {**params, "bias": theta[:, 0], "gain": theta[:, 1]}

    w_new, acc_b = _shared_filter_mh(
        generator, pop, data, *_shared_filter_inputs(pop, params, data, I_coup), params["w_stim_shared"],
        theta0["w_stim_shared"], beta, n_newton,
    )
    params = {**params, "w_stim_shared": w_new}
    if return_accept:
        f = w_new.dtype
        return params, 0.5 * (acc_a.to(f).mean() + acc_b.to(f))
    return params


def _shared_filter_mh(generator, pop, data, X, I0, gain, s_mu, s_sd, w_cur, w0, beta=1.0, n_newton: int = 6):
    """Sub-block (b) of the shared glm block: :func:`_shared_filter_fit`
    from the seed ``w0``, then one :func:`_independence_mh` accept of the
    global filter against its exact conditional. Returns (w_new (DB,),
    accept (0-d bool))."""
    S, dt, obs, nlin = data["S"], pop.dt, pop.observation, pop.nlin
    w_star, C = _shared_filter_fit(S, dt, obs, nlin, X, I0, gain, w0, s_mu, s_sd, beta, n_newton)

    def log_target(w):  # (1, DB) -> (1,)
        ll = obs.log_likelihood(S, I0 + (X @ w[0])[:, None] * gain, nlin, dt).sum()
        zp = (w - s_mu) / s_sd
        return beta * ll - 0.5 * (zp * zp).sum(1)

    DB = w_cur.shape[0]
    w_new, accept = _independence_mh(
        generator, log_target, w_cur[None], w_star, C, _fills(pop, (DB, s_mu)), _fills(pop, (DB, s_sd))
    )
    return w_new[0], accept[0]


# ---------------------------------------------------------------------------
# conjugate, gauge and discrete stages
# ---------------------------------------------------------------------------


def refresh_disconnected_weights(generator, pop, params):
    """Resample W[n,m] | A[n,m]=0 from its prior (the exact conditional)."""
    if not pop.weights.has_W:
        return params
    W = params["W"]
    MU, SIG = (x.expand_as(W) for x in pop.weights.prior_mu_sigma(params))
    W_prior = draw(generator, lambda g, mu, sig: sample_gaussian(g, mu, sig, dtype=W.dtype), MU, SIG)
    return {**params, "W": torch.where(params["A"] > 0, W, W_prior)}


def _betaln(a, b):
    """log B(a, b) = lgamma(a) + lgamma(b) − lgamma(a + b) (torch has no betaln)."""
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _sbm_hyperparams(pop):
    """(K, α0, b0, b1) of the SBM graph spec, with the defaults of models.network."""
    spec = pop.spec["network"]["graph"]
    b0, b1 = (float(v) for v in spec.get("B_prior", (1.0, 1.0)))
    return int(spec.get("K", 2)), float(spec.get("alpha0", 1.0)), b0, b1


def _onehot(y, K: int, dtype) -> torch.Tensor:
    """([C,] N, K) one-hot rows of the types, built on the device
    (``torch.nn.functional.one_hot`` checks its indices on the host)."""
    return (y[..., None] == torch.arange(K, device=y.device)).to(dtype)


def _collapsed_type_logits(A, y, n: int, K: int, alpha0: float, b0: float, b1: float) -> torch.Tensor:
    """(K,) unnormalized log p(y_n = k | y_−n, A) with (π, B) marginalized:

        log(α0 + c_k) + Σ_blocks [betaln(b0 + e', b1 + p' − e') − betaln(b0 + e, b1 + p − e)]

    where c, e and p are the class counts and block edge/pair counts over
    the other neurons, and (e', p') add neuron n's edges and pairs, as class
    k, to the blocks of row k and of column k (and its self-pair to block
    (k, k)). Differences of these logits are differences of the log
    marginal Σ lgamma(α0 + c) + Σ betaln(b0 + E, b1 + P − E). A (C, N, N)
    and y (C, N) of C chains give (C, K)."""
    N, f = A.shape[-1], A.dtype
    mask = (torch.arange(N, device=A.device) != n).to(f)
    onehot = _onehot(y, K, f) * mask[:, None]  # n excluded
    cnt = onehot.sum(-2)
    # block counts over ordered pairs not involving n: onehot's zeroed row n
    # drops them on both sides of A
    E = (onehot.transpose(-1, -2) @ A @ onehot).unsqueeze(-3)
    P = (cnt[..., :, None] * cnt[..., None, :]).unsqueeze(-3)
    eo = torch.einsum("...m,...mk->...k", A[..., n, :] * mask, onehot)  # n → class edges
    ei = torch.einsum("...m,...mk->...k", A[..., :, n] * mask, onehot)  # class → n edges
    eye = torch.eye(K, dtype=f, device=A.device)
    same = eye[:, :, None] * eye[:, None, :]
    # [candidate c, block row, block col]: row c gains (eo, cnt), column c
    # gains (ei, cnt), block (c, c) also the self-pair (A[n, n], 1)
    dE = (eye[:, :, None] * eo[..., None, None, :] + eye[:, None, :] * ei[..., None, :, None]
          + same * A[..., n, n, None, None, None])
    dP = eye[:, :, None] * cnt[..., None, None, :] + eye[:, None, :] * cnt[..., None, :, None] + same
    base = _betaln(b0 + E, b1 + (P - E))
    new = _betaln(b0 + E + dE, b1 + (P + dP) - (E + dE))
    return torch.log(alpha0 + cnt) + (new - base).sum((-2, -1))


def update_sbm_types_collapsed(generator, pop, params):
    """Collapsed sequential Gibbs over SBM types, (π, B) marginalized (the
    JAX function's docstring has why it replaces the uncollapsed kernel in
    the sweep, and why it is exact there: :func:`update_sbm_hypers` redraws
    (π, B) right after it). Neurons in turn, y_n ~ softmax of
    :func:`_collapsed_type_logits`, drawn by Gumbel-max on noise drawn up
    front. The identity for every other graph."""
    if pop.graph.name != "sbm":
        return params
    K, alpha0, b0, b1 = _sbm_hyperparams(pop)
    A, y = params["A"], params["y"]
    N, f = A.shape[-1], A.dtype
    u = draw(generator, lambda g: torch.rand((N, K), generator=g, dtype=f, device=A.device))
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(f).tiny)))
    idx = torch.arange(N, device=A.device)
    for n in range(N):
        y_n = torch.argmax(_collapsed_type_logits(A, y, n, K, alpha0, b0, b1) + gumbel[..., n, :], dim=-1)
        y = torch.where(idx == n, y_n[..., None], y)
    return {**params, "y": y}


def update_sbm_hypers(generator, pop, params):
    """Conjugate resampling of the SBM: π | y ~ Dir(α0 + counts),
    B[k,k'] | A, y ~ Beta(b0 + edges, b1 + pairs − edges) over all N²
    ordered pairs, clipped to [1e-6, 1 − 1e-6]. The identity for every
    other graph."""
    if pop.graph.name != "sbm":
        return params
    K, alpha0, b0, b1 = _sbm_hyperparams(pop)
    A = params["A"]
    onehot = _onehot(params["y"], K, A.dtype)
    counts = onehot.sum(-2)
    pi = draw(generator, sample_dirichlet, alpha0 + counts)
    edges = onehot.transpose(-1, -2) @ A @ onehot  # ([C,] K, K) edge counts between blocks
    pairs = counts[..., :, None] * counts[..., None, :]
    Bm = draw(generator, sample_beta, b0 + edges, b1 + (pairs - edges))
    return {**params, "pi": pi, "Bm": torch.clamp(Bm, 1e-6, 1.0 - 1e-6)}


def update_er_rho(generator, pop, params):
    """Conjugate Beta update of an inferred Erdős–Rényi density over all N²
    entries of A, the diagonal included (the JAX package's counting),
    clipped to [1e-6, 1 − 1e-6]. The identity for every other graph and for
    a fixed ρ."""
    if pop.graph.name != "erdos_renyi" or "rho" not in params:
        return params
    a0, b0 = (float(v) for v in pop.spec["network"]["graph"].get("rho_prior", (1.0, 1.0)))
    A = params["A"]
    n_edges = A.sum((-2, -1))
    n_pairs = A.shape[-1] * A.shape[-2]
    rho = draw(generator, sample_beta, a0 + n_edges, b0 + (n_pairs - n_edges))
    return {**params, "rho": torch.clamp(rho, 1e-6, 1.0 - 1e-6)}


def update_weight_hypers(generator, pop, params):
    """Conjugate Normal–Inverse-Gamma resampling of the off-diagonal weight
    prior's (μ_W, σ_W²) given all off-diagonal W entries, when the weight
    spec sets ``infer_hypers``."""
    if pop.weights.name != "gaussian" or "W_mu" not in params:
        return params
    wspec = pop.spec["network"]["weight"]
    m0, k0 = float(wspec.get("m0", 0.0)), float(wspec.get("k0", 1.0))
    a0, b0 = float(wspec.get("a0", 2.0)), float(wspec.get("b0", 2.0))

    N = pop.N
    w = params["W"]
    off = 1.0 - torch.eye(N, dtype=w.dtype, device=w.device)
    n = N * (N - 1)
    wbar = (w * off).sum((-2, -1)) / n
    ss = (off * (w - wbar[..., None, None]) ** 2).sum((-2, -1))

    k_n = k0 + n
    m_n = (k0 * m0 + n * wbar) / k_n
    a_n = a0 + n / 2.0
    b_n = b0 + 0.5 * ss + k0 * n * (wbar - m0) ** 2 / (2.0 * k_n)

    var = b_n / draw(generator, lambda g: sample_gamma(g, a_n, 1.0, dtype=w.dtype))
    mu_new = m_n + torch.sqrt(var / k_n) * draw(generator, lambda g: sample_gaussian(g, 0.0, 1.0, (), w.dtype))
    return {**params, "W_mu": mu_new, "W_sigma": torch.sqrt(var)}


def update_latent_rotation(generator, pop, params):
    """Haar orthogonal Gibbs move on the latent locations of the distance
    graph: the posterior is invariant under ℓ → ℓQ for every orthogonal Q
    (edge logits see only pairwise distances; the prior is isotropic), so
    the move is accepted with probability exactly 1. On O(2) the draw is a
    uniform angle times a reflection coin; for other D, QR of a Gaussian
    matrix with the R-diagonal sign fix."""
    if pop.graph.name != "distance" or "locs" not in params:
        return params
    locs = params["locs"]
    D = locs.shape[-1]
    f, dev = locs.dtype, locs.device
    if D == 2:
        u = draw(generator, lambda g: torch.rand(2, generator=g, dtype=f, device=dev))
        th = 2.0 * math.pi * u[..., 0]
        refl = 1.0 - 2.0 * (u[..., 1] >= 0.5).to(f)
        c, s = torch.cos(th), torch.sin(th)
        # rotation by th, times diag(1, refl)
        Qm = torch.stack([torch.stack([c, -s * refl], -1), torch.stack([s, c * refl], -1)], -2)
    else:
        G = draw(generator, lambda g: torch.randn((D, D), generator=g, dtype=f, device=dev))
        Qm, R = torch.linalg.qr(G)
        Qm = Qm * torch.sign(torch.diagonal(R, dim1=-2, dim2=-1)).unsqueeze(-2)
    return {**params, "locs": locs @ Qm}
