"""Plain reference of two stages of the Gibbs sweep, replayed from the draws
the program's stage took: the collapsed birth–death update of each
adjacency entry (A[n, p], W[n, p]), and the HMC transitions of the impulse
weights and of the latent locations.

Written from the algorithm, not from the program: it imports nothing of the
package under test and rebuilds ψ, the currents and the priors from the
raw spikes, stimulus and parameters (``glm``). The stage's random numbers
are drawn again from each chain's generator, restored to its state before
the stage, with the calls the stage makes in the order it makes them:

- adjacency, a chain: the offsets of ``T_sub // BLK`` blocks of ``BLK``
  bins (``randint(0, T − BLK)``, only where T > ``T_sub``), then uniforms
  (3, N, N) (birth, mixture, acceptance), then normals (N, N);
- HMC, a chain and a block (impulse, then latent): one normal a
  coordinate, then the acceptance uniform.

The birth–death update of entry (n, p), for each row n at once and the
entries p of a row in turn, each seeing the row's current with the entries
before it already updated: a Newton fit of the edge's weight from the
prior mean on the time subsample (``N_NEWTON`` steps, curvature held below
−0.1 of the prior's precision), its Laplace evidence giving a birth
probability σ(clip(logit + log Z₁, ±3.5)), a proposal (birth: the fit with
probability 0.8, the prior otherwise; no birth: the prior), and an exact
MH test on the full-T ΔLL.

Judged, a replay follows the judged outputs (``follow``): entry p of a row
sees the judged values of the entries before it, so one judged decision
that differs does not spread. A decision whose two sides lie within the
float32 rounding bound of its sums (:func:`_band`) may go either way: the
gap of an entry, or of a chain's transition, is its distance from the
nearest outcome that the reference allows.
"""

from __future__ import annotations

import math

import torch

from bench_port.reference import glm

__all__ = ["SUBSAMPLE_T", "SUBSAMPLE_BLK", "adjacency_draws", "adjacency_replay", "hmc_draws", "hmc_replay",
           "impulse_target", "latent_target"]

SUBSAMPLE_T = 16_384  # the Newton fits' time subsample, bins
SUBSAMPLE_BLK = 2_048  # contiguous bins a block of it
N_NEWTON = 8
P_BIRTH_CLIP = 3.5
MIX = 0.8  # the birth proposal's weight on the Newton fit
#: float32's unit roundoff, the precision the configurations state
U32 = 2.0 ** -24
_LOG2PI = math.log(2.0 * math.pi)


def _band(n_terms: int, size) -> torch.Tensor:
    """The rounding bound of a float32 sum of ``n_terms`` summands whose
    magnitudes add up to ``size``: unit roundoff × ⌈log2 n⌉ × Σ|summand|
    (pairwise summation)."""
    return U32 * math.ceil(math.log2(max(n_terms, 2))) * size


def _gen(state: torch.Tensor, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


def adjacency_draws(gen_state: torch.Tensor, N: int, T: int, device, dtype=torch.float32) -> dict:
    """The adjacency stage's draws of one chain from its generator's state,
    in the dtype the program runs in."""
    g = _gen(gen_state, device)
    offs = None
    if T > SUBSAMPLE_T:
        offs = torch.randint(0, T - SUBSAMPLE_BLK, (SUBSAMPLE_T // SUBSAMPLE_BLK,), generator=g, device=device)
    u = torch.rand((3, N, N), generator=g, dtype=dtype, device=device)
    z = torch.randn((N, N), generator=g, dtype=dtype, device=device)
    return {"offs": offs, "u": u, "z": z}


def hmc_draws(gen_state: torch.Tensor, shapes: list, device, dtype=torch.float32) -> list:
    """[(momentum, uniform)] of one chain, a block each in ``shapes``'
    order, from its generator's state, in the dtype the program runs in."""
    g = _gen(gen_state, device)
    out = []
    for shape in shapes:
        p0 = torch.randn(shape, generator=g, dtype=dtype, device=device)
        out.append((p0, torch.rand((), generator=g, dtype=dtype, device=device)))
    return out


def _mm_einsum(eq: str, a, b, tf32: bool):
    return torch.einsum(eq, glm._tf32(a), glm._tf32(b)) if tf32 else torch.einsum(eq, a, b)


def adjacency_replay(model: dict, params: dict, S: torch.Tensor, stim: torch.Tensor, draws: dict,
                     precision: str = "float64", follow: dict | None = None) -> dict:
    """The birth–death stage on one chain: ``params`` as the stage found
    them, ``draws`` of :func:`adjacency_draws`. Returns {"A", "W"}, the
    replay's own outputs, and with ``follow`` ({"A", "W"} judged) also
    "gap" (N, N): each entry's |ΔA| + |ΔW|/σ_W from the nearest outcome the
    reference allows it, the replay following the judged entries."""
    tf32 = precision == "tf32"
    f = glm._float(precision)
    dev, dt = S.device, float(model["dt"])
    if model["nlin"]["type"] != "exp" or model["observation"]["type"] != "poisson":
        raise ValueError("the reference replays the exp-Poisson model's birth–death stage only")
    T, N = S.shape
    p = {k: v.to(dev, f) for k, v in params.items()}
    ((_, _, X, Xs),) = glm.design_blocks(model, S, stim, block=T, precision=precision)
    X = X.reshape(T, N, -1)
    w_eff = torch.softmax(p["w_ir"], -1)  # (n, p, b)
    psi = _mm_einsum("tpb,npb->npt", X, w_eff, tf32)  # (rows n, entries p, T)
    I_rest = (p["bias"] + (glm._tf32(Xs) @ glm._tf32(p["w_stim"].T) if tf32 else Xs @ p["w_stim"].T)).T  # (n, T)
    S_r = S.to(f).T  # (n, T)
    A, W = p["A"].clone(), p["W"].clone()
    MU, SIG = glm.weight_prior(model, N, f, dev)
    P = torch.sigmoid(glm.edge_logits(model, p))
    LOGIT = torch.log(torch.clamp(P, 1e-12, 1.0)) - torch.log(torch.clamp(1.0 - P, 1e-12, 1.0))
    if draws["offs"] is not None:
        idx = (draws["offs"][:, None] + torch.arange(SUBSAMPLE_BLK, device=dev)).reshape(-1)
        psi_sub, S_sub, scale = psi[..., idx], S_r[:, idx], T / idx.numel()
        I_sub = I_rest[:, idx] + _mm_einsum("npt,np->nt", psi_sub, A * W, tf32)
    else:
        psi_sub, S_sub, scale = psi, S_r, 1.0
        I_sub = None
    I_n = I_rest + _mm_einsum("npt,np->nt", psi, A * W, tf32)
    if I_sub is None:
        I_sub = I_n
    a_sub_all = _mm_einsum("nt,npt->np", S_sub, psi_sub, tf32) * scale
    T_sub = S_sub.shape[1]
    u_a, u_mix, u_acc = (u.to(f) for u in draws["u"].unbind(0))
    z = draws["z"].to(f)
    clip = glm.EXP_CLIP

    gap = torch.zeros((N, N), dtype=torch.float64, device=dev)
    out_A, out_W = torch.empty_like(A), torch.empty_like(W)
    for m in range(N):
        a_cur, w_cur = A[:, m].clone(), W[:, m].clone()
        g_cur = (a_cur * w_cur)[:, None]
        psi_m, psi_s = psi[:, m], psi_sub[:, m]
        I_wo = I_n - g_cur * psi_m
        I_s = I_sub - g_cur * psi_s
        mu, sig, logit = MU[:, m], SIG[:, m], LOGIT[:, m]
        prec = 1.0 / (sig * sig)
        a_sub = a_sub_all[:, m]
        I0s = torch.clamp(I_s, -clip, clip)
        sum_E0s, sum_S_I0s = torch.exp(I0s).sum(-1), (S_sub * I0s).sum(-1)

        def grad_hess(w):
            up = torch.exp(torch.clamp(I_s + w[:, None] * psi_s, -clip, clip)) * psi_s
            return (a_sub - dt * scale * up.sum(-1) - (w - mu) * prec,
                    -dt * scale * (up * psi_s).sum(-1) - prec)

        w_star = mu
        for _ in range(N_NEWTON):
            d1, d2 = grad_hess(w_star)
            w_star = w_star - d1 / torch.minimum(d2, -0.1 * prec)
        h_star = torch.minimum(grad_hess(w_star)[1], -0.1 * prec)
        s = torch.sqrt(-1.0 / h_star)
        I1s = torch.clamp(I_s + w_star[:, None] * psi_s, -clip, clip)
        SI1s = S_sub * I1s
        dll_star = scale * ((SI1s.sum(-1) - sum_S_I0s) - dt * (torch.exp(I1s).sum(-1) - sum_E0s))
        band_z = _band(T_sub, scale * (SI1s.abs().sum(-1) + (S_sub * I0s).abs().sum(-1)
                                       + dt * (torch.exp(I1s).sum(-1) + sum_E0s)))
        zs = (w_star - mu) / sig
        log_z1 = dll_star - 0.5 * (zs * zs + _LOG2PI) - torch.log(sig) + 0.5 * _LOG2PI + torch.log(s)
        x_birth = torch.clamp(logit + log_z1, -P_BIRTH_CLIP, P_BIRTH_CLIP)
        p_birth = torch.sigmoid(x_birth)
        birth = u_a[:, m] < p_birth
        u_logit = torch.log(u_a[:, m]) - torch.log1p(-u_a[:, m])
        birth_open = (u_logit - x_birth).abs() < band_z

        w_prior = mu + sig * z[:, m]
        w_birth = torch.where(u_mix[:, m] < MIX, w_star + s * z[:, m], w_prior)

        # the full-T ΔLL of the edge at a weight, and its rounding bound
        I_woc = torch.clamp(I_wo, -clip, clip)
        SIwo, Ewo = S_r * I_woc, torch.exp(I_woc)
        sS_wo, sE_wo, aS_wo = SIwo.sum(-1), Ewo.sum(-1), SIwo.abs().sum(-1)

        def dll(w):
            I1 = torch.clamp(I_wo + w[:, None] * psi_m, -clip, clip)
            SI1, E1 = S_r * I1, torch.exp(I1)
            return ((SI1.sum(-1) - sS_wo) - dt * (E1.sum(-1) - sE_wo),
                    _band(T, SI1.abs().sum(-1) + aS_wo + dt * (E1.sum(-1) + sE_wo)))

        dll_cur, band_cur = dll(w_cur)

        def log_target(a, w, dll_w):
            zp = (w - mu) / sig
            return -0.5 * (zp * zp + _LOG2PI) - torch.log(sig) + a * (dll_w + logit)

        def log_proposal(a, w):
            zq = (w - w_star) / s
            lq_hat = -0.5 * (zq * zq + _LOG2PI) - torch.log(s)
            zp = (w - mu) / sig
            lq0 = -0.5 * (zp * zp + _LOG2PI) - torch.log(sig)
            lq1 = torch.logaddexp(math.log(MIX) + lq_hat, math.log(1.0 - MIX) + lq0)
            return torch.where(a > 0, torch.log(p_birth) + lq1, torch.log1p(-p_birth) + lq0)

        log_u = torch.log(u_acc[:, m])
        rest = -log_target(a_cur, w_cur, dll_cur) + log_proposal(a_cur, w_cur)
        one, zero = torch.ones_like(w_cur), torch.zeros_like(w_cur)
        dll_b, band_b = dll(w_birth)
        outcomes, reject_ok = [], torch.zeros_like(birth)
        a_new, w_new = a_cur, w_cur
        for a_p, w_p, dll_p, band_p, chosen in ((one, w_birth, dll_b, band_b, birth),
                                                (zero, w_prior, zero, zero, ~birth)):
            la = log_target(a_p, w_p, dll_p) - log_proposal(a_p, w_p) + rest
            accept = log_u < la
            open_ = (log_u - la).abs() < band_p + a_cur * band_cur + band_z
            reach = chosen | birth_open
            outcomes.append((a_p, w_p, reach & (accept | open_)))
            reject_ok = reject_ok | (reach & (~accept | open_))
            a_new = torch.where(chosen & accept, a_p, a_new)
            w_new = torch.where(chosen & accept, w_p, w_new)
        outcomes.append((a_cur, w_cur, reject_ok))
        out_A[:, m], out_W[:, m] = a_new, w_new
        if follow is not None:
            a_f, w_f = follow["A"][:, m].to(dev, f), follow["W"][:, m].to(dev, f)
            best = torch.full((N,), math.inf, dtype=torch.float64, device=dev)
            for a_o, w_o, ok in outcomes:
                d = ((a_f - a_o).abs() + (w_f - w_o).abs() / sig).double()
                best = torch.where(ok, torch.minimum(best, d), best)
            gap[:, m] = best
            a_new, w_new = a_f, w_f
        g_new = (a_new * w_new)[:, None]
        A[:, m], W[:, m] = a_new, w_new
        I_n = I_wo + g_new * psi_m
        if draws["offs"] is not None:
            I_sub = I_s + g_new * psi_s
        else:
            I_sub = I_n
    out = {"A": out_A, "W": out_W}
    if follow is not None:
        out["gap"] = gap
    return out


def impulse_target(model: dict, params: dict, S: torch.Tensor, stim: torch.Tensor, blocks: list,
                   precision: str = "float64"):
    """logp(w_ir) of the impulse block (the likelihood and the impulse
    prior, the other leaves fixed at ``params``): w_ir ↦ (value, gradient,
    Σ |summand|)."""
    imp = model["impulse"]
    f = glm._float(precision)
    mu_b = torch.as_tensor(imp["mu"], dtype=f, device=S.device)
    sd = float(imp["sigma"])

    def fn(w_ir):
        p = {**params, "w_ir": w_ir}
        ll, g, size = glm.log_likelihood_and_grad(model, p, S, stim, precision=precision, blocks=blocks,
                                                  with_abs=True)
        zz = ((w_ir - mu_b) / sd) ** 2
        lp = float((-0.5 * (zz + _LOG2PI) - math.log(sd)).sum())
        return ll + lp, g["w_ir"] - (w_ir - mu_b) / sd ** 2, size + float((0.5 * (zz + _LOG2PI)).sum())

    return fn


def latent_target(model: dict, params: dict, precision: str = "float64"):
    """logp(locs) of the latent block (the distance graph's prior: the
    locations' Gaussian and the edges' Bernoulli): locs ↦ (value,
    gradient, Σ |summand|)."""
    graph = model["network"]["graph"]
    f = glm._float(precision)
    A = params["A"].to(f)

    def fn(locs):
        x = locs.detach().requires_grad_(True)
        logits = glm.edge_logits(model, {"A": A, "locs": x})
        prob = torch.clamp(torch.sigmoid(logits), 1e-12, 1.0 - 1e-12)
        terms = torch.cat([(torch.special.xlogy(A, prob) + torch.special.xlogy(1.0 - A, 1.0 - prob)).reshape(-1),
                           glm._gauss(x, 0.0, graph["sigma_l"]).reshape(-1)])
        total = terms.sum()
        (g,) = torch.autograd.grad(total, (x,))
        return float(total.detach()), g, float(terms.detach().abs().sum())

    return fn


def hmc_replay(target, q0: torch.Tensor, eps: float, scale: torch.Tensor, p0: torch.Tensor, u: float,
               n_steps: int, n_terms: int, follow: torch.Tensor | None = None) -> dict:
    """One HMC transition of one leaf from ``q0``: ``n_steps`` leapfrog
    steps of size ``eps`` preconditioned by ``scale``, from momentum ``p0``,
    accepted where u < exp(min(H0 − H1, 0)). Returns {"q"}, the replay's own
    outcome, and with ``follow`` (the judged outcome) also "gap": its
    distance from the nearest allowed outcome (the proposal, or ``q0``) over
    the length of the proposal's move. ``n_terms``: the summands of logp,
    for the rounding bound of the acceptance test."""
    lp0, g, size0 = target(q0)
    q, p = q0, p0.to(q0.dtype)
    for _ in range(n_steps):
        p = p + 0.5 * eps * scale * g
        q = q + eps * scale * p
        lp1, g, size1 = target(q)
        p = p + 0.5 * eps * scale * g
    h0 = -lp0 + 0.5 * float((p0.double() ** 2).sum())
    h1 = -lp1 + 0.5 * float((p.double() ** 2).sum())
    la = min(h0 - h1, 0.0) if math.isfinite(h0 - h1) else -math.inf
    log_u = math.log(float(u))
    take = log_u < la
    out = {"q": q if take else q0}
    if follow is not None:
        open_ = abs(log_u - la) < float(_band(n_terms, size0 + size1))
        move = float(torch.linalg.norm((q - q0).double()))
        allowed = [q] * (take or open_) + [q0] * ((not take) or open_)
        d = min(float(torch.linalg.norm((follow.to(q.dtype) - o).double())) for o in allowed)
        out["gap"] = d / move if move > 0 else (0.0 if d == 0 else math.inf)
    return out
