"""The collapsed adjacency stage's row scan: each postsynaptic row's
birth–death updates of its entries (A[n, m], W[n, m]), m = 0..N−1 in order,
each seeing the entries before it updated.

:func:`birth_death_entry` is one entry's law, given the edge's ΔLL as
functions of its weight; every model's stage shares it. The exp-Poisson
model's scan, with that ΔLL in closed form, is :func:`adjacency_row_scan`:
on the card one launch of the row-scan kernel
(:func:`theano_pyglm_torch.ops.kernels.row_scan`, ``csrc/adjacency_rows.cu``),
on the CPU :func:`adjacency_row_scan_reference`, its plain version. Other
models take the exact ΔLL, with Newton's derivatives by autograd
(``inference/gibbs.py``, ``_generic_row_scan``).
"""

from __future__ import annotations

import math

import torch

from theano_pyglm_torch.ops import kernels
from theano_pyglm_torch.ops.clipping import clip_exponent, exp_clipped

__all__ = ["ROW_SCAN_FIELDS", "adjacency_row_scan", "adjacency_row_scan_reference", "birth_death_entry"]

# The per-entry quantities of a row, in the order of ``ent``'s middle axis.
ROW_SCAN_FIELDS = ("A", "W", "mu", "sig", "logit", "u_a", "u_mix", "u_acc", "z")
_LOG2PI = 1.8378770664093453
_U32 = 2.0**-24  # float32's unit roundoff


def _band(n: int, size):
    """The rounding bound of a float32 sum of ``n`` summands whose
    magnitudes add up to ``size``: unit roundoff × ⌈log2 n⌉ × Σ|summand|."""
    return _U32 * math.ceil(math.log2(max(n, 2))) * size


def birth_death_entry(dll_grad_hess, dll_star_of, dll_at, a_cur, w_cur, mu, sig, logit, u_a, u_mix, u_acc, z,
                      n_newton: int):
    """One entry (A[n, m], W[n, m]) of every row, given the edge's ΔLL as
    functions of its weight (each (R,) → (R,)): ``dll_grad_hess(w)`` its
    first two derivatives, ``dll_star_of(w)`` the ΔLL that shapes the birth
    probability, ``dll_at(w_prop)`` the exact (ΔLL at w_prop, ΔLL at w_cur).

    Newton on the weight from the prior mean (curvature held below −0.1 of
    the prior's precision) gives a Laplace fit w*, s; its evidence log Z1 a
    birth probability σ(clip(logit + log Z1, ±3.5)); the proposal is the
    mixture 0.8·N(w*, s²) + 0.2·prior on a birth, the prior otherwise; an
    independence-MH test accepts or rejects it. Returns (a_new, w_new,
    accept, (x_birth, log_alpha)), the last pair the two decisions' values."""
    prec = 1.0 / (sig * sig)

    def g_grad_hess(w):  # ΔLL derivatives plus the Gaussian prior's
        d1, d2 = dll_grad_hess(w)
        return d1 - (w - mu) * prec, d2 - prec

    # Newton from the prior mean: a state-independent seed, so the proposal
    # is a genuine independence proposal
    w_star = mu
    for _ in range(n_newton):
        d1, d2 = g_grad_hess(w_star)
        w_star = w_star - d1 / torch.minimum(d2, -0.1 * prec)
    h_star = torch.minimum(g_grad_hess(w_star)[1], -0.1 * prec)
    s = torch.sqrt(-1.0 / h_star)

    zs = (w_star - mu) / sig
    log_z1 = dll_star_of(w_star) - 0.5 * (zs * zs + _LOG2PI) - torch.log(sig) + 0.5 * _LOG2PI + torch.log(s)
    x_birth = torch.clamp(logit + log_z1, -3.5, 3.5)
    p_birth = torch.sigmoid(x_birth)
    a_prop = (u_a < p_birth).to(mu.dtype)
    w_prior = mu + sig * z
    w_birth = torch.where(u_mix < 0.8, w_star + s * z, w_prior)
    w_prop = torch.where(a_prop > 0, w_birth, w_prior)
    dll_prop, dll_cur = dll_at(w_prop)

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
    accept = torch.log(u_acc) < log_alpha
    return (torch.where(accept, a_prop, a_cur), torch.where(accept, w_prop, w_cur), accept,
            (x_birth, log_alpha))


def adjacency_row_scan_reference(psi, cur, S, ent, offs=None, blk: int = 0, *, beta: float, dt: float,
                                 n_newton: int, margins: bool = False):
    """Plain torch row scan of the collapsed adjacency stage for the
    exp-Poisson model: the row-scan kernel's algorithm (see
    :func:`adjacency_row_scan`), op for op.

    Each row's entries m in turn, each seeing the entries before it
    updated: the entry's coupling removed from the row's current, Newton on
    the closed-form ΔLL derivatives over the time subsample (every bin when
    ``offs`` is None), the subsampled ΔLL at w* scaled by T / T_sub for the
    birth probability, and the exact full-T ΔLLs of the proposal and of the
    current state for the MH test. Every ΔLL is a sum of per-bin
    differences Σ S·(I1 − I0) − dt·(e^I1 − e^I0), I = clip(·, ±EXP_CLIP).

    With ``margins`` also returns an (R, M) bool: the entries whose birth
    or MH decision lies within float32's rounding bound of its sums
    (unit roundoff × ⌈log2 n⌉ × the sum of the n summands' magnitudes), where
    another order of summation may decide otherwise. Checks of the kernel
    against this version compare a row only up to its first such entry."""
    M, R, T = psi.shape
    f = cur.dtype
    if offs is None:
        idx, scale = None, 1.0
        S_sub = S
    else:
        idx = (offs[:, :, None] + torch.arange(blk, device=offs.device)).reshape(R, -1)
        scale = T / idx.shape[1]
        S_sub = S.gather(-1, idx)
    T_sub = S_sub.shape[-1]
    I_n = cur
    I_sub = cur if idx is None else cur.gather(-1, idx)
    A, W, MU, SIG, LOGIT, U_A, U_MIX, U_ACC, Z = ent.unbind(1)
    cols, opened = [], []
    for m in range(M):
        psi_m = psi[m].to(f)
        psi_s = psi_m if idx is None else psi_m.gather(-1, idx)
        a_cur, w_cur = A[:, m], W[:, m]
        g_cur = (a_cur * w_cur)[:, None]
        I_wo = I_n - g_cur * psi_m
        I_s = I_wo if idx is None else I_sub - g_cur * psi_s
        a_sub = (S_sub * psi_s).sum(-1) * scale
        I0s_c = clip_exponent(I_s)
        E0s = torch.exp(I0s_c)
        sums = {}

        def dll_grad_hess(w):
            # subsampled ΔLL derivatives, by the closed form
            up = exp_clipped(I_s + w[:, None] * psi_s) * psi_s
            return beta * (a_sub - dt * scale * up.sum(-1)), beta * (-dt * scale * (up * psi_s).sum(-1))

        def dll_star_of(w):
            I1 = clip_exponent(I_s + w[:, None] * psi_s)
            sums["star"] = S_sub * (I1 - I0s_c) - dt * (torch.exp(I1) - E0s)
            return beta * scale * sums["star"].sum(-1)

        def dll_at(w_prop):
            # the exact full-T ΔLLs of the proposal and of the current state
            I_c, I_wo_c = clip_exponent(I_n), clip_exponent(I_wo)
            I1p_c = clip_exponent(I_wo + w_prop[:, None] * psi_m)
            E_wo = torch.exp(I_wo_c)
            sums["prop"] = S * (I1p_c - I_wo_c) - dt * (torch.exp(I1p_c) - E_wo)
            sums["cur"] = S * (I_c - I_wo_c) - dt * (torch.exp(I_c) - E_wo)
            return beta * sums["prop"].sum(-1), beta * sums["cur"].sum(-1)

        a_new, w_new, accept, (x_birth, log_alpha) = birth_death_entry(
            dll_grad_hess, dll_star_of, dll_at, a_cur, w_cur, MU[:, m], SIG[:, m], LOGIT[:, m], U_A[:, m],
            U_MIX[:, m], U_ACC[:, m], Z[:, m], n_newton)
        if margins:
            b = abs(beta)
            band_z = _band(T_sub, b * scale * sums["star"].abs().sum(-1))
            band_mh = (_band(T, b * sums["prop"].abs().sum(-1)) + a_cur * _band(T, b * sums["cur"].abs().sum(-1))
                       + band_z)
            u_logit = torch.log(U_A[:, m]) - torch.log1p(-U_A[:, m])
            opened.append(((u_logit - x_birth).abs() < band_z) | ((torch.log(U_ACC[:, m]) - log_alpha).abs() < band_mh))
        g_new = (a_new * w_new)[:, None]
        I_n = I_wo + g_new * psi_m
        if idx is not None:
            I_sub = I_s + g_new * psi_s
        cols.append((a_new, w_new, accept.to(f)))
    out = tuple(torch.stack(c, 1) for c in zip(*cols))
    return out + (torch.stack(opened, 1),) if margins else out


def adjacency_row_scan(psi, cur, S, ent, offs=None, blk: int = 0, *, beta: float, dt: float, n_newton: int):
    """The collapsed adjacency stage's row scan for the exp-Poisson model:
    every row's entries m = 0..M−1 in order, each one birth–death update
    (Newton fit on the time subsample, birth probability, mixture proposal,
    exact full-T MH test; :func:`birth_death_entry`).

    Args:
      psi: (M, R, T) unit-coupling currents, entry-major; float32 or
        bfloat16 (a bf16 design; widened where read).
      cur: (R, T) the rows' current I_rest + Σ_m ψ_m·A·W. The kernel
        overwrites it; the plain version leaves it.
      S: (R, T) the rows' spikes.
      ent: (R, 9, M) per entry: A, W, the weight prior's μ and σ, the edge
        prior's logit, the birth, mixture and MH uniforms and the normal
        (:data:`ROW_SCAN_FIELDS`).
      offs: (R, n_blk) int64 offsets of the subsample's blocks of ``blk``
        bins, or None: the subsample is every bin.
      beta, dt, n_newton: the tempering, the bin width, Newton's steps.

    Returns (A, W, accept), each (R, M), accept 0 or 1. CPU tensors take
    :func:`adjacency_row_scan_reference`; any other tensors
    :func:`theano_pyglm_torch.ops.kernels.row_scan`, one launch of the
    row-scan kernel, which raises where the kernel does not take them:
    nothing falls back to the plain version.
    """
    M, R, T = psi.shape
    if tuple(cur.shape) != (R, T) or tuple(S.shape) != (R, T) or tuple(ent.shape) != (R, len(ROW_SCAN_FIELDS), M):
        raise ValueError(f"row scan operands do not agree: psi {tuple(psi.shape)}, cur {tuple(cur.shape)}, "
                         f"S {tuple(S.shape)}, ent {tuple(ent.shape)}")
    if offs is not None and (offs.ndim != 2 or offs.shape[0] != R or not 0 < offs.shape[1] * blk <= T):
        raise ValueError(f"subsample offsets {tuple(offs.shape)} of blocks of {blk} do not fit rows of {T} bins")
    tensors = (psi, cur, S, ent) + (() if offs is None else (offs,))
    if {t.device for t in tensors} == {torch.device("cpu")}:
        return adjacency_row_scan_reference(psi, cur, S, ent, offs, blk, beta=beta, dt=dt, n_newton=n_newton)
    return kernels.row_scan(psi, cur, S, ent, offs, blk, beta=beta, dt=dt, n_newton=n_newton)
