"""Temporal filter bases.

Behavioral equivalent of the reference's ``pyglm/utils/basis.py`` (SURVEY.md
§2 "Basis utilities"): raised-cosine (Pillow et al. 2008 style, log-time
warped), exponential, Gaussian, and identity bases, with optional
L1-normalization and orthonormalization of the columns.

Bases are small (L ≲ a few hundred rows, B ≲ 10 columns) and built once per
model, so they are constructed in numpy on the host; downstream code converts
them to device arrays. The spec is a plain dict, mirroring the reference's
nested-dict hyperparameter style::

    basis = create_basis({'type': 'cosine', 'n_bas': 5, 'dt': 1e-3,
                          'dt_max': 0.1, 'a': 1.0, 'b': 1.0,
                          'norm': True, 'orth': False, 'n_eye': 0})

Returns an (L, B) float64 array whose columns are the basis functions sampled
on the grid ``t = (arange(L) + 1) * dt`` (strictly positive lags — column k at
row l is the filter value at lag (l+1)·dt, matching the strictly-causal
convolution in :mod:`theano_pyglm_torch.ops.convolve`).
"""

from __future__ import annotations

import numpy as np

__all__ = ["create_basis", "DEFAULT_COSINE", "project_onto_basis"]

DEFAULT_COSINE = {
    "type": "cosine",
    "n_eye": 0,
    "n_bas": 5,
    # log-warp u = log(a·l + b) over the lag index l = 1..L. For the warp to
    # actually be logarithmic (narrow early bumps, wide late ones), a·L must
    # exceed b by orders of magnitude — a=1, b=1 gives ~4.6 nats of warp over
    # L=100 lags. (A near-linear choice like a·L ≈ b degenerates into equal-
    # width bumps with no early temporal resolution.)
    "a": 1.0,
    "b": 1.0,
    "orth": False,
    "norm": True,
}


def _cosine_basis(L: int, n_eye: int, n_cos: int, a: float, b: float) -> np.ndarray:
    """Raised cosines, equally spaced in warped time u = log(a·t + b).

    Each bump: φ_j(u) = (cos(clip((u - c_j)·π/(2Δc), -π, π)) + 1)/2, with
    centers c_j linearly spaced so early bumps are narrow (fine temporal
    resolution at short lags) and late bumps wide — the Pillow-style basis the
    reference uses for both stimulus and spike-history filters.
    """
    t = np.arange(L, dtype=np.float64) + 1.0  # lag index (units of dt)
    u = np.log(a * t + b + 1e-20)
    c0, c1 = u[0], u[-1]
    if n_cos == 1:
        centers = np.array([(c0 + c1) / 2.0])
        dc = (c1 - c0) / 2.0 + 1e-12
    else:
        centers = np.linspace(c0, c1, n_cos)
        dc = centers[1] - centers[0]
    arg = np.clip((u[:, None] - centers[None, :]) * np.pi / (2.0 * dc), -np.pi, np.pi)
    cos_cols = 0.5 * (np.cos(arg) + 1.0)

    eye_cols = np.zeros((L, n_eye))
    eye_cols[:n_eye, :] = np.eye(n_eye)[: min(L, n_eye), :]
    return np.concatenate([eye_cols, cos_cols], axis=1)


def _exp_basis(L: int, n_bas: int, tau_min: float, tau_max: float) -> np.ndarray:
    """Exponential decays with log-spaced time constants (in units of dt)."""
    t = np.arange(L, dtype=np.float64) + 1.0
    taus = np.logspace(np.log10(tau_min), np.log10(tau_max), n_bas)
    return np.exp(-t[:, None] / taus[None, :])


def _gaussian_basis(L: int, n_bas: int) -> np.ndarray:
    """Gaussian bumps with centers spanning [0, L] and width = spacing."""
    t = np.arange(L, dtype=np.float64) + 1.0
    centers = np.linspace(t[0], t[-1], n_bas)
    width = (centers[1] - centers[0]) if n_bas > 1 else L / 2.0
    return np.exp(-0.5 * ((t[:, None] - centers[None, :]) / width) ** 2)


def _identity_basis(L: int) -> np.ndarray:
    return np.eye(L)


def create_basis(prms: dict) -> np.ndarray:
    """Build an (L, B) basis from a spec dict (see module docstring).

    Keys: ``type`` in {cosine, exp, gaussian, identity}; ``dt`` and ``dt_max``
    fix L = round(dt_max/dt); ``n_bas`` columns (plus ``n_eye`` leading
    identity columns for the cosine type); ``norm`` L1-normalizes columns to
    unit sum (Σ_l φ[l] = 1, so a unit weight contributes unit total log-rate);
    ``orth`` orthonormalizes columns by QR instead.
    """
    typ = prms["type"]
    dt = float(prms.get("dt", 1e-3))
    dt_max = float(prms.get("dt_max", 0.1))
    L = max(1, int(round(dt_max / dt)))
    n_bas = int(prms.get("n_bas", 5))

    if typ == "cosine":
        basis = _cosine_basis(
            L,
            n_eye=int(prms.get("n_eye", 0)),
            n_cos=n_bas,
            a=float(prms.get("a", 1.0)),
            b=float(prms.get("b", 1.0)),
        )
    elif typ == "exp":
        basis = _exp_basis(
            L,
            n_bas,
            tau_min=float(prms.get("tau_min", 1.0)),
            tau_max=float(prms.get("tau_max", L / 2.0)),
        )
    elif typ == "gaussian":
        basis = _gaussian_basis(L, n_bas)
    elif typ == "identity":
        basis = _identity_basis(L)
    else:
        raise ValueError(f"unknown basis type {typ!r}")

    if prms.get("orth", False):
        q, _ = np.linalg.qr(basis)
        basis = q[:, : basis.shape[1]]
    elif prms.get("norm", True) and typ != "identity":
        # L1-normalize: columns sum to one, so a basis weight w is the total
        # (discrete) log-rate contribution of that column and design-tensor
        # entries stay O(1) regardless of dt. (Documented spec — the
        # reference's dt-aware variant rescales by 1/dt, which only shifts
        # the weight prior scale; SURVEY.md §7 "Identifiability".)
        area = np.abs(basis).sum(axis=0)
        basis = basis / np.where(area > 0, area, 1.0)

    return basis


def project_onto_basis(f: np.ndarray, basis: np.ndarray) -> np.ndarray:
    """Least-squares projection of filter(s) f (L,) or (L, K) onto the basis
    columns; returns basis weights (B,) or (B, K). Reference parity:
    ``project_onto_basis`` in pyglm/utils/basis.py (SURVEY.md §2)."""
    coef, *_ = np.linalg.lstsq(basis, f, rcond=None)
    return coef
