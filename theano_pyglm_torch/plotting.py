"""Result plots — port of :mod:`theano_pyglm_tpu.plotting`.

Inferred-against-true network heatmaps, impulse-response and stimulus
filters, firing-rate traces and the time-rescaling KS plot. Matplotlib
with the Agg backend (headless); every function takes numpy arrays or
tensors and writes a PNG when given a path.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "plot_results",
    "plot_network",
    "plot_filters",
    "plot_rates",
    "plot_ks",
    "procrustes_align",
]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def procrustes_align(X, ref) -> np.ndarray:
    """Orthogonally align latent locations ``X`` (N, D) to ``ref`` (N, D).

    The distance-graph posterior is invariant under rotations and
    reflections of the locations about the prior centre (the sampler's
    rotation move mixes that orbit), so draws carry an arbitrary
    orientation. Compare them through the orthogonal Procrustes solution
    Q* = argmin_{QᵀQ=I} ‖XQ − ref‖_F = UVᵀ from the SVD of Xᵀ·ref
    (Schönemann 1966); no translation or scaling.
    """
    X = _np(X).astype(np.float64)
    ref = _np(ref).astype(np.float64)
    U, _, Vt = np.linalg.svd(X.T @ ref)
    return X @ (U @ Vt)


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_network(ax, G, title: str = "network"):
    G = _np(G)
    v = np.nanmax(np.abs(G)) or 1.0
    im = ax.imshow(G, cmap="RdBu_r", vmin=-v, vmax=v)
    ax.set_title(title)
    ax.set_xlabel("presynaptic")
    ax.set_ylabel("postsynaptic")
    return im


def plot_filters(ax, basis, weights, dt: float, title: str = "filters"):
    """weights: (K, B), one line per filter k."""
    basis, weights = _np(basis), _np(weights)
    t = (np.arange(basis.shape[0]) + 1) * dt
    filters = weights @ basis.T  # (K, L)
    for k in range(filters.shape[0]):
        ax.plot(t, filters[k], lw=1)
    ax.axhline(0, color="k", lw=0.5)
    ax.set_title(title)
    ax.set_xlabel("lag (s)")


def plot_rates(ax, rates, S, dt: float, t_max: float = 2.0):
    rates, S = _np(rates), _np(S)
    T = min(int(t_max / dt), rates.shape[0])
    t = np.arange(T) * dt
    for n in range(min(rates.shape[1], 5)):
        ax.plot(t, rates[:T, n], lw=0.8)
        spikes = np.where(S[:T, n] > 0)[0]
        ax.plot(spikes * dt, np.full(len(spikes), -2.0 - n), "|", ms=4)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("rate (Hz)")


def plot_ks(ax, rates, S, dt: float):
    """Time-rescaling KS plot (Brown et al. 2002): rescaled-ISI quantiles
    against uniform ones, with 95 % KS bands."""
    from theano_pyglm_torch.utils.ks import time_rescaling_ks

    ks, pv, us = time_rescaling_ks(_np(rates), _np(S), dt)
    for u in us:
        if len(u):
            q = (np.arange(len(u)) + 0.5) / len(u)
            ax.plot(q, u, lw=0.8)
    ax.plot([0, 1], [0, 1], "k--", lw=0.8)
    n_med = int(np.median([len(u) for u in us if len(u)]) or 1)
    band = 1.36 / np.sqrt(n_med)
    ax.plot([0, 1], [band, 1 + band], "k:", lw=0.6)
    ax.plot([0, 1], [-band, 1 - band], "k:", lw=0.6)
    ax.set_xlabel("uniform quantile")
    ax.set_ylabel("rescaled ISI quantile")
    ax.set_title("KS (time rescaling)")


def plot_results(pop, params_inf: dict, params_true: dict = None, data: dict = None, path: str = None):
    """Summary figure: inferred (and true) coupling matrix, impulse and
    stimulus filters. Parameters are tensors or numpy arrays. Returns the
    figure."""
    plt = _plt()
    n_rows = 2 if params_true is not None else 1
    fig, axes = plt.subplots(n_rows, 3, figsize=(12, 4 * n_rows), squeeze=False)

    def row(ax_row, params, label):
        params = {k: torch.as_tensor(_np(v)) for k, v in params.items()}
        G = _np(params["A"] * pop.weights.effective_W(params))
        plot_network(ax_row[0], G, f"{label} A∘W")
        w_eff = _np(pop.impulse.effective(params))
        K = min(pop.N, 5)
        plot_filters(ax_row[1], pop.basis_imp, w_eff.reshape(-1, w_eff.shape[-1])[: K * K], pop.dt,
                     f"{label} impulse filters")
        if "w_stim" in params and pop.basis_stim is not None:
            plot_filters(ax_row[2], pop.basis_stim, _np(params["w_stim"])[:, : pop.B_stim], pop.dt,
                         f"{label} stimulus filters")
        else:
            ax_row[2].axis("off")

    row(axes[0], params_inf, "inferred")
    if params_true is not None:
        row(axes[1], params_true, "true")
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=120)
    return fig
