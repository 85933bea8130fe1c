"""MCMC convergence diagnostics: split-R̂ and effective sample size.

A copy of the numpy module :mod:`theano_pyglm_tpu.utils.diagnostics` (the
port imports nothing of the JAX package, whose ``__init__`` imports JAX);
tests/test_torch_chains.py holds the two to identical outputs. Formulas
follow Vehtari et al. 2021 (rank-normalization omitted; plain split-R̂ and
Geyer initial-monotone ESS).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "split_rhat",
    "ess",
    "summarize_chains",
    "adjusted_rand_index",
    "support_metrics",
]


def support_metrics(W, A_true, thresh: float = 0.05) -> dict:
    """Edge-support precision/recall/F1 of a fitted coupling matrix against
    the true adjacency (off-diagonal entries only) — the quantitative check
    for sparse MAP recovery (acceptance config 2)."""
    W = np.asarray(W)
    A = np.asarray(A_true) > 0
    off = ~np.eye(W.shape[0], dtype=bool)
    pred = (np.abs(W) > thresh) & off
    true = A & off
    tp = int(np.sum(pred & true))
    fp = int(np.sum(pred & ~true))
    fn = int(np.sum(~pred & true))
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return {
        "precision": float(precision),
        "recall": float(recall),
        "f1": float(f1),
        "n_predicted_edges": tp + fp,
        "n_true_edges": tp + fn,
    }


def adjusted_rand_index(labels_a, labels_b) -> float:
    """Adjusted Rand index between two partitions (label-permutation
    invariant, 1.0 = identical up to relabeling, ~0 = chance). Used to score
    SBM type recovery against a planted partition (acceptance config 4)."""
    a = np.asarray(labels_a).ravel()
    b = np.asarray(labels_b).ravel()
    if a.shape != b.shape:
        raise ValueError("partitions must have equal length")
    n = a.shape[0]
    ua, ia = np.unique(a, return_inverse=True)
    ub, ib = np.unique(b, return_inverse=True)
    cont = np.zeros((ua.size, ub.size), dtype=np.int64)
    np.add.at(cont, (ia, ib), 1)

    def comb2(x):
        return x * (x - 1) // 2

    sum_ij = comb2(cont).sum()
    sum_a = comb2(cont.sum(axis=1)).sum()
    sum_b = comb2(cont.sum(axis=0)).sum()
    total = comb2(n)
    expected = sum_a * sum_b / total if total > 0 else 0.0
    max_index = 0.5 * (sum_a + sum_b)
    denom = max_index - expected
    if denom == 0:
        return 1.0 if sum_ij == max_index else 0.0
    return float((sum_ij - expected) / denom)


def _to_sc(x: np.ndarray) -> np.ndarray:
    """(n_samples, n_chains, ...) -> (n_samples, n_chains, flat_params)."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim == 2:
        x = x[:, :, None]
    return x.reshape(x.shape[0], x.shape[1], -1)


def split_rhat(x) -> np.ndarray:
    """Split-R̂ per parameter; x: (n_samples, n_chains, ...)."""
    x = _to_sc(x)
    if x.shape[0] < 4:
        return np.full(x.shape[-1], np.nan)
    n = x.shape[0] // 2
    halves = np.concatenate([x[:n], x[n : 2 * n]], axis=1)  # (n, 2m, p)
    m = halves.shape[1]
    chain_mean = halves.mean(axis=0)  # (2m, p)
    chain_var = halves.var(axis=0, ddof=1)
    W = chain_var.mean(axis=0)
    B = n * chain_mean.var(axis=0, ddof=1) if m > 1 else np.zeros_like(W)
    var_plus = (n - 1) / n * W + B / n
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_plus / np.where(W > 0, W, np.nan))


def _autocov(x: np.ndarray) -> np.ndarray:
    """FFT autocovariance per chain/param; x: (n, m, p) -> (n, m, p)."""
    n = x.shape[0]
    xc = x - x.mean(axis=0, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, size, axis=0)
    acov = np.fft.irfft(f * np.conj(f), size, axis=0)[:n].real
    return acov / n


def ess(x) -> np.ndarray:
    """Effective sample size per parameter (Geyer initial-monotone over
    chain-averaged autocorrelations); x: (n_samples, n_chains, ...)."""
    x = _to_sc(x)
    n, m, p = x.shape
    if n < 4:
        return np.full(p, np.nan)
    acov = _autocov(x)  # (n, m, p)
    chain_var = acov[0] * n / (n - 1.0)  # (m, p)
    W = chain_var.mean(axis=0)
    var_plus = (n - 1) / n * W + x.mean(axis=0).var(axis=0, ddof=1) if m > 1 else W
    rho = 1.0 - (W - acov.mean(axis=1)) / np.where(var_plus > 0, var_plus, np.nan)  # (n, p)

    out = np.empty(p)
    for j in range(p):
        r = rho[:, j]
        # pair sums; stop at first negative, enforce monotone decrease
        tau = 1.0
        prev = np.inf
        for k in range(1, (n - 1) // 2):
            pair = r[2 * k - 1] + r[2 * k]
            if not np.isfinite(pair) or pair < 0:
                break
            pair = min(pair, prev)
            prev = pair
            tau += 2.0 * pair
        out[j] = m * n / tau
    return out


def summarize_chains(samples_dict) -> dict:
    """Per-leaf max R̂ and min ESS for a dict of (n_samples, n_chains, ...)
    arrays — the quick convergence table."""
    out = {}
    for k, v in samples_dict.items():
        if np.asarray(v).dtype.kind not in "fc":
            continue
        r, e = split_rhat(v), ess(v)
        out[k] = {
            "max_rhat": float(np.nanmax(r)) if np.any(np.isfinite(r)) else float("nan"),
            "min_ess": float(np.nanmin(e)) if np.any(np.isfinite(e)) else float("nan"),
        }
    return out
