"""Goodness-of-fit via the time-rescaling theorem (Brown et al. 2002) —
the reference's KS/predictive plots (SURVEY.md §2 "Plotting" [L]).

If spikes follow an inhomogeneous Poisson process with intensity λ(t), the
rescaled inter-spike intervals z_k = ∫_{t_{k-1}}^{t_k} λ dt are Exp(1), so
u_k = 1 − e^{−z_k} are Uniform(0,1); the KS distance of {u_k} from uniform
measures model fit. Host-side numpy (analysis utility, not a hot path).

A copy of :mod:`theano_pyglm_tpu.utils.ks`, kept identical on purpose,
including the reference's known fault: a bin with more than one spike
repeats its cumulative value, so the intervals between its spikes come out
as z = 0 instead of being spread across the bin (ROADMAP.md, queue 3).
tests/test_torch_chains.py documents it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["time_rescaling_ks"]


def time_rescaling_ks(rates: np.ndarray, S: np.ndarray, dt: float):
    """Per-neuron KS statistic (and asymptotic p-value) of the time-rescaled
    spike trains against Uniform(0,1).

    Args:
      rates: (T, N) model intensity in spikes/s (e.g. nlin(total_current)).
      S: (T, N) spike counts (multiple spikes per bin are spread uniformly
         within the bin's integral).
    Returns:
      (ks_stats (N,), p_values (N,), u_lists) — u_lists[n] are the rescaled
      quantiles for QQ/KS plotting.
    """
    from scipy.stats import kstest

    rates = np.asarray(rates)
    S = np.asarray(S)
    T, N = S.shape
    cum = np.concatenate([np.zeros((1, N)), np.cumsum(rates * dt, axis=0)], axis=0)

    ks, pv, us = np.zeros(N), np.zeros(N), []
    for n in range(N):
        spike_bins = np.repeat(np.arange(T), S[:, n].astype(int))
        if len(spike_bins) < 2:
            ks[n], pv[n] = np.nan, np.nan
            us.append(np.array([]))
            continue
        # integral up to each spike (end of the spike's bin)
        Lam = cum[spike_bins + 1, n]
        z = np.diff(Lam)
        u = 1.0 - np.exp(-z)
        res = kstest(u, "uniform")
        ks[n], pv[n] = res.statistic, res.pvalue
        us.append(np.sort(u))
    return ks, pv, us
