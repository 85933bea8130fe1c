"""Spike-triggered averaging — port of :mod:`theano_pyglm_tpu.utils.sta`."""

from __future__ import annotations

import torch

__all__ = ["sta"]


def sta(stim, S, L: int, device=None) -> torch.Tensor:
    """Spike-triggered average of the stimulus.

    Args:
      stim: (T, D) stimulus at bin resolution (or (T,)).
      S: (T, N) spike counts.
      L: number of history lags: the STA covers lags 1..L, strictly causal
         (the convention of ops.convolve).
      device: where arrays that are not tensors go: the card unless the
         caller passes ``device="cpu"``; tensors stay on their device.

    Returns:
      (N, L, D): for each neuron, the average stimulus in the L bins
      preceding a spike (lag 1 first). One (N, T) @ (T, D) product per lag.
    """
    if not isinstance(S, torch.Tensor):
        S = torch.as_tensor(S, device=device if device is not None else "cuda")
    stim = torch.as_tensor(stim, device=S.device)
    if stim.ndim == 1:
        stim = stim[:, None]
    S = S.to(stim.dtype)
    out = stim.new_zeros((S.shape[1], L, stim.shape[1]))
    for lag in range(1, L + 1):
        out[:, lag - 1] = S[lag:].T @ stim[:-lag]  # spikes at t, stimulus at t - lag
    return out / torch.clamp(S.sum(0), min=1.0)[:, None, None]
