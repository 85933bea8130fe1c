"""Causal basis convolution — design-tensor construction.

Port of :mod:`theano_pyglm_tpu.ops.convolve`. The convolution is **strictly
causal**:

    out[t, ..., b] = sum_{l=0}^{L-1} basis[l, b] * x[t - 1 - l]

so a spike in bin t can influence the rate from bin t+1 onward, never its
own bin.

Written as the same time-blocked im2col matmul as the JAX package: the lag
windows of a zero-padded copy of the signal are a strided view
(``Tensor.unfold``), and each block of windows is contracted against the
flipped basis with one matmul. The arithmetic is that of a direct
convolution, reordered. A float32 matmul runs in full float32 on the GPU
as long as ``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's
default), the counterpart of the JAX package's ``Precision.HIGHEST``; no
cuDNN convolution (TF32 by default) is involved.
"""

from __future__ import annotations

import torch

from theano_pyglm_torch.utils.dtypes import default_float

__all__ = ["convolve_with_basis", "upsample_stim"]


def convolve_with_basis(x, basis, block: int = 2048) -> torch.Tensor:
    """Strictly-causal convolution of signal(s) with basis columns.

    Args:
      x: signal, shape (T,) or (T, N) — e.g. spike counts or a 1-D stimulus.
      basis: (L, B) filter basis (rows = lags 1·dt … L·dt).
      block: time-block size for the im2col windows (peak extra memory is
        block·L·N values; output correctness does not depend on it).

    Returns:
      (T, B) if x is (T,), else (T, N, B), with
      out[t, n, b] = Σ_l basis[l, b] · x[t-1-l, n] (zero-padded history),
      on x's device, in x's floating dtype (or the default float).
    """
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(default_float())
    basis = torch.as_tensor(basis, dtype=x.dtype, device=x.device)
    L, B = basis.shape
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    T, N = x.shape

    # out[t] = Σ_l basis[l]·x[t-1-l] = Σ_{l'} fb[l']·xp[t+l'] with
    # xp = [zeros(L); x] (so xp[i] = x[i-L]) and fb = flip(basis, lags).
    fb = torch.flip(basis, dims=(0,))
    xp = torch.cat([x.new_zeros((L, N)), x], dim=0)
    windows = xp.unfold(0, L, 1)  # (T+1, N, L): windows[i, n, l] = xp[i+l, n]
    out = x.new_empty((T, N, B))
    for t0 in range(0, T, block):
        t1 = min(t0 + block, T)
        out[t0:t1] = windows[t0:t1] @ fb
    return out[:, 0, :] if squeeze else out


def upsample_stim(stim, dt_stim: float, dt: float, T: int) -> torch.Tensor:
    """Resample a stimulus from its own sampling interval to bin resolution.

    Linear interpolation per stimulus dimension, clamped to the end values
    outside the stimulus' time range (``numpy.interp`` semantics).

    Args:
      stim: (T_stim, D) or (T_stim,) stimulus at interval ``dt_stim``.
      dt_stim: stimulus frame interval (s).
      dt: spike-bin width (s).
      T: number of spike bins to produce.

    Returns:
      (T, D) (or (T,)) stimulus at bin resolution.
    """
    stim = torch.as_tensor(stim)
    squeeze = stim.ndim == 1
    if squeeze:
        stim = stim[:, None]
    n = stim.shape[0]
    t_stim = torch.arange(n, dtype=stim.dtype, device=stim.device) * dt_stim
    t_bins = torch.arange(T, dtype=stim.dtype, device=stim.device) * dt
    if n == 1:
        out = stim.expand(T, -1).clone()
    else:
        lo = torch.clamp(torch.searchsorted(t_stim, t_bins, right=True) - 1, 0, n - 2)
        w = (t_bins - t_stim[lo]) / (t_stim[lo + 1] - t_stim[lo])
        w = torch.clamp(w, 0.0, 1.0)[:, None]
        out = stim[lo] * (1.0 - w) + stim[lo + 1] * w
    return out[:, 0] if squeeze else out
