"""Parameter conversion between numpy (and hence the JAX package) and torch.

The parity tests draw parameters once, in the JAX package or in numpy, and
carry them into the port with :func:`params_from_numpy`, so both packages
are evaluated at the same point.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(params: dict, device="cuda", dtype=torch.float32) -> dict:
    """``dict[str, array-like]`` → ``dict[str, Tensor]`` on ``device``, the
    current CUDA device unless the caller passes ``device="cpu"``.

    Floating (and boolean) leaves become ``dtype``; integer leaves, such as
    the SBM types ``y``, become int64.
    """
    out = {}
    for k, v in params.items():
        a = np.asarray(v)
        if np.issubdtype(a.dtype, np.integer):
            out[k] = torch.as_tensor(a.astype(np.int64), device=device)
        else:
            out[k] = torch.as_tensor(a.astype(np.float64), device=device).to(dtype)
    return out


def params_to_numpy(params: dict) -> dict:
    """``dict[str, Tensor]`` → ``dict[str, np.ndarray]`` (detached, on the host)."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
