"""Single source of truth for the clipped-exp likelihood spec.

The model with the 'exp' nonlinearity is λ = exp(clip(I, ±EXP_CLIP)) with
log λ = clip(I, ±EXP_CLIP): the clip applies to the COMBINED exponent
(bias + stimulus + coupling currents), never per term. With log λ = raw I
the Poisson log-likelihood S·log λ − λ·dt would grow linearly in I past the
point where e^I overflows float32, an unbounded direction a sampler can
ride; clipping λ and log λ at the same point keeps the posterior proper and
bounds every exponential at e^40, so float32 sums cannot give inf − inf.

Every path that evaluates the exp-Poisson likelihood uses these helpers or
EXP_CLIP itself. The CUDA kernels in ``csrc/`` receive EXP_CLIP from here at
build time as ``-DEXP_CLIP`` (see :mod:`theano_pyglm_torch.ops.cuda_loader`),
so the constant is never duplicated by hand.
"""

from __future__ import annotations

import torch

__all__ = ["EXP_CLIP", "clip_exponent", "exp_clipped", "exponent_active"]

EXP_CLIP = 40.0


def clip_exponent(I: torch.Tensor) -> torch.Tensor:
    """log λ for the clipped-exp model: clip(I, ±EXP_CLIP)."""
    return torch.clamp(I, -EXP_CLIP, EXP_CLIP)


def exp_clipped(I: torch.Tensor) -> torch.Tensor:
    """λ for the clipped-exp model: exp(clip(I, ±EXP_CLIP)) ≤ e^EXP_CLIP."""
    return torch.exp(clip_exponent(I))


def exponent_active(I: torch.Tensor) -> torch.Tensor:
    """Boolean mask where the clamp is inactive (∂clip/∂I = 1)."""
    return torch.abs(I) < EXP_CLIP
