"""Precision policy.

The GPU path runs float32, the type the fused kernels take. Verification
mode (the 1e-6 agreement bar of the parity tests) runs the same code in
float64 on the CPU. Code that creates model-facing tensors with no input to
follow asks :func:`default_float`; a :class:`~theano_pyglm_torch.Population`
takes its ``dtype`` from it unless one is given. A bfloat16 spike design
(``Population(design_dtype=torch.bfloat16)``) rounds where the JAX package
rounds: :func:`bf16_rounded`.
"""

import torch

__all__ = ["bf16_rounded", "default_float", "set_default_float"]

_FLOATS = (torch.float32, torch.float64)
_default = torch.float32


def default_float() -> torch.dtype:
    return _default


def set_default_float(dtype: torch.dtype) -> None:
    """Set the module-level default (float32 on the GPU, float64 for CPU
    verification)."""
    global _default
    if dtype not in _FLOATS:
        raise ValueError(f"default float must be one of {_FLOATS}, got {dtype}")
    _default = dtype


def bf16_rounded(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest even, as JAX's ``astype``), back in
    x's dtype: exact there, so products of two such values are exact in
    float32."""
    return x.to(torch.bfloat16).to(x.dtype)
