"""Fused coupling matmul + Poisson log-likelihood — the port's hand kernels.

Counterpart of :mod:`theano_pyglm_tpu.ops.pallas_kernels`. The innermost
computation of every inference path is

    I   = clip(I_rest + X_f @ U, ±EXP_CLIP)     X_f: (T, N·B), U: (N·B, N)
    LL  = Σ_{t,n} S·(I + log dt) − e^I · dt

Because LL is a scalar, its gradient needs no separate pass over the data:
the unit-cotangent residuals

    dU      = X_fᵀ @ dI_rest,   dI_rest = (S − e^I·dt)·1{|I_raw| < EXP_CLIP}

ride the same read of X_f as the value. Two CUDA kernels
(``csrc/fused_poisson_ll.cu``, built by :mod:`.cuda_loader`) compute them:

  K1 (:func:`fused_ll_value`)          value only — ``_fwd_kernel``'s port
  K2 (:func:`fused_ll_value_and_grad`) value, dU, dI_rest — ``_vg_kernel``'s

Each wrapper launches its kernel for CUDA tensors and adds one to its entry
of :data:`LAUNCHES`; for CPU tensors it runs the plain torch version beside
it (:func:`fused_poisson_ll_reference`), which is also the tests' oracle.
Any other placement, or a CUDA tensor that is not float32 and contiguous,
raises. :class:`FusedPoissonLL` is the autograd op: K2 when ``u`` or
``i_rest`` needs a gradient, else K1. The chain-batched form (ROADMAP K3) and
bf16 designs (K4) are not ported yet.
"""

from __future__ import annotations

import functools
import math

import torch

from theano_pyglm_torch.ops.clipping import clip_exponent, exponent_active

__all__ = [
    "LAUNCHES",
    "TILE_T",
    "FusedPoissonLL",
    "fused_ll_value",
    "fused_ll_value_and_grad",
    "fused_poisson_ll",
    "fused_poisson_ll_reference",
    "fused_poisson_ll_value_reference",
]

TILE_T = 64  # time bins per tile of the CUDA kernels
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory a Hopper block may use
# Launches of each kernel on a CUDA device; the CPU path does not count.
LAUNCHES = {"fwd": 0, "vg": 0}


# ---------------------------------------------------------------------------
# plain torch versions (the CPU path and the oracle)
# ---------------------------------------------------------------------------


def fused_poisson_ll_value_reference(x_f, u, i_rest, s, dt: float):
    """Plain torch K1: the scalar Σ S·(I + log dt) − e^I·dt."""
    I = clip_exponent(i_rest + x_f @ u)
    return torch.sum(s * (I + math.log(dt)) - torch.exp(I) * dt)


def fused_poisson_ll_reference(x_f, u, i_rest, s, dt: float):
    """Plain torch K2: (ll, dU, dI_rest) by the closed form."""
    i_raw = i_rest + x_f @ u
    I = clip_exponent(i_raw)
    rate_dt = torch.exp(I) * dt
    ll = torch.sum(s * (I + math.log(dt)) - rate_dt)
    d_irest = torch.where(exponent_active(i_raw), s - rate_dt, torch.zeros_like(rate_dt))
    return ll, x_f.T @ d_irest, d_irest


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(x_f, u, i_rest, s) -> bool:
    """Validate the operands; True when they lie on a CUDA device."""
    if x_f.ndim != 2 or u.ndim != 2 or x_f.shape[1] != u.shape[0]:
        raise ValueError(f"x_f {tuple(x_f.shape)} and u {tuple(u.shape)} do not chain")
    T, N = x_f.shape[0], u.shape[1]
    for name, t in (("i_rest", i_rest), ("s", s)):
        if tuple(t.shape) != (T, N):
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {(T, N)}")
    if T == 0:
        raise ValueError("empty time axis")
    tensors = (x_f, u, i_rest, s)
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return False
    if len(devices) != 1 or x_f.device.type != "cuda":
        raise ValueError(f"operands must share one CUDA device or all be on the CPU: {devices}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    NB = x_f.shape[1]
    if T * max(NB, N) >= 2**31:
        raise ValueError("T·max(NB, N) must fit in a 32-bit index")
    smem = 4 * (2 * NB * N + TILE_T * (NB + N))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"NB·N = {NB * N} needs {smem} B of shared memory (> {_SMEM_LIMIT})")
    return True


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(with_grad: bool, x_f, u, i_rest, s, dt: float):
    from theano_pyglm_torch.ops.cuda_loader import load_fused_ll

    lib = load_fused_ll()
    T, NB = x_f.shape
    N = u.shape[1]
    dev = x_f.device
    n_blocks = min(-(-T // TILE_T), 2 * _sm_count(dev.index))
    width = NB * N + 1 if with_grad else 1
    part = torch.empty((n_blocks, width), dtype=torch.float32, device=dev)
    out = torch.empty(width, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sizes = (T, NB, N, TILE_T, n_blocks, dev.index, float(dt), math.log(dt), stream)
    ins = (x_f.data_ptr(), u.data_ptr(), i_rest.data_ptr(), s.data_ptr())
    if with_grad:
        d_irest = torch.empty((T, N), dtype=torch.float32, device=dev)
        err = lib.fused_ll_vg(*ins, d_irest.data_ptr(), part.data_ptr(), out.data_ptr(), *sizes)
    else:
        err = lib.fused_ll_fwd(*ins, part.data_ptr(), out.data_ptr(), *sizes)
    if err != 0:
        msg = lib.fused_ll_error_string(err).decode()
        raise RuntimeError(f"fused Poisson-LL kernel launch failed: {msg} ({err})")
    LAUNCHES["vg" if with_grad else "fwd"] += 1
    if with_grad:
        return out[-1], out[:-1].view(NB, N), d_irest
    return out[0]


def fused_ll_value(x_f, u, i_rest, s, dt: float):
    """K1: the scalar log-likelihood (the gammaln(S+1) constant excluded)."""
    if _check(x_f, u, i_rest, s):
        return _launch(False, x_f, u, i_rest, s, dt)
    return fused_poisson_ll_value_reference(x_f, u, i_rest, s, dt)


def fused_ll_value_and_grad(x_f, u, i_rest, s, dt: float):
    """K2: (ll, dU, dI_rest) for a unit output cotangent."""
    if _check(x_f, u, i_rest, s):
        return _launch(True, x_f, u, i_rest, s, dt)
    return fused_poisson_ll_reference(x_f, u, i_rest, s, dt)


# ---------------------------------------------------------------------------
# autograd op
# ---------------------------------------------------------------------------


class FusedPoissonLL(torch.autograd.Function):
    """Scalar fused Poisson log-likelihood with its one-pass gradient.

    ``forward`` runs K2 when ``u`` or ``i_rest`` needs a gradient and saves
    the unit-cotangent residuals; otherwise it runs K1. ``backward`` scales
    the residuals by the incoming cotangent. ``x_f`` and ``s`` are data and
    get no gradient.
    """

    @staticmethod
    def forward(ctx, x_f, u, i_rest, s, dt):
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            ll, d_u, d_irest = fused_ll_value_and_grad(x_f, u, i_rest, s, dt)
            ctx.save_for_backward(d_u, d_irest)
            return ll
        return fused_ll_value(x_f, u, i_rest, s, dt)

    @staticmethod
    def backward(ctx, g):
        d_u, d_irest = ctx.saved_tensors
        g_u = g * d_u if ctx.needs_input_grad[1] else None
        g_irest = g * d_irest if ctx.needs_input_grad[2] else None
        return None, g_u, g_irest, None, None


def fused_poisson_ll(x_f, u, i_rest, s, dt: float):
    """Fused Σ [S·(I+log dt) − e^I·dt] with I = clip(I_rest + X_f@U, ±EXP_CLIP).

    Args:
      x_f: (T, NB) design.
      u: (NB, N) combined coupling weights.
      i_rest: (T, N) non-coupling currents.
      s: (T, N) spike counts.
      dt: bin width.

    Returns the scalar log-likelihood (the gammaln(S+1) constant excluded —
    add it outside if absolute values must match scipy). Differentiable in
    ``u`` and ``i_rest``.
    """
    return FusedPoissonLL.apply(
        x_f.contiguous(), u.contiguous(), i_rest.contiguous(), s.contiguous(), float(dt)
    )

