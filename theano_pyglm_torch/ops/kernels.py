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
``i_rest`` needs a gradient, else K1. A call's tile, grid, column groups and
shared memory come from :func:`launch_plan`, a plain function of the shapes.

Column groups. A block keeps its columns of U in shared memory, which holds
all of U up to NB·N ≈ 8,000 words (NB = 5N: N ≤ 88). Column n of I, dI_rest
and dU depends on column n of U alone, so past that the N columns are cut
into G groups of ``group_cols`` (a multiple of 8) and each block works on one
group: G is the least count whose group fits at a 4-bin tile (NB = 5N: G = 2
for 89 ≤ N ≤ 112; N = 100 runs two groups of 56 and 44). G = 1 at every
smaller shape, where the launch is what it was before groups. A tile's X_f is
read once per group, so its device-memory reads grow to G·|X_f| where the
L2 does not serve the groups that share a tile. The chain-batched form
(ROADMAP K3) and bf16 designs (K4) are not ported yet.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from theano_pyglm_torch.ops.clipping import clip_exponent, exponent_active

__all__ = [
    "DU_TILE",
    "LAUNCHES",
    "SMEM_LIMIT",
    "THREADS",
    "TILE_MAX",
    "FusedPoissonLL",
    "LaunchPlan",
    "du_tiles",
    "fused_ll_value",
    "fused_ll_value_and_grad",
    "fused_poisson_ll",
    "fused_poisson_ll_reference",
    "fused_poisson_ll_value_reference",
    "launch_plan",
]

THREADS = 256  # threads per block of the CUDA kernels (kThreads in the source)
TILE_MAX = 128  # the widest time tile, in bins
SMEM_LIMIT = 227 * 1024 - 256  # a Hopper block's 227 KB, less the kernels' static shared memory
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


class LaunchPlan(NamedTuple):
    """How one call of K1 or K2 is cut (see the source note of the kernels).
    The grid is (grid_x, grid_y · groups) blocks."""

    tile_t: int  # bins per time tile, a multiple of 4
    n_tiles: int  # ceil(T / tile_t)
    grid_x: int  # persistent blocks striding over the tiles, at most one per SM
    grid_y: int  # K2: slices of one group's dU micro-tiles; K1: 1
    smem_bytes: int  # dynamic shared memory of one block
    groups: int  # G, the column groups of U (1: all N columns in every block)
    group_cols: int  # columns of a group: N when G = 1, else a multiple of 8


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _smem_bytes(NB: int, N: int, tile_t: int) -> int:
    """Mirror of smem_bytes_for in the source: U, two stages of the X_f,
    I_rest and S tiles, and a join scratch, in 32-bit words, for a block
    that holds N columns (a column group's width)."""
    bs = _ceil_to(N, 8) + (0 if _ceil_to(N, 8) % 16 else 8)  # b_stride
    ns = _ceil_to(tile_t * N, 4) + 8  # n_span
    stage = _ceil_to(tile_t, 16) * NB + 2 * ns
    return 4 * (_ceil_to(NB, 8) * bs + 2 * stage + 8 * THREADS)


# K2's dU micro-tile, rows × columns (kMtM, kMtN in the source): at the
# flagship shape NB = 135 = 15·9 and N = 27 ≤ 4·7 leave little padding
DU_TILE = (9, 7)


def du_tiles(NB: int, N: int) -> int:
    """K2's dU in DU_TILE micro-tiles, one per thread of a grid_y slice."""
    return -(-NB // DU_TILE[0]) * -(-N // DU_TILE[1])


def _group_cols(NB: int, N: int) -> int:
    """Columns of a group for the least G whose group fits at a 4-bin tile:
    N itself (G = 1), else ceil(N / G) rounded up to whole n-tiles of 8.
    Raises ValueError when not even one n-tile fits."""
    for G in range(1, -(-N // 8) + 1):
        W = N if G == 1 else _ceil_to(-(-N // G), 8)
        if _smem_bytes(NB, W, 4) <= SMEM_LIMIT:
            return W
    W = min(N, 8)
    raise ValueError(
        f"NB={NB}, N={N} needs {_smem_bytes(NB, W, 4)} B of shared memory even in column "
        f"groups of {W} (> {SMEM_LIMIT})"
    )


@functools.lru_cache(maxsize=256)
def launch_plan(T: int, NB: int, N: int, sm_count: int, grad: bool) -> LaunchPlan:
    """Tile, grid, column groups and shared memory of one call at (T, NB, N)
    on a card with ``sm_count`` SMs.

    G is the least number of column groups whose U slice and two 4-bin
    stages fit in SMEM_LIMIT (:func:`_group_cols`). The tile is the widest
    multiple of 4 bins up to TILE_MAX whose two stages fit beside the group,
    then narrowed so that every block takes the same number of tiles, give
    or take one. K2 splits a group's dU micro-tiles over grid_y slices of
    THREADS. Raises ValueError when not even a group of 8 columns fits at a
    4-bin tile, or when one time tile's blocks outnumber the SMs.
    """
    if min(T, NB, N, sm_count) < 1:
        raise ValueError(f"empty launch: T={T} NB={NB} N={N} sm_count={sm_count}")
    W = _group_cols(NB, N)
    groups = -(-N // W)
    tile_max = 4
    while tile_max + 4 <= TILE_MAX and _smem_bytes(NB, W, tile_max + 4) <= SMEM_LIMIT:
        tile_max += 4
    grid_y = -(-du_tiles(NB, W) // THREADS) if grad else 1
    if grid_y * groups > sm_count:
        raise ValueError(f"NB={NB}, N={N}: {grid_y * groups} blocks a tile exceed {sm_count} SMs")
    gx_cap = sm_count // (grid_y * groups)
    per_block = -(-T // (gx_cap * tile_max))
    tile_t = min(tile_max, _ceil_to(-(-T // (gx_cap * per_block)), 4))
    n_tiles = -(-T // tile_t)
    grid_x = min(gx_cap, n_tiles)
    return LaunchPlan(
        tile_t=tile_t,
        n_tiles=n_tiles,
        grid_x=grid_x,
        grid_y=grid_y,
        smem_bytes=_smem_bytes(NB, W, tile_t),
        groups=groups,
        group_cols=W,
    )


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
    if T * max(x_f.shape[1], N) >= 2**31:
        raise ValueError("T·max(NB, N) must fit in a 32-bit index")
    return True


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_BARRIERS: dict = {}  # (device index, stream) -> the kernels' grid-barrier words


def _barrier(dev, stream: int) -> torch.Tensor:
    bar = _BARRIERS.get((dev.index, stream))
    if bar is None:
        bar = _BARRIERS[(dev.index, stream)] = torch.zeros(2, dtype=torch.int32, device=dev)
    return bar


def _launch(with_grad: bool, x_f, u, i_rest, s, dt: float):
    from theano_pyglm_torch.ops.cuda_loader import load_fused_ll

    lib = load_fused_ll()
    T, NB = x_f.shape
    N = u.shape[1]
    dev = x_f.device
    plan = launch_plan(T, NB, N, _sm_count(dev.index), with_grad)
    # float4 rows: dU (K2), then one value per column group
    width = _ceil_to((NB * N if with_grad else 0) + plan.groups, 4)
    part = torch.empty((plan.grid_x, width), dtype=torch.float32, device=dev)
    out = torch.empty(width, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sizes = (T, NB, N, plan.group_cols, plan.tile_t, plan.grid_x, plan.grid_y, plan.smem_bytes,
             dev.index, float(dt), math.log(dt), stream)
    ins = (x_f.data_ptr(), u.data_ptr(), i_rest.data_ptr(), s.data_ptr())
    scratch = (part.data_ptr(), out.data_ptr(), _barrier(dev, stream).data_ptr())
    if with_grad:
        d_irest = torch.empty((T, N), dtype=torch.float32, device=dev)
        err = lib.fused_ll_vg(*ins, d_irest.data_ptr(), *scratch, *sizes)
    else:
        err = lib.fused_ll_fwd(*ins, *scratch, *sizes)
    if err != 0:
        msg = lib.fused_ll_error_string(err).decode()
        raise RuntimeError(f"fused Poisson-LL kernel launch failed: {msg} ({err})")
    LAUNCHES["vg" if with_grad else "fwd"] += 1
    if with_grad:
        return out[NB * N], out[: NB * N].view(NB, N), d_irest
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

