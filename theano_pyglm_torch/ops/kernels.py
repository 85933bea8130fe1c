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

and, for C chains of U (C, NB, N) and I_rest (C, T, N) against one X_f and
one S (the sampler's chain axis), the chain-batched pair K3, the port of the
``custom_vmap`` rules ``_ll_chains_xla`` / ``_vg_chains_xla`` that JAX
reaches under ``vmap`` (plain XLA there, not ``pallas_call``s):

  K3-fwd (:func:`fused_ll_value_chains`)          the C values
  K3-vg  (:func:`fused_ll_value_and_grad_chains`) the C values, dU, dI_rest

K3 is a chain dimension of K1/K2's columns: column c·N + n reads
U[c, :, n], I_rest[c, :, n] and S[:, n], so one tile of X_f and S feeds every
chain (see the source note).

Each wrapper launches its kernel for CUDA tensors and adds one to its entry
of :data:`LAUNCHES`; for CPU tensors it runs the plain torch version beside
it (:func:`fused_poisson_ll_reference`, :func:`fused_poisson_ll_chains_reference`),
which is also the tests' oracle. The chain wrappers cut the C chains into
the groups that :func:`chain_groups` gives and launch one K3 per group, or
K1/K2 per chain where K3 does not take two.
Any other placement, a CUDA operand that is not contiguous, or one that is
not float32 (X_f: float32 or bfloat16) raises. :class:`FusedPoissonLL` is the autograd op: K2 when ``u`` or
``i_rest`` needs a gradient, else K1; :class:`FusedPoissonLLChains` is
K3's. A call's tile, grid, column groups and shared memory come from
:func:`launch_plan`, a plain function of the shapes.

Column groups. A block keeps its columns of U in shared memory, which holds
all of U up to NB·N ≈ 8,000 words (NB = 5N: N ≤ 88). Column n of I, dI_rest
and dU depends on column n of U alone, so past that the N columns are cut
into G groups of ``group_cols`` (a multiple of 8) and each block works on one
group: G is the least count whose group fits at a 4-bin tile (NB = 5N: G = 2
for 89 ≤ N ≤ 112; N = 100 runs two groups of 56 and 44). G = 1 at every
smaller shape, where the launch is what it was before groups. A tile's X_f is
read once per group, so its device-memory reads grow to G·|X_f| where the
L2 does not serve the groups that share a tile. K3 takes one column group:
all the C·N columns of its chains beside a 4-bin tile, for at most
MAX_CHAINS chains. Past that the chains go in groups of chains, as even as
the most K3 takes allows (NB = 5N: 8 chains up to N = 33, 4 up to 46, 3 up
to 53, 2 up to 64); from N = 65 on, each chain runs K1/K2
(:func:`chain_groups`).

bf16 designs (``Population(design_dtype=torch.bfloat16)``, the JAX op's
``x_f`` in bfloat16): X_f may be bfloat16 while U, I_rest and S stay
float32, and the call has the JAX op's two semantics. Without a chain axis
(the Pallas kernels) ``jnp.dot(bf16, f32)`` promotes: I = I_rest +
f32(X_f)·U and dU = f32(X_f)ᵀ·dI. With a chain axis (the ``custom_vmap``
rules) U and dI are rounded to bfloat16 (to nearest even) for the products:
I = I_rest + X_f·bf16(U) and dU = X_fᵀ·bf16(dI), accumulated in float32,
dI_rest in float32. The four kernels of ``csrc/fused_poisson_ll_bf16.cu``
(K4) carry them: K4-fwd and K4-vg for one chain, K4-fwd-chains and
K4-vg-chains for every group of chains, a group of one included, so that a
chain axis of 1 keeps the chain semantics. The plain versions widen a
bfloat16 X_f exactly to U's dtype and, on a chain axis, round U and dI.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from theano_pyglm_torch.ops.clipping import clip_exponent, exponent_active
from theano_pyglm_torch.utils.dtypes import bf16_rounded

__all__ = [
    "DU_TILE",
    "LAUNCHES",
    "MAX_CHAINS",
    "SMEM_LIMIT",
    "THREADS",
    "TILE_MAX",
    "FusedPoissonLL",
    "FusedPoissonLLChains",
    "LaunchPlan",
    "chain_groups",
    "du_tiles",
    "fused_ll_value",
    "fused_ll_value_and_grad",
    "fused_ll_value_chains",
    "fused_ll_value_and_grad_chains",
    "fused_poisson_ll",
    "fused_poisson_ll_chains",
    "fused_poisson_ll_chains_reference",
    "fused_poisson_ll_chains_value_reference",
    "fused_poisson_ll_reference",
    "fused_poisson_ll_value_reference",
    "launch_plan",
]

THREADS = 256  # threads per block of the CUDA kernels (kThreads in the source)
WARPS = THREADS // 32
TILE_MAX = 128  # the widest time tile, in bins
SMEM_LIMIT = 227 * 1024 - 256  # a Hopper block's 227 KB, less the kernels' static shared memory
MAX_CHAINS = 8  # K3's and K4-chains' chains, at most (kMaxChains in the sources)
WARP_TILES = 16  # K4-vg-chains: dU mma tiles a warp holds (kWarpTiles in the bf16 source)
# Launches of each kernel on a CUDA device; the CPU path does not count.
# K4 (a bfloat16 X_f) counts under the float32 kernel's key with "_bf16".
LAUNCHES = {"fwd": 0, "vg": 0, "fwd_chains": 0, "vg_chains": 0,
            "fwd_bf16": 0, "vg_bf16": 0, "fwd_chains_bf16": 0, "vg_chains_bf16": 0}


# ---------------------------------------------------------------------------
# plain torch versions (the CPU path and the oracle)
# ---------------------------------------------------------------------------


def _wide(x_f, like):
    """X_f in ``like``'s dtype: a bfloat16 design widens exactly."""
    return x_f if x_f.dtype == like.dtype else x_f.to(like.dtype)


def _chain_rounded(x_f, t):
    """``t`` as the chain rules of a bfloat16 X_f take it: rounded to
    bfloat16 (to nearest even), in ``t``'s dtype; a float32 X_f leaves it."""
    return bf16_rounded(t) if x_f.dtype == torch.bfloat16 else t


def fused_poisson_ll_value_reference(x_f, u, i_rest, s, dt: float):
    """Plain torch K1 (K4-fwd for a bfloat16 X_f): the scalar
    Σ S·(I + log dt) − e^I·dt."""
    I = clip_exponent(i_rest + _wide(x_f, u) @ u)
    return torch.sum(s * (I + math.log(dt)) - torch.exp(I) * dt)


def fused_poisson_ll_reference(x_f, u, i_rest, s, dt: float):
    """Plain torch K2 (K4-vg for a bfloat16 X_f): (ll, dU, dI_rest) by the
    closed form."""
    x = _wide(x_f, u)
    i_raw = i_rest + x @ u
    I = clip_exponent(i_raw)
    rate_dt = torch.exp(I) * dt
    ll = torch.sum(s * (I + math.log(dt)) - rate_dt)
    d_irest = torch.where(exponent_active(i_raw), s - rate_dt, torch.zeros_like(rate_dt))
    return ll, x.T @ d_irest, d_irest


def fused_poisson_ll_chains_value_reference(x_f, u, i_rest, s, dt: float):
    """Plain torch K3-fwd (K4-fwd-chains for a bfloat16 X_f, with U rounded
    to bfloat16): the (C,) values of U (C, NB, N), I_rest (C, T, N)."""
    I = clip_exponent(i_rest + _wide(x_f, u) @ _chain_rounded(x_f, u))
    return torch.sum(s * (I + math.log(dt)) - torch.exp(I) * dt, dim=(-2, -1))


def fused_poisson_ll_chains_reference(x_f, u, i_rest, s, dt: float):
    """Plain torch K3-vg (K4-vg-chains for a bfloat16 X_f, with U and, for
    dU, dI rounded to bfloat16): (ll (C,), dU (C, NB, N), dI_rest (C, T, N))."""
    x = _wide(x_f, u)
    i_raw = i_rest + x @ _chain_rounded(x_f, u)
    I = clip_exponent(i_raw)
    rate_dt = torch.exp(I) * dt
    ll = torch.sum(s * (I + math.log(dt)) - rate_dt, dim=(-2, -1))
    d_irest = torch.where(exponent_active(i_raw), s - rate_dt, torch.zeros_like(rate_dt))
    return ll, x.T @ _chain_rounded(x_f, d_irest), d_irest


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


class LaunchPlan(NamedTuple):
    """How one call of K1, K2, K3 or K4 is cut (see the source notes of the
    kernels). The grid is (grid_x, grid_y · groups) blocks."""

    tile_t: int  # bins per time tile, a multiple of 4 (a bfloat16 X_f: of 8)
    n_tiles: int  # ceil(T / tile_t)
    grid_x: int  # persistent blocks striding over the tiles, at most one per SM
    grid_y: int  # K2/K3-vg/K4-vg(-chains): slices of one group's dU work; K1/K3-fwd/K4-fwd(-chains): 1
    smem_bytes: int  # dynamic shared memory of one block
    groups: int  # G, the column groups of U (1: all N columns in every block; K3, K4-chains: 1)
    group_cols: int  # columns of a group: N when G = 1, else a multiple of 8


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _smem_bytes(NB: int, N: int, tile_t: int, chains: int = 1) -> int:
    """Mirror of smem_bytes_for in the source: U, two stages of the X_f,
    I_rest and S tiles, and a join scratch, in 32-bit words, for a block
    that holds N columns (a column group's width) of each of ``chains``
    chains (K3; 1 for K1/K2)."""
    cols = _ceil_to(chains * N, 8)
    bs = cols + (0 if cols % 16 else 8)  # b_stride of the C·N columns
    ns = _ceil_to(tile_t * N, 4) + 8  # n_span
    stage = _ceil_to(tile_t, 16) * NB + (chains + 1) * ns
    return 4 * (_ceil_to(NB, 8) * bs + 2 * stage + 8 * THREADS)


def _odd4(words: int) -> int:
    """The least stride of at least ``words`` 32-bit words that is 4 more
    than a multiple of 8: eight such rows start in eight distinct groups of
    four banks (k_stride in the bf16 source)."""
    return words + (12 - words % 8) % 8


def _smem_bytes_bf16(NB: int, N: int, tile_t: int, chains=None, grad: bool = False) -> int:
    """Mirror of smem_bytes_bf16 in ``fused_poisson_ll_bf16.cu``, in 32-bit
    words: U, two stages of the bfloat16 X_f tile (its rows, then at least
    16 zero values that the k-steps past the last row's NB read) and the
    I_rest and S spans, K4-vg-chains' bfloat16 copy of dI, and the join
    scratch. ``chains`` None: K4 on N columns (a column group's width), U
    in float32 rows as K1/K2 hold it; else K4-chains on that many chains,
    bf16(U) transposed, two k-values a word."""
    C = 1 if chains is None else chains
    RT = _ceil_to(tile_t, 16)
    stage = _ceil_to(RT * NB + 16, 8) // 2 + (C + 1) * (_ceil_to(tile_t * N, 4) + 8)
    if chains is None:
        cols = _ceil_to(N, 8)
        u_words, di_words = _ceil_to(NB, 8) * (cols + (0 if cols % 16 else 8)), 0
    else:
        u_words = _ceil_to(C * N, 32) * _odd4(_ceil_to(NB, 16) // 2)
        di_words = _ceil_to(C * N, 8) * _odd4(RT // 2) if grad else 0
    return 4 * (u_words + 2 * stage + di_words + 8 * THREADS)


# K2's dU micro-tile, rows × columns (kMtM, kMtN in the source): at the
# flagship shape NB = 135 = 15·9 and N = 27 ≤ 4·7 leave little padding
DU_TILE = (9, 7)


def du_tiles(NB: int, N: int, chains: int = 1) -> int:
    """K2's (K3-vg's) dU in DU_TILE micro-tiles, one per thread of a grid_y
    slice; a micro-tile never crosses a chain."""
    return -(-NB // DU_TILE[0]) * chains * -(-N // DU_TILE[1])


def mma_tiles(NB: int, N: int, chains: int) -> int:
    """K4-vg-chains' dU in 16 × 8 mma tiles over NB rows and the C·N
    columns of all chains; a warp holds WARP_TILES of them."""
    return -(-NB // 16) * -(-(chains * N) // 8)


def _group_cols(NB: int, N: int, fits) -> int:
    """Columns of a group for the least G whose group fits at the narrowest
    tile (``fits(W)``: a block's shared memory for W columns there): N
    itself (G = 1), else ceil(N / G) rounded up to whole n-tiles of 8.
    Raises ValueError when not even one n-tile fits."""
    for G in range(1, -(-N // 8) + 1):
        W = N if G == 1 else _ceil_to(-(-N // G), 8)
        if fits(W) <= SMEM_LIMIT:
            return W
    W = min(N, 8)
    raise ValueError(
        f"NB={NB}, N={N} needs {fits(W)} B of shared memory even in column "
        f"groups of {W} (> {SMEM_LIMIT})"
    )


def _k3_fits(NB: int, N: int, C: int) -> bool:
    """K3 takes C chains at (NB, N): 2 ≤ C ≤ MAX_CHAINS, and all C·N columns
    of U and C I_rest spans fit beside a 4-bin tile."""
    return 2 <= C <= MAX_CHAINS and _smem_bytes(NB, N, 4, C) <= SMEM_LIMIT


@functools.lru_cache(maxsize=256)
def chain_groups(NB: int, N: int, C: int) -> tuple:
    """The sizes of the groups of chains that a chain-batched call of C
    chains at (NB, N) launches, in chain order: the fewest groups that K3
    takes, as even as they can be. With a float32 X_f a group of one chain
    is a call of K1/K2: C = 1, and every chain where K3 does not take two;
    with a bfloat16 X_f every group, one chain included, is a K4-chains
    call (the chain semantics)."""
    if C < 1:
        raise ValueError(f"no chains: C={C}")
    most = max((c for c in range(2, MAX_CHAINS + 1) if _k3_fits(NB, N, c)), default=1)
    n = -(-C // most)
    return tuple(C // n + (i < C % n) for i in range(n))


@functools.lru_cache(maxsize=256)
def launch_plan(T: int, NB: int, N: int, sm_count: int, grad: bool, chains=None, x_bytes: int = 4) -> LaunchPlan:
    """Tile, grid, column groups and shared memory of one call at (T, NB, N)
    on a card with ``sm_count`` SMs. ``chains`` is the size of the call's
    chain axis, None without one; ``x_bytes`` X_f's element size. A float32
    X_f: K1/K2 (``chains`` None or 1) or K3 on 2 ≤ C ≤ MAX_CHAINS chains. A
    bfloat16 X_f (``x_bytes`` = 2): K4 (``chains`` None) or K4-chains on
    1 ≤ C ≤ MAX_CHAINS chains.

    K1/K2 and K4: G is the least number of column groups whose U slice and
    two stages of the narrowest tile fit in SMEM_LIMIT (:func:`_group_cols`).
    K3 and K4-chains take one group: all C·N columns of U and C I_rest spans
    beside the narrowest tile, else ValueError (:func:`chain_groups` cuts
    the chains so that each group fits K3). The tile is the widest multiple
    of 4 bins (8 for a bfloat16 X_f, whose tile spans then start on 16
    bytes at any NB) up to TILE_MAX whose two stages fit beside the group,
    then narrowed so that every block takes the same number of tiles, give
    or take one. K2, K3-vg and K4-vg split a group's dU micro-tiles over
    grid_y slices of THREADS; K4-vg-chains its dU mma tiles over slices of
    WARPS · WARP_TILES. Raises ValueError when not even a group of 8
    columns fits at the narrowest tile, when one time tile's blocks
    outnumber the SMs, or when C is outside the kernel's range.
    """
    if min(T, NB, N, sm_count) < 1:
        raise ValueError(f"empty launch: T={T} NB={NB} N={N} sm_count={sm_count}")
    C = 1 if chains is None else int(chains)
    if x_bytes == 4:
        step = 4

        def smem(W, tile):
            return _smem_bytes(NB, W, tile, C)

        if C == 1:
            W = _group_cols(NB, N, lambda W: smem(W, step))
        elif not 2 <= C <= MAX_CHAINS:
            raise ValueError(f"K3 takes 2 to {MAX_CHAINS} chains, not C={C} (NB={NB}, N={N})")
        elif not _k3_fits(NB, N, C):
            raise ValueError(
                f"K3 at NB={NB}, N={N}, C={C} needs {_smem_bytes(NB, N, 4, C)} B of shared memory "
                f"(> {SMEM_LIMIT}); it takes no column groups"
            )
        else:
            W = N
        slices = -(-du_tiles(NB, W, C) // THREADS)
    elif x_bytes == 2:
        step = 8

        def smem(W, tile):
            return _smem_bytes_bf16(NB, W, tile, chains, grad)

        if chains is None:
            W = _group_cols(NB, N, lambda W: smem(W, step))
            slices = -(-du_tiles(NB, W) // THREADS)
        elif not 1 <= C <= MAX_CHAINS:
            raise ValueError(f"K4-chains takes 1 to {MAX_CHAINS} chains, not C={C} (NB={NB}, N={N})")
        elif smem(N, step) > SMEM_LIMIT:
            raise ValueError(
                f"K4-chains at NB={NB}, N={N}, C={C} needs {smem(N, step)} B of shared memory "
                f"(> {SMEM_LIMIT}); it takes no column groups"
            )
        else:
            W = N
            slices = -(-mma_tiles(NB, N, C) // (WARPS * WARP_TILES))
    else:
        raise ValueError(f"X_f of {x_bytes}-byte elements: the kernels take float32 or bfloat16")
    groups = -(-N // W)
    tile_max = step
    while tile_max + step <= TILE_MAX and smem(W, tile_max + step) <= SMEM_LIMIT:
        tile_max += step
    grid_y = slices if grad else 1
    if grid_y * groups > sm_count:
        raise ValueError(f"NB={NB}, N={N}, C={C}: {grid_y * groups} blocks a tile exceed {sm_count} SMs")
    gx_cap = sm_count // (grid_y * groups)
    per_block = -(-T // (gx_cap * tile_max))
    tile_t = min(tile_max, _ceil_to(-(-T // (gx_cap * per_block)), step))
    n_tiles = -(-T // tile_t)
    grid_x = min(gx_cap, n_tiles)
    return LaunchPlan(
        tile_t=tile_t,
        n_tiles=n_tiles,
        grid_x=grid_x,
        grid_y=grid_y,
        smem_bytes=smem(W, tile_t),
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
    return _on_card((x_f, u, i_rest, s), T, x_f.shape[1], N)


def _check_chains(x_f, u, i_rest, s) -> bool:
    """Validate K3's operands, U (C, NB, N) and I_rest (C, T, N) against
    X_f (T, NB) and S (T, N); True when they lie on a CUDA device."""
    if x_f.ndim != 2 or u.ndim != 3 or x_f.shape[1] != u.shape[1]:
        raise ValueError(f"x_f {tuple(x_f.shape)} and chains of u {tuple(u.shape)} do not chain")
    T, (C, _, N) = x_f.shape[0], u.shape
    if tuple(i_rest.shape) != (C, T, N):
        raise ValueError(f"i_rest is {tuple(i_rest.shape)}, expected {(C, T, N)}")
    if tuple(s.shape) != (T, N):
        raise ValueError(f"s is {tuple(s.shape)}, expected {(T, N)}")
    if T == 0 or C == 0:
        raise ValueError("empty time or chain axis")
    return _on_card((x_f, u, i_rest, s), T, x_f.shape[1], N)


def _on_card(tensors, T: int, NB: int, N: int) -> bool:
    """True for contiguous operands on one CUDA device, all float32 but
    X_f, which may be bfloat16; False for operands all on the CPU; anything
    else raises."""
    x_f = tensors[0]
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return False
    if len(devices) != 1 or x_f.device.type != "cuda":
        raise ValueError(f"operands must share one CUDA device or all be on the CPU: {devices}")
    if x_f.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA kernels take a float32 or bfloat16 X_f, got {x_f.dtype}")
    for t in tensors:
        if t is not x_f and t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32 U, I_rest and S, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    if T * max(NB, N) >= 2**31:
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


def _library(x_f):
    """(the kernels' library for X_f's dtype, the suffix of its entry points
    and of their LAUNCHES keys)."""
    from theano_pyglm_torch.ops.cuda_loader import load_fused_ll, load_fused_ll_bf16

    if x_f.dtype == torch.bfloat16:
        return load_fused_ll_bf16(), "_bf16"
    return load_fused_ll(), ""


def _launch(with_grad: bool, x_f, u, i_rest, s, dt: float):
    """K1/K2, or K4-fwd/K4-vg for a bfloat16 X_f."""
    lib, tag = _library(x_f)
    T, NB = x_f.shape
    N = u.shape[1]
    dev = x_f.device
    plan = launch_plan(T, NB, N, _sm_count(dev.index), with_grad, x_bytes=x_f.element_size())
    # float4 rows: dU (K2), then one value per column group
    width = _ceil_to((NB * N if with_grad else 0) + plan.groups, 4)
    part = torch.empty((plan.grid_x, width), dtype=torch.float32, device=dev)
    out = torch.empty(width, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sizes = (T, NB, N, plan.group_cols, plan.tile_t, plan.grid_x, plan.grid_y, plan.smem_bytes,
             dev.index, float(dt), math.log(dt), stream)
    ins = (x_f.data_ptr(), u.data_ptr(), i_rest.data_ptr(), s.data_ptr())
    scratch = (part.data_ptr(), out.data_ptr(), _barrier(dev, stream).data_ptr())
    key = ("vg" if with_grad else "fwd") + tag
    if with_grad:
        d_irest = torch.empty((T, N), dtype=torch.float32, device=dev)
        err = getattr(lib, "fused_ll_" + key)(*ins, d_irest.data_ptr(), *scratch, *sizes)
    else:
        err = getattr(lib, "fused_ll_" + key)(*ins, *scratch, *sizes)
    if err != 0:
        msg = lib.fused_ll_error_string(err).decode()
        raise RuntimeError(f"fused Poisson-LL kernel launch failed: {msg} ({err})")
    LAUNCHES[key] += 1
    if with_grad:
        return out[NB * N], out[: NB * N].view(NB, N), d_irest
    return out[0]


def _launch_chains(with_grad: bool, x_f, u, i_rest, s, dt: float):
    """The C chains in :func:`chain_groups`' groups: one K3 launch for each
    group of two or more and K1/K2 for a chain alone; with a bfloat16 X_f
    one K4-chains launch for every group, a chain alone included."""
    C, NB, N = u.shape
    outs, a = [], 0
    for c in chain_groups(NB, N, C):
        if c == 1 and x_f.dtype != torch.bfloat16:
            got = _launch(with_grad, x_f, u[a], i_rest[a], s, dt)
            got = tuple(t[None] for t in got) if with_grad else got[None]
        else:
            got = _launch_k3(with_grad, x_f, u[a : a + c], i_rest[a : a + c], s, dt)
        outs.append(got)
        a += c
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(t) for t in zip(*outs)) if with_grad else torch.cat(outs)


def _launch_k3(with_grad: bool, x_f, u, i_rest, s, dt: float):
    """K3, or K4-chains for a bfloat16 X_f, on the C chains of u."""
    lib, tag = _library(x_f)
    T, NB = x_f.shape
    C, _, N = u.shape
    dev = x_f.device
    plan = launch_plan(T, NB, N, _sm_count(dev.index), with_grad, chains=C, x_bytes=x_f.element_size())
    # float4 rows: dU (K3-vg), then one value per chain
    n_du = C * NB * N if with_grad else 0
    width = _ceil_to(n_du + C, 4)
    part = torch.empty((plan.grid_x, width), dtype=torch.float32, device=dev)
    out = torch.empty(width, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sizes = (T, NB, N, C, plan.tile_t, plan.grid_x, plan.grid_y, plan.smem_bytes,
             dev.index, float(dt), math.log(dt), stream)
    ins = (x_f.data_ptr(), u.data_ptr(), i_rest.data_ptr(), s.data_ptr())
    scratch = (part.data_ptr(), out.data_ptr(), _barrier(dev, stream).data_ptr())
    key = ("vg_chains" if with_grad else "fwd_chains") + tag
    if with_grad:
        d_irest = torch.empty((C, T, N), dtype=torch.float32, device=dev)
        err = getattr(lib, "fused_ll_" + key)(*ins, d_irest.data_ptr(), *scratch, *sizes)
    else:
        err = getattr(lib, "fused_ll_" + key)(*ins, *scratch, *sizes)
    if err != 0:
        msg = lib.fused_ll_error_string(err).decode()
        raise RuntimeError(f"chain-batched fused Poisson-LL kernel launch failed: {msg} ({err})")
    LAUNCHES[key] += 1
    if with_grad:
        return out[n_du : n_du + C], out[:n_du].view(C, NB, N), d_irest
    return out[:C]


def fused_ll_value(x_f, u, i_rest, s, dt: float):
    """K1 (K4-fwd for a bfloat16 X_f): the scalar log-likelihood (the
    gammaln(S+1) constant excluded)."""
    if _check(x_f, u, i_rest, s):
        return _launch(False, x_f, u, i_rest, s, dt)
    return fused_poisson_ll_value_reference(x_f, u, i_rest, s, dt)


def fused_ll_value_and_grad(x_f, u, i_rest, s, dt: float):
    """K2 (K4-vg for a bfloat16 X_f): (ll, dU, dI_rest) for a unit output
    cotangent."""
    if _check(x_f, u, i_rest, s):
        return _launch(True, x_f, u, i_rest, s, dt)
    return fused_poisson_ll_reference(x_f, u, i_rest, s, dt)


def fused_ll_value_chains(x_f, u, i_rest, s, dt: float):
    """K3-fwd (K4-fwd-chains for a bfloat16 X_f): the (C,) log-likelihoods
    of U (C, NB, N), I_rest (C, T, N), in :func:`chain_groups`' groups."""
    if _check_chains(x_f, u, i_rest, s):
        return _launch_chains(False, x_f, u, i_rest, s, dt)
    return fused_poisson_ll_chains_value_reference(x_f, u, i_rest, s, dt)


def fused_ll_value_and_grad_chains(x_f, u, i_rest, s, dt: float):
    """K3-vg (K4-vg-chains for a bfloat16 X_f): (ll (C,), dU (C, NB, N),
    dI_rest (C, T, N)) for a unit cotangent of every chain's value, in
    :func:`chain_groups`' groups."""
    if _check_chains(x_f, u, i_rest, s):
        return _launch_chains(True, x_f, u, i_rest, s, dt)
    return fused_poisson_ll_chains_reference(x_f, u, i_rest, s, dt)


# ---------------------------------------------------------------------------
# autograd ops
# ---------------------------------------------------------------------------


class FusedPoissonLL(torch.autograd.Function):
    """Scalar fused Poisson log-likelihood with its one-pass gradient.

    ``forward`` runs K2 (K4-vg) when ``u`` or ``i_rest`` needs a gradient
    and saves the unit-cotangent residuals; otherwise it runs K1 (K4-fwd). ``backward`` scales
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
      x_f: (T, NB) design, float32 or bfloat16 (widened exactly: no
        rounding of U, as the JAX op without a chain axis).
      u: (NB, N) combined coupling weights.
      i_rest: (T, N) non-coupling currents.
      s: (T, N) spike counts.
      dt: bin width.

    Returns the scalar log-likelihood (the gammaln(S+1) constant excluded —
    add it outside if absolute values must match scipy). Differentiable in
    ``u`` and ``i_rest``. Where any operand carries a leading chain axis, as
    the JAX op does under ``vmap``, this is :func:`fused_poisson_ll_chains`
    and returns the (C,) values.
    """
    if max(x_f.ndim, u.ndim, i_rest.ndim, s.ndim) == 3:
        return fused_poisson_ll_chains(x_f, u, i_rest, s, dt)
    return FusedPoissonLL.apply(
        x_f.contiguous(), u.contiguous(), i_rest.contiguous(), s.contiguous(), float(dt)
    )



class FusedPoissonLLChains(torch.autograd.Function):
    """The (C,) chain-batched fused log-likelihood with its one-pass
    gradient: K3-vg (K4-vg-chains) when ``u`` or ``i_rest`` needs a
    gradient, else K3-fwd (K4-fwd-chains).
    ``backward`` scales each chain's residuals by its entry of the (C,)
    cotangent."""

    @staticmethod
    def forward(ctx, x_f, u, i_rest, s, dt):
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            ll, d_u, d_irest = fused_ll_value_and_grad_chains(x_f, u, i_rest, s, dt)
            ctx.save_for_backward(d_u, d_irest)
            return ll
        return fused_ll_value_chains(x_f, u, i_rest, s, dt)

    @staticmethod
    def backward(ctx, g):
        d_u, d_irest = ctx.saved_tensors
        g = g[:, None, None]
        g_u = g * d_u if ctx.needs_input_grad[1] else None
        g_irest = g * d_irest if ctx.needs_input_grad[2] else None
        return None, g_u, g_irest, None, None


def fused_poisson_ll_chains(x_f, u, i_rest, s, dt: float):
    """The (C,) fused log-likelihoods of C chains: the counterpart of the
    JAX op under ``vmap`` over a chain axis (its ``custom_vmap`` rules).

    Args:
      x_f: (T, NB) design, or (C, T, NB); float32 or bfloat16 (U and, for
        dU, dI then rounded to bfloat16 where X_f and S are shared, as the
        JAX op's chain rules round them).
      u: (C, NB, N) combined coupling weights, or (NB, N) for every chain.
      i_rest: (C, T, N) non-coupling currents, or (T, N) for every chain.
      s: (T, N) spike counts, or (C, T, N).
      dt: bin width.

    At least one operand carries the chain axis. With X_f and S shared the
    chains go through the chain wrappers (a missing chain axis of U or
    I_rest is broadcast): K3 on the groups of :func:`chain_groups`, K1/K2 on
    a chain alone (a bfloat16 X_f: K4-chains on every group). Where X_f or S carries the chain axis (JAX maps the
    unbatched op there) each chain runs K1/K2 in turn. Differentiable in
    ``u`` and ``i_rest``.
    """
    batched = [t for t in (u, i_rest, x_f, s) if t.ndim == 3]
    if not batched:
        raise ValueError("no operand carries a chain axis: use fused_poisson_ll")
    C = batched[0].shape[0]
    if x_f.ndim == 3 or s.ndim == 3:
        per = [t if t.ndim == 3 else t.expand(C, *t.shape) for t in (x_f, u, i_rest, s)]
        return torch.stack([fused_poisson_ll(*(t[c] for t in per), dt) for c in range(C)])
    if u.ndim == 2:
        u = u.expand(C, *u.shape)
    if i_rest.ndim == 2:
        i_rest = i_rest.expand(C, *i_rest.shape)
    return FusedPoissonLLChains.apply(
        x_f.contiguous(), u.contiguous(), i_rest.contiguous(), s.contiguous(), float(dt)
    )
