"""Fused coupling matmul + Poisson log-likelihood — the port's hand kernels.

Counterpart of :mod:`theano_pyglm_tpu.ops.pallas_kernels`. The innermost
computation of every inference path is

    I   = clip(I_rest + X_f @ U, ±EXP_CLIP)     X_f: (T, N·B), U: (N·B, N)
    LL  = Σ_{t,n} S·(I + log dt) − e^I · dt

Because LL is a scalar, its gradient needs no separate pass over the data:
the unit-cotangent residuals

    dU      = X_fᵀ @ dI_rest,   dI_rest = (S − e^I·dt)·1{|I_raw| < EXP_CLIP}

ride the same read of X_f as the value. Two CUDA kernels
(``csrc/fused_poisson_ll.cu``, and ``csrc/fused_poisson_ll_wide.cu`` where U
is too wide for it; built by :mod:`.cuda_loader`) compute them:

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
chain. The four chain kernels (K3-fwd, K3-vg and their bfloat16 instances)
are one template in ``csrc/fused_ll_chains.cu``, built into one library:
the value kernels are its value-only instances (see the source notes).

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

Wide U. A block of ``csrc/fused_poisson_ll.cu`` keeps U in shared memory,
which holds all of U up to NB·N ≈ 8,000 words (NB = 5N: N ≤ 88). Past that
K1/K2 launch their wide-U instance (``csrc/fused_poisson_ll_wide.cu``,
counted under the same keys of :data:`LAUNCHES` and in
:data:`WIDE_LAUNCHES`): U is split into TF32 parts once a call into a
device scratch and streamed in k-slabs beside X_f's, a block holds all N
columns over a tile of 16·``m_tiles``·``m_warps`` bins, and K2's dU is a
second phase over the dI_rest it has just written, in ``du_parts`` parts
of dU's rows (:func:`_wide_plan`, fields ``k_slab`` to ``du_chunk``).
Where even that does not fit (N ≳ 900) the U-resident instance still runs,
in column groups: column n of I, dI_rest and dU depends on column n of U
alone, so the N columns are cut into G groups of ``group_cols`` (a
multiple of 8) and each block works on one group, G the least count whose
group fits at a 4-bin tile; a tile's X_f is
then read once per group. K3 takes one column group:
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
dI_rest in float32. Four kernels (K4) carry them: K4-fwd and K4-vg for one
chain (``csrc/fused_poisson_ll_bf16.cu``), K4-fwd-chains and K4-vg-chains
for every group of chains, a group of one included, so that a chain axis of
1 keeps the chain semantics (the bfloat16 instances of the chain source).
The plain versions widen a bfloat16 X_f exactly to U's dtype and, on a
chain axis, round U and dI. K4-fwd and K4-vg hold U split into TF32 big and
small parts in shared memory, so they take column groups of their own
(:func:`k4_group_cols`): the n-tiles cut as evenly as they can be into the
fewest groups whose split U fits beside 32-bin tiles (N = 100 at NB = 500:
four).

The collapsed adjacency stage's row scan (:func:`row_scan`,
``csrc/adjacency_rows.cu``) is a hand kernel that ports no TPU kernel: the
JAX package's stage is a ``lax.scan``. One launch runs every row's
birth–death updates of its entries in order; the algorithm, its plain
version and the dispatch between them are
:mod:`theano_pyglm_torch.inference.row_scan`. Launches count in
:data:`ROW_SCAN_LAUNCHES`.
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
    "ROW_SCAN_LAUNCHES",
    "WIDE_LAUNCHES",
    "SMEM_LIMIT",
    "THREADS",
    "TILE_MAX",
    "FusedPoissonLL",
    "FusedPoissonLLChains",
    "LaunchPlan",
    "chain_groups",
    "du_tiles",
    "k4_du_slices",
    "k4_du_warps",
    "k4_group_cols",
    "k4_vg_items",
    "mma_tiles",
    "row_scan",
    "row_scan_cluster",
    "row_scan_smem_bytes",
    "vg_chains_items",
    "vg_chains_k_slices",
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
    "wide_du_run",
    "wide_du_runs",
    "wide_fwd_runs",
    "wide_split_words",
]

THREADS = 256  # threads per block of the CUDA kernels (kThreads in the source)
WARPS = THREADS // 32
TILE_MAX = 128  # the widest time tile, in bins
SMEM_LIMIT = 227 * 1024 - 256  # a Hopper block's 227 KB, less the kernels' static shared memory
MAX_CHAINS = 8  # K3's and K4-chains' chains, at most (kMaxChains in the sources)
WARP_TILES = 16  # K3-vg, K4-vg-chains: dU mma tiles a warp holds, at most (kWarpTiles)
UNIT_TILES = 8  # K3-vg, K4-vg-chains: n-tiles of a forward unit, at most (kUnitTiles)
VALUE_TILES = 4  # K3-fwd, K4-fwd-chains: n-tiles of a forward unit of two m-tiles, at most (kValueTiles)
K4_UNIT_TILES = 2  # K4-fwd, K4-vg: n-tiles of a forward unit of two m-tiles, at most (kUnitTiles)
K4_GROUP_TILES = 4  # K4-fwd, K4-vg: n-tiles of a column group, at most (kGroupTiles)
K4_MIN_TILE = 32  # K4's column groups keep room for tiles of this many bins where they can
# Launches of each kernel on a CUDA device; the CPU path does not count.
# K4 (a bfloat16 X_f) counts under the float32 kernel's key with "_bf16".
LAUNCHES = {"fwd": 0, "vg": 0, "fwd_chains": 0, "vg_chains": 0,
            "fwd_bf16": 0, "vg_bf16": 0, "fwd_chains_bf16": 0, "vg_chains_bf16": 0}
# Of LAUNCHES["fwd"] and ["vg"], those of the wide-U instance.
WIDE_LAUNCHES = {"fwd": 0, "vg": 0}
# Launches of the adjacency stage's row scan (csrc/adjacency_rows.cu), a
# bfloat16 ψ under "row_scan_bf16": one a stage call and row batch, the
# replays of a captured row batch included (inference/gibbs.py _replay_rows).
ROW_SCAN_LAUNCHES = {"row_scan": 0, "row_scan_bf16": 0}


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
    group_cols: int  # columns of a group (K4: of its widest): N when G = 1, else a multiple of 8
    # K1/K2's wide-U instance (fused_poisson_ll_wide.cu); 0 in every other plan
    k_slab: int = 0  # X_f columns and U rows of a k-slab (8, 16 or 32)
    stages: int = 0  # k-slabs in the ring (2 to 4)
    m_warps: int = 0  # warps along the tile; WARPS // m_warps share its n-tiles
    m_tiles: int = 0  # m-tiles (16 bins) of a warp: tile_t = 16·m_tiles·m_warps
    du_parts: int = 0  # K2: parts of dU's runs, kWarps runs each; grid_x // du_parts blocks a part
    du_chunk: int = 0  # K2: bins of a dU chunk


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _b_stride(cols: int) -> int:
    """U's row stride for ``cols`` columns: ceil8, ≡ 8 (mod 16) words
    (b_stride in ``fused_ll_common.cuh``)."""
    cols = _ceil_to(cols, 8)
    return cols + (0 if cols % 16 else 8)


def _n_span(N: int, tile_t: int) -> int:
    """An I_rest or S span of a tile, 8 words past its rows (n_span)."""
    return _ceil_to(tile_t * N, 4) + 8


def _smem_bytes(NB: int, N: int, tile_t: int) -> int:
    """Mirror of smem_bytes_for in ``fused_poisson_ll.cu`` (K1/K2): U, two
    stages of the X_f, I_rest and S tiles, and a join scratch, in 32-bit
    words, for a block that holds N columns (a column group's width)."""
    stage = _ceil_to(tile_t, 16) * NB + 2 * _n_span(N, tile_t)
    return 4 * (_ceil_to(NB, 8) * _b_stride(N) + 2 * stage + 8 * THREADS)


def _odd4(words: int) -> int:
    """The least stride of at least ``words`` 32-bit words that is 4 more
    than a multiple of 8: eight such rows start in eight distinct groups of
    four banks (k_stride in the chain source)."""
    return words + (12 - words % 8) % 8


def _x_words_bf16(NB: int, tile_t: int) -> int:
    """A stage's bfloat16 X_f region in 32-bit words: the tile's RT =
    ceil16(tile_t) rows, then at least 16 values that the k-steps past the
    last row's NB read."""
    return _ceil_to(_ceil_to(tile_t, 16) * NB + 16, 8) // 2


def _k4_groups(N: int, W: int) -> int:
    """K4's column groups for a widest group of W columns: the N columns'
    NT n-tiles cut into G groups as even as they can be (group q: n-tiles
    q·NT/G to (q + 1)·NT/G), W = N for one group, else 8·ceil(NT / G)
    (n_groups in ``fused_poisson_ll_bf16.cu``)."""
    return -(-(-(-N // 8)) // -(-W // 8))


def _k4_fwd_split(RT: int, ntg: int, ksteps: int) -> tuple:
    """K4's forward of a tile of RT rows and ntg n-tiles of ``ksteps``
    k-steps: (n-groups, units, k-split, a unit's widest n-tiles). Units are
    32 bins × up to K4_UNIT_TILES n-tiles, in the fewest n-groups that give
    each warp a unit where the n-tiles allow, else in the widest units;
    where the units are fewer than the warps, that many warps (a power of 2,
    at most one a k-step) split each unit's k-steps and its epilogue
    (fwd_groups, fwd_k_split in the source)."""
    rp = -(-RT // 32)
    ngf = -(-ntg // K4_UNIT_TILES)
    if rp * ntg >= WARPS:
        ngf = max(ngf, -(-WARPS // rp))
    units = rp * ngf
    most = 1 if units >= WARPS else min(WARPS // units, ksteps)
    kf = 8 if most >= 8 else 4 if most >= 4 else 2 if most >= 2 else 1
    return ngf, units, kf, -(-ntg // ngf)


def _k4_join_words(RT: int, ntg: int, ksteps: int) -> int:
    """The forward's join where K4 splits a unit's k-steps: a slot a unit and
    k-slice, 8 values a lane and n-tile of the widest unit (join_words)."""
    _, units, kf, width = _k4_fwd_split(RT, ntg, ksteps)
    return 0 if kf == 1 else units * kf * 32 * 8 * width


def _smem_bytes_bf16(NB: int, N: int, tile_t: int, W: int = None) -> int:
    """Mirror of smem_bytes_bf16 in ``fused_poisson_ll_bf16.cu`` (K4-fwd,
    K4-vg) for N columns in groups whose widest is W (default N, one
    group), in 32-bit words: U split into TF32 big and small parts, a uint4
    a lane, k-step of 8 and n-tile of the widest group; two stages of the
    bfloat16 X_f tile (at least 16 values after its rows) and the I_rest
    and S spans; the forward's join where a unit's k-steps are split."""
    W = N if W is None else W
    nt, G, ks8, RT = -(-N // 8), _k4_groups(N, W), -(-NB // 8), _ceil_to(tile_t, 16)
    hi, lo = -(-nt // G), nt // G
    stage = _x_words_bf16(NB, tile_t) + 2 * _n_span(W, tile_t)
    join = max(_k4_join_words(RT, hi, ks8), _k4_join_words(RT, lo, ks8))
    # after the tiles K4-vg's k-slices join their dU rows there
    rs = -(-(-(-NB // 16)) // k4_du_slices(NB, W))
    du = WARPS // k4_du_warps(rs, hi) * min(16 * rs, NB) * W
    return 4 * max(ks8 * hi * 128 + 2 * stage + join, du)


def _smem_bytes_chains(NB: int, N: int, C: int, tile_t: int, bf16: bool, grad: bool) -> int:
    """Mirror of smem_bytes_chains in ``fused_ll_chains.cu`` (K3-fwd, K3-vg,
    K4-fwd-chains, K4-vg-chains on C chains), in 32-bit words: U (K3
    float32 rows of b_stride(C·N); K4 bf16(U) transposed in k-pairs,
    ceil8(C·N) columns), two stages of the X_f tile (K4: at least 16
    values after its rows) and the C I_rest spans and the S span, and
    K4-vg-chains' bfloat16 copy of dI (ceil8(C·N) columns of bin pairs). No
    join scratch: after the tiles the whole region is the cross-block sums'
    scratch."""
    CN, RT = C * N, _ceil_to(tile_t, 16)
    if bf16:
        u_words = _ceil_to(CN, 8) * _odd4(_ceil_to(NB, 16) // 2)
        x_words = _x_words_bf16(NB, tile_t)
        di_words = _ceil_to(CN, 8) * _odd4(RT // 2) if grad else 0
    else:
        u_words = _ceil_to(NB, 8) * _b_stride(CN)
        x_words, di_words = RT * NB, 0
    return 4 * (u_words + 2 * (x_words + (C + 1) * _n_span(N, tile_t)) + di_words)


# K2's dU micro-tile, rows × columns (kMtM, kMtN in the source): at the
# flagship shape NB = 135 = 15·9 and N = 27 ≤ 4·7 leave little padding
DU_TILE = (9, 7)


def du_tiles(NB: int, N: int) -> int:
    """K2's dU in DU_TILE micro-tiles, one per thread of a
    grid_y slice."""
    return -(-NB // DU_TILE[0]) * -(-N // DU_TILE[1])


def mma_tiles(NB: int, N: int, chains: int) -> int:
    """K3-vg's and K4-vg-chains' dU in 16 × 8 mma tiles (items) over NB
    rows and the C·N columns of all chains; a warp holds at most WARP_TILES
    of them."""
    return -(-NB // 16) * -(-(chains * N) // 8)


def _work_warps(items: int) -> int:
    """The warps that share a grid_y slice's dU items: the fewest of 1, 2,
    4, 8 whose runs hold at most WARP_TILES items (work_warps in
    ``fused_ll_chains.cu``)."""
    return next(w for w in (1, 2, 4) if items <= w * WARP_TILES) if items <= 4 * WARP_TILES else WARPS


def vg_chains_k_slices(NB: int, N: int, chains: int, grid_y: int) -> int:
    """K3-vg's and K4-vg-chains' k-slices: the warps that share a run of dU
    items split a tile's k-steps, each into a partial row of its own, so a
    call's scratch holds grid_x · k-slices rows."""
    slice_items = -(-mma_tiles(NB, N, chains) // grid_y)
    return WARPS // _work_warps(slice_items)


def vg_chains_items(NB: int, N: int, chains: int, grid_y: int) -> list:
    """Mirror of the dU work of K3-vg and K4-vg-chains: for each grid_y
    slice and warp, (its k-slice, its run of (m-tile, n-tile) items). A
    slice's items go m-major (item q: m-tile q // NT, n-tile q % NT over the
    NT n-tiles of the C·N columns) to IW item-warps in runs of per_warp =
    ceil(slice items / IW) (IW the fewest of 1, 2, 4, 8 with per_warp ≤
    WARP_TILES); warp w takes the run of item-warp w % IW and the tile's
    k-steps ≡ w // IW (mod WARPS / IW). A run covers few m-tiles, and the
    kernel builds one A fragment of X_fᵀ per m-tile of a group of its
    items and k-step."""
    NT = -(-(chains * N) // 8)
    n_items = mma_tiles(NB, N, chains)
    slice_items = -(-n_items // grid_y)
    iw_count = _work_warps(slice_items)
    per_warp = -(-slice_items // iw_count)
    runs = []
    for y in range(grid_y):
        end = min((y + 1) * slice_items, n_items)
        for w in range(WARPS):
            q0 = y * slice_items + (w % iw_count) * per_warp
            runs.append((w // iw_count, [divmod(q, NT) for q in range(q0, min(q0 + per_warp, end))]))
    return runs


def _unit_rows_cap(N: int, C: int, grad: bool = True) -> int:
    """The chain kernels' widest tile: forward units are 16 bins × up to
    UNIT_TILES n-tiles (the value kernels': 32 bins × up to VALUE_TILES),
    the C·N columns in NGF n-groups; at most rows·(WARPS // NGF) bins keep
    each warp at one unit a tile where NGF ≤ WARPS."""
    rows, width = (16, UNIT_TILES) if grad else (32, VALUE_TILES)
    ngf = -(-(-(-(C * N) // 8)) // width)
    return rows * max(1, WARPS // ngf)


def k4_group_cols(NB: int, N: int) -> int:
    """K4's widest column group (N for one group): the fewest even groups of
    at most K4_GROUP_TILES n-tiles whose U, split, fits beside two stages of
    K4_MIN_TILE-bin tiles, else of 8-bin tiles. Raises ValueError when not
    even one n-tile fits."""
    nt = -(-N // 8)
    for tile in (K4_MIN_TILE, 8):
        for G in range(-(-nt // K4_GROUP_TILES), nt + 1):
            W = N if G == 1 else 8 * -(-nt // G)
            if _smem_bytes_bf16(NB, N, tile, W) <= SMEM_LIMIT:
                return W
    raise ValueError(
        f"NB={NB}, N={N} needs {_smem_bytes_bf16(NB, N, 8, min(N, 8))} B of shared memory even in "
        f"column groups of 8 (> {SMEM_LIMIT})"
    )


def k4_du_warps(rows: int, ntw: int) -> int:
    """K4-vg's item-warps for a grid_y slice of ``rows`` dU m-rows of ntw
    n-tiles: the fewest of 1, 2, 4, 8 whose even shares of the rows hold at
    most WARP_TILES items (du_warps in the source); the other warps of a
    group of WARPS split the tile's k-steps, their sums joined in shared
    memory after the tiles."""
    return next((w for w in (1, 2, 4) if -(-rows // w) * ntw <= WARP_TILES), WARPS)


def k4_du_slices(NB: int, W: int) -> int:
    """K4-vg's grid_y: the fewest slices of the m-rows whose 8 warps hold
    the widest group's items, WARP_TILES a warp at most."""
    return -(-(-(-NB // 16)) // (WARPS * (WARP_TILES // -(-W // 8))))


def k4_vg_items(NB: int, N: int, W: int, grid_y: int) -> list:
    """Mirror of K4-vg's dU work: for each column group, grid_y slice and
    warp, (its group, its k-slice, its (m-tile, n-tile) items, the n-tile
    counted in the group). A slice's m-rows (each the group's ntg items) are
    cut evenly over IW item-warps (:func:`k4_du_warps` of the widest group);
    warp w takes the rows of item-warp w % IW and the tile's k-steps ≡ w //
    IW (mod WARPS / IW)."""
    nt, G, mt = -(-N // 8), _k4_groups(N, W), -(-NB // 16)
    rs = -(-mt // grid_y)
    iw_count = k4_du_warps(rs, -(-nt // G))
    runs = []
    for q in range(G):
        ntg = (q + 1) * nt // G - q * nt // G
        for y in range(grid_y):
            s_lo = y * rs
            s_n = max(0, min(rs, mt - s_lo))
            for w in range(WARPS):
                iw = w % iw_count
                m_lo, m_hi = s_lo + iw * s_n // iw_count, s_lo + (iw + 1) * s_n // iw_count
                runs.append((q, w // iw_count, [(m, n) for m in range(m_lo, m_hi) for n in range(ntg)]))
    return runs


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


# K1/K2's wide-U instance (``csrc/fused_poisson_ll_wide.cu``)
WIDE_FWD_RUN = {1: 16, 2: 8}  # n-tiles a warp with 1 or 2 m-tiles, at most (kFwdRun1, kFwdRun2)
WIDE_DU_RUN = 8  # n-tiles of a dU run of two m-tiles, at most (kDuRun)
WIDE_SLABS = ((32, 3), (32, 2), (16, 4), (16, 3), (16, 2), (8, 2))  # (k-slab, stages), the first that fits
WIDE_CHUNKS = (64, 32, 16, 8)  # K2's dU chunk, in bins: the first that fits
# (m_warps, m_tiles) of the wide instance's tile for K1 and K2, widest tile
# first; at one width K1 takes two m-tiles a warp first (half the B-fragment
# reads a product) and K2 one (its phase 2 gets the registers)
WIDE_LAYOUTS = {False: ((8, 2), (4, 2), (8, 1), (2, 2), (4, 1), (1, 2), (2, 1), (1, 1)),
                True: ((8, 2), (8, 1), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))}


def _wide_fwd_words(TM: int, ks: int, stages: int, N: int) -> int:
    """The wide instance's phase-1 shared memory in 32-bit words (fwd_words
    in the source): ``stages`` k-slabs, each X_f's (TM rows of ks + 4 words)
    and U's (ks / 8 k-steps × the n-tiles × 32 lanes, a uint4 each), then
    the tile's I_rest and S."""
    return stages * (TM * (ks + 4) + ks // 8 * -(-N // 8) * 128) + 2 * _ceil_to(TM * N, 4)


def wide_du_runs(NB: int, N: int) -> tuple:
    """The wide K2's dU work: (runs a pair of m-tiles, runs, parts). dU's
    ceil(NB / 16) m-tiles go in pairs, each pair cut into the fewest even
    runs of at most WIDE_DU_RUN n-tiles, pair by pair; a part is WARPS
    consecutive runs, one a warp (du_ranges, du_runs, du_parts in the
    source)."""
    nr = -(-(-(-N // 8)) // WIDE_DU_RUN)
    runs = -(-(-(-NB // 16)) // 2) * nr
    return nr, runs, -(-runs // WARPS)


def wide_du_run(NB: int, N: int, part: int, warp: int):
    """(first m-tile of its pair, first n-tile, n-tiles) of the dU run of
    ``warp`` in ``part``; None past the last run."""
    nt = -(-N // 8)
    nr, runs, _ = wide_du_runs(NB, N)
    run = part * WARPS + warp
    if run >= runs:
        return None
    mp, rr = divmod(run, nr)
    return 2 * mp, rr * nt // nr, (rr + 1) * nt // nr - rr * nt // nr


def _wide_part_cols(NB: int, N: int) -> tuple:
    """(columns, row stride) of a dU chunk's X_f part columns: 32 × the most
    m-tile pairs one part's runs span, and the least stride ≥ that which is
    ≡ 8 (mod 32) words (part_pairs, part_stride in the source)."""
    nr, runs, parts = wide_du_runs(NB, N)
    most = max((min(runs, (p + 1) * WARPS) - 1) // nr - p * WARPS // nr + 1 for p in range(parts))
    return 32 * most, 32 * most + (8 - 32 * most) % 32


def _smem_bytes_wide(NB: int, N: int, TM: int, ks: int, stages: int, chunk: int = 0) -> int:
    """Mirror of smem_bytes_wide in ``fused_poisson_ll_wide.cu``: the larger
    of phase 1 (:func:`_wide_fwd_words`) and, for K2 (``chunk`` > 0), phase
    2 (two buffers each of a chunk's X_f part columns, its dI and its dI
    split in B-fragment order; after them a part's rows of dU), and the
    cross-block sums' 4·THREADS words."""
    du = 0
    if chunk:
        cols, stride = _wide_part_cols(NB, N)
        du = max(2 * (chunk * stride + _ceil_to(chunk * N, 4) + chunk // 8 * -(-N // 8) * 128), cols * N)
    return 4 * max(_wide_fwd_words(TM, ks, stages, N), du, 4 * THREADS)


def wide_fwd_runs(N: int, m_warps: int, m_tiles: int) -> list:
    """(first m-tile, first n-tile, n-tiles) of each warp's share of a
    tile's forward in the wide instance: warp w takes the m_tiles m-tiles
    from m_tiles·(w % m_warps) and an even share of the n-tiles among the
    WARPS // m_warps warps that share them."""
    nt, wn = -(-N // 8), WARPS // m_warps
    return [(m_tiles * (w % m_warps), (w // m_warps) * nt // wn,
             (w // m_warps + 1) * nt // wn - (w // m_warps) * nt // wn) for w in range(WARPS)]


def wide_split_words(NB: int, N: int, k_slab: int) -> int:
    """Floats of the wide instance's scratch of U split into TF32 parts: the
    k-steps of ceil(ceil8(NB) / k_slab) slabs × the n-tiles × 32 lanes × 4."""
    return -(-_ceil_to(NB, 8) // k_slab) * (k_slab // 8) * -(-N // 8) * 128


def _wide_plan(T: int, NB: int, N: int, sm_count: int, grad: bool):
    """The wide instance's plan, or None where it does not fit. A layout of
    WIDE_LAYOUTS[grad] fits where every warp gets at least one n-tile and
    at most WIDE_FWD_RUN[m_tiles], and phase 1 fits with a (k-slab, stages)
    of WIDE_SLABS (of the first two, where any layout fits with them); of
    those the widest tile (16·m_tiles·m_warps bins) that still gives at
    least half the SMs a tile, else the narrowest. K2 takes every SM (phase
    2's parts times their shares of the bins) and the widest chunk of
    WIDE_CHUNKS that fits."""
    nt = -(-N // 8)
    for slabs in (WIDE_SLABS[:2], WIDE_SLABS):  # slabs 32 columns deep where they fit
        fits = []
        for wm, mi in WIDE_LAYOUTS[grad]:
            wn, tm = WARPS // wm, 16 * mi * wm
            if wn > nt or -(-nt // wn) > WIDE_FWD_RUN[mi]:
                continue
            slab = next(((ks, st) for ks, st in slabs if 4 * _wide_fwd_words(tm, ks, st, N) <= SMEM_LIMIT), None)
            if slab is not None:
                fits.append((wm, mi, *slab))
        if fits:
            break
    else:
        return None
    wm, mi, ks, st = next((f for f in fits if -(-T // (16 * f[0] * f[1])) >= sm_count // 2), fits[-1])
    tm, parts, chunk = 16 * mi * wm, 0, 0
    if grad:
        parts = wide_du_runs(NB, N)[2]
        chunk = next((c for c in WIDE_CHUNKS if _smem_bytes_wide(NB, N, tm, ks, st, c) <= SMEM_LIMIT), 0)
        if not chunk or parts > sm_count:
            return None
    n_tiles = -(-T // tm)
    return LaunchPlan(tile_t=tm, n_tiles=n_tiles, grid_x=sm_count if grad else min(sm_count, n_tiles), grid_y=1,
                      smem_bytes=_smem_bytes_wide(NB, N, tm, ks, st, chunk), groups=1, group_cols=N,
                      k_slab=ks, stages=st, m_warps=wm, m_tiles=mi, du_parts=parts, du_chunk=chunk)


# Shared memory that chain_groups keeps free beside a group (bytes): the 8 KB
# join scratch of the first chain kernels' layout. With it the groups, and
# with them the sums of every chain-batched call, stay those of that layout.
GROUP_SPARE = 4 * 8 * THREADS


def _k3_fits(NB: int, N: int, C: int) -> bool:
    """K3 takes C chains at (NB, N): 2 ≤ C ≤ MAX_CHAINS, and all C·N columns
    of U and C I_rest spans fit beside a 4-bin tile with GROUP_SPARE to
    spare, in the float32 layout, which both K3 kernels share and which
    needs more than either bfloat16 one."""
    smem = _smem_bytes_chains(NB, N, C, 4, bf16=False, grad=True)
    return 2 <= C <= MAX_CHAINS and smem + GROUP_SPARE <= SMEM_LIMIT


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
    1 ≤ C ≤ MAX_CHAINS chains. ``grad``: the value-and-gradient kernel,
    else the value-only one.

    K1/K2: G is the least number of column groups whose U slice and two
    stages of the narrowest tile fit in SMEM_LIMIT (:func:`_group_cols`);
    where G > 1, the wide-U instance's plan (:func:`_wide_plan`: G = 1, the
    fields ``k_slab`` to ``du_chunk`` set) wherever it fits; K4
    its own even groups of at most K4_GROUP_TILES n-tiles
    (:func:`k4_group_cols`).
    The chain kernels take one group: all C·N columns of U and C I_rest
    spans beside the narrowest tile, else ValueError (:func:`chain_groups`
    cuts the chains so that each group fits K3). The tile is the widest
    multiple of 4 bins (8 for a bfloat16 X_f, whose tile spans then start on
    16 bytes at any NB) up to TILE_MAX (the chain kernels: up to
    :func:`_unit_rows_cap`, 256 bins at most) whose two stages fit beside
    the group, then
    narrowed so that every block takes the same number of tiles, give or
    take one. K2 splits a group's dU micro-tiles over grid_y slices of
    THREADS; K3-vg and K4-vg-chains their dU mma tiles over slices of
    WARPS · WARP_TILES; K4-vg its m-rows (:func:`k4_du_slices`). Raises ValueError when not even a group of 8
    columns fits at the narrowest tile, when one time tile's blocks
    outnumber the SMs, or when C is outside the kernel's range.
    """
    if min(T, NB, N, sm_count) < 1:
        raise ValueError(f"empty launch: T={T} NB={NB} N={N} sm_count={sm_count}")
    C = 1 if chains is None else int(chains)
    tile_cap = TILE_MAX
    if x_bytes not in (2, 4):
        raise ValueError(f"X_f of {x_bytes}-byte elements: the kernels take float32 or bfloat16")
    if chains is not None and (x_bytes == 2 or C > 1):
        # the chain kernels: K3 (a float32 X_f, 2 ≤ C), K4-chains (bfloat16, 1 ≤ C)
        name, least = ("K4-chains", 1) if x_bytes == 2 else ("K3", 2)
        step = 8 if x_bytes == 2 else 4

        def smem(W, tile):
            return _smem_bytes_chains(NB, W, C, tile, bf16=x_bytes == 2, grad=grad)

        if not least <= C <= MAX_CHAINS:
            raise ValueError(f"{name} takes {least} to {MAX_CHAINS} chains, not C={C} (NB={NB}, N={N})")
        if smem(N, step) > SMEM_LIMIT:
            raise ValueError(
                f"{name} at NB={NB}, N={N}, C={C} needs {smem(N, step)} B of shared memory "
                f"(> {SMEM_LIMIT}); it takes no column groups"
            )
        W, tile_cap = N, _unit_rows_cap(N, C, grad)
        slices = -(-mma_tiles(NB, N, C) // (WARPS * WARP_TILES))
    elif x_bytes == 4:
        # K1/K2 (a float32 X_f, no chain axis or one chain)
        step = 4

        def smem(W, tile):
            return _smem_bytes(NB, W, tile)

        W = _group_cols(NB, N, lambda W: smem(W, step))
        if W < N:  # U does not stay resident: the wide instance, where it fits
            wide = _wide_plan(T, NB, N, sm_count, grad)
            if wide is not None:
                return wide
        slices = -(-du_tiles(NB, W) // THREADS)
    else:
        # K4 (bfloat16, no chain axis): its own column groups
        step = 8

        def smem(W, tile):
            return _smem_bytes_bf16(NB, N, tile, W)

        W = k4_group_cols(NB, N)
        slices = k4_du_slices(NB, W)
    groups = -(-N // W)
    tile_max = step
    while tile_max + step <= tile_cap and smem(W, tile_max + step) <= SMEM_LIMIT:
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
    """K1/K2 (their wide-U instance where the plan says so), or
    K4-fwd/K4-vg for a bfloat16 X_f."""
    T, NB = x_f.shape
    N = u.shape[1]
    dev = x_f.device
    plan = launch_plan(T, NB, N, _sm_count(dev.index), with_grad, x_bytes=x_f.element_size())
    if plan.k_slab:
        return _launch_wide(with_grad, plan, x_f, u, i_rest, s, dt)
    lib, tag = _library(x_f)
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


def _launch_wide(with_grad: bool, plan: LaunchPlan, x_f, u, i_rest, s, dt: float):
    """K1/K2's wide-U instance (``csrc/fused_poisson_ll_wide.cu``), counted
    under K1's and K2's keys of :data:`LAUNCHES` and in
    :data:`WIDE_LAUNCHES`."""
    from theano_pyglm_torch.ops.cuda_loader import load_fused_ll_wide

    lib = load_fused_ll_wide()
    T, NB = x_f.shape
    N = u.shape[1]
    dev = x_f.device
    # dU's partial rows (K2: grid_x // du_parts of them) and a value per block
    dw = _ceil_to(NB * N, 4) if with_grad else 0
    rows = plan.grid_x // plan.du_parts if with_grad else 0
    part = torch.empty(rows * dw + plan.grid_x, dtype=torch.float32, device=dev)
    out = torch.empty(dw + 4, dtype=torch.float32, device=dev)
    usp = torch.empty(wide_split_words(NB, N, plan.k_slab), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sizes = (T, NB, N, plan.tile_t, plan.k_slab, plan.stages, plan.m_warps, plan.m_tiles, plan.du_parts,
             plan.du_chunk, plan.grid_x, plan.smem_bytes, dev.index, float(dt), math.log(dt), stream)
    ins = (x_f.data_ptr(), u.data_ptr(), i_rest.data_ptr(), s.data_ptr())
    scratch = (usp.data_ptr(), part.data_ptr(), out.data_ptr(), _barrier(dev, stream).data_ptr())
    key = "vg" if with_grad else "fwd"
    if with_grad:
        d_irest = torch.empty((T, N), dtype=torch.float32, device=dev)
        err = lib.fused_ll_vg_wide(*ins, d_irest.data_ptr(), *scratch, *sizes)
    else:
        err = lib.fused_ll_fwd_wide(*ins, *scratch, *sizes)
    if err != 0:
        msg = lib.fused_ll_error_string(err).decode()
        raise RuntimeError(f"fused Poisson-LL kernel launch failed: {msg} ({err})")
    LAUNCHES[key] += 1
    WIDE_LAUNCHES[key] += 1
    if with_grad:
        return out[dw], out[: NB * N].view(NB, N), d_irest
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
    """K3, or K4-chains for a bfloat16 X_f, on the C chains of u: values
    and gradients from the chain kernels' one library."""
    from theano_pyglm_torch.ops.cuda_loader import load_fused_ll_chains

    lib = load_fused_ll_chains()
    tag = "_bf16" if x_f.dtype == torch.bfloat16 else ""
    T, NB = x_f.shape
    C, _, N = u.shape
    dev = x_f.device
    plan = launch_plan(T, NB, N, _sm_count(dev.index), with_grad, chains=C, x_bytes=x_f.element_size())
    # float4 rows: dU (K3-vg), then one value per chain; the value-and-
    # gradient kernels write a row per block and k-slice, the value kernels
    # a row per block
    n_du = C * NB * N if with_grad else 0
    width = _ceil_to(n_du + C, 4)
    rows = plan.grid_x * (vg_chains_k_slices(NB, N, C, plan.grid_y) if with_grad else 1)
    part = torch.empty((rows, width), dtype=torch.float32, device=dev)
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


# ---------------------------------------------------------------------------
# the collapsed adjacency stage's row scan
# ---------------------------------------------------------------------------

ROW_SCAN_MAX_CLUSTER = 8  # CTAs a row, at most (a portable cluster)


def row_scan_cluster(R: int, T_sub: int, sm_count: int) -> int:
    """CTAs a row of the row scan (a cluster of them shares its sums through
    distributed shared memory): 1 where the R rows fill the SMs, else the
    least power of two that does, at most ROW_SCAN_MAX_CLUSTER; more where a
    CTA's share of the subsample (ψ_s, I_s and S_sub, 12 bytes a bin) would
    not fit its shared memory. Raises where even the largest cluster's does
    not."""
    k = 1
    while k < ROW_SCAN_MAX_CLUSTER and (R * k < sm_count or row_scan_smem_bytes(T_sub, k) > SMEM_LIMIT):
        k *= 2
    if row_scan_smem_bytes(T_sub, k) > SMEM_LIMIT:
        raise ValueError(f"a subsample of {T_sub} bins does not fit {ROW_SCAN_MAX_CLUSTER} CTAs' shared memory")
    return k


def row_scan_smem_bytes(T_sub: int, K: int) -> int:
    """A row-scan CTA's dynamic shared memory: its 1/K of ψ_s, I_s, S_sub."""
    return 12 * -(-T_sub // K)


def row_scan(psi, cur, S, ent, offs, blk: int, *, beta: float, dt: float, n_newton: int):
    """One launch of the row-scan kernel (``csrc/adjacency_rows.cu``) on
    operands of one CUDA device, shaped as
    :func:`theano_pyglm_torch.inference.row_scan.adjacency_row_scan` takes
    them (which checks their shapes and is the kernel's plain version's
    dispatch). Overwrites ``cur``; returns (A, W, accept), each (R, M).
    Counted in :data:`ROW_SCAN_LAUNCHES`; raises on operands the kernel does
    not take."""
    tensors = (psi, cur, S, ent) + (() if offs is None else (offs,))
    devices = {t.device for t in tensors}
    if len(devices) != 1 or psi.device.type != "cuda":
        raise ValueError(f"row scan operands must share one CUDA device: {devices}")
    if psi.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the row-scan kernel takes a float32 or bfloat16 psi, got {psi.dtype}")
    for name, t in (("cur", cur), ("S", S), ("ent", ent)):
        if t.dtype != torch.float32:
            raise TypeError(f"the row-scan kernel takes a float32 {name}, got {t.dtype}")
    if offs is not None and offs.dtype != torch.int64:
        raise TypeError(f"the row-scan kernel takes int64 offsets, got {offs.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the row-scan kernel takes contiguous tensors")
    M, R, T = psi.shape
    if T >= 2**31:
        raise ValueError("T must fit in a 32-bit index")
    from theano_pyglm_torch.ops.cuda_loader import load_adjacency_rows

    lib = load_adjacency_rows()
    n_blk, blk = (1, T) if offs is None else (offs.shape[1], int(blk))
    scale = T / (n_blk * blk)
    beta, dt = float(beta), float(dt)
    dev = psi.device
    K = row_scan_cluster(R, n_blk * blk, _sm_count(dev.index))
    out = torch.empty((3, R, M), dtype=torch.float32, device=dev)
    key = "row_scan_bf16" if psi.dtype == torch.bfloat16 else "row_scan"
    err = getattr(lib, "adjacency_" + key)(
        psi.data_ptr(), None if offs is None else offs.data_ptr(), cur.data_ptr(), S.data_ptr(), ent.data_ptr(),
        out.data_ptr(), R, M, T, n_blk, blk, K, int(n_newton), row_scan_smem_bytes(n_blk * blk, K), dev.index,
        beta, dt, scale, dt * scale, beta * scale, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.adjacency_row_scan_error_string(err).decode()
        raise RuntimeError(f"row-scan kernel launch failed: {msg} ({err})")
    ROW_SCAN_LAUNCHES[key] += 1
    return out[0], out[1], out[2]
