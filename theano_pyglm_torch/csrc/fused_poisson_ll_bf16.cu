// Fused coupling matmul + Poisson log-likelihood on a bfloat16 spike design,
// one chain, hand-written for Hopper (sm_90a), bound to PyTorch through a
// plain C interface and ctypes (theano_pyglm_torch/ops/cuda_loader.py,
// ops/kernels.py).
//
// Replaces the bfloat16 instances of the JAX package's fused op
// (theano_pyglm_tpu/ops/pallas_kernels.py), which Population(design_dtype=
// jnp.bfloat16, use_pallas=True) reaches with X_f in bfloat16 and U, I_rest
// and S in float32:
//   K4-fwd        _fwd_kernel (:73) / _fwd_call's pallas_call (:195)      -> fused_ll_fwd_bf16
//   K4-vg         _vg_kernel (:100) / _vg_call's pallas_call (:138)       -> fused_ll_vg_bf16
// (the chain rules of its custom_vmap, K4-fwd-chains and K4-vg-chains, are
// in fused_ll_chains.cu). Without a chain axis jnp.dot(bf16, f32) promotes:
//   I_raw = I_rest + f32(X_f)·U,   I = clip(I_raw, ±EXP_CLIP),
//   ll = Σ S·(I + log dt) − e^I·dt,
//   dI_rest = (S − e^I·dt)·1{|I_raw| < EXP_CLIP},   dU = f32(X_f)ᵀ·dI,
// U and dI float32, never rounded (the rounding belongs to the chain rules).
//
// Bounds on an H100 SXM (3.35 TB/s HBM) at the flagship shape T=60,000,
// NB=135, N=27, each byte read or written once: K4-fwd moves 29.2 MB (X_f
// 16.2, I_rest and S 6.5 each) in 8.7 us; K4-vg adds dI_rest, 35.6 MB in
// 10.6 us. Their products, bf16 × float32 as two TF32 products each, take
// 1.8 us (K4-fwd) and 3.5 us (K4-vg) at 495 TFLOP/s: the bytes bound both.
//
// The frame is K1/K2's (csrc/fused_poisson_ll.cu): one persistent block of
// 256 threads per SM, launched cooperatively; each tile's X_f, I_rest and S
// spans moved by TMA bulk copies onto an mbarrier into the other of two
// stages while the current tile computes; dI written in place of the tile's
// I_rest and copied out; every block's partial rows summed after a grid
// barrier in a fixed order (no float atomics: bit for bit); a compensated
// value. A tile's work (PERF.md §6 has the probes):
// - Both products on the tensor cores as TF32 mma.sync.m16n8k8. A widened
//   bf16 value is exact in TF32, so f32(X)·V = X·tf32(V) + X·tf32(V −
//   tf32(V)): two products per k-step where 3xTF32 takes three.
// - U is split into its TF32 big and small parts once per call, into shared
//   memory in the order of the forward's B fragments: one 16-byte load per
//   lane, k-step and n-tile gives both parts of both rows. With one column
//   group it arrives by one TMA bulk copy, queued ahead of the first tile,
//   into the stage that the second tile will use, and is laid out from
//   there; a block of a column group reads its columns from device memory.
// - The forward as units of two m-tiles (32 bins) × up to kUnitTiles (2)
//   n-tiles, whose products share each k-step's B fragments, the small and
//   big parts' products into accumulators of their own; the unit's width a
//   compile-time constant; two k-steps an iteration on two sets of operand
//   registers, each loaded a step ahead. Where a tile has fewer units than
//   warps, the most warps (a power of 2) split each unit's k-steps
//   (fwd_k_split); the unit's warps put their sums in join slots, meet at a
//   named barrier of their own, and each takes every KF-th entry of the
//   unit's epilogue, the slots added in slice order. The epilogue,
//   specialised to the unit's width, issues every term's loads before it
//   sums the terms.
// - K4-vg's dU = X_fᵀ·dI: A is X_fᵀ read from the tile's bf16 rows and
//   widened (exact), B the tile's dI split into TF32 big and small parts: two
//   products per (m-tile, n-tile, k-step). Its 16 × 8 tiles (items) go to
//   warps in whole m-rows of the group's n-tiles, K3-vg's rule for the count
//   (fused_ll_chains.cu): IW warps, the fewest of 1, 2, 4, 8 that hold a
//   grid_y slice's rows at most kWarpTiles items each, the 8 / IW warps that
//   share rows splitting the tile's k-steps. A k-step's B fragments are
//   loaded and split once for all of a warp's rows. Each tile's products go
//   to fresh accumulators, added into the rows' sums once per tile (one
//   accumulator over a block's ~1,800 bins loses to the tensor cores'
//   float32 accumulation: K3-vg's dU was 1.1e-5 off so). After the tiles
//   the k-slices' sums meet in shared memory, are added in slice order and
//   leave as one partial row a block, row by row (a partial row per
//   k-slice, as K3-vg writes, doubled the cross-block sums at the
//   flagship).
// - Nothing is zeroed but what a live row reads unwritten: U's pad rows and
//   columns (laid out as 0), and the 16 values after a tile's X_f rows
//   (zeroed as the tile is issued). A stage's X_f region holds the tile's
//   RT = ceil16(tile_t) rows and those 16 values: the forward's k-steps past
//   the last live row's NB columns read them against U's zero pad rows, and
//   bits left there by nothing may be Inf or NaN (NaN·0 is NaN). dU's last
//   k-step of a ragged tile masks both operands past the tile's rows.
// - Column groups of at most kGroupTiles n-tiles (32 columns), as many more
//   as U's split needs to fit beside two stages of 32-bin tiles (N = 100 at
//   NB = 500: four groups of 3, 3, 3 and 4 n-tiles): the n-tiles cut into G
//   groups as even as they can be, a block works on one group, and X_f is
//   read once per group. K4-vg's dU then holds whole m-rows of a group in a
//   warp (below), with the group's B fragments shared by the rows.

#include <type_traits>

#include "fused_ll_common.cuh"

#ifndef EXP_CLIP
#error "EXP_CLIP must come from theano_pyglm_torch/ops/clipping.py as -DEXP_CLIP"
#endif

namespace {

constexpr int kUnitTiles = 2;   // n-tiles of a forward unit, at most (ops/kernels.py K4_UNIT_TILES)
constexpr int kGroupTiles = 4;  // n-tiles of a column group, at most (ops/kernels.py K4_GROUP_TILES)

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// The forward of a tile of RP row pairs and ntg n-tiles (mirrored by
// ops/kernels.py _k4_fwd_split): units of 32 bins × up to kUnitTiles
// n-tiles, in the fewest n-groups that give each warp a unit where the
// n-tiles allow, else in the widest units; where the units are fewer than
// the warps, the most warps (a power of 2, at most one a k-step) that split
// each unit's k-steps.
__host__ __device__ constexpr int fwd_groups(int RP, int ntg) {
    return RP * ntg >= kWarps ? imax((ntg + kUnitTiles - 1) / kUnitTiles, (kWarps + RP - 1) / RP)
                              : (ntg + kUnitTiles - 1) / kUnitTiles;
}
__host__ __device__ constexpr int fwd_k_split(int units, int ksteps) {
    const int most = units >= kWarps ? 1 : imin(kWarps / units, ksteps);
    return most >= 8 ? 8 : most >= 4 ? 4 : most >= 2 ? 2 : 1;
}
// the words of the forward's join where the k-steps are split: a slot a
// unit and k-slice of 8 values a lane and n-tile of the widest unit
__host__ __device__ constexpr int join_words(int RT, int ntg, int ksteps) {
    const int RP = (RT + 31) / 32, NGF = fwd_groups(RP, ntg), KF = fwd_k_split(RP * NGF, ksteps);
    return KF == 1 ? 0 : RP * NGF * KF * 32 * 8 * ((ntg + NGF - 1) / NGF);
}

// K4-vg's dU: the item-warps that share a grid_y slice's `rows` m-rows of
// ntw n-tiles each: the fewest of 1, 2, 4, 8 whose shares hold at most
// kWarpTiles items (mirrored by ops/kernels.py k4_du_warps)
__host__ __device__ constexpr int du_warps(int rows, int ntw) {
    return rows * ntw <= kWarpTiles ? 1 : (rows + 1) / 2 * ntw <= kWarpTiles ? 2
         : (rows + 3) / 4 * ntw <= kWarpTiles ? 4 : kWarps;
}

// Column groups: the N columns' NT n-tiles cut into G groups as even as
// they can be (group q: n-tiles q·NT/G to (q + 1)·NT/G); W, the widest
// group's columns, is N for one group, else 8·ceil(NT / G).
__host__ __device__ constexpr int n_groups(int N, int W) { return ((N + 7) / 8 + (W + 7) / 8 - 1) / ((W + 7) / 8); }

// Shared-memory layout, in 32-bit words, mirrored by ops/kernels.py
// _smem_bytes_bf16:
//   U         (ceil8(NB) / 8 k-steps × the group's n-tiles × 32 lanes) uint4
//             fragments {big U[k][c], big U[k + 4][c], small U[k][c], small
//             U[k + 4][c]}, k = 8·step + lane % 4, c = 8·n-tile + lane / 4
//   stage 0, 1  X_f (x_words: RT × NB bf16 values, then at least 16 more),
//             then I_rest (NS; K4-vg: dI in place), then S (NS)
//   join      the forward's partial sums where units split their k-steps
// After the tiles the whole region is scratch for the cross-block sums.
__host__ __device__ constexpr int x_words(int NB, int tile_t) {
    return ceil_to(ceil_to(tile_t, 16) * NB + 16, 8) / 2;
}
__host__ __device__ constexpr int u_words(int NB, int ntw) { return ceil_to(NB, 8) / 8 * ntw * 128; }
__host__ __device__ constexpr int stage_words(int NB, int W, int tile_t) {
    return x_words(NB, tile_t) + 2 * n_span(W, tile_t);
}
// K4-vg's grid_y: the fewest slices of dU's m-rows whose 8 warps hold the
// widest group's items, kWarpTiles a warp at most (ops/kernels.py
// k4_du_slices)
__host__ __device__ constexpr int du_slices(int NB, int ntw) {
    return ((NB + 15) / 16 + kWarps * (kWarpTiles / ntw) - 1) / (kWarps * (kWarpTiles / ntw));
}
size_t smem_bytes_bf16(int NB, int N, int W, int tile_t) {
    const int NT = (N + 7) / 8, G = n_groups(N, W), KS8 = ceil_to(NB, 8) / 8, RT = ceil_to(tile_t, 16);
    const int hi = (NT + G - 1) / G, lo = NT / G;  // the groups' n-tiles
    const int join = imax(join_words(RT, hi, KS8), join_words(RT, lo, KS8));
    const size_t tiles = (size_t)u_words(NB, hi) + 2 * (size_t)stage_words(NB, W, tile_t) + join;
    // after the tiles K4-vg's k-slices join their dU rows there
    const int MT = (NB + 15) / 16, RS = (MT + du_slices(NB, hi) - 1) / du_slices(NB, hi);
    const size_t du = (size_t)(kWarps / du_warps(RS, hi)) * imin(RS * 16, NB) * W;
    return (tiles > du ? tiles : du) * 4;
}

// Bytes of a span of n elements of `size` bytes at src that one bulk copy
// can take: the 16-byte multiple when src is 16-byte aligned, else none.
__device__ __forceinline__ uint32_t bulk_bytes(const void* src, int n, int size) {
    return (reinterpret_cast<uintptr_t>(src) & 15) ? 0u : (uint32_t)(n * size) & ~15u;
}

// An int, or a compile-time one (std::integral_constant) as its value.
__device__ __forceinline__ int int_of(int v) { return v; }
template <int V>
__device__ __forceinline__ int int_of(std::integral_constant<int, V>) { return V; }

// A bf16 value's bits widened to float32's (exact; also exact as TF32).
__device__ __forceinline__ uint32_t widen(uint16_t h) { return (uint32_t)h << 16; }

// The two TF32 products of one m16n8k8 tile against U's fragment
// {big b0, big b1, small b0, small b1}, into accumulators of their own.
__device__ __forceinline__ void mma_split(float (&c_small)[4], float (&c_big)[4], const uint32_t (&a)[4],
                                          const uint4& b) {
    mma_tf32(c_small, a, b.z, b.w);
    mma_tf32(c_big, a, b.x, b.y);
}

// The grid is (grid_x, grid_y · G): blockIdx.y = group · grid_y + dU slice.
// part row b (blockIdx.x): K4-fwd [ll of each group, pad]; K4-vg [dU (NB·N
// row-major), ll of each group, pad]. bar: 2 words, zeroed before the first
// call.
template <bool kGrad>
__global__ void __launch_bounds__(kThreads, 1)
fused_ll_bf16_tiles(const uint16_t* __restrict__ x_f, const float* __restrict__ u,
                    const float* __restrict__ i_rest, const float* __restrict__ s,
                    float* __restrict__ d_irest, float* __restrict__ part, float* __restrict__ out,
                    unsigned* __restrict__ bar, int T, int NB, int N, int W, int tile_t, float dt,
                    float log_dt) {
    extern __shared__ __align__(16) float smem[];
    __shared__ __align__(8) uint64_t s_bar[3];  // a stage's bulk copies have landed; U's
    const int NT = (N + 7) >> 3, G = n_groups(N, W), YS = gridDim.y / G;
    const int grp = blockIdx.y / YS, ys = blockIdx.y - grp * YS;
    const int nt_lo = grp * NT / G, ntg = (grp + 1) * NT / G - nt_lo;  // this block's n-tiles
    const int c0 = nt_lo * 8, nc = min(c0 + ntg * 8, N) - c0;           // and columns
    const bool whole = G == 1;  // one group: I_rest and S tiles are contiguous
    const int rs = nc;          // a row's words in an I_rest or S span
    const int RT = ceil_to(tile_t, 16);
    const int KS8 = ceil_to(NB, 8) >> 3;  // the forward's k-steps
    const int XW = x_words(NB, tile_t), NS = n_span(W, tile_t), SW = stage_words(NB, W, tile_t);
    uint4* s_uf = reinterpret_cast<uint4*>(smem);
    float* s_stage = smem + u_words(NB, (NT + G - 1) / G);
    float* s_join = s_stage + 2 * (size_t)SW;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int n_tiles = (T + tile_t - 1) / tile_t;
    const bool lead_y = ys == 0;

    if (tid == 0) {
        mbar_init(&s_bar[0]);
        mbar_init(&s_bar[1]);
        mbar_init(&s_bar[2]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // A tile's X_f span (bf16), its I_rest span and its S span: thread 0
    // moves each contiguous span with one TMA bulk copy onto the stage's
    // mbarrier; the threads copy what a bulk copy cannot take (an X_f tail by
    // plain loads, a float32 tail by cp.async), and a column group's I_rest
    // and S rows, N apart, by cp.async a word at a time, a warp a row.
    auto issue = [&](int tile, int st) {
        const int t0 = tile * tile_t, rows = min(tile_t, T - t0);
        float* base = s_stage + (size_t)st * SW;
        uint16_t* xdst = reinterpret_cast<uint16_t*>(base);
        const uint16_t* xsrc = x_f + (size_t)t0 * NB;
        const int nx = rows * NB, nf = whole ? rows * N : 0;
        float* ir_dst = base + XW;
        float* s_dst = ir_dst + NS;
        const float* ir_src = i_rest + (size_t)t0 * N + c0;
        const float* s_src = s + (size_t)t0 * N + c0;
        const uint32_t xbytes = bulk_bytes(xsrc, nx, 2);
        const uint32_t ibytes = bulk_bytes(ir_src, nf, 4), sbytes = bulk_bytes(s_src, nf, 4);
        if (tid == 0) {
            // this stage's earlier reads and writes, in the generic proxy,
            // are ordered before the bulk copies' writes
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_expect_tx(&s_bar[st], xbytes + ibytes + sbytes);
            if (xbytes) bulk_copy(xdst, xsrc, xbytes, &s_bar[st]);
            if (ibytes) bulk_copy(ir_dst, ir_src, ibytes, &s_bar[st]);
            if (sbytes) bulk_copy(s_dst, s_src, sbytes, &s_bar[st]);
        }
        for (int i = (int)(xbytes >> 1) + tid; i < nx; i += kThreads) xdst[i] = xsrc[i];
        // the values after the tile's rows that a live row's last k-step reads
        if (tid < 16) xdst[nx + tid] = 0;
        if (whole) {
            for (int i = (int)(ibytes >> 2) + tid; i < nf; i += kThreads) cp_async4(ir_dst + i, ir_src + i);
            for (int i = (int)(sbytes >> 2) + tid; i < nf; i += kThreads) cp_async4(s_dst + i, s_src + i);
        } else {
            for (int r = warp; r < rows; r += kWarps)
                for (int c = lane; c < nc; c += 32) {
                    cp_async4(ir_dst + r * rs + c, ir_src + (size_t)r * N + c);
                    cp_async4(s_dst + r * rs + c, s_src + (size_t)r * N + c);
                }
        }
    };

    // U, once. With one group, U (NB × N, contiguous) is staged in stage 1,
    // which is free until the second tile is issued: one bulk copy of its
    // 16-byte-aligned middle, queued ahead of the first tile (the threads copy
    // its head and tail); a block of a column group reads its columns from
    // device memory. Either way the block splits each value once into U's
    // fragments, pads included.
    const int UT = NB * N;
    const bool staged = whole && UT + 4 <= SW;
    const int uh = min(UT, (int)(((16 - (reinterpret_cast<uintptr_t>(u) & 15)) & 15) >> 2));
    const int unb = (UT - uh) & ~3;
    float* ustg = s_stage + SW + ((4 - uh) & 3);  // ustg + uh lies on 16 bytes
    if (staged) {
        if (tid == 0) {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_expect_tx(&s_bar[2], (uint32_t)unb * 4);
            if (unb) bulk_copy(ustg + uh, u + uh, (uint32_t)unb * 4, &s_bar[2]);
        }
        for (int i = tid; i < uh; i += kThreads) ustg[i] = u[i];
        for (int i = uh + unb + tid; i < UT; i += kThreads) ustg[i] = u[i];
    }
    issue(blockIdx.x, 0);
    cp_async_commit();
    if (staged) mbar_wait(&s_bar[2], 0);
    __syncthreads();  // U's copy is in place
    {
        // fragment f = (k-step ks, n-tile j, lane l): column 8j + l / 4, rows
        // 8ks + l % 4 and 4 below; a thread reads a batch of its fragments'
        // values before it splits and writes them
        const float* usrc = staged ? ustg : u + c0;
        const int n_frag = KS8 * ntg * 32;
        constexpr int kB = 4;
        for (int f0 = tid; f0 < n_frag; f0 += kThreads * kB) {
            float v[kB][2];
#pragma unroll
            for (int i = 0; i < kB; ++i) {
                const int f = f0 + i * kThreads, l = f & 31, q = f >> 5;
                const int ks = q / ntg, col = (q - ks * ntg) * 8 + (l >> 2), k0 = ks * 8 + (l & 3);
                const bool live = f < n_frag && col < nc;
                v[i][0] = live && k0 < NB ? usrc[(size_t)k0 * N + col] : 0.f;
                v[i][1] = live && k0 + 4 < NB ? usrc[(size_t)(k0 + 4) * N + col] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < kB; ++i) {
                const int f = f0 + i * kThreads;
                if (f < n_frag) {
                    uint4 b;
                    split_tf32(v[i][0], b.x, b.z);
                    split_tf32(v[i][1], b.y, b.w);
                    s_uf[f] = b;
                }
            }
        }
    }
    __syncthreads();  // U is laid out; stage 1 is free

    // the forward's units (32 bins × the n-tiles of one of NGF n-groups) and
    // the warps that split each unit's k-steps
    const int NGF = fwd_groups((RT + 31) >> 5, ntg), units = ((RT + 31) >> 5) * NGF;
    const int KF = fwd_k_split(units, KS8);
    const int JW = KF > 1 ? 8 * ((ntg + NGF - 1) / NGF) : 0;  // a join slot's values a lane

    // K4-vg's dU: its 16 × 8 tiles in m-rows of the group's ntg n-tiles; a
    // grid_y slice's RS rows cut evenly over IW item-warps (du_warps of the
    // widest group), whose 8 / IW k-slices split the tile's k-steps
    const int MT = (NB + 15) >> 4, RS = (MT + YS - 1) / YS;
    const int IW = kGrad ? du_warps(RS, (NT + G - 1) / G) : kWarps, KSL = kWarps / IW;
    const int iw = warp % IW, ksl = warp / IW;
    const int s_lo = ys * RS, s_n = max(0, min(RS, MT - s_lo));
    const int m_lo = s_lo + iw * s_n / IW, m_n = kGrad ? s_lo + (iw + 1) * s_n / IW - m_lo : 0;
    float dacc[kGrad ? kWarpTiles : 1][4];  // item (row r, n-tile j) at r·ntg + j
#pragma unroll
    for (int j = 0; j < (kGrad ? kWarpTiles : 1); ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) dacc[j][c] = 0.f;

    // the value: each unit's terms a thread summed into part_v, the parts
    // added into ll with Kahan's compensation (ll_c)
    float ll = 0.f, ll_c = 0.f;
    int k = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
        const int next = tile + gridDim.x;
        if (next < n_tiles) issue(next, (k + 1) & 1);
        cp_async_commit();
        cp_async_wait_prev();
        mbar_wait(&s_bar[k & 1], (k >> 1) & 1);
        __syncthreads();  // this tile's copies are in place

        const int t0 = tile * tile_t;
        const int rows = min(tile_t, T - t0);
        const uint16_t* sx = reinterpret_cast<const uint16_t*>(s_stage + (size_t)(k & 1) * SW);
        float* sir = s_stage + (size_t)(k & 1) * SW + XW;  // I_rest, then (vg) dI in place
        const float* ssp = sir + NS;

        // The epilogue of a unit at width NW (n-tiles nt0 ..), rows r0 ..:
        // this warp's entries q < 8·NW / parts, q the unit's entry e = q·parts
        // + part_of, am[q] its product; e = (i·NW + j)·4 + c is I's row r0 +
        // 16i + g + 8(c / 2), column 8(nt0 + j) + 2t + c % 2. Every term's
        // loads are issued first (a dead entry reads the tile's first word),
        // then the terms are summed.
        auto epilogue = [&](auto width, int r0, int nt0, auto parts, auto part_of, const auto& am) {
            constexpr int NW = decltype(width)::value, E = 8 * NW;
            const int P = int_of(parts), n_m = E / P;
            auto place = [&](int q) {  // entry q's offset in a span, -1 where it is not live
                const int e = q * P + int_of(part_of), i = e / (4 * NW), j = (e >> 2) % NW, c = e & 3;
                const int r = r0 + 16 * i + g + 8 * (c >> 1), col = (nt0 + j) * 8 + 2 * t + (c & 1);
                return r < rows && col < nc ? r * rs + col : -1;
            };
            float ir_v[E], s_v[E];
#pragma unroll
            for (int q = 0; q < E; ++q) {
                if (q >= n_m) break;
                const int o = max(place(q), 0);
                ir_v[q] = sir[o];
                s_v[q] = ssp[o];
            }
            float part_v = 0.f;
#pragma unroll
            for (int q = 0; q < E; ++q) {
                if (q >= n_m) break;
                const int o = place(q);
                const float i_raw = ir_v[q] + am[q];
                const float I = fminf(fmaxf(i_raw, -EXP_CLIP), EXP_CLIP);
                const float rate_dt = expf(I) * dt;
                const float term = s_v[q] * (I + log_dt) - rate_dt;
                part_v += o >= 0 ? term : 0.f;
                // the clip's gradient is 0 outside the active range
                if (kGrad && o >= 0) sir[o] = fabsf(i_raw) < EXP_CLIP ? s_v[q] - rate_dt : 0.f;
            }
            const float y = part_v - ll_c, sum = ll + y;
            ll_c = (sum - ll) - y;
            ll = sum;
        };
        // The forward of a unit at width NW over its k-steps ks_lo .. ks_hi:
        // f32(X_f)·U as X_f·small + X_f·big, each into accumulators of its
        // own (independent products), two m-tiles sharing each k-step's B
        // fragments, two k-steps an iteration, each loaded a step ahead.
        // Where the tile's RT rows end after the first m-tile the second
        // repeats its products, never read.
        auto forward = [&](auto width, int r0, int nt0, int ks_lo, int ks_hi, auto& acc) {
            constexpr int NW = decltype(width)::value;
            float acc_s[2][NW][4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < NW; ++j)
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[i][j][c] = acc_s[i][j][c] = 0.f;
            const int mstep = r0 + 16 < RT ? 16 * NB : 0;
            const uint16_t* x0 = sx + (size_t)(r0 + g) * NB + t;
            const uint4* ub = s_uf + (size_t)nt0 * 32 + lane;
            auto load = [&](int ks, uint32_t(&a)[2][4], uint4(&b)[NW]) {
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const uint16_t* xi = x0 + i * mstep + ks * 8;
                    a[i][0] = widen(xi[0]), a[i][1] = widen(xi[8 * NB]);
                    a[i][2] = widen(xi[4]), a[i][3] = widen(xi[8 * NB + 4]);
                }
#pragma unroll
                for (int j = 0; j < NW; ++j) b[j] = ub[((size_t)ks * ntg + j) * 32];
            };
            auto step = [&](const uint32_t(&a)[2][4], const uint4(&b)[NW]) {
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int j = 0; j < NW; ++j) mma_split(acc_s[i][j], acc[i][j], a[i], b[j]);
            };
            uint32_t a0[2][4], a1[2][4];
            uint4 b0[NW], b1[NW];
            int ks = ks_lo;
            if (ks < ks_hi) load(ks, a0, b0);
            for (; ks + 1 < ks_hi; ks += 2) {
                load(ks + 1, a1, b1);
                step(a0, b0);
                if (ks + 2 < ks_hi) load(ks + 2, a0, b0);
                step(a1, b1);
            }
            if (ks < ks_hi) step(a0, b0);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < NW; ++j)
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[i][j][c] += acc_s[i][j][c];
        };
        // unit u: row pair u / NGF, n-group u % NGF (n-tiles nt0 .. nt0 + nw - 1)
        auto unit_at = [&](int unit, int& r0, int& nt0) -> int {
            const int rp = unit / NGF, ng = unit - rp * NGF;
            r0 = rp * 32, nt0 = ng * ntg / NGF;
            return (ng + 1) * ntg / NGF - nt0;
        };
        // a unit's width (1 or kUnitTiles n-tiles), a compile-time constant
        auto at_width = [&](int nw, auto&& body) {
            if (nw == 1)
                body(std::integral_constant<int, 1>{});
            else
                body(std::integral_constant<int, kUnitTiles>{});
        };
        const int KSV = KS8;  // the forward's k-steps
        // Each unit on KF warps (KF = 1: a warp a unit, striding over them),
        // each its share of the k-steps; where KF > 1 the unit's warps write
        // their sums to their join slots, meet at a barrier of their own
        // (named barrier 1 + unit), and each takes every KF-th entry of the
        // unit's epilogue (and only those), the slots summed in slice order.
        for (int w = warp; w < units * KF; w += kWarps) {
            const int unit = w / KF, part = w - unit * KF;
            int r0, nt0;
            const int nw = unit_at(unit, r0, nt0);
            at_width(nw, [&](auto width) {
                constexpr int NW = decltype(width)::value;
                float acc[2][NW][4], am[8 * NW];
                forward(width, r0, nt0, part * KSV / KF, (part + 1) * KSV / KF, acc);
                if (KF == 1) {
#pragma unroll
                    for (int e = 0; e < 8 * NW; ++e) am[e] = acc[e / (4 * NW)][(e >> 2) % NW][e & 3];
                } else {
                    // slot (unit, k-slice): entry e of lane l at e·32 + l, so
                    // that a warp's stores and loads meet no bank twice
                    float* slot = s_join + (size_t)unit * KF * JW * 32 + lane;
#pragma unroll
                    for (int e = 0; e < 8 * NW; ++e)
                        slot[((size_t)part * JW + e) * 32] = acc[e / (4 * NW)][(e >> 2) % NW][e & 3];
                    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + unit), "r"(KF * 32) : "memory");
                    // every slot's value loaded before any is added
#pragma unroll
                    for (int q = 0; q < 8 * NW; ++q) {
                        if (q >= 8 * NW / KF) break;
                        const int e = q * KF + part;
                        float pv[kWarps];
#pragma unroll
                        for (int k2 = 0; k2 < kWarps; ++k2) pv[k2] = k2 < KF ? slot[((size_t)k2 * JW + e) * 32] : 0.f;
                        float v = pv[0];
#pragma unroll
                        for (int k2 = 1; k2 < kWarps; ++k2) v += pv[k2];
                        am[q] = v;
                    }
                }
                if (KF == 1)  // the whole unit this warp's: its entries fixed at compile time
                    epilogue(width, r0, nt0, std::integral_constant<int, 1>{}, std::integral_constant<int, 0>{}, am);
                else
                    epilogue(width, r0, nt0, KF, part, am);
            });
        }

        if constexpr (kGrad) {
            __syncthreads();  // the tile's dI is in shared memory
            if (lead_y && whole) copy_out(d_irest + (size_t)t0 * N, sir, rows * N);
            if (lead_y && !whole)
#pragma unroll 4
                for (int r = warp; r < rows; r += kWarps)
                    for (int c = lane; c < nc; c += 32) d_irest[(size_t)(t0 + r) * N + c0 + c] = sir[r * rs + c];
            // dU += X_fᵀ · dI over the tile's bins: this warp's m-rows, its
            // k-slice of the k-steps of 8 bins, into fresh accumulators. Per
            // k-step the group's B fragments (dI, 8 bins × 8 columns, split)
            // first, then per m-row its A fragment (X_fᵀ, 16 rows of NB × 8
            // bins, widened) and the row's products, small parts first.
            // Columns past the group's last read the next row: sums never
            // written. Past the tile's rows (a ragged tile's last k-step) both
            // operands are 0.
            const int kb_end = (rows + 7) >> 3;
            auto du = [&](auto width) {
                    constexpr int NTG = decltype(width)::value, RW = kWarpTiles / NTG;
                    float dtile[RW * NTG][4];
#pragma unroll
                    for (int q = 0; q < RW * NTG; ++q)
#pragma unroll
                        for (int c = 0; c < 4; ++c) dtile[q][c] = 0.f;
                    auto du_step = [&](int kb) {
                        const bool lo = kb * 8 + t < rows, hi = kb * 8 + t + 4 < rows;
                        const float* dk = sir + (kb * 8 + t) * rs + g;
                        const uint16_t* xk = sx + (size_t)(kb * 8 + t) * NB + m_lo * 16 + g;
                        uint32_t bb[NTG][2], bs[NTG][2];
#pragma unroll
                        for (int j = 0; j < NTG; ++j) {
                            split_tf32(lo ? dk[j * 8] : 0.f, bb[j][0], bs[j][0]);
                            split_tf32(hi ? dk[j * 8 + 4 * rs] : 0.f, bb[j][1], bs[j][1]);
                        }
#pragma unroll
                        for (int r = 0; r < RW; ++r) {
                            if (r >= m_n) break;
                            const uint16_t* xm = xk + r * 16;
                            const uint32_t a[4] = {lo ? widen(xm[0]) : 0u, lo ? widen(xm[8]) : 0u,
                                                   hi ? widen(xm[4 * NB]) : 0u, hi ? widen(xm[4 * NB + 8]) : 0u};
#pragma unroll
                            for (int j = 0; j < NTG; ++j) mma_tf32(dtile[r * NTG + j], a, bs[j][0], bs[j][1]);
#pragma unroll
                            for (int j = 0; j < NTG; ++j) mma_tf32(dtile[r * NTG + j], a, bb[j][0], bb[j][1]);
                        }
                    };
                    for (int kb = ksl; kb < kb_end; kb += KSL) du_step(kb);
#pragma unroll
                    for (int q = 0; q < RW * NTG; ++q)
#pragma unroll
                        for (int c = 0; c < 4; ++c) dacc[q][c] += dtile[q][c];
            };
            if (m_n > 0) switch (ntg) {  // the group's n-tiles, a compile-time constant
                    case 1: du(std::integral_constant<int, 1>{}); break;
                    case 2: du(std::integral_constant<int, 2>{}); break;
                    case 3: du(std::integral_constant<int, 3>{}); break;
                    default: du(std::integral_constant<int, kGroupTiles>{});
                }
        }
        __syncthreads();  // readers of this stage are done before it is refilled
    }

    // -- this block's partial row: [dU (NB·N), ll of each group, pad], width
    // ceil4(NB·N + G); K4-fwd: [ll of each group, pad]. K4-vg's k-slices
    // write their sums of its rows (the slice's m-rows × the group's
    // columns) to shared memory, free now, where they are added in k-slice
    // order and copied out row by row.
    const int ll_off = kGrad ? NB * N : 0;
    const int w4 = ceil_to(ll_off + G, 4) >> 2;
    float* row = part + (size_t)blockIdx.x * w4 * 4;
    if constexpr (kGrad) {
        const int r_lo = s_lo * 16, r_n = min(s_n * 16, NB - r_lo);  // this slice's rows of dU
        const int DW = r_n * nc;                                     // a k-slice's words
        if (m_n > 0)
#pragma unroll
            for (int q = 0; q < kWarpTiles; ++q) {
                const int r = q / ntg, j = q - r * ntg;
                if (r >= m_n) break;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int mr = (m_lo + r) * 16 + g + ((c >> 1) << 3), col = j * 8 + 2 * t + (c & 1);
                    if (mr < NB && col < nc) smem[(size_t)ksl * DW + (mr - r_lo) * nc + col] = dacc[q][c];
                }
            }
        __syncthreads();
        for (int r = warp; r < r_n; r += kWarps)
            for (int c = lane; c < nc; c += 32) {
                float v = smem[r * nc + c];
                for (int q = 1; q < KSL; ++q) v += smem[(size_t)q * DW + r * nc + c];
                row[(size_t)(r_lo + r) * N + c0 + c] = v;
            }
    }
    const float v = block_sum(ll);
    if (lead_y && tid == 0) row[ll_off + grp] = v;

    // -- after a grid barrier, every block sums a slice of the columns over
    // the grid_x partial rows, in a fixed order (shared memory is its
    // scratch now); with column groups, after a second barrier one thread
    // adds the groups' values in group order
    grid_barrier(bar);
    sum_part_rows(part, out, w4, gridDim.x, smem);
    if (G > 1) {
        grid_barrier(bar);
        if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) {
            float acc = 0.f;
            for (int q = 0; q < G; ++q) acc += __ldcg(out + ll_off + q);
            out[ll_off] = acc;
        }
    }
}

template <bool kGrad>
cudaError_t launch(const void* x_f, const float* u, const float* i_rest, const float* s,
                   float* d_irest, float* part, float* out, unsigned* bar, int T, int NB, int N,
                   int W, int tile_t, int grid_x, int grid_y, int smem_bytes, int device,
                   float dt, float log_dt, cudaStream_t stream) {
    static int attr_bytes[kMaxDevices];  // the shared-memory attribute set so far, per device
    if (device < 0 || device >= kMaxDevices || tile_t < 8 || tile_t % 8 != 0) return cudaErrorInvalidValue;
    // the columns: all N in one group, or the widest of G even groups of n-tiles
    const int G = n_groups(N, W);
    if (W < 1 || W > N || (W < N && W != 8 * (((N + 7) / 8 + G - 1) / G))) return cudaErrorInvalidValue;
    if ((size_t)smem_bytes != smem_bytes_bf16(NB, N, W, tile_t)) return cudaErrorInvalidValue;
    // a group of at most kGroupTiles n-tiles; K4-vg's dU in du_slices slices
    const int ntw = (W + 7) / 8;
    if (ntw > kGroupTiles || grid_y != (kGrad ? du_slices(NB, ntw) : 1)) return cudaErrorInvalidValue;
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (attr_bytes[device] < smem_bytes) {
        err = cudaFuncSetAttribute(fused_ll_bf16_tiles<kGrad>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes);
        if (err != cudaSuccess) return err;
        attr_bytes[device] = smem_bytes;
    }
    const uint16_t* x = static_cast<const uint16_t*>(x_f);
    // cooperative: the runtime refuses a grid whose blocks cannot all be
    // resident at once, which the grid barrier needs
    void* args[] = {&x, &u, &i_rest, &s, &d_irest, &part, &out, &bar, &T, &NB, &N, &W, &tile_t, &dt, &log_dt};
    return cudaLaunchCooperativeKernel((const void*)fused_ll_bf16_tiles<kGrad>, dim3(grid_x, grid_y * G),
                                       dim3(kThreads), args, (size_t)smem_bytes, stream);
}

}  // namespace

// K4-fwd: the value on a bf16 x_f (T, NB), U float32. out[0] = ll. W: the
// widest column group's columns (N for one group); part: (grid_x, ceil4(G))
// scratch, out: ceil4(G) floats; grid_y = 1; bar: 2 words, zeroed before
// the first call on the stream.
extern "C" int fused_ll_fwd_bf16(const void* x_f, const float* u, const float* i_rest,
                                 const float* s, float* part, float* out, unsigned* bar, int T,
                                 int NB, int N, int W, int tile_t, int grid_x, int grid_y,
                                 int smem_bytes, int device, float dt, float log_dt, void* stream) {
    return (int)launch<false>(x_f, u, i_rest, s, nullptr, part, out, bar, T, NB, N, W, tile_t, grid_x, grid_y,
                              smem_bytes, device, dt, log_dt, (cudaStream_t)stream);
}

// K4-vg: out[0 : NB·N] = dU, out[NB·N] = ll; d_irest (T, N). grid_y: dU
// slices (ops/kernels.py k4_du_slices); part: (grid_x, ceil4(NB·N + G))
// scratch, out: ceil4(NB·N + G) floats.
extern "C" int fused_ll_vg_bf16(const void* x_f, const float* u, const float* i_rest,
                                const float* s, float* d_irest, float* part, float* out,
                                unsigned* bar, int T, int NB, int N, int W, int tile_t, int grid_x,
                                int grid_y, int smem_bytes, int device, float dt, float log_dt,
                                void* stream) {
    return (int)launch<true>(x_f, u, i_rest, s, d_irest, part, out, bar, T, NB, N, W, tile_t, grid_x, grid_y,
                             smem_bytes, device, dt, log_dt, (cudaStream_t)stream);
}

extern "C" const char* fused_ll_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
