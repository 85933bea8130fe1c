// The four chain-batched kernels of the fused Poisson log-likelihood, one
// template (chains_tiles<X, kGrad>) hand-written for Hopper (sm_90a), bound
// to PyTorch through a plain C interface and ctypes
// (theano_pyglm_torch/ops/cuda_loader.py, ops/kernels.py).
//
// Replaces the chain rules that the JAX package's fused op
// (theano_pyglm_tpu/ops/pallas_kernels.py) reaches under a vmap over chains
// (plain XLA there, via the custom_vmap rules _fwd_vmap :242 and _vg_vmap
// :266), in its two dtypes:
//   K3-fwd        _ll_chains_xla (:213), float32 X_f            -> fused_ll_fwd_chains
//   K3-vg         _vg_chains_xla (:164), float32 X_f            -> fused_ll_vg_chains
//   K4-fwd-chains _ll_chains_xla, bfloat16 X_f, U rounded (:216) -> fused_ll_fwd_chains_bf16
//   K4-vg-chains  _vg_chains_xla, bfloat16 X_f, U (:171) and dI (:179)
//                 rounded                                       -> fused_ll_vg_chains_bf16
// The value kernels are the value-only instances (kGrad = false).
// C chains of U (C, NB, N) and I_rest (C, T, N) against one X_f (T, NB) and
// one S (T, N); column c·N + n of the product reads U[c, :, n], I_rest[c, :, n]
// and S[:, n]:
//   I_raw = I_rest + X_f·U                 (K4: X_f·bf16(U))
//   I     = clip(I_raw, ±EXP_CLIP)
//   ll_c  = Σ S·(I + log dt) − e^I·dt       one value per chain
//   dI    = (S − e^I·dt)·1{|I_raw| < EXP_CLIP}                 (C, T, N)
//   dU    = X_fᵀ·dI                        (K4: X_fᵀ·bf16(dI))  (C, NB, N)
// with products accumulated in float32 and bf16(·) rounding to nearest even.
//
// Bounds on an H100 SXM at the flagship's 4 chains (T=60,000, NB=135, N=27):
// K3-vg moves 90.7 MB (27 us at 3.35 TB/s) and does two products of
// 1.75 GFLOP; counted as the card can do them float32-accurate, 3xTF32 on the
// tensor cores (3 × 3.5 GFLOP at 495 TFLOP/s, 21 us), the bytes bound it.
// K4-vg-chains moves 74.5 MB (22 us) and does its bf16 products in 4 us.
// K3-fwd moves 64.8 MB (19.4 us) and does 5.25 GFLOP as 3xTF32 (10.6 us at
// 495 TFLOP/s, 16.7 us at the 315 that mma.sync reaches); K4-fwd-chains
// moves 48.6 MB (14.5 us), its bf16 products under 2 us: the bytes bound
// all four, the value kernels' products close behind.
//
// The frame (K1/K2's, csrc/fused_poisson_ll.cu): one persistent block of
// 256 threads per SM, launched cooperatively; each tile's X_f, I_rest and
// S spans moved by TMA bulk copies onto an mbarrier into the other of two
// stages; dI written in place of the tile's I_rest and copied out
// coalesced; every block's partial row summed after a grid barrier in a
// fixed order: no float atomics, bit for bit; a compensated value per
// chain. What a tile's work is, and why (PERF.md §6 has the probes):
// - Both products on the tensor cores. dU's 16 × 8 tiles (items; m: NB,
//   n: the C·N columns) of a grid_y slice are dealt in m-major runs to IW
//   of the 8 warps (the fewest of 1, 2, 4, 8 whose runs hold at most
//   kWarpTiles items), and the 8 / IW warps that share a run split the
//   tile's k-steps, each into a partial row of its own (so that a few
//   items still give every warp independent products: config 2's 12 items
//   go to all 8 warps, each taking every eighth k-step). A run is taken in
//   groups of 4 items without a branch between them: the group's B fragments first, then for each m-tile
//   the group touches (one, unless it crosses the end of an m-row) one A
//   fragment of X_fᵀ for all of them and the products in passes, so that
//   consecutive products are independent. K3-vg splits both operands into
//   TF32 big and small parts (3xTF32: a_small·b_big + a_big·b_small +
//   a_big·b_big, mma.sync.m16n8k8), reading dI in place (a column's offset
//   in the tile's I_rest spans, fixed per warp, in registers); K4-vg-chains
//   builds X_fᵀ's bf16 pairs and reads the transposed bf16 copy of dI that
//   the epilogue writes, one word a register (m16n8k16). Each tile's
//   products go to fresh accumulators, added into the run's sums once per
//   tile.
// - The forward as wide units: 16 bins × up to kUnitTiles n-tiles, so one A
//   fragment of X_f (split, or paired) feeds up to 8 n-tiles, the unit's
//   width a compile-time constant (no branch between its products), with
//   the next k-step's operands loaded before this step's products. The tile is at most 16·(8 / n-groups) bins, so each warp has
//   one unit a tile where the columns allow (the flagship: 4 × 2 units of
//   16 bins × 7 n-tiles).
// - A cheap epilogue: a column's chain and offsets are computed once per
//   unit (by a float reciprocal of N, exact at these sizes: no integer
//   division), its two rows' terms summed first; only then does the
//   column's sum meet the per-chain selection, 16 times a unit instead of
//   64 (the value instance: over the C chains only, and C Kahan updates).
// - dU's tiles are written to the partial rows from their fragments (an
//   entry per register; a warp's store covers 8 rows × 4 column pairs).
// Past 8·kWarpTiles items, grid_y slices split them, each recomputing the
// tile's currents (only slice 0 writes dI_rest and the values).
//
// The value instance (kGrad = false) differs behind if constexpr: no dU
// product, no dI, no dU rows, one partial row of C values a block. On 8
// warps its products and loads would wait on each other, with no dU work
// to fill the gaps, so a warp's unit spans two m-tiles (32 bins × up to
// kValueTiles n-tiles: the flagship 2 × 4 units), whose products share each
// k-step's B fragments and its splits; the k-loop takes two k-steps an
// iteration on two sets of operand registers, each loaded a step ahead;
// and the epilogue, specialised to the unit's width, issues every term's
// loads before it sums the terms. Its fixed cost is its own: it zeroes no
// shared memory (only U's pads, as it lays U out, and the ≤ 16 values after
// a tile's X_f rows that a live row's last k-step reads, as the tile is
// issued), and it brings U in by TMA bulk copies, queued ahead of the first
// tile, into the stage that the second tile will use, and lays it out from
// there (the gradient instance reads U from device memory a word at a
// time, after zeroing all of shared memory).

#include <cuda_bf16.h>

#include <type_traits>

#include "fused_ll_common.cuh"

#ifndef EXP_CLIP
#error "EXP_CLIP must come from theano_pyglm_torch/ops/clipping.py as -DEXP_CLIP"
#endif

namespace {

constexpr int kMaxChains = 8;   // ops/kernels.py MAX_CHAINS
constexpr int kUnitTiles = 8;   // n-tiles of a forward unit, at most (ops/kernels.py UNIT_TILES)
constexpr int kValueTiles = 4;  // the value instance's: its units span two m-tiles (VALUE_TILES)

// Shared-memory layout, in 32-bit words, mirrored by ops/kernels.py
// _smem_bytes_chains, for C chains of N columns (CN = C·N):
//   U         K3: float32, ceil8(NB) rows of b_stride(CN) words (column
//             c·N + n holds U[c, :, n]); K4: bf16(U) transposed, ceil8(CN)
//             columns of k_stride(ceil16(NB) / 2) words of k-pairs
//   stage 0, 1  X_f (K3: RT × NB floats; K4: x_words of bf16 values, at
//             least 16 values after the RT rows), then the C I_rest spans
//             (NS words each; K3-vg and K4-vg-chains: dI in place), then S
//             (NS); the value instance stages U in stage 1 before its
//             first tile
//   dI bf16   K4-vg-chains only: ceil8(CN) columns of k_stride(RT / 2) words
// RT = ceil16(tile_t), NS = n_span(N, tile_t). After the tiles the whole
// region is scratch for the cross-block sums.
__host__ __device__ constexpr int k_stride(int words) { return words + (12 - words % 8) % 8; }
__host__ __device__ constexpr int x_words(int NB, int tile_t, bool bf16) {
    const int RT = ceil_to(tile_t, 16);
    return bf16 ? ceil_to(RT * NB + 16, 8) / 2 : RT * NB;
}
__host__ __device__ constexpr int u_words(int NB, int CN, bool bf16) {
    return bf16 ? ceil_to(CN, 8) * k_stride(ceil_to(NB, 16) / 2) : ceil_to(NB, 8) * b_stride(CN);
}
__host__ __device__ constexpr int stage_words(int NB, int N, int C, int tile_t, bool bf16) {
    return x_words(NB, tile_t, bf16) + (C + 1) * n_span(N, tile_t);
}
__host__ __device__ constexpr int di_words(int CN, int tile_t, bool bf16, bool grad) {
    return bf16 && grad ? ceil_to(CN, 8) * k_stride(ceil_to(tile_t, 16) / 2) : 0;
}
size_t smem_bytes_chains(int NB, int N, int C, int tile_t, bool bf16, bool grad) {
    const int CN = C * N;
    return ((size_t)u_words(NB, CN, bf16) + 2 * (size_t)stage_words(NB, N, C, tile_t, bf16) +
            (size_t)di_words(CN, tile_t, bf16, grad)) * 4;
}

// Bytes of a span at src that one bulk copy can take: the 16-byte multiple
// when src is 16-byte aligned, else none.
__device__ __forceinline__ uint32_t bulk_bytes(const void* src, int bytes) {
    return (reinterpret_cast<uintptr_t>(src) & 15) ? 0u : (uint32_t)bytes & ~15u;
}

__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) { return (uint32_t)lo | ((uint32_t)hi << 16); }
__device__ __forceinline__ uint16_t bf16_bits(float x) { return __bfloat16_as_ushort(__float2bfloat16_rn(x)); }

// c += a·b for one m16n8k16 bf16 tile, float32 accumulation (pairs of bf16
// a register: a = A[g][2t..2t+1], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..];
// b = B[2t..2t+1][g], B[2t+8..2t+9][g]; c as mma_tf32's).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The chain of column col: floor((col + 0.5) / N) through a float
// reciprocal. The quotient lies at least 0.5 / N from an integer and the
// float error is under (col / N + 1) · 2^-23, so this is exact while
// C·N < 2^16 (the launcher's limit).
__device__ __forceinline__ int chain_of(int col, float inv_n) { return (int)(((float)col + 0.5f) * inv_n); }

// Grid (grid_x, grid_y): blockIdx.y is the dU slice (the value instance:
// grid_y = 1). part rows b·KS + k (KS k-slices per blockIdx.x b): [dU
// (C·NB·N, chain-major), ll of each chain (0 past k-slice 0), pad]; the
// value instance: one row a block, [ll of each chain, pad]. bar: 2 words,
// zeroed before the first call.
template <typename X, bool kGrad>
__global__ void __launch_bounds__(kThreads, 1)
chains_tiles(const X* __restrict__ x_f, const float* __restrict__ u, const float* __restrict__ i_rest,
             const float* __restrict__ s, float* __restrict__ d_irest, float* __restrict__ part,
             float* __restrict__ out, unsigned* __restrict__ bar, int T, int NB, int N, int C, int tile_t, float dt,
             float log_dt) {
    constexpr bool kBf16 = sizeof(X) == 2;
    constexpr int K16 = kBf16 ? 16 : 8;  // the mma's k extent: NB in the forward, bins in dU
    extern __shared__ __align__(16) float smem[];
    // a stage's bulk copies have landed; the value instance's third: a chunk of U
    __shared__ __align__(8) uint64_t s_bar[kGrad ? 2 : 3];
    const int CN = C * N;
    const int RT = ceil_to(tile_t, 16), NS = n_span(N, tile_t);
    const int KP = ceil_to(NB, K16);                      // the forward's k extent
    const int BS = b_stride(CN);                          // K3: U's row stride
    const int KS = k_stride(ceil_to(NB, 16) / 2);         // K4: a bf16(U) column's words
    const int DS = k_stride(RT / 2);                      // K4: a bf16 dI column's words
    const int XW = x_words(NB, tile_t, kBf16), SW = stage_words(NB, N, C, tile_t, kBf16);
    const int UW = u_words(NB, CN, kBf16), DW = di_words(CN, tile_t, kBf16, kGrad);
    const int NT = (CN + 7) >> 3;                             // n-tiles of 8 columns
    // forward n-groups and units of a tile: units of 16 bins × up to
    // kUnitTiles n-tiles; the value instance's 32 bins × up to kValueTiles
    const int NGF = kGrad ? (NT + kUnitTiles - 1) / kUnitTiles : (NT + kValueTiles - 1) / kValueTiles;
    const int units = (kGrad ? RT >> 4 : (RT + 31) >> 5) * NGF;
    const int MT = (NB + 15) >> 4;                            // dU m-tiles
    const int n_items = MT * NT;                              // dU mma tiles
    // a slice's items over IW item-warps (the fewest that hold them in runs
    // of at most kWarpTiles), its k-steps over KS = kWarps / IW k-slices
    const int slice_items = (n_items + gridDim.y - 1) / gridDim.y;
    const int IW = work_warps(slice_items), KSL = kGrad ? kWarps / IW : 1;
    const int per_warp = (slice_items + IW - 1) / IW;
    const float inv_n = 1.f / (float)N;
    float* s_u = smem;
    uint32_t* s_ub = reinterpret_cast<uint32_t*>(smem);
    float* s_stage = smem + UW;
    uint16_t* s_dih = reinterpret_cast<uint16_t*>(s_stage + 2 * (size_t)SW);
    const uint32_t* s_di = reinterpret_cast<const uint32_t*>(s_dih);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int n_tiles = (T + tile_t - 1) / tile_t;
    const int ys = blockIdx.y;
    const bool lead_y = ys == 0;

    // Zero U, both stages and the dI copy (pads stay zero; words never
    // copied stay finite), before any copy lands in them. The value instance
    // zeroes only what its forward reads unwritten: U's pads as U is laid
    // out, the values after a tile's X_f rows as the tile is issued.
    if constexpr (kGrad) {
        float4* z = reinterpret_cast<float4*>(smem);
        const int n4 = (UW + 2 * SW + DW) >> 2;
        for (int i = tid; i < n4; i += kThreads) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (tid == 0) {
        mbar_init(&s_bar[0]);
        mbar_init(&s_bar[1]);
        if constexpr (!kGrad) mbar_init(&s_bar[2]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // A tile's X_f span, its C I_rest spans and its S span: thread 0 moves
    // each with one TMA bulk copy onto the stage's mbarrier; the threads copy
    // what a bulk copy cannot take (a tail under 16 bytes, or a whole span
    // whose source is not 16-byte aligned): float32 words by cp.async, bf16
    // values by plain loads.
    auto issue = [&](int tile, int st) {
        const int t0 = tile * tile_t, rows = min(tile_t, T - t0);
        float* base = s_stage + (size_t)st * SW;
        X* xdst = reinterpret_cast<X*>(base);
        const X* xsrc = x_f + (size_t)t0 * NB;
        const int nx = rows * NB, nf = rows * N;
        const uint32_t xbytes = bulk_bytes(xsrc, nx * (int)sizeof(X));
        // float32 span q: the I_rest of chain q < C, then S
        auto fsrc = [&](int q) { return q < C ? i_rest + ((size_t)q * T + t0) * N : s + (size_t)t0 * N; };
        uint32_t total = xbytes;
        for (int q = 0; q <= C; ++q) total += bulk_bytes(fsrc(q), nf * 4);
        if (tid == 0) {
            // this stage's earlier reads and writes, in the generic proxy,
            // are ordered before the bulk copies' writes
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_expect_tx(&s_bar[st], total);
            if (xbytes) bulk_copy(xdst, xsrc, xbytes, &s_bar[st]);
            for (int q = 0; q <= C; ++q) {
                const uint32_t bytes = bulk_bytes(fsrc(q), nf * 4);
                if (bytes) bulk_copy(base + XW + q * NS, fsrc(q), bytes, &s_bar[st]);
            }
        }
        if constexpr (kBf16) {
            for (int i = (int)(xbytes >> 1) + tid; i < nx; i += kThreads) xdst[i] = xsrc[i];
        } else {
            for (int i = (int)(xbytes >> 2) + tid; i < nx; i += kThreads) cp_async4(xdst + i, xsrc + i);
        }
        for (int q = 0; q <= C; ++q)
            for (int i = (int)(bulk_bytes(fsrc(q), nf * 4) >> 2) + tid; i < nf; i += kThreads)
                cp_async4(base + XW + q * NS + i, fsrc(q) + i);
        if constexpr (!kGrad) {
            // the values after the tile's rows that a live row's k-steps past
            // NB read (against U's zero pad rows): 0, not what the stage held
            // (K3: those inside the X_f region; past it, K3 reads I_rest)
            const int pad = kBf16 ? 16 : KP - NB;
            if (tid < pad && nx + tid < XW * (int)(4 / sizeof(X))) xdst[nx + tid] = X(0);
        }
    };
    // U, once: K3 float32 rows of BS words; K4 bf16(U) rounded once,
    // transposed into k-pairs. The gradient instance reads U from device
    // memory a word at a time (K3-vg by cp.async), after the zeroing.
    if constexpr (kGrad && kBf16) {
        const int KH = ceil_to(NB, 16) / 2;
        for (int col = warp; col < CN; col += kWarps) {
            const int ch = chain_of(col, inv_n);
            const float* uc = u + (size_t)ch * NB * N + (col - ch * N);
            for (int p = lane; p < KH; p += 32) {
                const int m = 2 * p;
                const uint16_t lo = m < NB ? bf16_bits(uc[(size_t)m * N]) : 0;
                const uint16_t hi = m + 1 < NB ? bf16_bits(uc[(size_t)(m + 1) * N]) : 0;
                s_ub[(size_t)col * KS + p] = pack(lo, hi);
            }
        }
    } else if constexpr (kGrad) {
        for (int m = warp; m < NB; m += kWarps)
            for (int col = lane; col < CN; col += 32) {
                const int ch = chain_of(col, inv_n);
                cp_async4(s_u + m * BS + col, u + ((size_t)ch * NB + m) * N + (col - ch * N));
            }
    }
    // The value instance brings U in through stage 1, which is free until
    // the second tile is issued. U (C, NB, N) is one contiguous span; thread
    // 0 moves it in chunks of at most SW - 4 words, each with TMA bulk
    // copies (the chunk's 16-byte-aligned middle; the threads copy its head
    // and tail), the first queued ahead of the first tile; the block lays
    // each chunk out from shared memory, padding included.
    float* stg = s_stage + SW;
    const int UT = C * NB * N, cap = SW - 4;
    // chunk [lo, lo + n) of U: its first h words lead src to a 16-byte
    // boundary, nb words follow in bulk, from dst + h on 16 bytes
    auto u_part = [&](int lo, int& n, int& h, int& nb) -> float* {
        n = min(cap, UT - lo);
        h = min(n, (int)(((16 - (reinterpret_cast<uintptr_t>(u + lo) & 15)) & 15) >> 2));
        nb = (n - h) & ~3;
        return stg + ((4 - h) & 3);
    };
    auto u_chunk = [&](int lo) {
        int n, h, nb;
        float* dst = u_part(lo, n, h, nb);
        const float* src = u + lo;
        if (tid == 0) {
            // the previous chunk's reads, in the generic proxy, are ordered
            // before the bulk copies' writes
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_expect_tx(&s_bar[2], (uint32_t)nb * 4);
            if (nb) bulk_copy(dst + h, src + h, (uint32_t)nb * 4, &s_bar[2]);
        }
        for (int i = tid; i < h; i += kThreads) dst[i] = src[i];
        for (int i = h + nb + tid; i < n; i += kThreads) dst[i] = src[i];
    };
    if constexpr (kGrad) cp_async_commit();
    if constexpr (!kGrad) u_chunk(0);
    issue(blockIdx.x, 0);
    cp_async_commit();
    if constexpr (!kGrad) {
        const int CNP = NT * 8;
        for (int lo = 0, ph = 0; lo < UT; lo += cap, ++ph) {
            int n, h, nb;
            const float* dst = u_part(lo, n, h, nb);
            mbar_wait(&s_bar[2], ph & 1);
            __syncthreads();  // the chunk is in place
            // element (m, col) of U's layout is U[ch, m, n] (col = ch·N + n),
            // word f of the chunk; the pads (m ≥ NB or col ≥ CN) get 0 once.
            // A thread reads a batch of its elements before it writes them,
            // so that the reads' latencies overlap.
            if constexpr (kBf16) {
                uint16_t* ubh = reinterpret_cast<uint16_t*>(s_ub);  // k-pair word p holds m = 2p, 2p + 1
                constexpr int kB = 5;                                // ceil(ceil16(NB) / 32) at NB ≤ 160
                const int KP16 = ceil_to(NB, 16);
                for (int col = warp; col < CNP; col += kWarps) {
                    const int ch = chain_of(col, inv_n), f0 = ch * NB * N + (col - ch * N) - lo;
                    const bool real = col < CN;
                    for (int m0 = lane; m0 < KP16; m0 += 32 * kB) {
                        float v[kB];
#pragma unroll
                        for (int i = 0; i < kB; ++i) {
                            const int m = m0 + 32 * i, f = f0 + m * N;
                            v[i] = real && m < NB && (unsigned)f < (unsigned)n ? dst[f] : 0.f;
                        }
#pragma unroll
                        for (int i = 0; i < kB; ++i) {
                            const int m = m0 + 32 * i, f = f0 + m * N;
                            if (m < KP16 && (ph == 0 || (real && m < NB && (unsigned)f < (unsigned)n)))
                                ubh[(size_t)col * 2 * KS + m] = bf16_bits(v[i]);
                        }
                    }
                }
            } else {
                constexpr int kB = 8;
                for (int col = lane; col < CNP; col += 32) {
                    const int ch = chain_of(col, inv_n), f0 = ch * NB * N + (col - ch * N) - lo;
                    const bool real = col < CN;
                    for (int m0 = warp; m0 < KP; m0 += kWarps * kB) {
                        float v[kB];
#pragma unroll
                        for (int i = 0; i < kB; ++i) {
                            const int m = m0 + kWarps * i, f = f0 + m * N;
                            v[i] = real && m < NB && (unsigned)f < (unsigned)n ? dst[f] : 0.f;
                        }
#pragma unroll
                        for (int i = 0; i < kB; ++i) {
                            const int m = m0 + kWarps * i, f = f0 + m * N;
                            if (m < KP && (ph == 0 || (real && m < NB && (unsigned)f < (unsigned)n)))
                                s_u[m * BS + col] = v[i];
                        }
                    }
                }
            }
            __syncthreads();  // the chunk's readers are done before stage 1 is refilled
            if (lo + cap < UT) u_chunk(lo + cap);
        }
    }

    // this warp's run of dU items (m-major: item q is m-tile q / NT, n-tile
    // q % NT), and where each item's B operand starts: K3-vg the column's
    // place in the tile's I_rest spans (dI in place; a pad column reads
    // chain 0's, into a discarded sum); K4 its bf16 dI column
    const int iw = warp % IW, ksl = kGrad ? warp / IW : 0;
    const int q0 = ys * slice_items + iw * per_warp;
    const int n_mine = max(0, min(per_warp, min((ys + 1) * slice_items, n_items) - q0));
    const int m_first = n_mine > 0 ? q0 / NT : 0, n_first = q0 - m_first * NT;
    int bofs[kWarpTiles];
    {
        int n = n_first;
#pragma unroll
        for (int j = 0; j < kWarpTiles; ++j) {
            const int col = n * 8 + g;
            if constexpr (kBf16) {
                bofs[j] = col * DS + t;
            } else {
                const int ch = chain_of(col, inv_n);
                bofs[j] = col < CN ? ch * NS + (col - ch * N) : 0;
            }
            if (++n == NT) n = 0;
        }
    }
    float dacc[kWarpTiles][4];
#pragma unroll
    for (int j = 0; j < kWarpTiles; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) dacc[j][c] = 0.f;

    // the value of each chain: a unit's terms summed per column, then per
    // chain into part, the parts added into ll with Kahan's compensation
    float ll[kMaxChains], ll_c[kMaxChains];
#pragma unroll
    for (int q = 0; q < kMaxChains; ++q) ll[q] = ll_c[q] = 0.f;
    int k = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
        const int next = tile + gridDim.x;
        if (next < n_tiles) issue(next, (k + 1) & 1);
        cp_async_commit();
        cp_async_wait_prev();
        mbar_wait(&s_bar[k & 1], (k >> 1) & 1);
        __syncthreads();  // this tile's copies (and, the first time, U's) are in place

        const int t0 = tile * tile_t;
        const int rows = min(tile_t, T - t0);
        const X* sx = reinterpret_cast<const X*>(s_stage + (size_t)(k & 1) * SW);
        float* sir = s_stage + (size_t)(k & 1) * SW + XW;  // I_rest, then dI in place
        const float* ssp = sir + C * NS;

        if constexpr (kGrad) {
            // forward: unit = (16 bins, n-tiles nt0 .. nt0 + nw - 1 of one n-group)
            for (int unit = warp; unit < units; unit += kWarps) {
                const int rb = unit / NGF, ng = unit - rb * NGF;
                const int r0 = rb * 16, nt0 = ng * NT / NGF, nw = (ng + 1) * NT / NGF - nt0;
                float acc[kUnitTiles][4];
#pragma unroll
                for (int j = 0; j < kUnitTiles; ++j)
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
                // the k-loop at the unit's width W = nw n-tiles, a compile-time
                // constant: no branch between the n-tiles' products
                auto forward = [&](auto width) {
                    constexpr int W = decltype(width)::value;
                    if constexpr (kBf16) {
                        // X_f · bf16(U): one bf16 m16n8k16 product per k-step and
                        // n-tile; the next step's operands are loaded first
                        const uint16_t* x0 = reinterpret_cast<const uint16_t*>(sx) + (size_t)(r0 + g) * NB + 2 * t;
                        const uint16_t* x8 = x0 + 8 * NB;
                        const uint32_t* ub = s_ub + (size_t)(nt0 * 8 + g) * KS + t;
                        uint32_t a[4] = {pack(x0[0], x0[1]), pack(x8[0], x8[1]), pack(x0[8], x0[9]), pack(x8[8], x8[9])};
                        uint32_t b[W][2];
#pragma unroll
                        for (int j = 0; j < W; ++j)
                            b[j][0] = ub[j * 8 * KS], b[j][1] = ub[j * 8 * KS + 4];
                        for (int kk = 0; kk < KP; kk += 16) {
                            const uint32_t ac[4] = {a[0], a[1], a[2], a[3]};
                            uint32_t bc[W][2];
#pragma unroll
                            for (int j = 0; j < W; ++j) bc[j][0] = b[j][0], bc[j][1] = b[j][1];
                            const int kn = kk + 16;
                            if (kn < KP) {
                                a[0] = pack(x0[kn], x0[kn + 1]), a[1] = pack(x8[kn], x8[kn + 1]);
                                a[2] = pack(x0[kn + 8], x0[kn + 9]), a[3] = pack(x8[kn + 8], x8[kn + 9]);
#pragma unroll
                                for (int j = 0; j < W; ++j)
                                    b[j][0] = ub[j * 8 * KS + (kn >> 1)],
                                    b[j][1] = ub[j * 8 * KS + (kn >> 1) + 4];
                            }
#pragma unroll
                            for (int j = 0; j < W; ++j) mma_bf16(acc[j], ac, bc[j][0], bc[j][1]);
                        }
                    } else {
                        // 3xTF32: X_f and U split into big and small TF32 parts,
                        // a_small·b_big + a_big·b_small + a_big·b_big per k-step
                        // and n-tile, each product step over all n-tiles so that
                        // consecutive products are independent; the next step's
                        // operands are loaded first
                        const float* xa = reinterpret_cast<const float*>(sx) + (size_t)(r0 + g) * NB + t;
                        const float* ub = s_u + t * BS + nt0 * 8 + g;
                        float xr[4] = {xa[0], xa[8 * NB], xa[4], xa[8 * NB + 4]};
                        float ur[W][2];
#pragma unroll
                        for (int j = 0; j < W; ++j)
                            ur[j][0] = ub[8 * j], ur[j][1] = ub[4 * BS + 8 * j];
                        for (int kk = 0; kk < KP; kk += 8) {
                            uint32_t ab[4], as[4], bb[W][2], bs[W][2];
#pragma unroll
                            for (int i = 0; i < 4; ++i) split_tf32(xr[i], ab[i], as[i]);
#pragma unroll
                            for (int j = 0; j < W; ++j)
                                split_tf32(ur[j][0], bb[j][0], bs[j][0]), split_tf32(ur[j][1], bb[j][1], bs[j][1]);
                            const int kn = kk + 8;
                            if (kn < KP) {
                                xr[0] = xa[kn], xr[1] = xa[8 * NB + kn], xr[2] = xa[kn + 4], xr[3] = xa[8 * NB + kn + 4];
#pragma unroll
                                for (int j = 0; j < W; ++j)
                                    ur[j][0] = ub[kn * BS + 8 * j], ur[j][1] = ub[(kn + 4) * BS + 8 * j];
                            }
#pragma unroll
                            for (int j = 0; j < W; ++j) mma_tf32(acc[j], as, bb[j][0], bb[j][1]);
#pragma unroll
                            for (int j = 0; j < W; ++j) mma_tf32(acc[j], ab, bs[j][0], bs[j][1]);
#pragma unroll
                            for (int j = 0; j < W; ++j) mma_tf32(acc[j], ab, bb[j][0], bb[j][1]);
                        }
                    }
                };
                switch (nw) {
                    case 1: forward(std::integral_constant<int, 1>{}); break;
                    case 2: forward(std::integral_constant<int, 2>{}); break;
                    case 3: forward(std::integral_constant<int, 3>{}); break;
                    case 4: forward(std::integral_constant<int, 4>{}); break;
                    case 5: forward(std::integral_constant<int, 5>{}); break;
                    case 6: forward(std::integral_constant<int, 6>{}); break;
                    case 7: forward(std::integral_constant<int, 7>{}); break;
                    default: forward(std::integral_constant<int, kUnitTiles>{});
                }
                // a column's chain and offsets once, its two rows' terms
                // summed, then the column's sum into its chain's part
                float part_v[kMaxChains];
#pragma unroll
                for (int q = 0; q < kMaxChains; ++q) part_v[q] = 0.f;
#pragma unroll
                for (int j = 0; j < kUnitTiles; ++j) {
                    if (j >= nw) break;
#pragma unroll
                    for (int p = 0; p < 2; ++p) {
                        const int col = (nt0 + j) * 8 + 2 * t + p;
                        const bool live = col < CN;
                        const int ch = chain_of(col, inv_n), n = col - ch * N;
                        float* irc = sir + ch * NS + n;
                        const float* sc = ssp + n;
                        float col_sum = 0.f;
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const int r = r0 + g + 8 * h;
                            float d_i = 0.f;
                            if (live && r < rows) {
                                const float i_raw = irc[r * N] + acc[j][2 * h + p];
                                const float I = fminf(fmaxf(i_raw, -EXP_CLIP), EXP_CLIP);
                                const float rate_dt = expf(I) * dt;
                                const float spikes = sc[r * N];
                                col_sum += spikes * (I + log_dt) - rate_dt;
                                // the clip's gradient is 0 outside the active range
                                d_i = fabsf(i_raw) < EXP_CLIP ? spikes - rate_dt : 0.f;
                                irc[r * N] = d_i;
                            }
                            // K4: dI's bf16 copy, every bin below RT of the columns below
                            // ceil8(CN), 0 outside the tile's rows and the columns
                            if constexpr (kBf16) s_dih[(size_t)col * 2 * DS + r] = bf16_bits(d_i);
                        }
#pragma unroll
                        for (int q = 0; q < kMaxChains; ++q)
                            if (q == ch) part_v[q] += col_sum;
                    }
                }
#pragma unroll
                for (int q = 0; q < kMaxChains; ++q) {
                    const float y = part_v[q] - ll_c[q], sum = ll[q] + y;
                    ll_c[q] = (sum - ll[q]) - y;
                    ll[q] = sum;
                }
            }

        } else {
            // the value instance: unit = (32 bins: two m-tiles, which share
            // each k-step's B fragments, × n-tiles nt0 .. nt0 + nw - 1 of one
            // n-group), its forward two k-steps an iteration (two sets of
            // operand registers in turn, each loaded a step ahead) and its
            // epilogue at the unit's width W
            for (int unit = warp; unit < units; unit += kWarps) {
                const int rb = unit / NGF, ng = unit - rb * NGF;
                const int r0 = rb * 32, nt0 = ng * NT / NGF, nw = (ng + 1) * NT / NGF - nt0;
                // X_f elements from the first m-tile's rows to the second's
                // (where the tile's RT rows end after the first, the second
                // repeats its products, never read)
                const int mstep = r0 + 16 < RT ? 16 * NB : 0;
                const int KPV = KP;  // the forward's k extent
                float part_v[kMaxChains];
#pragma unroll
                for (int q = 0; q < kMaxChains; ++q) part_v[q] = 0.f;
                auto value_unit = [&](auto width) {
                    constexpr int W = decltype(width)::value;
                    float acc[2][W][4];
#pragma unroll
                    for (int i = 0; i < 2; ++i)
#pragma unroll
                        for (int j = 0; j < W; ++j)
#pragma unroll
                            for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
                    if constexpr (kBf16) {
                        // X_f · bf16(U): one bf16 m16n8k16 product per k-step,
                        // m-tile and n-tile
                        const uint16_t* x0 = reinterpret_cast<const uint16_t*>(sx) + (size_t)(r0 + g) * NB + 2 * t;
                        const uint32_t* ub = s_ub + (size_t)(nt0 * 8 + g) * KS + t;
                        auto load = [&](int kk, uint32_t(&a)[2][4], uint32_t(&b)[W][2]) {
#pragma unroll
                            for (int i = 0; i < 2; ++i) {
                                const uint16_t* xi = x0 + i * mstep + kk;
                                const uint16_t* x8 = xi + 8 * NB;
                                a[i][0] = pack(xi[0], xi[1]), a[i][1] = pack(x8[0], x8[1]);
                                a[i][2] = pack(xi[8], xi[9]), a[i][3] = pack(x8[8], x8[9]);
                            }
#pragma unroll
                            for (int j = 0; j < W; ++j)
                                b[j][0] = ub[j * 8 * KS + (kk >> 1)], b[j][1] = ub[j * 8 * KS + (kk >> 1) + 4];
                        };
                        auto step = [&](const uint32_t(&a)[2][4], const uint32_t(&b)[W][2]) {
#pragma unroll
                            for (int i = 0; i < 2; ++i)
#pragma unroll
                                for (int j = 0; j < W; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
                        };
                        uint32_t a0[2][4], b0[W][2], a1[2][4], b1[W][2];
                        load(0, a0, b0);
                        int kk = 0;
                        for (; kk + 16 < KPV; kk += 32) {
                            load(kk + 16, a1, b1);
                            step(a0, b0);
                            if (kk + 32 < KPV) load(kk + 32, a0, b0);
                            step(a1, b1);
                        }
                        if (kk < KPV) step(a0, b0);
                    } else {
                        // 3xTF32: X_f and U split into big and small TF32
                        // parts, a_small·b_big + a_big·b_small + a_big·b_big per
                        // k-step, m-tile and n-tile, each product step over all
                        // tiles so that consecutive products are independent
                        const float* xa = reinterpret_cast<const float*>(sx) + (size_t)(r0 + g) * NB + t;
                        const float* ub = s_u + t * BS + nt0 * 8 + g;
                        auto load = [&](int kk, float(&x)[2][4], float(&u8)[W][2]) {
#pragma unroll
                            for (int i = 0; i < 2; ++i) {
                                const float* xi = xa + i * mstep + kk;
                                x[i][0] = xi[0], x[i][1] = xi[8 * NB], x[i][2] = xi[4], x[i][3] = xi[8 * NB + 4];
                            }
#pragma unroll
                            for (int j = 0; j < W; ++j) u8[j][0] = ub[kk * BS + 8 * j], u8[j][1] = ub[(kk + 4) * BS + 8 * j];
                        };
                        auto step = [&](const float(&x)[2][4], const float(&u8)[W][2]) {
                            uint32_t ab[2][4], as[2][4], bb[W][2], bs[W][2];
#pragma unroll
                            for (int i = 0; i < 2; ++i)
#pragma unroll
                                for (int q = 0; q < 4; ++q) split_tf32(x[i][q], ab[i][q], as[i][q]);
#pragma unroll
                            for (int j = 0; j < W; ++j)
                                split_tf32(u8[j][0], bb[j][0], bs[j][0]), split_tf32(u8[j][1], bb[j][1], bs[j][1]);
#pragma unroll
                            for (int i = 0; i < 2; ++i)
#pragma unroll
                                for (int j = 0; j < W; ++j) mma_tf32(acc[i][j], as[i], bb[j][0], bb[j][1]);
#pragma unroll
                            for (int i = 0; i < 2; ++i)
#pragma unroll
                                for (int j = 0; j < W; ++j) mma_tf32(acc[i][j], ab[i], bs[j][0], bs[j][1]);
#pragma unroll
                            for (int i = 0; i < 2; ++i)
#pragma unroll
                                for (int j = 0; j < W; ++j) mma_tf32(acc[i][j], ab[i], bb[j][0], bb[j][1]);
                        };
                        float x0[2][4], u0[W][2], x1[2][4], u1[W][2];
                        load(0, x0, u0);
                        int kk = 0;
                        for (; kk + 8 < KPV; kk += 16) {
                            load(kk + 8, x1, u1);
                            step(x0, u0);
                            if (kk + 16 < KPV) load(kk + 16, x0, u0);
                            step(x1, u1);
                        }
                        if (kk < KPV) step(x0, u0);
                    }
                    // the epilogue: every term's loads are issued
                    // unconditionally (a dead column reads chain 0's column 0,
                    // a dead row the tile's row 0) and its term selected away,
                    // so that the terms' latencies overlap
#pragma unroll
                    for (int j = 0; j < W; ++j)
#pragma unroll
                        for (int p = 0; p < 2; ++p) {
                            const int col = (nt0 + j) * 8 + 2 * t + p;
                            const bool live = col < CN;
                            const int ch = chain_of(col, inv_n), n = live ? col - ch * N : 0;
                            const float* irc = sir + (live ? ch * NS : 0) + n;
                            const float* sc = ssp + n;
                            float col_sum = 0.f;
#pragma unroll
                            for (int i = 0; i < 2; ++i)
#pragma unroll
                                for (int h = 0; h < 2; ++h) {
                                    const int r = r0 + 16 * i + g + 8 * h, rr = r < rows ? r : 0;
                                    const float i_raw = irc[rr * N] + acc[i][j][2 * h + p];
                                    const float I = fminf(fmaxf(i_raw, -EXP_CLIP), EXP_CLIP);
                                    const float term = sc[rr * N] * (I + log_dt) - expf(I) * dt;
                                    col_sum += live && r < rows ? term : 0.f;
                                }
#pragma unroll
                            for (int q = 0; q < kMaxChains; ++q) {
                                if (q >= C) break;
                                if (q == ch) part_v[q] += col_sum;
                            }
                        }
                };
                switch (nw) {
                    case 1: value_unit(std::integral_constant<int, 1>{}); break;
                    case 2: value_unit(std::integral_constant<int, 2>{}); break;
                    case 3: value_unit(std::integral_constant<int, 3>{}); break;
                    default: value_unit(std::integral_constant<int, kValueTiles>{});
                }
#pragma unroll
                for (int q = 0; q < kMaxChains; ++q) {
                    if (q >= C) break;
                    const float y = part_v[q] - ll_c[q], sum = ll[q] + y;
                    ll_c[q] = (sum - ll[q]) - y;
                    ll[q] = sum;
                }
            }
        }

        if constexpr (kGrad) {
            __syncthreads();  // the tile's dI is in shared memory
            if (lead_y)
                for (int ch = 0; ch < C; ++ch) copy_out(d_irest + ((size_t)ch * T + t0) * N, sir + ch * NS, rows * N);
            // dU += X_fᵀ · dI over the tile's bins, this warp's k-slice of the
            // k-steps. K4: bins past the tile's rows meet zeros of dI's bf16
            // copy. K3-vg: dI in place holds the tile's rows only, so a last
            // k-step past them (a tile of 4s, the ragged tile) reads 0 for them.
            const int kb_end = ceil_to(rows, K16) / K16;
            // K3-vg: the tile's products go to fresh accumulators, added into
            // dacc once per tile in float32: the tensor cores' float32
            // accumulation loses more than an IEEE sum, and over a block's
            // ~1,800 bins of three products a k-step in one accumulator dU was
            // 1.1e-5 off the plain version (rel-L2, T = 240,000 on 2 chains).
            // K4-vg-chains' one bf16 product a k-step accumulates into dacc (as
            // the first K4-vg-chains did, within 4.4e-6), sparing the registers.
            constexpr int DT = kBf16 ? 1 : kWarpTiles;
            float dtile[DT][4];
#pragma unroll
            for (int j = 0; j < DT; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) dtile[j][c] = 0.f;
            auto du_step = [&](int kb, auto tail) {
                // the run in groups of 4 items, no branch between a group's
                // items: their B fragments loaded first, then for each m-tile
                // the group touches (one, unless the group crosses the end of
                // an m-row) its A fragment once and the group's products in
                // passes, so that consecutive products are independent; an
                // item of another m-tile meets B = 0 there. A group's items
                // past the run compute into sums never written (their m-tile
                // clamped, their column wrapped: every read stays in the stage).
                int m = m_first, n = n_first;
                auto group = [&](auto first, auto size) {
                    constexpr int j0 = decltype(first)::value, GS = decltype(size)::value;
                    int mj[GS];
#pragma unroll
                    for (int jj = 0; jj < GS; ++jj) {
                        mj[jj] = min(m, MT - 1);
                        const bool wrap = ++n == NT;
                        n = wrap ? 0 : n, m += wrap;
                    }
                    if constexpr (kBf16) {
                        // A = X_fᵀ (16 rows of NB × 16 bins) in bf16 pairs along
                        // bins, B = dI's bf16 copy (16 bins × 8 columns)
                        const uint16_t* xk = reinterpret_cast<const uint16_t*>(sx) + (size_t)(kb * 16 + 2 * t) * NB + g;
                        uint32_t b[GS][2];
#pragma unroll
                        for (int jj = 0; jj < GS; ++jj)
                            b[jj][0] = s_di[bofs[j0 + jj] + kb * 8], b[jj][1] = s_di[bofs[j0 + jj] + kb * 8 + 4];
                        auto products = [&](int mm, bool masked) {
                            const uint16_t* xm = xk + mm * 16;
                            const uint32_t a[4] = {pack(xm[0], xm[NB]), pack(xm[8], xm[NB + 8]),
                                                   pack(xm[8 * NB], xm[9 * NB]), pack(xm[8 * NB + 8], xm[9 * NB + 8])};
#pragma unroll
                            for (int jj = 0; jj < GS; ++jj) {
                                const bool mine = !masked || mj[jj] == mm;
                                mma_bf16(dacc[j0 + jj], a, mine ? b[jj][0] : 0u, mine ? b[jj][1] : 0u);
                            }
                        };
                        if (mj[0] == mj[GS - 1])
                            products(mj[0], false);
                        else
                            for (int mm = mj[0]; mm <= mj[GS - 1]; ++mm) products(mm, true);
                    } else {
                        // A = X_fᵀ (16 rows of NB × 8 bins), B = dI (8 bins × 8
                        // columns), both split into TF32 big and small parts
                        const float* xk = reinterpret_cast<const float*>(sx) + (size_t)(kb * 8 + t) * NB + g;
                        const float* dk = sir + (kb * 8 + t) * N;
                        const bool lo = !decltype(tail)::value || kb * 8 + t < rows;
                        const bool hi = !decltype(tail)::value || kb * 8 + t + 4 < rows;
                        uint32_t bb[GS][2], bs[GS][2];
#pragma unroll
                        for (int jj = 0; jj < GS; ++jj) {
                            split_tf32(lo ? dk[bofs[j0 + jj]] : 0.f, bb[jj][0], bs[jj][0]);
                            split_tf32(hi ? dk[bofs[j0 + jj] + 4 * N] : 0.f, bb[jj][1], bs[jj][1]);
                        }
                        auto products = [&](int mm, bool masked) {
                            const float* xm = xk + mm * 16;
                            uint32_t ab[4], as[4];
                            split_tf32(xm[0], ab[0], as[0]);
                            split_tf32(xm[8], ab[1], as[1]);
                            split_tf32(xm[4 * NB], ab[2], as[2]);
                            split_tf32(xm[4 * NB + 8], ab[3], as[3]);
#pragma unroll
                            for (int jj = 0; jj < GS; ++jj) {
                                const bool mine = !masked || mj[jj] == mm;
                                mma_tf32(dtile[j0 + jj], as, mine ? bb[jj][0] : 0u, mine ? bb[jj][1] : 0u);
                            }
#pragma unroll
                            for (int jj = 0; jj < GS; ++jj) {
                                const bool mine = !masked || mj[jj] == mm;
                                mma_tf32(dtile[j0 + jj], ab, mine ? bs[jj][0] : 0u, mine ? bs[jj][1] : 0u);
                            }
#pragma unroll
                            for (int jj = 0; jj < GS; ++jj) {
                                const bool mine = !masked || mj[jj] == mm;
                                mma_tf32(dtile[j0 + jj], ab, mine ? bb[jj][0] : 0u, mine ? bb[jj][1] : 0u);
                            }
                        };
                        if (mj[0] == mj[GS - 1])
                            products(mj[0], false);
                        else
                            for (int mm = mj[0]; mm <= mj[GS - 1]; ++mm) products(mm, true);
                    }
                };
#pragma unroll
                for (int j0 = 0; j0 < kWarpTiles; j0 += 4) {
                    if (n_mine <= j0) break;
                    switch (j0) {  // a compile-time first item for the group's sums
                        case 0: group(std::integral_constant<int, 0>{}, std::integral_constant<int, 4>{}); break;
                        case 4: group(std::integral_constant<int, 4>{}, std::integral_constant<int, 4>{}); break;
                        case 8: group(std::integral_constant<int, 8>{}, std::integral_constant<int, 4>{}); break;
                        default: group(std::integral_constant<int, 12>{}, std::integral_constant<int, 4>{});
                    }
                }
            };
            if (n_mine > 0) {
                const int kb_full = min(kb_end, rows / K16);
                for (int kb = ksl; kb < kb_full; kb += KSL) du_step(kb, std::false_type{});
                if (kb_full < kb_end && kb_full % KSL == ksl) du_step(kb_full, std::true_type{});
                if constexpr (!kBf16) {
#pragma unroll
                    for (int j = 0; j < kWarpTiles; ++j)
#pragma unroll
                        for (int c = 0; c < 4; ++c) dacc[j][c] += dtile[j][c];
                }
            }
        }
        __syncthreads();  // readers of this stage (and of dI's copy) are done before it is refilled
    }

    // -- this block's part of its partial rows, one per k-slice: [dU
    // (C·NB·N), ll of each chain (k-slice 0; 0 in the others), pad], width
    // ceil4(C·NB·N + C)
    const int ll_off = kGrad ? NB * CN : 0;
    const int w4 = ceil_to(ll_off + C, 4) >> 2;
    float* row = part + ((size_t)blockIdx.x * KSL + ksl) * w4 * 4;
    if (lead_y && ksl > 0 && iw == 0 && lane < C) row[ll_off + lane] = 0.f;
    if constexpr (kGrad) {
        int m = m_first, n = n_first;
#pragma unroll
        for (int j = 0; j < kWarpTiles; ++j) {
            if (j >= n_mine) break;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int mr = m * 16 + g + ((c >> 1) << 3), col = n * 8 + 2 * t + (c & 1);
                if (mr < NB && col < CN) {
                    const int ch = chain_of(col, inv_n);
                    row[((size_t)ch * NB + mr) * N + (col - ch * N)] = dacc[j][c];
                }
            }
            if (++n == NT) n = 0, ++m;
        }
    }
#pragma unroll
    for (int q = 0; q < kMaxChains; ++q) {
        if (q >= C) break;
        const float v = block_sum(ll[q]);
        if (lead_y && tid == 0) row[ll_off + q] = v;
    }

    // -- after a grid barrier, every block sums a slice of the columns over
    // the grid_x · KS partial rows, in a fixed order (shared memory is its
    // scratch now)
    grid_barrier(bar);
    sum_part_rows(part, out, w4, gridDim.x * KSL, smem);
}

template <typename X, bool kGrad>
cudaError_t launch(const void* x_f, const float* u, const float* i_rest, const float* s, float* d_irest,
                   float* part, float* out, unsigned* bar, int T, int NB, int N, int C, int tile_t, int grid_x,
                   int grid_y, int smem_bytes, int device, float dt, float log_dt, cudaStream_t stream) {
    constexpr bool kBf16 = sizeof(X) == 2;
    static int attr_bytes[kMaxDevices];  // the shared-memory attribute set so far, per device
    if (device < 0 || device >= kMaxDevices || tile_t % (kBf16 ? 8 : 4) != 0) return cudaErrorInvalidValue;
    // one group of chains: K3 2 ≤ C ≤ kMaxChains, K4 1 ≤ C ≤ kMaxChains;
    // chain_of is exact below 2^16 columns
    if (C < (kBf16 ? 1 : 2) || C > kMaxChains || C * N >= (1 << 16)) return cudaErrorInvalidValue;
    if ((size_t)smem_bytes != smem_bytes_chains(NB, N, C, tile_t, kBf16, kGrad)) return cudaErrorInvalidValue;
    // every dU item in a warp's run of at most kWarpTiles; at most 8 forward
    // units... of any number: the units loop strides by the warps. The value
    // instance: one slice.
    const int items = ((NB + 15) / 16) * ((C * N + 7) / 8);
    if (kGrad ? grid_y < 1 || grid_y * kWarps * kWarpTiles < items : grid_y != 1) return cudaErrorInvalidValue;
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (attr_bytes[device] < smem_bytes) {
        err = cudaFuncSetAttribute(chains_tiles<X, kGrad>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
        if (err != cudaSuccess) return err;
        attr_bytes[device] = smem_bytes;
    }
    const X* x = static_cast<const X*>(x_f);
    // cooperative: the runtime refuses a grid whose blocks cannot all be
    // resident at once, which the grid barrier needs
    void* args[] = {&x, &u, &i_rest, &s, &d_irest, &part, &out, &bar, &T, &NB, &N, &C, &tile_t, &dt, &log_dt};
    return cudaLaunchCooperativeKernel((const void*)chains_tiles<X, kGrad>, dim3(grid_x, grid_y), dim3(kThreads),
                                       args, (size_t)smem_bytes, stream);
}

}  // namespace

// K3-fwd. u (C, NB, N), i_rest (C, T, N), x_f (T, NB) and s (T, N) shared,
// 2 ≤ C ≤ 8; out[0 : C] = the chains' ll. part: (grid_x, ceil4(C)) scratch,
// out: ceil4(C) floats; grid_y = 1; bar: 2 words, zeroed before the first
// call on the stream.
extern "C" int fused_ll_fwd_chains(const float* x_f, const float* u, const float* i_rest, const float* s,
                                   float* part, float* out, unsigned* bar, int T, int NB, int N, int C, int tile_t,
                                   int grid_x, int grid_y, int smem_bytes, int device, float dt, float log_dt,
                                   void* stream) {
    return (int)launch<float, false>(x_f, u, i_rest, s, nullptr, part, out, bar, T, NB, N, C, tile_t, grid_x,
                                     grid_y, smem_bytes, device, dt, log_dt, (cudaStream_t)stream);
}

// K3-vg. u, i_rest, x_f and s as K3-fwd's; out[0 : C·NB·N] = dU ((C, NB, N)
// row-major), out[C·NB·N + c] = chain c's ll; d_irest (C, T, N). grid_y: dU
// slices. part: (grid_x · k-slices, ceil4(C·NB·N + C)) scratch, out:
// ceil4(C·NB·N + C) floats; bar as K3-fwd's.
extern "C" int fused_ll_vg_chains(const void* x_f, const float* u, const float* i_rest, const float* s,
                                  float* d_irest, float* part, float* out, unsigned* bar, int T, int NB, int N,
                                  int C, int tile_t, int grid_x, int grid_y, int smem_bytes, int device, float dt,
                                  float log_dt, void* stream) {
    return (int)launch<float, true>(x_f, u, i_rest, s, d_irest, part, out, bar, T, NB, N, C, tile_t, grid_x,
                                    grid_y, smem_bytes, device, dt, log_dt, (cudaStream_t)stream);
}

// K4-fwd-chains: K3-fwd on a bf16 x_f (T, NB), 1 ≤ C ≤ 8, U rounded to bf16
// for the product.
extern "C" int fused_ll_fwd_chains_bf16(const void* x_f, const float* u, const float* i_rest, const float* s,
                                        float* part, float* out, unsigned* bar, int T, int NB, int N, int C,
                                        int tile_t, int grid_x, int grid_y, int smem_bytes, int device, float dt,
                                        float log_dt, void* stream) {
    return (int)launch<uint16_t, false>(x_f, u, i_rest, s, nullptr, part, out, bar, T, NB, N, C, tile_t, grid_x,
                                        grid_y, smem_bytes, device, dt, log_dt, (cudaStream_t)stream);
}

// K4-vg-chains: K3-vg on a bf16 x_f (T, NB), 1 ≤ C ≤ 8, U and dI rounded to
// bf16 for the products.
extern "C" int fused_ll_vg_chains_bf16(const void* x_f, const float* u, const float* i_rest, const float* s,
                                       float* d_irest, float* part, float* out, unsigned* bar, int T, int NB,
                                       int N, int C, int tile_t, int grid_x, int grid_y, int smem_bytes,
                                       int device, float dt, float log_dt, void* stream) {
    return (int)launch<uint16_t, true>(x_f, u, i_rest, s, d_irest, part, out, bar, T, NB, N, C, tile_t, grid_x,
                                       grid_y, smem_bytes, device, dt, log_dt, (cudaStream_t)stream);
}

extern "C" const char* fused_ll_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
