// Fused coupling matmul + Poisson log-likelihood on a bfloat16 spike design,
// hand-written for Hopper (sm_90a), bound to PyTorch through a plain C
// interface and ctypes (theano_pyglm_torch/ops/cuda_loader.py, ops/kernels.py).
//
// Replaces the bfloat16 instances of the JAX package's fused op
// (theano_pyglm_tpu/ops/pallas_kernels.py), which Population(design_dtype=
// jnp.bfloat16, use_pallas=True) reaches with X_f in bfloat16 and U, I_rest
// and S in float32:
//   K4-fwd        _fwd_kernel (:73) / _fwd_call's pallas_call (:195)      -> fused_ll_fwd_bf16
//   K4-vg         _vg_kernel (:100) / _vg_call's pallas_call (:138)       -> fused_ll_vg_bf16
// and the chain rules of its custom_vmap (plain XLA there):
//   K4-fwd-chains _ll_chains_xla (:213), U rounded to bf16 (:216)         -> fused_ll_fwd_chains_bf16
//   K4-vg-chains  _vg_chains_xla (:164), U (:171) and dI (:179) rounded    -> fused_ll_vg_chains_bf16
//
// The two semantics of the JAX op on a bf16 design:
//   one chain:  I = I_rest + f32(X_f)·U,        dU = f32(X_f)ᵀ·dI
//   chains:     I = I_rest + X_f·bf16(U),       dU = X_fᵀ·bf16(dI)
// with I clipped to ±EXP_CLIP, ll = Σ S·(I + log dt) − e^I·dt, dI_rest =
// (S − e^I·dt)·1{|I_raw| < EXP_CLIP} in float32, products accumulated in
// float32, bf16(·) rounding to nearest even as JAX's astype does.
//
// Bounds on an H100 SXM (3.35 TB/s HBM; 67 TFLOP/s for products with a
// float32 operand, 989 TFLOP/s for bf16 × bf16) at the flagship shape
// T=60,000, NB=135, N=27, each byte read or written once: K4-fwd moves
// 29.2 MB (X_f 16.2, I_rest and S 6.5 each) in 8.7 us against 0.44 GFLOP in
// 6.5 us: bytes. K4-vg adds dI_rest: 35.6 MB in 10.6 us against 0.87 GFLOP
// in 13.1 us: the float32 operations. On 4 chains K4-fwd-chains moves
// 48.6 MB in 14.5 us and K4-vg-chains 74.5 MB in 22.2 us; their 1.75 and
// 3.5 GFLOP of bf16 products take under 4 us on the tensor cores: bytes.
//
// The design is K1/K2/K3's (csrc/fused_poisson_ll.cu, whose template this
// file leaves as it is; the helpers both use are in fused_ll_common.cuh):
// one persistent block of 256 threads per SM, launched cooperatively; each
// tile's X_f, I_rest and S spans moved by TMA bulk copies onto an mbarrier
// into the other of two stages while the current tile computes; every
// block's partial row summed after a grid barrier in a fixed order (no
// float atomics, bit-for-bit repeatable); a compensated value per chain.
// What the bf16 design changes:
// - X_f tiles arrive as bf16: half the bytes of the largest stream. A
//   tile's span starts on 16 bytes when tile_t is a multiple of 8 (a row of
//   NB = 135 values is 270 bytes), so the wrapper plans tiles of 8s. A
//   stage's X_f region holds the tile's RT = ceil16(tile_t) rows and at
//   least 16 zero values after them: the forward k-steps past the last
//   row's NB columns read there, and the float32 I_rest span that follows
//   would read back as bf16 values that may be Inf or NaN (NaN·0 is NaN).
//   The tail of a span under 16 bytes (or a whole span whose source is not
//   16-byte aligned) is copied by plain loads.
// - One chain: a widened bf16 value is exactly a TF32 value, so
//   f32(X)·U = X·tf32(U) + X·tf32(U − tf32(U)): 2 mma.sync.m16n8k8 per
//   k-step and n-tile instead of 3xTF32's 3, with U kept in float32 in
//   shared memory as K2 keeps it and split on the fly. (bf16 m16n8k16 with U
//   cut into three bf16 pieces would take 3 products of k16, the same
//   tensor-core work for more splitting.) dU = f32(X)ᵀ·dI stays K2's
//   float32 FMA product in register micro-tiles, X widened on load. Column
//   groups of U (N ≥ 89 at NB = 5N) are taken as K1/K2 take them.
// - Chains: U is rounded to bf16 once, in the prologue, and held transposed
//   in shared memory, two k-values a 32-bit word, one column of all C·N
//   columns per k_stride words (4 more than a multiple of 8, so a warp's
//   B-fragment reads hit 32 distinct banks). The forward is
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: one product per k16 step
//   and n-tile, exact products accumulated in float32. The epilogue writes
//   dI in float32 in place of the tile's I_rest (copied out as dI_rest) and a
//   bf16 copy of it, transposed as the dU product's B fragments want it
//   (bins of a column paired in a word, 0 past the tile's rows and the last
//   column). dU = X_fᵀ·bf16(dI) is then on the tensor cores as well: a
//   warp holds up to kWarpTiles 16 × 8 accumulator tiles of dU (NB × C·N)
//   for the whole kernel; past 8 · kWarpTiles tiles grid_y slices split
//   them, each slice recomputing the tile's currents. X_f's A fragments are
//   built from two 16-bit reads each (an X_f row of odd NB starts on an odd
//   value). A group of one chain is this kernel too, so a chain axis of 1
//   keeps the chain semantics.

#include <cuda_bf16.h>

#include "fused_ll_common.cuh"

#ifndef EXP_CLIP
#error "EXP_CLIP must come from theano_pyglm_torch/ops/clipping.py as -DEXP_CLIP"
#endif

namespace {

constexpr int kScratch = kThreads * 8;  // words for joining partial sums (≥ kThreads · kMtN)
constexpr int kMtM = 9, kMtN = 7;  // K4-vg's dU micro-tile (ops/kernels.py DU_TILE)
constexpr int kMaxSlices = 32;  // threads that share one dU micro-tile, at most
constexpr int kMaxChains = 8;  // ops/kernels.py MAX_CHAINS
constexpr int kWarpTiles = 16;  // K4-vg-chains: dU mma tiles a warp holds (ops/kernels.py WARP_TILES)

// Shared-memory layout, in 32-bit words, mirrored by ops/kernels.py
// _smem_bytes_bf16, for C chains (one chain: C = 1) of a column group of W
// neurons (W = N when one group holds them all; the chain kernels take one):
//   U         one chain: float32 (ceil8(NB) × b_stride(W)), as K2 holds it;
//             chains: bf16(U) transposed, column c·N + n in k_stride(KP/2)
//             words of k-pairs (KP = ceil16(NB)), ceil32(C·N) columns
//   stage 0, 1  X_f (x_words: RT × NB bf16 values, ≥ 16 zero values), then
//             C I_rest spans (NS each; vg: dI in place), then S (NS)
//   dI bf16   K4-vg-chains: ceil8(C·N) columns of k_stride(RT/2) words
//   scratch   (kScratch)
__host__ __device__ constexpr int k_stride(int words) { return words + (12 - words % 8) % 8; }
__host__ __device__ constexpr int x_words(int NB, int tile_t) {
    return ceil_to(ceil_to(tile_t, 16) * NB + 16, 8) / 2;
}
__host__ __device__ constexpr int stage_words(int NB, int W, int tile_t, int C) {
    return x_words(NB, tile_t) + (C + 1) * n_span(W, tile_t);
}
__host__ __device__ constexpr int u_words(int NB, int W, int C, bool chains) {
    return chains ? ceil_to(C * W, 32) * k_stride(ceil_to(NB, 16) / 2) : ceil_to(NB, 8) * b_stride(W);
}
__host__ __device__ constexpr int di_words(int W, int tile_t, int C, bool chains, bool grad) {
    return chains && grad ? ceil_to(C * W, 8) * k_stride(ceil_to(tile_t, 16) / 2) : 0;
}
size_t smem_bytes_bf16(int NB, int W, int tile_t, int C, bool chains, bool grad) {
    return ((size_t)u_words(NB, W, C, chains) + 2 * (size_t)stage_words(NB, W, tile_t, C) +
            (size_t)di_words(W, tile_t, C, chains, grad) + kScratch) * 4;
}

// Bytes of a span of n elements of `size` bytes at src that one bulk copy
// can take: the 16-byte multiple when src is 16-byte aligned, else none.
__device__ __forceinline__ uint32_t bulk_bytes(const void* src, int n, int size) {
    return (reinterpret_cast<uintptr_t>(src) & 15) ? 0u : (uint32_t)(n * size) & ~15u;
}

// A bf16 value's bits widened to float32's (exact; also exact as TF32).
__device__ __forceinline__ uint32_t widen(uint16_t h) { return (uint32_t)h << 16; }
__device__ __forceinline__ float widen_f(uint16_t h) { return __uint_as_float(widen(h)); }
// Two bf16 values in one register, the lower index in the low half (the
// mma fragments' order).
__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) { return (uint32_t)lo | ((uint32_t)hi << 16); }
__device__ __forceinline__ uint16_t bf16_bits(float x) { return __bfloat16_as_ushort(__float2bfloat16_rn(x)); }

// c += a·b for one m16n8k16 bf16 tile, float32 accumulation (pairs of bf16
// a register: a = A[g][2t..2t+1], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..];
// b = B[2t..2t+1][g], B[2t+8..2t+9][g]; c as mma_tf32's).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The grid is (grid_x, grid_y · G): blockIdx.y = group · grid_y + dU slice.
// part row b: K4-fwd [ll of each group, pad]; K4-vg [dU (NB·N row-major),
// ll of each group, pad]; the chain kernels (G = 1, W = N) [dU (C·NB·N,
// chain-major), ll of each chain, pad] (K4-fwd-chains: no dU). bar: 2 words,
// zeroed before the first call.
template <bool kGrad, bool kChains>
__global__ void __launch_bounds__(kThreads, 1)
fused_ll_bf16_tiles(const uint16_t* __restrict__ x_f, const float* __restrict__ u,
                    const float* __restrict__ i_rest, const float* __restrict__ s,
                    float* __restrict__ d_irest, float* __restrict__ part, float* __restrict__ out,
                    unsigned* __restrict__ bar, int T, int NB, int N, int W, int tile_t, float dt,
                    float log_dt, int C) {
    constexpr int NQ = kChains ? kMaxChains : 1;  // values a thread keeps: one per chain
    extern __shared__ __align__(16) float smem[];
    __shared__ __align__(8) uint64_t s_bar[2];  // a stage's bulk copies have landed
    const int nch = kChains ? C : 1;
    const int CN = nch * N;  // columns of U, I and dU in all
    const int G = kChains ? 1 : (N + W - 1) / W, YS = gridDim.y / G;
    const int grp = blockIdx.y / YS, ys = blockIdx.y - grp * YS;
    const int c0 = grp * W, nc = kChains ? CN : min(W, N - c0);  // this block's columns
    const bool whole = kChains || nc == N;  // one group: I_rest and S tiles are contiguous
    const int rs = kChains ? N : nc;        // a row's words in an I_rest or S span
    const int RT = ceil_to(tile_t, 16);
    const int KP = ceil_to(NB, kChains ? 16 : 8);  // the forward's k extent
    const int BS = b_stride(W);                     // one chain: U's row stride
    const int KS = k_stride(ceil_to(NB, 16) / 2);   // chains: a bf16(U) column's words
    const int DS = k_stride(RT / 2);                // K4-vg-chains: a bf16 dI column's words
    const int DC = ceil_to(CN, 8);                  // K4-vg-chains: dI columns held
    const int XW = x_words(NB, tile_t), NS = n_span(W, tile_t);
    const int SW = stage_words(NB, W, tile_t, nch);
    const int UW = u_words(NB, W, nch, kChains);
    const int DW = di_words(W, tile_t, nch, kChains, kGrad);
    const int NT = (nc + 7) >> 3;  // n-tiles of 8 columns
    const int NG = (NT + 3) >> 2;  // forward n-groups of 4 n-tiles
    float* s_u = smem;
    uint32_t* s_ub = reinterpret_cast<uint32_t*>(smem);
    float* s_stage = smem + UW;
    uint16_t* s_dih = reinterpret_cast<uint16_t*>(s_stage + 2 * (size_t)SW);
    const uint32_t* s_di = reinterpret_cast<const uint32_t*>(s_dih);
    float* s_join = s_stage + 2 * (size_t)SW + DW;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int n_tiles = (T + tile_t - 1) / tile_t;
    const bool lead_y = ys == 0;

    // Zero U, both stages and the dI copy (pads stay zero), before any copy
    // lands in them.
    {
        float4* z = reinterpret_cast<float4*>(smem);
        const int n4 = (UW + 2 * SW + DW) >> 2;
        for (int i = tid; i < n4; i += kThreads) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (tid == 0) {
        mbar_init(&s_bar[0]);
        mbar_init(&s_bar[1]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // A tile's X_f span (bf16), its I_rest spans (chains: one a chain) and
    // its S span: thread 0 moves each contiguous span with one TMA bulk copy
    // onto the stage's mbarrier; the threads copy what a bulk copy cannot
    // take (an X_f tail by plain loads, a float32 tail by cp.async). A column
    // group's I_rest and S rows lie N apart: cp.async takes them a word at a
    // time.
    const int nf = kChains ? C + 1 : 2;  // float32 spans: I_rest (C of them), then S
    auto issue = [&](int tile, int st) {
        const int t0 = tile * tile_t, rows = min(tile_t, T - t0);
        float* base = s_stage + (size_t)st * SW;
        uint16_t* xdst = reinterpret_cast<uint16_t*>(base);
        const uint16_t* xsrc = x_f + (size_t)t0 * NB;
        const int nx = rows * NB;
        const uint32_t xbytes = bulk_bytes(xsrc, nx, 2);
        auto span = [&](int q, float*& dst, const float*& src) -> int {
            dst = base + XW + q * NS;
            src = q == nf - 1 ? s + (size_t)t0 * N + c0 : i_rest + ((size_t)q * T + t0) * N + c0;
            return whole ? rows * N : 0;
        };
        float* dst;
        const float* src;
        uint32_t total = xbytes;
        for (int q = 0; q < nf; ++q) {
            const int n = span(q, dst, src);
            total += bulk_bytes(src, n, 4);
        }
        if (tid == 0) {
            // this stage's earlier reads and writes, in the generic proxy,
            // are ordered before the bulk copies' writes
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_expect_tx(&s_bar[st], total);
            if (xbytes) bulk_copy(xdst, xsrc, xbytes, &s_bar[st]);
            for (int q = 0; q < nf; ++q) {
                const int n = span(q, dst, src);
                const uint32_t bytes = bulk_bytes(src, n, 4);
                if (bytes) bulk_copy(dst, src, bytes, &s_bar[st]);
            }
        }
        for (int i = (int)(xbytes >> 1) + tid; i < nx; i += kThreads) xdst[i] = xsrc[i];
        for (int q = 0; q < nf; ++q) {
            const int n = span(q, dst, src);
            for (int i = (int)(bulk_bytes(src, n, 4) >> 2) + tid; i < n; i += kThreads) cp_async4(dst + i, src + i);
        }
        if (!whole) {
            float* d_ir = base + XW;
            const float* src_ir = i_rest + (size_t)t0 * N + c0;
            const float* src_s = s + (size_t)t0 * N + c0;
            for (int i = tid; i < rows * nc; i += kThreads) {
                const int r = i / nc;
                const size_t o = (size_t)r * N + (i - r * nc);
                cp_async4(d_ir + i, src_ir + o);
                cp_async4(d_ir + NS + i, src_s + o);
            }
        }
    };
    if constexpr (kChains) {
        // bf16(U), rounded once: column c·N + n holds U[c, :, n] as k-pairs
        const int KH = ceil_to(NB, 16) / 2;
        for (int e = tid; e < CN * KH; e += kThreads) {
            const int col = e / KH, p = e - col * KH;
            const int ch = col / N, m = 2 * p;
            const float* uc = u + (size_t)ch * NB * N + (col - ch * N);
            const uint16_t lo = m < NB ? bf16_bits(uc[(size_t)m * N]) : 0;
            const uint16_t hi = m + 1 < NB ? bf16_bits(uc[(size_t)(m + 1) * N]) : 0;
            s_ub[(size_t)col * KS + p] = pack(lo, hi);
        }
    } else {
        // the block's columns of U into rows of BS words, 4 bytes a thread
        for (int e = tid; e < NB * nc; e += kThreads) {
            const int m = e / nc, col = e - m * nc;
            cp_async4(s_u + m * BS + col, u + (size_t)m * N + c0 + col);
        }
    }
    cp_async_commit();
    issue(blockIdx.x, 0);
    cp_async_commit();

    // K4-vg's dU: kMtM × kMtN micro-tiles in registers for the whole kernel,
    // float32 FMA, exactly as K2 (see fused_poisson_ll.cu).
    const int ngc = (nc + kMtN - 1) / kMtN, MG = (NB + kMtM - 1) / kMtM;
    const int y_items = kGrad && !kChains ? min(kThreads, MG * ngc - ys * kThreads) : 0;
    const int n_slices = y_items > 0 ? min(kThreads / y_items, kMaxSlices) : 0;
    const int slice = y_items > 0 ? tid / y_items : 0;
    const int item_l = tid - slice * y_items;
    const bool owns_du = slice < n_slices;
    const int item = ys * kThreads + item_l;
    const int mg = owns_du ? item / ngc : 0;
    const int n0d = owns_du ? (item % ngc) * kMtN : 0;
    float du[kChains ? 1 : kMtM][kChains ? 1 : kMtN];
#pragma unroll
    for (int i = 0; i < (kChains ? 1 : kMtM); ++i)
#pragma unroll
        for (int j = 0; j < (kChains ? 1 : kMtN); ++j) du[i][j] = 0.f;

    // K4-vg-chains' dU: the 16 × 8 tiles of dU (NB × C·N), item i = m-tile
    // i % MT, n-tile i / MT; warp w of slice ys holds items
    // ys·kWarps·kWarpTiles + w + kWarps·j, j < kWarpTiles.
    constexpr int WT = kChains && kGrad ? kWarpTiles : 1;
    const int MT = ceil_to(NB, 16) >> 4;
    const int n_mma = kChains && kGrad ? MT * (DC >> 3) : 0;
    const int item0 = ys * kWarps * kWarpTiles + warp;
    float dacc[WT][4];
#pragma unroll
    for (int j = 0; j < WT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) dacc[j][c] = 0.f;

    // the value (of each chain): each forward unit's terms a thread summed
    // into part, the parts added into ll with Kahan's compensation (ll_c)
    float ll[NQ], ll_c[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) ll[q] = ll_c[q] = 0.f;
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
        const uint16_t* sx = reinterpret_cast<const uint16_t*>(s_stage + (size_t)(k & 1) * SW);
        float* sir = s_stage + (size_t)(k & 1) * SW + XW;  // I_rest, then (vg) dI in place
        const float* ssp = sir + nch * NS;

        // forward: unit = (16 bins, 4 n-tiles of 8 columns)
        for (int unit = warp; unit < (RT >> 4) * NG; unit += kWarps) {
            const int fb = unit / NG, ng = unit - fb * NG;
            const int r0 = fb * 16, nt0 = ng * 4;
            float acc_lo[4][4], acc_hi[4][4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc_lo[j][c] = acc_hi[j][c] = 0.f;
            if constexpr (kChains) {
                // X_f · bf16(U): one bf16 m16n8k16 product per k-step and
                // n-tile. n-tiles past NT read zero columns of U.
                const uint16_t* x0 = sx + (size_t)(r0 + g) * NB + 2 * t;
                const uint16_t* x8 = x0 + 8 * NB;
                const uint32_t* ub = s_ub + (size_t)(nt0 * 8 + g) * KS + t;
                for (int kk = 0; kk < KP; kk += 16) {
                    const uint32_t a[4] = {pack(x0[kk], x0[kk + 1]), pack(x8[kk], x8[kk + 1]),
                                           pack(x0[kk + 8], x0[kk + 9]), pack(x8[kk + 8], x8[kk + 9])};
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        mma_bf16(acc_hi[j], a, ub[j * 8 * KS + (kk >> 1)], ub[j * 8 * KS + (kk >> 1) + 4]);
                }
            } else {
                // f32(X_f) · U = X_f·tf32(U) + X_f·tf32(U − tf32(U)): the
                // widened bf16 values are exact TF32 operands. n-tiles past
                // NT multiply whatever follows U's last columns and are
                // never read.
                const uint16_t* xa = sx + (size_t)(r0 + g) * NB + t;
                const float* ub = s_u + t * BS + nt0 * 8 + g;
                for (int kk = 0; kk < KP; kk += 8) {
                    const uint32_t a[4] = {widen(xa[kk]), widen(xa[8 * NB + kk]), widen(xa[kk + 4]),
                                           widen(xa[8 * NB + kk + 4])};
                    uint32_t bb[4][2], bs[4][2];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        split_tf32(ub[kk * BS + 8 * j], bb[j][0], bs[j][0]);
                        split_tf32(ub[(kk + 4) * BS + 8 * j], bb[j][1], bs[j][1]);
                    }
#pragma unroll
                    for (int j = 0; j < 4; ++j) mma_tf32(acc_lo[j], a, bs[j][0], bs[j][1]);
#pragma unroll
                    for (int j = 0; j < 4; ++j) mma_tf32(acc_hi[j], a, bb[j][0], bb[j][1]);
                }
            }
            float part_v[NQ];
#pragma unroll
            for (int q = 0; q < NQ; ++q) part_v[q] = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int r = r0 + g + ((c >> 1) << 3), col = (nt0 + j) * 8 + 2 * t + (c & 1);
                    float d_i = 0.f;
                    if (r < rows && col < nc) {  // the ragged tile, the padded columns
                        const int ch = kChains ? col / N : 0;
                        const int e = ch * NS + r * rs + (col - ch * N);
                        const float i_raw = sir[e] + (acc_hi[j][c] + acc_lo[j][c]);
                        const float I = fminf(fmaxf(i_raw, -EXP_CLIP), EXP_CLIP);
                        const float rate_dt = expf(I) * dt;
                        const float spikes = ssp[e - ch * NS];
                        const float term = spikes * (I + log_dt) - rate_dt;
                        if (kChains) {
#pragma unroll
                            for (int q = 0; q < NQ; ++q)
                                if (q == ch) part_v[q] += term;
                        } else {
                            part_v[0] += term;
                        }
                        if (kGrad) {  // the clip's gradient is 0 outside the active range
                            d_i = fabsf(i_raw) < EXP_CLIP ? spikes - rate_dt : 0.f;
                            sir[e] = d_i;
                        }
                    }
                    // dI's bf16 copy: every (bin, column) of the tile below
                    // RT and DC, 0 outside the tile's rows and the columns
                    if (kChains && kGrad && col < DC) s_dih[(size_t)col * 2 * DS + r] = bf16_bits(d_i);
                }
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                const float y = part_v[q] - ll_c[q], sum = ll[q] + y;
                ll_c[q] = (sum - ll[q]) - y;
                ll[q] = sum;
            }
        }

        if (kGrad) {
            __syncthreads();  // the tile's dI is in shared memory
            if (lead_y && whole) {
                if constexpr (kChains) {
                    for (int ch = 0; ch < C; ++ch)
                        copy_out(d_irest + ((size_t)ch * T + t0) * N, sir + ch * NS, rows * N);
                } else {
                    copy_out(d_irest + (size_t)t0 * N, sir, rows * N);
                }
            }
            if (lead_y && !whole)
                for (int i = tid; i < rows * nc; i += kThreads) {
                    const int r = i / nc;
                    d_irest[(size_t)(t0 + r) * N + c0 + (i - r * nc)] = sir[i];
                }
            if constexpr (kChains) {
                // dU += X_fᵀ · bf16(dI): A = X_fᵀ (16 rows of NB × 16 bins,
                // built from 16-bit reads), B = dI's bf16 copy (16 bins × 8
                // columns, a word a register); bins past the tile's rows
                // meet zero dI
                const int kb_end = ceil_to(rows, 16) >> 4;
#pragma unroll
                for (int j = 0; j < WT; ++j) {
                    const int it = item0 + kWarps * j;
                    if (it < n_mma) {
                        const int mt = it % MT, nt = it / MT;
                        const uint16_t* xc = sx + (size_t)(2 * t) * NB + mt * 16 + g;
                        const uint32_t* dc = s_di + (size_t)(nt * 8 + g) * DS + t;
                        for (int kb = 0; kb < kb_end; ++kb) {
                            const uint16_t* xk = xc + (size_t)kb * 16 * NB;
                            const uint32_t a[4] = {pack(xk[0], xk[NB]), pack(xk[8], xk[NB + 8]),
                                                   pack(xk[8 * NB], xk[9 * NB]), pack(xk[8 * NB + 8], xk[9 * NB + 8])};
                            mma_bf16(dacc[j], a, dc[kb * 8], dc[kb * 8 + 4]);
                        }
                    }
                }
            } else if (owns_du) {
                // X_f and dI rows lie NB and rs apart, so each operand is a
                // scalar read; rows past NB or columns past the group's last
                // read the next row and land in discarded sums
                const uint16_t* xm = sx + mg;
                const float* dp = sir + n0d;
#pragma unroll 2
                for (int r = slice; r < rows; r += n_slices) {
                    float xv[kMtM], dv[kMtN];
#pragma unroll
                    for (int i = 0; i < kMtM; ++i) xv[i] = widen_f(xm[r * NB + i * MG]);
#pragma unroll
                    for (int j = 0; j < kMtN; ++j) dv[j] = dp[r * rs + j];
#pragma unroll
                    for (int i = 0; i < (kChains ? 1 : kMtM); ++i)
#pragma unroll
                        for (int j = 0; j < (kChains ? 1 : kMtN); ++j) du[i][j] = fmaf(xv[i], dv[j], du[i][j]);
                }
            }
        }
        __syncthreads();  // readers of this stage (and of dI's copy) are done before it is refilled
    }

    // -- this block's part of its partial row, width ceil4(NB·C·N + V) with
    // dU, else ceil4(V), for V values: one per group (one chain) or per chain
    const int n_vals = kChains ? nch : G;
    const int ll_off = kGrad ? NB * CN : 0, width = ll_off + n_vals;
    const int w4 = ceil_to(width, 4) >> 2;
    float* row = part + (size_t)blockIdx.x * w4 * 4;
    if constexpr (kGrad && kChains) {
        // every dU entry is one thread's: no join
#pragma unroll
        for (int j = 0; j < WT; ++j) {
            const int it = item0 + kWarps * j;
            if (it < n_mma) {
                const int mt = it % MT, nt = it / MT;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int m = mt * 16 + g + ((c >> 1) << 3), col = nt * 8 + 2 * t + (c & 1);
                    if (m < NB && col < CN) {
                        const int ch = col / N;
                        row[((size_t)ch * NB + m) * N + (col - ch * N)] = dacc[j][c];
                    }
                }
            }
        }
    } else if constexpr (kGrad) {
        // join the slices' sums in slice order, one micro-tile row at a time
#pragma unroll
        for (int i = 0; i < kMtM; ++i) {
            __syncthreads();
            if (slice > 0 && owns_du)
#pragma unroll
                for (int j = 0; j < kMtN; ++j) s_join[(tid - y_items) * kMtN + j] = du[i][j];
            __syncthreads();
            if (slice == 0)
                for (int sl = 1; sl < n_slices; ++sl)
#pragma unroll
                    for (int j = 0; j < kMtN; ++j)
                        du[i][j] += s_join[((sl - 1) * y_items + item_l) * kMtN + j];
        }
        if (slice == 0 && owns_du)
#pragma unroll
            for (int i = 0; i < kMtM; ++i)
#pragma unroll
                for (int j = 0; j < kMtN; ++j)
                    if (mg + i * MG < NB && n0d + j < nc) row[(mg + i * MG) * N + c0 + n0d + j] = du[i][j];
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        if (q >= (kChains ? nch : 1)) break;
        const float v = block_sum(ll[q]);
        if (lead_y && tid == 0) row[ll_off + (kChains ? q : grp)] = v;
    }

    // -- after a grid barrier, every block sums a slice of the columns over
    // the partial rows, in a fixed order; with column groups, after a second
    // barrier one thread adds the groups' values in group order
    grid_barrier(bar);
    sum_columns(part, out, w4, s_join);
    if (G > 1) {
        grid_barrier(bar);
        if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) {
            float acc = 0.f;
            for (int q = 0; q < G; ++q) acc += __ldcg(out + ll_off + q);
            out[ll_off] = acc;
        }
    }
}

template <bool kGrad, bool kChains>
cudaError_t launch(const void* x_f, const float* u, const float* i_rest, const float* s,
                   float* d_irest, float* part, float* out, unsigned* bar, int T, int NB, int N,
                   int C, int W, int tile_t, int grid_x, int grid_y, int smem_bytes, int device,
                   float dt, float log_dt, cudaStream_t stream) {
    static int attr_bytes[kMaxDevices];  // the shared-memory attribute set so far, per device
    if (device < 0 || device >= kMaxDevices || tile_t % 8 != 0) return cudaErrorInvalidValue;
    // one chain: a column group is all N columns, or whole n-tiles of 8;
    // chains: one group of 1 ≤ C ≤ kMaxChains chains
    if (kChains ? (W != N || C < 1 || C > kMaxChains) : (C != 1 || W < 1 || W > N || (W < N && W % 8 != 0)))
        return cudaErrorInvalidValue;
    if ((size_t)smem_bytes != smem_bytes_bf16(NB, W, tile_t, C, kChains, kGrad)) return cudaErrorInvalidValue;
    const int work = kChains ? (ceil_to(NB, 16) / 16) * (ceil_to(C * N, 8) / 8)
                             : ((NB + kMtM - 1) / kMtM) * ((W + kMtN - 1) / kMtN);
    const int per_slice = kChains ? kWarps * kWarpTiles : kThreads;
    if (kGrad ? grid_y * per_slice < work : grid_y != 1) return cudaErrorInvalidValue;
    const int G = kChains ? 1 : (N + W - 1) / W;
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (attr_bytes[device] < smem_bytes) {
        err = cudaFuncSetAttribute(fused_ll_bf16_tiles<kGrad, kChains>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
        if (err != cudaSuccess) return err;
        attr_bytes[device] = smem_bytes;
    }
    const uint16_t* x = static_cast<const uint16_t*>(x_f);
    void* args[] = {&x, &u, &i_rest, &s, &d_irest, &part, &out, &bar,
                    &T, &NB, &N, &W, &tile_t, &dt, &log_dt, &C};
    return cudaLaunchCooperativeKernel((const void*)fused_ll_bf16_tiles<kGrad, kChains>,
                                       dim3(grid_x, grid_y * G), dim3(kThreads), args,
                                       (size_t)smem_bytes, stream);
}

}  // namespace

// K4-fwd: K1 on a bf16 x_f (T, NB). out[0] = ll. W: the columns of a group
// (N for one group); part: (grid_x, ceil4(G)) scratch, out: ceil4(G) floats;
// grid_y = 1; bar: 2 words, zeroed before the first call on the stream.
extern "C" int fused_ll_fwd_bf16(const void* x_f, const float* u, const float* i_rest,
                                 const float* s, float* part, float* out, unsigned* bar, int T,
                                 int NB, int N, int W, int tile_t, int grid_x, int grid_y,
                                 int smem_bytes, int device, float dt, float log_dt, void* stream) {
    return (int)launch<false, false>(x_f, u, i_rest, s, nullptr, part, out, bar, T, NB, N, 1, W,
                                     tile_t, grid_x, grid_y, smem_bytes, device, dt, log_dt,
                                     (cudaStream_t)stream);
}

// K4-vg: K2 on a bf16 x_f. out[0 : NB·N] = dU, out[NB·N] = ll; d_irest (T, N).
extern "C" int fused_ll_vg_bf16(const void* x_f, const float* u, const float* i_rest,
                                const float* s, float* d_irest, float* part, float* out,
                                unsigned* bar, int T, int NB, int N, int W, int tile_t, int grid_x,
                                int grid_y, int smem_bytes, int device, float dt, float log_dt,
                                void* stream) {
    return (int)launch<true, false>(x_f, u, i_rest, s, d_irest, part, out, bar, T, NB, N, 1, W,
                                    tile_t, grid_x, grid_y, smem_bytes, device, dt, log_dt,
                                    (cudaStream_t)stream);
}

// K4-fwd-chains: u (C, NB, N), i_rest (C, T, N), a bf16 x_f (T, NB) and s
// (T, N) shared, 1 ≤ C ≤ 8; out[0 : C] = the chains' ll.
extern "C" int fused_ll_fwd_chains_bf16(const void* x_f, const float* u, const float* i_rest,
                                        const float* s, float* part, float* out, unsigned* bar,
                                        int T, int NB, int N, int C, int tile_t, int grid_x,
                                        int grid_y, int smem_bytes, int device, float dt,
                                        float log_dt, void* stream) {
    return (int)launch<false, true>(x_f, u, i_rest, s, nullptr, part, out, bar, T, NB, N, C, N,
                                    tile_t, grid_x, grid_y, smem_bytes, device, dt, log_dt,
                                    (cudaStream_t)stream);
}

// K4-vg-chains: out[0 : C·NB·N] = dU ((C, NB, N)), out[C·NB·N + c] = chain c's
// ll; d_irest (C, T, N). grid_y: dU slices of 8 · kWarpTiles mma tiles.
extern "C" int fused_ll_vg_chains_bf16(const void* x_f, const float* u, const float* i_rest,
                                       const float* s, float* d_irest, float* part, float* out,
                                       unsigned* bar, int T, int NB, int N, int C, int tile_t,
                                       int grid_x, int grid_y, int smem_bytes, int device, float dt,
                                       float log_dt, void* stream) {
    return (int)launch<true, true>(x_f, u, i_rest, s, d_irest, part, out, bar, T, NB, N, C, N,
                                   tile_t, grid_x, grid_y, smem_bytes, device, dt, log_dt,
                                   (cudaStream_t)stream);
}

extern "C" const char* fused_ll_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
