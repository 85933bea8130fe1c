// Fused coupling matmul + Poisson log-likelihood where U is too wide to stay
// in shared memory: K1's and K2's column-group instance, hand-written for
// Hopper (sm_90a), bound to PyTorch through a plain C interface and ctypes
// (theano_pyglm_torch/ops/cuda_loader.py, ops/kernels.py).
//
// Replaces the Pallas TPU kernels of theano_pyglm_tpu/ops/pallas_kernels.py
// at the shapes where U (NB × N) does not fit beside a time tile in one
// block's shared memory (NB = 5N: N ≥ 89; ops/kernels.py launch_plan picks
// this instance wherever the U-resident layout of fused_poisson_ll.cu would
// need column groups and this one fits, N up to about 900):
//   K1  _fwd_kernel (:73, value only)          -> fused_ll_fwd_wide
//   K2  _vg_kernel  (:100, one-pass value+grad) -> fused_ll_vg_wide
// computing what K1/K2 compute:
//   I_raw = I_rest + X_f @ U        X_f (T, NB), U (NB, N), I_rest and S (T, N)
//   I     = clip(I_raw, ±EXP_CLIP)
//   ll    = Σ S·(I + log dt) − e^I·dt
//   K2 also: dI_rest = (S − e^I·dt)·1{|I_raw| < EXP_CLIP}   (T, N)
//            dU      = X_fᵀ @ dI_rest                       (NB, N)
//
// Bounds on an H100 SXM (3.35 TB/s HBM, 495 TFLOP/s TF32 on the tensor
// cores) at the long recording's shape T=600,000, NB=500, N=100, each byte
// read or written once: K1 moves 1.68 GB (0.50 ms) and does 60 GFLOP,
// float32-accurate as three TF32 products (0.36 ms): the bytes bound it. K2
// adds dI_rest and dU (1.92 GB, 0.57 ms) and a second product of the same
// size (0.73 ms): the operations bound it, with the bytes close behind.
//
// The U-resident instance ran these shapes in column groups and lost to its
// own plain version, for four reasons; what this design does about each:
// 1. A 16-bin tile (all the room U's resident column slice left) gave a
//    block two forward units for eight warps. Here U is not resident: a
//    block walks the K dimension in k-slabs of 32 (X_f's slab beside U's)
//    through a ring of stages, as a GEMM main loop does, and U (0.2 MB at
//    N=100) is served by the L2. The block holds all N columns over a tile
//    of 16·kMI·WM bins: warp (wm, wn) owns kMI m-tiles (16 bins each) and
//    an even share of the n-tiles among the WARPS / WM warps of its m-tiles
//    (K1 at N=100: 128 bins, each warp 2 m-tiles × 7 or 6 n-tiles; K2: one
//    m-tile × all 13, which leaves its phase 2 the registers). U is split
//    into its TF32 big and small parts once per call (phase 0, by all
//    blocks, before a grid barrier) into a device scratch in B-fragment
//    order, a slab of it contiguous: one TMA bulk copy a stage, and one
//    16-byte shared load per lane, k-step and n-tile. X_f's slab arrives by
//    16-byte cp.async; a stage completes on an mbarrier (the bulk bytes and
//    every thread's cp.async arrival). A k-step's A fragments (X_f) are
//    split once for all of a warp's n-tiles, a step ahead; the products
//    go in groups of four independent accumulators.
// 2. K2's dU slices redid the forward. Here every (bin, column) current is
//    computed once, in phase 1, which writes dI_rest (an output anyway);
//    after a grid barrier phase 2 computes dU = X_fᵀ·dI on the tensor cores
//    as a split-T product: dU's 16 × 8 tiles go in runs of two m-tiles × at
//    most 8 n-tiles to warps, eight runs a part; block (p, r) takes part p
//    over an even share r of the bins (R = blocks / parts shares), in chunks
//    of TC bins: the part's X_f columns and the chunk's dI staged (dI by one
//    bulk copy), dI split into TF32 parts once per chunk into B-fragment
//    order while the previous chunk's products run. Each chunk's products
//    go to fresh accumulators, added to the run's sums once per chunk (the
//    tensor cores' float32 accumulation over thousands of bins loses
//    accuracy). A part's rows of dU are staged in shared memory and written
//    to partial row r row-major.
// 3. X_f was read once per (group, dU slice), four times at N=100. Here
//    phase 1 reads it once and phase 2 once more: 2·|X_f|. dI is read once
//    per part (four at N=100), the parts of one share at about the same
//    time, so mostly from the L2.
// 4. A group's I_rest and S rows lay N apart and cp.async moved them a word
//    at a time. Here a tile's I_rest and S are two contiguous spans, each
//    moved by one TMA bulk copy onto an mbarrier, issued as the previous
//    tile's epilogue ends; dI leaves from the accumulators' registers.
// One cooperative launch per call: phase 0 (split U), phase 1, for K2 phase
// 2, then the cross-block sums after a grid barrier, each partial row
// summed over its rows in a fixed order and the blocks' values by one block
// in block order. No float atomics: repeated calls give identical bits.
//
// What limits it (PERF.md §6, tools/kernel_probe.py): the 3xTF32 mma.sync
// products of both phases, at about half the rate that instruction reaches
// on this card with four accumulators a warp (tools/mma_probe.py: 308
// TFLOP/s at 8 warps an SM), and the copies, which overlap the products
// only in part (a ring of two 32-deep stages at N=100 beside the tile's
// I_rest and S). wgmma, with B read by the tensor cores from shared memory,
// is the next step. Measured and rejected: U split as it is read (twice
// the ALU work a product; slower), each X_f row by its own bulk copy
// (slower than cp.async), dI's split interleaved with the products' k-steps
// (slower), the ring's first X_f slabs issued before phase 0's barrier and
// chunk 0's X_f before phase 2's (K1 4 % slower at T=600,000, K2 2 % at
// T=10,176), dI's split without divisions, four reads in flight (within
// 1 %). At T=10,176 (80 tiles for 132 SMs) K2 takes about what its plain
// version takes: 16 k-slab steps of about 4.5 µs a tile in phase 1, five
// chunks of about 9 µs a block in phase 2, of which 45–48 µs stay with the
// products, the epilogue and the later copies off (kernel_probe.py `empty`:
// phase 0, the grid barriers, dI's split, the partial rows and their sums).

#include "fused_ll_common.cuh"

#ifndef EXP_CLIP
#error "EXP_CLIP must come from theano_pyglm_torch/ops/clipping.py as -DEXP_CLIP"
#endif

namespace {

constexpr int kFwdRun1 = 16;  // phase 1: n-tiles a warp with one m-tile, at most (ops/kernels.py WIDE_FWD_RUN)
constexpr int kFwdRun2 = 8;   // phase 1: n-tiles a warp with two m-tiles, at most
constexpr int kDuRun = 8;     // phase 2: n-tiles of a run of two m-tiles, at most (WIDE_DU_RUN)

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Shared-memory layout, in 32-bit words, mirrored by ops/kernels.py
// (_smem_bytes_wide). Phase 1:
//   stages × k-slab: X_f (TM rows of KS + 4 words: conflict-free A reads),
//                    then U's slab (KS / 8 k-steps × NT n-tiles × 32 lanes,
//                    a uint4 {big U[k][c], big U[k + 4][c], small ..., small
//                    ...} each, k = 8·step + lane % 4, c = 8·n-tile + lane / 4)
//   I_rest, S        (ceil4(TM·N) each, the tile's)
// Phase 2 (K2), over the same words:
//   2 × X_f          a chunk's part columns (TC rows of XS2 ≡ 8 mod 32 words)
//   2 × dI           a chunk's dI (ceil4(TC·N))
//   2 × dI split     (TC / 8 k-steps × NT n-tiles × 32 lanes) uint4
// then the part's rows of dU (32·part_pairs × N), staged for its partial row.
// After the phases the region is the cross-block sums' scratch.
__host__ __device__ constexpr int slab_words(int TM, int KS, int NT) { return TM * (KS + 4) + KS / 8 * NT * 128; }
__host__ __device__ constexpr int fwd_words(int TM, int KS, int stages, int N) {
    return stages * slab_words(TM, KS, (N + 7) / 8) + 2 * ceil_to(TM * N, 4);
}
// Phase 2's runs: dU's m-tiles in pairs, each pair cut into NR runs of at
// most kDuRun n-tiles, pair by pair; a part is kWarps consecutive runs.
__host__ __device__ constexpr int du_ranges(int NT) { return cdiv(NT, kDuRun); }
__host__ __device__ constexpr int du_pairs(int NB) { return cdiv(cdiv(NB, 16), 2); }
__host__ __device__ constexpr int du_runs(int NB, int N) { return du_pairs(NB) * du_ranges((N + 7) / 8); }
__host__ __device__ constexpr int du_parts(int NB, int N) { return cdiv(du_runs(NB, N), kWarps); }
// the most m-tile pairs that one part's runs span
__host__ __device__ int part_pairs(int NB, int N) {
    const int NR = du_ranges((N + 7) / 8), runs = du_runs(NB, N);
    int most = 0;
    for (int p = 0; p * kWarps < runs; ++p)
        most = imax(most, (imin(runs, (p + 1) * kWarps) - 1) / NR - p * kWarps / NR + 1);
    return most;
}
// the row stride of a chunk's X_f part columns: ≥ their 32·part_pairs
// columns, ≡ 8 (mod 32) words, so that the transposed A reads are free of
// bank conflicts
__host__ __device__ int part_stride(int NB, int N) {
    const int w = 32 * part_pairs(NB, N);
    return w + (8 - w % 32 + 32) % 32;
}
__host__ __device__ int du_words(int TC, int NB, int N) {
    return 2 * (TC * part_stride(NB, N) + ceil_to(TC * N, 4) + TC / 8 * ((N + 7) / 8) * 128);
}
size_t smem_bytes_wide(int NB, int N, int TM, int KS, int stages, int TC) {
    // K2 also stages a part's rows of dU (32·part_pairs rows of N) after phase 2
    const int du = TC ? imax(du_words(TC, NB, N), 32 * part_pairs(NB, N) * N) : 0;
    const int words = imax(imax(fwd_words(TM, KS, stages, N), du), 4 * kThreads);
    return (size_t)words * 4;
}

// Bytes of a span of n floats at src that one bulk copy can take: the
// 16-byte multiple when src is 16-byte aligned, else none.
__device__ __forceinline__ uint32_t bulk_bytes(const float* src, int n) {
    return (reinterpret_cast<uintptr_t>(src) & 15) ? 0u : (uint32_t)(n * 4) & ~15u;
}
// 16 (4) bytes global → shared, or as many zero bytes where !ok (src must be
// a valid address either way)
__device__ __forceinline__ void cp_async16z(void* dst, const void* src, bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4z(void* dst, const void* src, bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(ok ? 4 : 0) : "memory");
}
// An mbarrier of `count` arrivals a phase.
__device__ __forceinline__ void mbar_init_count(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
// This thread's arrival on bar, once its earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// The executing thread's earlier accesses, in the generic proxy, ordered
// before its later ones in the async proxy (TMA), in every state space.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async;\n" ::: "memory"); }

// acc[i][j] += a[i]·b[j] for the M m-tiles i of a warp and its n-tiles j < n,
// float32-accurate from TF32 parts. b[j] = {big b0, big b1, small b0, small
// b1} of n-tile j's fragment, at stride 32 uint4, loaded once for the M
// m-tiles. The n-tiles go in groups of G (M·G = 4 accumulators), a warp-
// uniform branch past the last live group, so that a short run issues no
// products for the n-tiles it lacks; in a group all small·big terms, then
// big·small, then big·big, four independent products in a row; the next
// group's fragments are loaded before this group's products.
template <int M, int J>
__device__ __forceinline__ void warp_products(float (&acc)[M][J][4], const uint32_t (&ab)[M][4],
                                              const uint32_t (&as)[M][4], const uint4* b, int n) {
    constexpr int G = 4 / M;
    static_assert(J % G == 0, "a run holds whole groups");
    uint4 f[G], nxt[G];
#pragma unroll
    for (int q = 0; q < G; ++q)
        if (q < n) f[q] = b[q * 32];
#pragma unroll
    for (int j0 = 0; j0 < J; j0 += G) {
        if (j0 >= n) break;
#pragma unroll
        for (int q = 0; q < G; ++q)
            if (j0 + G + q < n) nxt[q] = b[(j0 + G + q) * 32];
#pragma unroll
        for (int q = 0; q < G; ++q)
#pragma unroll
            for (int i = 0; i < M; ++i)
                if (j0 + q < n) mma_tf32(acc[i][j0 + q], as[i], f[q].x, f[q].y);
#pragma unroll
        for (int q = 0; q < G; ++q)
#pragma unroll
            for (int i = 0; i < M; ++i)
                if (j0 + q < n) mma_tf32(acc[i][j0 + q], ab[i], f[q].z, f[q].w);
#pragma unroll
        for (int q = 0; q < G; ++q)
#pragma unroll
            for (int i = 0; i < M; ++i)
                if (j0 + q < n) mma_tf32(acc[i][j0 + q], ab[i], f[q].x, f[q].y);
#pragma unroll
        for (int q = 0; q < G; ++q) f[q] = nxt[q];
    }
}

// The grid is (grid_x) blocks, one per SM; a tile is TM = 16·kMI·WM bins.
// usp: U split (ceil(ceil8(NB) / KS) k-slabs of KS / 8 k-steps × NT
// n-tiles × 32 lanes, uint4). part: K2's R partial rows of DW4 float4 (dU,
// NB·N row-major), then (K1 and K2) a value per block. out: K1 [ll]; K2
// [dU (DW4 float4), ll]. bar: 2 words, zeroed before the first call.
template <bool kGrad, int kMI>
__global__ void __launch_bounds__(kThreads, 1)
fused_ll_wide_tiles(const float* __restrict__ x_f, const float* __restrict__ u,
                    const float* __restrict__ i_rest, const float* __restrict__ s,
                    float* __restrict__ d_irest, uint4* __restrict__ usp, float* __restrict__ part,
                    float* __restrict__ out, unsigned* __restrict__ bar, int T, int NB, int N, int KS,
                    int NSTG, int WM, int P, int TC, float dt, float log_dt) {
    constexpr int kRun = kMI == 2 ? kFwdRun2 : kFwdRun1;
    extern __shared__ __align__(16) float smem[];
    __shared__ __align__(8) uint64_t s_bar;      // a tile's I_rest and S have landed
    __shared__ __align__(8) uint64_t s_full[4];  // a ring stage's slabs have landed
    __shared__ __align__(8) uint64_t s_p2;       // a phase-2 group of chunk copies has landed
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int TM = 16 * kMI * WM;
    const int NT = (N + 7) >> 3, KSS = KS >> 3, XS = KS + 4;
    const int NSL = cdiv(ceil_to(NB, 8), KS);  // k-slabs of a tile
    const int SLAB = slab_words(TM, KS, NT);
    const int n_tiles = cdiv(T, TM);
    const int DW4 = kGrad ? cdiv(NB * N, 4) : 0, R = kGrad ? (int)gridDim.x / P : 0;
    float* llp = part + (size_t)R * DW4 * 4;  // a value per block
    float* s_ir = smem + NSTG * SLAB;
    float* s_s = s_ir + ceil_to(TM * N, 4);
    // X_f's rows start on 16 bytes: it moves 16 bytes a cp.async, else 4
    const bool vec = (NB & 3) == 0 && (reinterpret_cast<uintptr_t>(x_f) & 15) == 0;
    // dI_rest leaves as (2t, 2t + 1) pairs: N even, 8-byte aligned
    const bool pairs = (N & 1) == 0 && (reinterpret_cast<uintptr_t>(d_irest) & 7) == 0;

    // The ring's and phase 2's barriers complete on every thread's cp.async
    // arrival and thread 0's bulk-copy bytes.
    if (tid == 0) {
        mbar_init(&s_bar);
        for (int q = 0; q < NSTG; ++q) mbar_init_count(&s_full[q], kThreads + 1);
        mbar_init_count(&s_p2, kThreads + 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // A tile's I_rest and S: two contiguous spans of rows·N floats, each by
    // one TMA bulk copy from thread 0 onto s_bar; what a bulk copy cannot
    // take (a tail under 16 bytes, or a span whose source is not 16-byte
    // aligned) by plain loads, read only after later barriers.
    auto issue_io = [&](int tile) {
        const int t0 = tile * TM, n = imin(TM, T - t0) * N;
        const float* src[2] = {i_rest + (size_t)t0 * N, s + (size_t)t0 * N};
        float* dst[2] = {s_ir, s_s};
        const uint32_t bytes[2] = {bulk_bytes(src[0], n), bulk_bytes(src[1], n)};
        if (tid == 0) {
            // the buffers' earlier reads, in the generic proxy, are ordered
            // before the bulk copies' writes
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_expect_tx(&s_bar, bytes[0] + bytes[1]);
            for (int q = 0; q < 2; ++q)
                if (bytes[q]) bulk_copy(dst[q], src[q], bytes[q], &s_bar);
        }
        for (int q = 0; q < 2; ++q)
            for (int i = (int)(bytes[q] >> 2) + tid; i < n; i += kThreads) dst[q][i] = src[q][i];
    };
    if ((int)blockIdx.x < n_tiles) issue_io(blockIdx.x);

    // -- phase 0: U split into TF32 big and small parts, once per call, by
    // all blocks; zero past NB rows and N columns
    {
        const int nf = NSL * KSS * NT * 32;
        for (int f = blockIdx.x * kThreads + tid; f < nf; f += gridDim.x * kThreads) {
            const int l = f & 31, q = f >> 5, j = q % NT, ks = q / NT;
            const int k = 8 * ks + (l & 3), c = 8 * j + (l >> 2);
            const float v0 = c < N && k < NB ? __ldg(u + (size_t)k * N + c) : 0.f;
            const float v1 = c < N && k + 4 < NB ? __ldg(u + (size_t)(k + 4) * N + c) : 0.f;
            uint4 b;
            split_tf32(v0, b.x, b.z);
            split_tf32(v1, b.y, b.w);
            usp[f] = b;
        }
    }
    grid_barrier(bar);

    // -- phase 1: the forward, tile by tile, and the value (K2: dI_rest).
    // Warp (wm, wn) owns m-tiles kMI·wm, ... of the tile and n-tiles [nlo,
    // nlo + ntw); a lane's entries are rows 16·m + g (+ 8), columns 8·n + 2t
    // (+ 1) of the tile.
    const int WN = kWarps / WM, wm = warp % WM, wn = warp / WM;
    const int nlo = wn * NT / WN, ntw = (wn + 1) * NT / WN - nlo;
    const int my_tiles = (int)blockIdx.x < n_tiles ? cdiv(n_tiles - blockIdx.x, gridDim.x) : 0;
    const int steps = my_tiles * NSL;  // (tile, k-slab) pairs, in order
    // step's X_f and U slabs into stage step % NSTG, completing on its
    // barrier: U's slab (contiguous in usp) by one TMA bulk copy from thread
    // 0, X_f's slab by cp.async from every thread, 16 bytes a thread where
    // its rows are 16-byte aligned, else 4
    auto issue = [&](int step) {
        if (step >= steps) return;
        const int st = step % NSTG, t0 = (blockIdx.x + step / NSL * gridDim.x) * TM, k0 = step % NSL * KS;
        const int rows = imin(TM, T - t0), kw = imin(KS, NB - k0);
        float* sx = smem + st * SLAB;
        if (tid == 0) {
            const uint32_t ubytes = KSS * NT * 512;
            fence_proxy_async();  // the stage's earlier reads precede the copy's writes
            mbar_expect_tx(&s_full[st], ubytes);
            bulk_copy(sx + TM * XS, usp + (size_t)(step % NSL) * KSS * NT * 32, ubytes, &s_full[st]);
        }
        if (vec) {
            const int q4 = KS >> 2;  // 16-byte words a slab row
            for (int i = tid; i < TM * q4; i += kThreads) {
                const int r = i / q4, c = 4 * (i - r * q4);
                const bool ok = r < rows && c < kw;
                cp_async16z(sx + r * XS + c, ok ? x_f + (size_t)(t0 + r) * NB + k0 + c : x_f, ok);
            }
        } else {
            for (int i = tid; i < TM * KS; i += kThreads) {
                const int r = i / KS, c = i - r * KS;
                const bool ok = r < rows && c < kw;
                cp_async4z(sx + r * XS + c, ok ? x_f + (size_t)(t0 + r) * NB + k0 + c : x_f, ok);
            }
        }
        cp_async_arrive(&s_full[st]);
    };

    // A k-slab's products go to fresh accumulators (fr), added to the
    // tile's sums (acc) once per slab: the tensor cores' float32
    // accumulation rounds toward zero, which over a tile's hundreds of
    // products into one sum of a few units lost 4e-5 of I at NB = 1395.
    float acc[kMI][kRun][4], fr[kMI][kRun][4];
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kRun; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
    // the value: each tile's terms a thread summed into part_v, the parts
    // added into ll with Kahan's compensation (ll_c)
    float ll = 0.f, ll_c = 0.f;
    for (int q = 0; q < NSTG - 1; ++q) issue(q);
    for (int step = 0; step < steps; ++step) {
        __syncthreads();  // the stage refilled next was read by every warp
        issue(step + NSTG - 1);
        mbar_wait(&s_full[step % NSTG], (step / NSTG) & 1);  // step's slabs are in place
        const float* sx = smem + step % NSTG * SLAB;
        const uint4* su = reinterpret_cast<const uint4*>(sx + TM * XS) + nlo * 32 + lane;
        const float* xa = sx + (16 * kMI * wm + g) * XS + t;
        // the A fragments of k-step kk, split; the next k-step's are read
        // and split before this one's products
        auto load_a = [&](int kk, uint32_t (&ab)[kMI][4], uint32_t (&as)[kMI][4]) {
#pragma unroll
            for (int i = 0; i < kMI; ++i) {
                const float* xm = xa + 16 * i * XS + 8 * kk;
                split_tf32(xm[0], ab[i][0], as[i][0]);
                split_tf32(xm[8 * XS], ab[i][1], as[i][1]);
                split_tf32(xm[4], ab[i][2], as[i][2]);
                split_tf32(xm[8 * XS + 4], ab[i][3], as[i][3]);
            }
        };
        uint32_t ab[kMI][4], as[kMI][4], nb[kMI][4], ns[kMI][4];
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
            for (int j = 0; j < kRun; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) fr[i][j][c] = 0.f;
        load_a(0, ab, as);
        for (int kk = 0; kk < KSS; ++kk) {
            if (kk + 1 < KSS) load_a(kk + 1, nb, ns);
            warp_products(fr, ab, as, su + kk * NT * 32, ntw);
#pragma unroll
            for (int i = 0; i < kMI; ++i)
#pragma unroll
                for (int q = 0; q < 4; ++q) ab[i][q] = nb[i][q], as[i][q] = ns[i][q];
        }
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
            for (int j = 0; j < kRun; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[i][j][c] += fr[i][j][c];
        if (step % NSL != NSL - 1) continue;

        // the tile's epilogue
        const int tix = step / NSL, tile = blockIdx.x + tix * gridDim.x, t0 = tile * TM;
        const int rows = imin(TM, T - t0);
        mbar_wait(&s_bar, tix & 1);  // the tile's I_rest and S
        float part_v = 0.f;
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
            for (int j = 0; j < kRun; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = 16 * (kMI * wm + i) + g + 8 * h, col = 8 * (nlo + j) + 2 * t;
                    if (j < ntw && r < rows && col < N) {  // the ragged tile, the padded columns
                        float d[2];
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const bool live = col + e < N;
                            const float i_raw = (live ? s_ir[r * N + col + e] : 0.f) + acc[i][j][2 * h + e];
                            const float I = fminf(fmaxf(i_raw, -EXP_CLIP), EXP_CLIP);
                            const float rate_dt = expf(I) * dt;
                            const float spikes = live ? s_s[r * N + col + e] : 0.f;
                            if (live) part_v += spikes * (I + log_dt) - rate_dt;
                            // the clip's gradient is 0 outside the active range
                            d[e] = fabsf(i_raw) < EXP_CLIP ? spikes - rate_dt : 0.f;
                        }
                        if (kGrad) {
                            float* dst = d_irest + (size_t)(t0 + r) * N + col;
                            if (pairs) {
                                *reinterpret_cast<float2*>(dst) = make_float2(d[0], d[1]);
                            } else {
                                dst[0] = d[0];
                                if (col + 1 < N) dst[1] = d[1];
                            }
                        }
                    }
#pragma unroll
                    for (int e = 0; e < 2; ++e) acc[i][j][2 * h + e] = 0.f;
                }
        const float y = part_v - ll_c, sum = ll + y;
        ll_c = (sum - ll) - y;
        ll = sum;
        if (tix + 1 < my_tiles) {
            __syncthreads();  // the tile's I_rest and S are read
            issue_io(tile + gridDim.x);
        }
    }
    const float v = block_sum(ll);
    if (tid == 0) llp[blockIdx.x] = v;

    if constexpr (kGrad) {
        // -- phase 2: dU = X_fᵀ·dI, block (p, r) on part p over chunks r,
        // r + R, ... of TC bins; warp w on run p·kWarps + w: m-tiles 2·mp
        // and 2·mp + 1, n-tiles [dlo, dlo + ntd)
        grid_barrier(bar);  // every tile's dI is written
        const int NR = du_ranges(NT), runs = du_runs(NB, N);
        const int p = blockIdx.x / R, r = blockIdx.x - p * R;
        const int run = p * kWarps + warp;
        const bool live = p < P && run < runs;
        const int mp = live ? run / NR : 0, rr = live ? run - mp * NR : 0;
        const int dlo = rr * NT / NR, ntd = live ? (rr + 1) * NT / NR - dlo : 0;
        const int mp_lo = p * kWarps / NR, col0 = 32 * mp_lo;  // the part's first pair, its X_f column
        const int XPW = 32 * part_pairs(NB, N), XS2 = part_stride(NB, N);
        // two buffers each of the chunks' X_f part columns, their dI and
        // their dI split into B fragments: chunk c + 1's dI is split while
        // chunk c's products run, chunk c + 1's X_f and chunk c + 2's dI land
        const int XW = TC * XS2, DW = ceil_to(TC * N, 4), SW = (TC >> 3) * NT * 128;
        float* s_x2 = smem;
        float* s_d2 = s_x2 + 2 * XW;
        uint4* s_sp = reinterpret_cast<uint4*>(s_d2 + 2 * DW);
        // block (p, r)'s bins: an even share of the k-steps (8 bins) over
        // the R ranges, in chunks of TC bins from its first
        const int kt = cdiv(T, 8), b_lo = 8 * (int)((long long)r * kt / R);
        const int b_hi = imin(T, 8 * (int)((long long)(r + 1) * kt / R));
        const int my_chunks = p < P && b_hi > b_lo ? cdiv(b_hi - b_lo, TC) : 0;
        auto chunk_t0 = [&](int ci) { return b_lo + ci * TC; };
        auto chunk_rows = [&](int ci) { return imin(TC, b_hi - chunk_t0(ci)); };
        // A group of chunk copies completes on s_p2: a chunk's dI span by a
        // TMA bulk copy from thread 0, and cp.async from every thread (X_f's
        // part columns, 16 bytes a thread where its rows are 16-byte aligned,
        // else 4; a dI tail under 16 bytes).
        const int cw = imin(XPW, NB - col0);  // the part's live X_f columns
        auto d_bytes = [&](int ci) { return ci < my_chunks ? (uint32_t)(chunk_rows(ci) * N * 4) & ~15u : 0u; };
        auto issue_x = [&](int ci) {  // chunk ci's X_f part columns into buffer ci % 2
            if (ci >= my_chunks) return;
            const int t0 = chunk_t0(ci), rows = chunk_rows(ci);
            float* bx = s_x2 + (ci & 1) * XW;
            if (vec) {
                const int q4 = XPW >> 2;
                for (int i = tid; i < TC * q4; i += kThreads) {
                    const int rw = i / q4, c = 4 * (i - rw * q4);
                    const bool ok = rw < rows && c < cw;
                    cp_async16z(bx + rw * XS2 + c, ok ? x_f + (size_t)(t0 + rw) * NB + col0 + c : x_f, ok);
                }
            } else {
                for (int i = tid; i < TC * XPW; i += kThreads) {
                    const int rw = i / XPW, c = i - rw * XPW;
                    const bool ok = rw < rows && c < cw;
                    cp_async4z(bx + rw * XS2 + c, ok ? x_f + (size_t)(t0 + rw) * NB + col0 + c : x_f, ok);
                }
            }
        };
        auto issue_d = [&](int ci) {  // chunk ci's dI rows (16-byte aligned: t0 is a multiple of 8)
            if (ci >= my_chunks) return;
            const float* src = d_irest + (size_t)chunk_t0(ci) * N;
            float* bd = s_d2 + (ci & 1) * DW;
            const uint32_t nb = d_bytes(ci);
            if (tid == 0 && nb) bulk_copy(bd, src, nb, &s_p2);
            for (int i = (int)(nb >> 2) + tid; i < chunk_rows(ci) * N; i += kThreads) cp_async4z(bd + i, src + i, true);
        };
        // the X_f of chunk xi and the dI of chunks d0 and d1 (d1 < 0: none) as one group
        auto issue_group = [&](int xi, int d0, int d1) {
            if (tid == 0) {
                fence_proxy_async();  // earlier reads, and phase 1's dI writes, precede the copies
                mbar_expect_tx(&s_p2, d_bytes(d0) + (d1 < 0 ? 0u : d_bytes(d1)));
            }
            issue_x(xi);
            issue_d(d0);
            if (d1 >= 0) issue_d(d1);
            cp_async_arrive(&s_p2);
        };
        // chunk ci's dI split into B fragments {big b0, big b1, small b0,
        // small b1} (b0 = dI[8ks + lane % 4][8j + lane / 4], b1 four rows
        // below) for its live k-steps, zero past its rows and N
        auto split_d = [&](int ci) {
            if (ci >= my_chunks) return;
            const int rows = chunk_rows(ci);
            const float* bd = s_d2 + (ci & 1) * DW;
            uint4* sp = s_sp + (ci & 1) * (SW >> 2);
            for (int f = tid; f < cdiv(rows, 8) * NT * 32; f += kThreads) {
                const int l = f & 31, q = f >> 5, j = q % NT, ks = q / NT;
                const int k = 8 * ks + (l & 3), c = 8 * j + (l >> 2);
                const float v0 = c < N && k < rows ? bd[k * N + c] : 0.f;
                const float v1 = c < N && k + 4 < rows ? bd[(k + 4) * N + c] : 0.f;
                uint4 b;
                split_tf32(v0, b.x, b.z);
                split_tf32(v1, b.y, b.w);
                sp[f] = b;
            }
        };

        float run_sum[2][kDuRun][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < kDuRun; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) run_sum[i][j][c] = 0.f;
        int phase2 = 0;  // s_p2's phase
        issue_group(0, 0, 1);
        mbar_wait(&s_p2, phase2++ & 1);
        __syncthreads();
        split_d(0);
        // chunk 0's split is whole before its products read it, and its dI
        // buffer is read before the loop's first group refills it (chunk 2)
        __syncthreads();
        for (int ci = 0; ci < my_chunks; ++ci) {
            // chunk ci's X_f and split dI and chunk ci + 1's dI are in place;
            // the buffers refilled here were read before the last barrier
            issue_group(ci + 1, ci + 2, -1);
            split_d(ci + 1);
            if (ntd > 0) {
                float cacc[2][kDuRun][4];
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int j = 0; j < kDuRun; ++j)
#pragma unroll
                        for (int c = 0; c < 4; ++c) cacc[i][j][c] = 0.f;
                // A = X_fᵀ: A[g][t] = X_f[8ks + t][16m + g], rows of XS2 words
                const float* xa = s_x2 + (ci & 1) * XW + t * XS2 + 32 * (mp - mp_lo) + g;
                const uint4* db = s_sp + (ci & 1) * (SW >> 2) + dlo * 32 + lane;
                auto load_a = [&](int ks, uint32_t (&ab)[2][4], uint32_t (&as)[2][4]) {
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        const float* xk = xa + 8 * ks * XS2 + 16 * i;
                        split_tf32(xk[0], ab[i][0], as[i][0]);
                        split_tf32(xk[8], ab[i][1], as[i][1]);
                        split_tf32(xk[4 * XS2], ab[i][2], as[i][2]);
                        split_tf32(xk[4 * XS2 + 8], ab[i][3], as[i][3]);
                    }
                };
                uint32_t ab[2][4], as[2][4], nb[2][4], ns[2][4];
                load_a(0, ab, as);
                const int kl = cdiv(chunk_rows(ci), 8);  // the chunk's live k-steps
                for (int ks = 0; ks < kl; ++ks) {
                    if (ks + 1 < kl) load_a(ks + 1, nb, ns);
                    warp_products(cacc, ab, as, db + ks * NT * 32, ntd);
#pragma unroll
                    for (int i = 0; i < 2; ++i)
#pragma unroll
                        for (int q = 0; q < 4; ++q) ab[i][q] = nb[i][q], as[i][q] = ns[i][q];
                }
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int j = 0; j < kDuRun; ++j)
#pragma unroll
                        for (int c = 0; c < 4; ++c) run_sum[i][j][c] += cacc[i][j][c];
            }
            mbar_wait(&s_p2, phase2++ & 1);
            __syncthreads();
        }
        // The runs' sums into partial row r: staged in shared memory as the
        // part's rows of dU (from row r0p), then written out row-major, each
        // entry whose run is the part's (column block j of pair mp is run
        // mp·NR + ((j + 1)·NR − 1) / NT).
        const int r0p = 32 * mp_lo, r1p = imin(NB, 32 * (mp_lo + part_pairs(NB, N)));
        if (ntd > 0)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < kDuRun; ++j)
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const int mr = 16 * (2 * mp + i) + g + ((c >> 1) << 3);
                        const int nc = 8 * (dlo + j) + 2 * t + (c & 1);
                        if (j < ntd && mr < NB && nc < N) smem[(mr - r0p) * N + nc] = run_sum[i][j][c];
                    }
        __syncthreads();
        if (p < P) {
            float* row = part + (size_t)r * DW4 * 4 + (size_t)r0p * N;
            for (int e = tid; e < (r1p - r0p) * N; e += kThreads) {
                const int mr = e / N, nc = e - mr * N;
                const int run_e = (r0p + mr) / 32 * NR + ((nc / 8 + 1) * NR - 1) / NT;
                if (run_e >= p * kWarps && run_e < imin(runs, (p + 1) * kWarps)) row[e] = smem[e];
            }
        }
    }

    // -- after a grid barrier: dU's R partial rows summed, a slice of the
    // columns a block, in a fixed order; the blocks' values by block 0 in
    // block order
    grid_barrier(bar);
    if (kGrad) sum_part_rows(part, out, DW4, R, smem);
    if (blockIdx.x == 0) {
        float a = 0.f;
        for (int b = tid; b < (int)gridDim.x; b += kThreads) a += __ldcg(llp + b);
        a = block_sum(a);
        if (tid == 0) out[DW4 * 4] = a;
    }
}

template <bool kGrad, int kMI>
cudaError_t launch_mi(const float* x_f, const float* u, const float* i_rest, const float* s, float* d_irest,
                      uint4* usp, float* part, float* out, unsigned* bar, int T, int NB, int N, int k_slab,
                      int stages, int m_warps, int parts, int chunk, int grid_x, int smem_bytes, int device,
                      float dt, float log_dt, cudaStream_t stream) {
    static int attr_bytes[kMaxDevices];  // the shared-memory attribute set so far, per device
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (attr_bytes[device] < smem_bytes) {
        err = cudaFuncSetAttribute(fused_ll_wide_tiles<kGrad, kMI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes);
        if (err != cudaSuccess) return err;
        attr_bytes[device] = smem_bytes;
    }
    // cooperative: the runtime refuses a grid whose blocks cannot all be
    // resident at once, which the grid barriers need
    void* args[] = {&x_f, &u, &i_rest, &s, &d_irest, &usp, &part, &out, &bar, &T, &NB, &N,
                    &k_slab, &stages, &m_warps, &parts, &chunk, &dt, &log_dt};
    return cudaLaunchCooperativeKernel((const void*)fused_ll_wide_tiles<kGrad, kMI>, dim3(grid_x),
                                       dim3(kThreads), args, (size_t)smem_bytes, stream);
}

template <bool kGrad>
cudaError_t launch(const float* x_f, const float* u, const float* i_rest, const float* s,
                   float* d_irest, uint4* usp, float* part, float* out, unsigned* bar, int T, int NB,
                   int N, int tile_t, int k_slab, int stages, int m_warps, int m_tiles, int parts, int chunk,
                   int grid_x, int smem_bytes, int device, float dt, float log_dt, cudaStream_t stream) {
    if (device < 0 || device >= kMaxDevices || grid_x < 1) return cudaErrorInvalidValue;
    const int NT = (N + 7) / 8;
    if (!(m_warps == 1 || m_warps == 2 || m_warps == 4 || m_warps == 8) || !(m_tiles == 1 || m_tiles == 2) ||
        tile_t != 16 * m_tiles * m_warps)
        return cudaErrorInvalidValue;
    const int WN = kWarps / m_warps;  // every warp owns at least one n-tile, at most its run
    if (WN > NT || cdiv(NT, WN) > (m_tiles == 2 ? kFwdRun2 : kFwdRun1)) return cudaErrorInvalidValue;
    if (!(k_slab == 8 || k_slab == 16 || k_slab == 32) || stages < 2 || stages > 4) return cudaErrorInvalidValue;
    if (kGrad ? parts != du_parts(NB, N) || grid_x < parts || chunk < 8 || chunk > 64 || chunk % 8
              : parts != 0 || chunk != 0)
        return cudaErrorInvalidValue;
    if ((size_t)smem_bytes != smem_bytes_wide(NB, N, tile_t, k_slab, stages, chunk)) return cudaErrorInvalidValue;
    return (m_tiles == 2 ? launch_mi<kGrad, 2> : launch_mi<kGrad, 1>)(
        x_f, u, i_rest, s, d_irest, usp, part, out, bar, T, NB, N, k_slab, stages, m_warps, parts, chunk, grid_x,
        smem_bytes, device, dt, log_dt, stream);
}

}  // namespace

// K1, column-group instance. out[0] = ll. usp: U split (ops/kernels.py
// wide_split_words floats); part: grid_x floats; out: 4 floats; parts and
// chunk 0; bar: 2 words, zeroed before the first call on the stream.
extern "C" int fused_ll_fwd_wide(const float* x_f, const float* u, const float* i_rest, const float* s,
                                 void* usp, float* part, float* out, unsigned* bar, int T, int NB, int N,
                                 int tile_t, int k_slab, int stages, int m_warps, int m_tiles, int parts,
                                 int chunk, int grid_x, int smem_bytes, int device, float dt, float log_dt,
                                 void* stream) {
    return (int)launch<false>(x_f, u, i_rest, s, nullptr, (uint4*)usp, part, out, bar, T, NB, N, tile_t,
                              k_slab, stages, m_warps, m_tiles, parts, chunk, grid_x, smem_bytes, device, dt,
                              log_dt, (cudaStream_t)stream);
}

// K2, column-group instance. out[0 : NB·N] = dU (row-major (NB, N)),
// out[4·ceil(NB·N / 4)] = ll; d_irest (T, N). part: R = grid_x / parts rows
// of 4·ceil(NB·N / 4) floats, then grid_x floats; out: 4·ceil(NB·N / 4) + 4
// floats; usp and bar as K1's.
extern "C" int fused_ll_vg_wide(const float* x_f, const float* u, const float* i_rest, const float* s,
                                float* d_irest, void* usp, float* part, float* out, unsigned* bar, int T,
                                int NB, int N, int tile_t, int k_slab, int stages, int m_warps, int m_tiles,
                                int parts, int chunk, int grid_x, int smem_bytes, int device, float dt,
                                float log_dt, void* stream) {
    return (int)launch<true>(x_f, u, i_rest, s, d_irest, (uint4*)usp, part, out, bar, T, NB, N, tile_t,
                             k_slab, stages, m_warps, m_tiles, parts, chunk, grid_x, smem_bytes, device, dt,
                             log_dt, (cudaStream_t)stream);
}

extern "C" const char* fused_ll_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
