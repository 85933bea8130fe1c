// Fused coupling matmul + Poisson log-likelihood, hand-written for Hopper
// (sm_90a), bound to PyTorch through a plain C interface and ctypes
// (theano_pyglm_torch/ops/cuda_loader.py, ops/kernels.py).
//
// Replaces the Pallas TPU kernels of theano_pyglm_tpu/ops/pallas_kernels.py:
//   K1  _fwd_kernel (:73, value only)          -> fused_ll_fwd
//   K2  _vg_kernel  (:100, one-pass value+grad) -> fused_ll_vg
// and the chain-batched rules that its custom_vmap reaches under a vmap over
// chains (plain XLA there, not pallas_calls):
//   K3  _ll_chains_xla (:213, value per chain)  -> fused_ll_fwd_chains
//       _vg_chains_xla (:164, value+grad)       -> fused_ll_vg_chains
//
//   I_raw = I_rest + X_f @ U        X_f (T, NB), U (NB, N), I_rest and S (T, N)
//   I     = clip(I_raw, ±EXP_CLIP)
//   ll    = Σ S·(I + log dt) − e^I·dt
//   K2 also: dI_rest = (S − e^I·dt)·1{|I_raw| < EXP_CLIP}   (T, N)
//            dU      = X_fᵀ @ dI_rest                       (NB, N)
// Both cotangents are for a unit output cotangent; the autograd Function
// scales them.
//
// Bounds on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 outside the
// tensor cores) at the flagship shape T=60,000, NB=135, N=27, each byte read
// or written once: K1 moves 45.4 MB (X_f 32.4, I_rest and S 6.5 each) in
// 13.5 us and does 0.437 GFLOP in 6.5 us, so HBM bounds it at 13.5 us. K2
// adds dI_rest (6.5 MB) and dU: 51.9 MB in 15.5 us against 0.875 GFLOP in
// 13.1 us, HBM-bound with the float32 FMA pipe close behind. At the long
// recording's shape T=600,000, NB=500, N=100 the operations bound both:
// K1 60 GFLOP in 0.90 ms, K2 120 GFLOP in 1.79 ms (their bytes, 1.68 and
// 1.92 GB, take 0.50 and 0.57 ms).
//
// The first version (one thread per (bin, neuron) current and per dU entry)
// read both operands of every FMA from shared memory; copied each 64-bin
// tile global→register→shared between two barriers with nothing in flight
// during the math; ran 2 blocks of 256 threads per SM with a ~13 % ragged
// tail; and summed the blocks' partial rows in a second launch, after a
// cudaSetDevice and a cudaFuncSetAttribute on every call. It ran at 8–12 %
// of the bounds.
//
// This design, one persistent block of 256 threads per SM:
// - The forward product on the tensor cores in split-precision TF32
//   ("3xTF32"): each float32 operand a is split into a_big = tf32(a) and
//   a_small = tf32(a − a_big) and a·b is accumulated in float32 as
//   a_small·b_big + a_big·b_small + a_big·b_big with mma.sync.m16n8k8, which
//   keeps float32 accuracy (plain TF32 would not meet the tests' limits). A
//   warp owns a 16-bin × 32-neuron unit of the tile: per 8-wide k-step one A
//   fragment of X_f feeds four n-tiles of U, and the products go to two
//   accumulator sets so that consecutive mma.sync are independent. A
//   register-tiled float32 FMA forward (4 × 4 per thread, float4 operand
//   reads) took over twice as long: its two operand floats per four FMAs
//   kept the shared-memory pipe, not the FMA pipe, busy.
// - K2's dU = X_fᵀ·dI in float32 FMA, in registers for the whole kernel: a
//   thread owns a 9 (NB) × 7 (N) micro-tile (135 = 15·9 and 27 ≤ 4·7 waste
//   little at the flagship shape), and the 4 threads that share one each
//   take every fourth bin; the four sums are joined once, at the end, in a
//   fixed order. At most 32 threads share a micro-tile: uncapped, the one
//   micro-tile of NB·N = 5 had 256 sharers, joined by one thread in
//   series, and K2 took 60 us there (32 us capped). A 3xTF32 mma version
//   of this product ran over twice as slow: its B operand changes with
//   every n-tile, so each product paid for its own split and selects. dU
//   is written once per block; where its micro-tiles outnumber 256
//   threads, blockIdx.y splits them, each y recomputes the currents it
//   needs, and only y = 0 writes dI_rest and the value. wgmma is not used: at N=27 its 64-row tiles would mostly multiply
//   padding, and its TF32 form wants both operands K-major, which Xᵀ·dI
//   does not give without a transpose.
// - Asynchronous double-buffered copies: with one column group a tile's
//   X_f, I_rest and S are three contiguous spans (tile_t is a multiple of
//   4, so each starts on 16 bytes), each moved by one TMA bulk copy
//   (cp.async.bulk, completing on the stage's mbarrier) into the other
//   stage while the current tile computes.
//   K2 overwrites the tile's I_rest with dI in place and writes it out
//   coalesced.
// - The wrapper (ops/kernels.py, launch_plan) picks the tile so that every
//   block gets the same number of tiles, give or take one (60,000 bins: 518
//   tiles of 116 over 132 blocks, the longest block 2 % above the mean).
// - Column groups. A block keeps U in shared memory, and all of U fits
//   only up to NB·N of about 8,000 words (NB = 5N: N ≤ 88). Column n of I,
//   dI_rest and dU depends on column n of U alone, so past that the N
//   columns are cut into the least number G of groups of W columns (W a
//   multiple of 8, the last group narrower) whose U slice and two 4-bin
//   stages fit (NB = 5N: G = 2 for 89 ≤ N ≤ 112, N = 100 in groups of 56
//   and 44). blockIdx.y = group·grid_y + dU slice; a block holds its
//   group's columns of U, the tile's whole X_f rows, and the group's I_rest
//   and S columns (rows N apart in memory, so cp.async moves them a word at
//   a time). G = 1 at every smaller shape, where the launch is the one
//   before groups. The cost: X_f is read once per group, G·|X_f| bytes
//   where the L2 does not serve the groups that work on one tile at about
//   the same time, and the forward product of a 16-bin tile gives a block
//   two units of work for eight warps (PERF.md §6).
// - One launch, deterministic. Each block writes its partial row (dU and
//   each group's ll) to scratch; the grid, launched cooperatively so that
//   all its blocks are resident, meets at a barrier of two integer words;
//   then every block sums a slice of the columns over the rows in a fixed
//   order, and with G > 1, after a second barrier, one thread adds the
//   groups' ll in group order. No float atomics: repeated runs give
//   identical bits.
// - The host sets the shared-memory attribute once per (kernel, device,
//   size) and calls cudaSetDevice only when the device is not current.
//
// What limits it (PERF.md §6, tools/kernel_probe.py): per tile, the 3xTF32
// products at the rate mma.sync gets on Hopper and K2's FMA product take
// longer than the tile's copies, and the prologue, the first tile's copy and
// the cross-block sums cost a fixed ~8 us a call. In column groups the
// forward product dominates: at N=100 a 16-bin tile gives a block 2
// forward units for 8 warps, and K2's two dU slices each redo them
// (without the forward, K2 takes 5.0 of its 14.8 ms at T=600,000).
//
// K3, the chain-batched pair: C chains of U (C, NB, N) and I_rest (C, T, N)
// against one X_f (T, NB) and one S (T, N), giving the C values, dU
// (C, NB, N) and dI_rest (C, T, N). The chain axis is a column axis of the
// same design: column c·N + n of the product reads U[c, :, n], I_rest[c, :, n]
// and S[:, n], so U sits in shared memory as (NB, C·N), and a tile's X_f and
// S are copied once and feed every chain (the shared read is the point: C
// calls of K2 read X_f C times). A stage holds C I_rest spans, one per chain,
// each one TMA bulk copy, and one S span. A forward unit's 32 columns may
// cross chains, so a thread keeps one compensated value per chain (at most
// kMaxChains) and the block joins them per chain, in a fixed order, into C
// values: no atomics, bit for bit. dU micro-tiles never cross a chain (a
// chain's N columns in ceil(N / kMtN) of them). At the flagship, C = 4:
// U is 135 × 108 (65 KB of shared memory), a tile 60 bins, dU 240
// micro-tiles (grid_y = 1). K3 takes one column group: the wrapper cuts the
// chains of a call whose C·N columns do not fit beside a 4-bin tile into
// groups that do, one launch each (ops/kernels.py chain_groups). Bounds at
// the flagship, C = 4: K3-vg does 3.50 GFLOP (52 us at 67 TFLOP/s) against
// 90.7 MB (27 us at 3.35 TB/s); K3-fwd 1.75 GFLOP (26 us) against 64.8 MB
// (19 us): the operations bound both.

#include "fused_ll_common.cuh"

#ifndef EXP_CLIP
#error "EXP_CLIP must come from theano_pyglm_torch/ops/clipping.py as -DEXP_CLIP"
#endif

namespace {

constexpr int kScratch = kThreads * 8;  // words for joining partial sums (≥ kThreads · kMtN)
constexpr int kMtM = 9, kMtN = 7;  // K2's dU micro-tile (ops/kernels.py DU_TILE): 135 = 15·9, 28 = 4·7
constexpr int kMaxSlices = 32;  // threads that share one dU micro-tile, at most
constexpr int kMaxChains = 8;  // K3's chains, at most (ops/kernels.py MAX_CHAINS)

// Shared-memory layout, in 32-bit words, mirrored by ops/kernels.py, for C
// chains (K1/K2: C = 1) of a column group of W neurons (W = N when one group
// holds them all; K3 takes one group):
//   U[:, group]     (ceil8(NB) × BS, BS = b_stride(C·W), zero-padded; K3:
//                   chain c's columns at c·N)
//   stage 0, 1      X_f (RT × NB, RT = ceil16(tile_t): the tile's rows as
//                   they lie in memory), then C I_rest spans (NS each; K2/K3
//                   turn them into dI), then S (NS), each of W columns with
//                   rows packed
//   scratch         (kScratch)
// Reads past a row's NB columns land in the next row (or, past the last, in
// I_rest) and meet zero rows of U or are discarded. The B-operand stride
// BS ≡ 8 (mod 16) makes U's fragment reads conflict-free. NS leaves 8 words
// after a tile's rows·W for the dU reads past its last neuron.
__host__ __device__ constexpr int stage_words(int NB, int W, int tile_t, int C) {
    return ceil_to(tile_t, 16) * NB + (C + 1) * n_span(W, tile_t);
}
size_t smem_bytes_for(int NB, int W, int tile_t, int C) {
    const size_t words =
        (size_t)ceil_to(NB, 8) * b_stride(C * W) + 2 * (size_t)stage_words(NB, W, tile_t, C);
    return (words + kScratch) * 4;
}

// Bytes of a span of n floats at src that one bulk copy can take: the
// 16-byte multiple when src is 16-byte aligned, else none.
__device__ __forceinline__ uint32_t bulk_bytes(const float* src, int n) {
    return (reinterpret_cast<uintptr_t>(src) & 15) ? 0u : (uint32_t)(n * 4) & ~15u;
}

// The grid is (grid_x, grid_y · G): blockIdx.y = group · grid_y + dU slice.
// part row b (one per blockIdx.x): K1 [ll of each group, pad]; K2 [dU (NB·N
// row-major), ll of each group, pad]; K3 (kChains: C chains, G = 1, W = N)
// [dU (C·NB·N, chain-major), ll of each chain, pad] (K3-fwd: no dU). bar: 2
// words, zeroed before the first call.
template <bool kGrad, bool kChains>
__global__ void __launch_bounds__(kThreads, 1)
fused_ll_tiles(const float* __restrict__ x_f, const float* __restrict__ u,
               const float* __restrict__ i_rest, const float* __restrict__ s,
               float* __restrict__ d_irest, float* __restrict__ part, float* __restrict__ out,
               unsigned* __restrict__ bar, int T, int NB, int N, int W, int tile_t, float dt,
               float log_dt, int C) {
    constexpr int NQ = kChains ? kMaxChains : 1;  // values a thread keeps: one per chain
    extern __shared__ __align__(16) float smem[];
    __shared__ __align__(8) uint64_t s_bar[2];  // a stage's bulk copies have landed
    const int nch = kChains ? C : 1;             // chains (a constant 1 for K1/K2)
    const int CN = nch * N;                      // columns of U, I and dU in all
    const int G = kChains ? 1 : (N + W - 1) / W, YS = gridDim.y / G;
    const int grp = blockIdx.y / YS, ys = blockIdx.y - grp * YS;
    const int c0 = grp * W, nc = kChains ? CN : min(W, N - c0);  // this block's columns
    const bool whole = kChains || nc == N;  // one group: I_rest and S tiles are contiguous
    const int rs = kChains ? N : nc;        // a row's words in an I_rest or S span
    const int KP = ceil_to(NB, 8), RT = ceil_to(tile_t, 16);
    const int BS = b_stride(nch * W), NS = n_span(W, tile_t);
    const int SW = stage_words(NB, W, tile_t, nch);
    const int NT = (nc + 7) >> 3;  // n-tiles of 8 columns
    const int NG = (NT + 3) >> 2;  // forward n-groups of 4 n-tiles
    float* s_u = smem;
    float* s_stage = s_u + (size_t)KP * BS;
    float* s_join = s_stage + 2 * (size_t)SW;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int n_tiles = (T + tile_t - 1) / tile_t;
    const bool lead_y = ys == 0;

    // Zero U and both stages (pads stay zero; words never copied stay
    // finite), before any copy lands in them.
    {
        float4* z = reinterpret_cast<float4*>(smem);
        const int n4 = (KP * BS + 2 * SW) >> 2;
        for (int i = tid; i < n4; i += kThreads) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (tid == 0) {
        mbar_init(&s_bar[0]);
        mbar_init(&s_bar[1]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // A tile's X_f is one contiguous span, and so is each I_rest span (K3:
    // one a chain) and the S span when one group holds all N columns: thread
    // 0 moves each span with one TMA bulk copy onto the stage's mbarrier, and
    // the threads copy what a bulk copy cannot take (a tail under 16 bytes,
    // or a whole span whose source is not 16-byte aligned) with cp.async, in
    // one group. A column group's I_rest and S rows lie N apart: cp.async
    // takes them a word at a time.
    auto issue = [&](int tile, int st) {
        const int t0 = tile * tile_t, rows = min(tile_t, T - t0);
        float* base = s_stage + (size_t)st * SW;
        if constexpr (!kChains) {
            float* dst[3] = {base, base + RT * NB, base + RT * NB + NS};
            const float* src[3] = {x_f + (size_t)t0 * NB, i_rest + (size_t)t0 * N + c0,
                                   s + (size_t)t0 * N + c0};
            const int span = whole ? rows * N : 0, strided = whole ? 0 : rows * nc;
            const int n[3] = {rows * NB, span, span};
            uint32_t bytes[3], total = 0;
            for (int q = 0; q < 3; ++q) total += bytes[q] = bulk_bytes(src[q], n[q]);
            if (tid == 0) {
                // this stage's earlier reads and writes, in the generic proxy,
                // are ordered before the bulk copies' writes
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                mbar_expect_tx(&s_bar[st], total);
                for (int q = 0; q < 3; ++q)
                    if (bytes[q]) bulk_copy(dst[q], src[q], bytes[q], &s_bar[st]);
            }
            for (int q = 0; q < 3; ++q)
                for (int i = (int)(bytes[q] >> 2) + tid; i < n[q]; i += kThreads) cp_async4(dst[q] + i, src[q] + i);
            for (int i = tid; i < strided; i += kThreads) {
                const int r = i / nc;
                const size_t o = (size_t)r * N + (i - r * nc);
                cp_async4(dst[1] + i, src[1] + o);
                cp_async4(dst[2] + i, src[2] + o);
            }
        } else {
            // span q: 0 X_f, 1..C the chains' I_rest, C + 1 S
            auto span = [&](int q, float*& dst, const float*& src) -> int {
                if (q == 0) {
                    dst = base, src = x_f + (size_t)t0 * NB;
                    return rows * NB;
                }
                dst = base + RT * NB + (q - 1) * NS;
                src = q <= C ? i_rest + ((size_t)(q - 1) * T + t0) * N : s + (size_t)t0 * N;
                return rows * N;
            };
            float* dst;
            const float* src;
            uint32_t total = 0;
            for (int q = 0; q < C + 2; ++q) {
                const int n = span(q, dst, src);
                total += bulk_bytes(src, n);
            }
            if (tid == 0) {
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                mbar_expect_tx(&s_bar[st], total);
                for (int q = 0; q < C + 2; ++q) {
                    const int n = span(q, dst, src);
                    const uint32_t bytes = bulk_bytes(src, n);
                    if (bytes) bulk_copy(dst, src, bytes, &s_bar[st]);
                }
            }
            for (int q = 0; q < C + 2; ++q) {
                const int n = span(q, dst, src);
                for (int i = (int)(bulk_bytes(src, n) >> 2) + tid; i < n; i += kThreads) cp_async4(dst + i, src + i);
            }
        }
    };
    // the block's columns of U into rows of BS words, 4 bytes a thread (K3:
    // column c·N + n from U[c, :, n])
    for (int e = tid; e < NB * nc; e += kThreads) {
        const int m = e / nc, col = e - m * nc;
        if (kChains) {
            const int ch = col / N;
            cp_async4(s_u + m * BS + col, u + ((size_t)ch * NB + m) * N + (col - ch * N));
        } else {
            cp_async4(s_u + m * BS + col, u + (size_t)m * N + c0 + col);
        }
    }
    cp_async_commit();
    issue(blockIdx.x, 0);
    cp_async_commit();

    // K2's and K3's dU: kMtM × kMtN micro-tiles in registers for the whole
    // kernel, float32 FMA. A micro-tile holds rows mg, mg + MG, ... of dU (so
    // that a warp's X_f reads fall in consecutive banks) and columns n0d,
    // n0d + 1, ... of one chain (K3: a chain's N columns in ngc micro-tile
    // columns). n_slices = THREADS / (this y-slice's micro-tiles) threads, at
    // most kMaxSlices, share one micro-tile, each taking every n_slices-th
    // bin of a tile; their sums are joined once, at the end, in a fixed
    // order. (The cap bounds the join: uncapped, one micro-tile at NB·N = 5
    // took 256 slices, summed by one thread.)
    const int ngc = ((kChains ? N : nc) + kMtN - 1) / kMtN;  // micro-tile columns of a chain
    const int ngd = nch * ngc, MG = (NB + kMtM - 1) / kMtM;
    const int y_items = kGrad ? min(kThreads, MG * ngd - ys * kThreads) : 0;
    const int n_slices = y_items > 0 ? min(kThreads / y_items, kMaxSlices) : 0;
    const int slice = y_items > 0 ? tid / y_items : 0;
    const int item_l = tid - slice * y_items;
    const bool owns_du = slice < n_slices;
    const int item = ys * kThreads + item_l;
    const int mg = owns_du ? item / ngd : 0;
    const int chd = kChains && owns_du ? (item % ngd) / ngc : 0;  // the micro-tile's chain (K3)
    const int n0d = owns_du ? (item % ngd - chd * ngc) * kMtN : 0;
    float du[kMtM][kMtN];
#pragma unroll
    for (int i = 0; i < kMtM; ++i)
#pragma unroll
        for (int j = 0; j < kMtN; ++j) du[i][j] = 0.f;

    // the value (K3: of each chain): each forward unit's 16 terms a thread
    // summed into part, the parts added into ll with Kahan's compensation
    // (ll_c). Added in plain sequence, at T=600,000 a thread's ~10,000 terms
    // lost 2e-5 of the value in float32.
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
        const float* sx = s_stage + (size_t)(k & 1) * SW;
        float* sir = s_stage + (size_t)(k & 1) * SW + RT * NB;  // I_rest, then (K2/K3) dI in place
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
            const float* xa = sx + (size_t)(r0 + g) * NB + t;
            const float* ub = s_u + t * BS + nt0 * 8 + g;
            for (int kk = 0; kk < KP; kk += 8) {
                uint32_t ab[4], as[4], bb[4][2], bs[4][2];
                split_tf32(xa[kk], ab[0], as[0]);
                split_tf32(xa[8 * NB + kk], ab[1], as[1]);
                split_tf32(xa[kk + 4], ab[2], as[2]);
                split_tf32(xa[8 * NB + kk + 4], ab[3], as[3]);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    split_tf32(ub[kk * BS + 8 * j], bb[j][0], bs[j][0]);
                    split_tf32(ub[(kk + 4) * BS + 8 * j], bb[j][1], bs[j][1]);
                }
                // 3xTF32: the small terms into acc_lo, big·big into acc_hi,
                // the n-tiles interleaved, so that consecutive products are
                // independent. n-tiles past NT multiply whatever follows U's
                // last columns (inside shared memory) and are never read.
#pragma unroll
                for (int j = 0; j < 4; ++j) mma_tf32(acc_lo[j], as, bb[j][0], bb[j][1]);
#pragma unroll
                for (int j = 0; j < 4; ++j) mma_tf32(acc_hi[j], ab, bb[j][0], bb[j][1]);
#pragma unroll
                for (int j = 0; j < 4; ++j) mma_tf32(acc_lo[j], ab, bs[j][0], bs[j][1]);
            }
            float part[NQ];
#pragma unroll
            for (int q = 0; q < NQ; ++q) part[q] = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int r = r0 + g + ((c >> 1) << 3), col = (nt0 + j) * 8 + 2 * t + (c & 1);
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
                                if (q == ch) part[q] += term;
                        } else {
                            part[0] += term;
                        }
                        if (kGrad)  // the clip's gradient is 0 outside the active range
                            sir[e] = fabsf(i_raw) < EXP_CLIP ? spikes - rate_dt : 0.f;
                    }
                }
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                const float y = part[q] - ll_c[q], sum = ll[q] + y;
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
            if (owns_du) {
                // X_f and dI rows lie NB and rs apart, so each operand is a
                // scalar read; rows past NB or columns past the chain's (or
                // group's) last read the next row and land in discarded sums
                const float* xm = sx + mg;
                const float* dp = sir + chd * NS + n0d;
#pragma unroll 2
                for (int r = slice; r < rows; r += n_slices) {
                    float xv[kMtM], dv[kMtN];
#pragma unroll
                    for (int i = 0; i < kMtM; ++i) xv[i] = xm[r * NB + i * MG];
#pragma unroll
                    for (int j = 0; j < kMtN; ++j) dv[j] = dp[r * rs + j];
#pragma unroll
                    for (int i = 0; i < kMtM; ++i)
#pragma unroll
                        for (int j = 0; j < kMtN; ++j) du[i][j] = fmaf(xv[i], dv[j], du[i][j]);
                }
            }
        }
        __syncthreads();  // readers of this stage are done before it is refilled
    }

    // -- this block's part of its partial row, width ceil4(NB·C·N + V) with
    // dU, else ceil4(V), for V values: one per group (K1/K2) or per chain (K3)
    const int n_vals = kChains ? nch : G;
    const int ll_off = kGrad ? NB * CN : 0, width = ll_off + n_vals;
    const int w4 = ceil_to(width, 4) >> 2;
    float* row = part + (size_t)blockIdx.x * w4 * 4;
    if (kGrad) {
        // join the slices' sums in slice order, one micro-tile row at a time
        // (slices 1.. fill s_join, kMtN words a thread)
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
        const int ncol = kChains ? N : nc;  // columns of the micro-tile's chain (or group)
        if (slice == 0 && owns_du)
#pragma unroll
            for (int i = 0; i < kMtM; ++i)
#pragma unroll
                for (int j = 0; j < kMtN; ++j)
                    if (mg + i * MG < NB && n0d + j < ncol) {
                        const int m = mg + i * MG;
                        if (kChains)
                            row[((size_t)chd * NB + m) * N + n0d + j] = du[i][j];
                        else
                            row[m * N + c0 + n0d + j] = du[i][j];
                    }
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
cudaError_t launch(const float* x_f, const float* u, const float* i_rest, const float* s,
                   float* d_irest, float* part, float* out, unsigned* bar, int T, int NB, int N,
                   int C, int W, int tile_t, int grid_x, int grid_y, int smem_bytes, int device,
                   float dt, float log_dt, cudaStream_t stream) {
    static int attr_bytes[kMaxDevices];  // the shared-memory attribute set so far, per device
    if (device < 0 || device >= kMaxDevices || tile_t % 4 != 0) return cudaErrorInvalidValue;
    // K1/K2: a column group is all N columns, or whole n-tiles of 8; K3: one
    // group of 2 ≤ C ≤ kMaxChains chains
    if (kChains ? (W != N || C < 2 || C > kMaxChains) : (C != 1 || W < 1 || W > N || (W < N && W % 8 != 0)))
        return cudaErrorInvalidValue;
    if ((size_t)smem_bytes != smem_bytes_for(NB, W, tile_t, C)) return cudaErrorInvalidValue;
    const int du_tiles = ((NB + kMtM - 1) / kMtM) * C * ((W + kMtN - 1) / kMtN);
    if (kGrad ? grid_y * kThreads < du_tiles : grid_y != 1) return cudaErrorInvalidValue;
    const int G = kChains ? 1 : (N + W - 1) / W;
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (attr_bytes[device] < smem_bytes) {
        err = cudaFuncSetAttribute(fused_ll_tiles<kGrad, kChains>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
        if (err != cudaSuccess) return err;
        attr_bytes[device] = smem_bytes;
    }
    // cooperative: the runtime refuses a grid whose blocks cannot all be
    // resident at once, which the grid barrier needs
    void* args[] = {&x_f, &u, &i_rest, &s, &d_irest, &part, &out, &bar,
                    &T, &NB, &N, &W, &tile_t, &dt, &log_dt, &C};
    return cudaLaunchCooperativeKernel((const void*)fused_ll_tiles<kGrad, kChains>,
                                       dim3(grid_x, grid_y * G), dim3(kThreads), args,
                                       (size_t)smem_bytes, stream);
}

}  // namespace

// K1. out[0] = ll. W: the columns of a group (N for one group), G = ceil(N / W);
// part: (grid_x, ceil4(G)) scratch, out: ceil4(G) floats; grid_y = 1; bar:
// 2 words, zeroed before the first call on the stream.
extern "C" int fused_ll_fwd(const float* x_f, const float* u, const float* i_rest,
                            const float* s, float* part, float* out, unsigned* bar, int T, int NB,
                            int N, int W, int tile_t, int grid_x, int grid_y, int smem_bytes,
                            int device, float dt, float log_dt, void* stream) {
    return (int)launch<false, false>(x_f, u, i_rest, s, nullptr, part, out, bar, T, NB, N, 1, W,
                                     tile_t, grid_x, grid_y, smem_bytes, device, dt, log_dt,
                                     (cudaStream_t)stream);
}

// K2. out[0 : NB·N] = dU (row-major (NB, N)), out[NB·N] = ll; d_irest (T, N).
// grid_y: dU slices per group. part: (grid_x, ceil4(NB·N + G)) scratch, out:
// ceil4(NB·N + G) floats; W and bar as K1's.
extern "C" int fused_ll_vg(const float* x_f, const float* u, const float* i_rest,
                           const float* s, float* d_irest, float* part, float* out, unsigned* bar,
                           int T, int NB, int N, int W, int tile_t, int grid_x, int grid_y,
                           int smem_bytes, int device, float dt, float log_dt, void* stream) {
    return (int)launch<true, false>(x_f, u, i_rest, s, d_irest, part, out, bar, T, NB, N, 1, W,
                                    tile_t, grid_x, grid_y, smem_bytes, device, dt, log_dt,
                                    (cudaStream_t)stream);
}

// K3-fwd. u (C, NB, N), i_rest (C, T, N), x_f (T, NB) and s (T, N) shared;
// out[0 : C] = the chains' ll. part: (grid_x, ceil4(C)) scratch, out: ceil4(C)
// floats; grid_y = 1; bar as K1's.
extern "C" int fused_ll_fwd_chains(const float* x_f, const float* u, const float* i_rest,
                                   const float* s, float* part, float* out, unsigned* bar, int T,
                                   int NB, int N, int C, int tile_t, int grid_x, int grid_y,
                                   int smem_bytes, int device, float dt, float log_dt,
                                   void* stream) {
    return (int)launch<false, true>(x_f, u, i_rest, s, nullptr, part, out, bar, T, NB, N, C, N,
                                    tile_t, grid_x, grid_y, smem_bytes, device, dt, log_dt,
                                    (cudaStream_t)stream);
}

// K3-vg. out[0 : C·NB·N] = dU ((C, NB, N) row-major), out[C·NB·N + c] = chain
// c's ll; d_irest (C, T, N). grid_y: dU slices. part: (grid_x, ceil4(C·NB·N +
// C)) scratch, out: ceil4(C·NB·N + C) floats; bar as K1's.
extern "C" int fused_ll_vg_chains(const float* x_f, const float* u, const float* i_rest,
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
