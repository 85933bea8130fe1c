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
// (the chain rules of its custom_vmap, K4-fwd-chains and K4-vg-chains, are
// in fused_ll_chains.cu).
//
// The two semantics of the JAX op on a bf16 design:
//   one chain:  I = I_rest + f32(X_f)·U,        dU = f32(X_f)ᵀ·dI
//   chains:     I = I_rest + X_f·bf16(U),       dU = X_fᵀ·bf16(dI)
// with I clipped to ±EXP_CLIP, ll = Σ S·(I + log dt) − e^I·dt, dI_rest =
// (S − e^I·dt)·1{|I_raw| < EXP_CLIP} in float32, products accumulated in
// float32, bf16(·) rounding to nearest even as JAX's astype does.
//
// Bounds on an H100 SXM (3.35 TB/s HBM; 67 TFLOP/s for products with a
// float32 operand) at the flagship shape T=60,000, NB=135, N=27, each byte
// read or written once: K4-fwd moves 29.2 MB (X_f 16.2, I_rest and S 6.5
// each) in 8.7 us against 0.44 GFLOP in 6.5 us: bytes. K4-vg adds dI_rest:
// 35.6 MB in 10.6 us against 0.87 GFLOP in 13.1 us: the float32 operations.
//
// The design is K1/K2's (csrc/fused_poisson_ll.cu, whose template this
// file leaves as it is; the helpers both use are in fused_ll_common.cuh):
// one persistent block of 256 threads per SM, launched cooperatively; each
// tile's X_f, I_rest and S spans moved by TMA bulk copies onto an mbarrier
// into the other of two stages while the current tile computes; every
// block's partial row summed after a grid barrier in a fixed order (no
// float atomics, bit-for-bit repeatable); a compensated value.
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
// - A widened bf16 value is exactly a TF32 value, so
//   f32(X)·U = X·tf32(U) + X·tf32(U − tf32(U)): 2 mma.sync.m16n8k8 per
//   k-step and n-tile instead of 3xTF32's 3, with U kept in float32 in
//   shared memory as K2 keeps it and split on the fly. (bf16 m16n8k16 with U
//   cut into three bf16 pieces would take 3 products of k16, the same
//   tensor-core work for more splitting.) dU = f32(X)ᵀ·dI stays K2's
//   float32 FMA product in register micro-tiles, X widened on load. Column
//   groups of U (N ≥ 89 at NB = 5N) are taken as K1/K2 take them.

#include "fused_ll_common.cuh"

#ifndef EXP_CLIP
#error "EXP_CLIP must come from theano_pyglm_torch/ops/clipping.py as -DEXP_CLIP"
#endif

namespace {

constexpr int kScratch = kThreads * 8;  // words for joining partial sums (≥ kThreads · kMtN)
constexpr int kMtM = 9, kMtN = 7;  // K4-vg's dU micro-tile (ops/kernels.py DU_TILE)
constexpr int kMaxSlices = 32;  // threads that share one dU micro-tile, at most

// Shared-memory layout, in 32-bit words, mirrored by ops/kernels.py
// _smem_bytes_bf16, for a column group of W neurons (W = N when one group
// holds them all):
//   U         float32 (ceil8(NB) × b_stride(W)), as K2 holds it
//   stage 0, 1  X_f (x_words: RT × NB bf16 values, ≥ 16 zero values), then
//             I_rest (NS; K4-vg: dI in place), then S (NS)
//   scratch   (kScratch)
__host__ __device__ constexpr int x_words(int NB, int tile_t) {
    return ceil_to(ceil_to(tile_t, 16) * NB + 16, 8) / 2;
}
__host__ __device__ constexpr int stage_words(int NB, int W, int tile_t) {
    return x_words(NB, tile_t) + 2 * n_span(W, tile_t);
}
size_t smem_bytes_bf16(int NB, int W, int tile_t) {
    return ((size_t)ceil_to(NB, 8) * b_stride(W) + 2 * (size_t)stage_words(NB, W, tile_t) + kScratch) * 4;
}

// Bytes of a span of n elements of `size` bytes at src that one bulk copy
// can take: the 16-byte multiple when src is 16-byte aligned, else none.
__device__ __forceinline__ uint32_t bulk_bytes(const void* src, int n, int size) {
    return (reinterpret_cast<uintptr_t>(src) & 15) ? 0u : (uint32_t)(n * size) & ~15u;
}

// A bf16 value's bits widened to float32's (exact; also exact as TF32).
__device__ __forceinline__ uint32_t widen(uint16_t h) { return (uint32_t)h << 16; }
__device__ __forceinline__ float widen_f(uint16_t h) { return __uint_as_float(widen(h)); }

// The grid is (grid_x, grid_y · G): blockIdx.y = group · grid_y + dU slice.
// part row b: K4-fwd [ll of each group, pad]; K4-vg [dU (NB·N row-major),
// ll of each group, pad]. bar: 2 words, zeroed before the first call. The
// last parameter, always 1, is the chain count that an earlier chain
// instance of this template took; it stays, unread, so that K4-fwd's and
// K4-vg's machine code (the parameters' layout) does not change.
template <bool kGrad>
__global__ void __launch_bounds__(kThreads, 1)
fused_ll_bf16_tiles(const uint16_t* __restrict__ x_f, const float* __restrict__ u,
                    const float* __restrict__ i_rest, const float* __restrict__ s,
                    float* __restrict__ d_irest, float* __restrict__ part, float* __restrict__ out,
                    unsigned* __restrict__ bar, int T, int NB, int N, int W, int tile_t, float dt,
                    float log_dt, int C) {
    extern __shared__ __align__(16) float smem[];
    __shared__ __align__(8) uint64_t s_bar[2];  // a stage's bulk copies have landed
    const int G = (N + W - 1) / W, YS = gridDim.y / G;
    const int grp = blockIdx.y / YS, ys = blockIdx.y - grp * YS;
    const int c0 = grp * W, nc = min(W, N - c0);  // this block's columns
    const bool whole = nc == N;  // one group: I_rest and S tiles are contiguous
    const int rs = nc;           // a row's words in an I_rest or S span
    const int RT = ceil_to(tile_t, 16);
    const int KP = ceil_to(NB, 8);  // the forward's k extent
    const int BS = b_stride(W);     // U's row stride
    const int XW = x_words(NB, tile_t), NS = n_span(W, tile_t);
    const int SW = stage_words(NB, W, tile_t);
    const int UW = ceil_to(NB, 8) * BS;
    const int NT = (nc + 7) >> 3;  // n-tiles of 8 columns
    const int NG = (NT + 3) >> 2;  // forward n-groups of 4 n-tiles
    float* s_u = smem;
    float* s_stage = smem + UW;
    float* s_join = s_stage + 2 * (size_t)SW;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int n_tiles = (T + tile_t - 1) / tile_t;
    const bool lead_y = ys == 0;

    // Zero U and both stages (pads stay zero), before any copy lands in
    // them.
    {
        float4* z = reinterpret_cast<float4*>(smem);
        const int n4 = (UW + 2 * SW) >> 2;
        for (int i = tid; i < n4; i += kThreads) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (tid == 0) {
        mbar_init(&s_bar[0]);
        mbar_init(&s_bar[1]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // A tile's X_f span (bf16), its I_rest span and its S span: thread 0
    // moves each contiguous span with one TMA bulk copy
    // onto the stage's mbarrier; the threads copy what a bulk copy cannot
    // take (an X_f tail by plain loads, a float32 tail by cp.async). A column
    // group's I_rest and S rows lie N apart: cp.async takes them a word at a
    // time.
    const int nf = 2;  // float32 spans: I_rest, then S
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
    // the block's columns of U into rows of BS words, 4 bytes a thread
    for (int e = tid; e < NB * nc; e += kThreads) {
        const int m = e / nc, col = e - m * nc;
        cp_async4(s_u + m * BS + col, u + (size_t)m * N + c0 + col);
    }
    cp_async_commit();
    issue(blockIdx.x, 0);
    cp_async_commit();

    // K4-vg's dU: kMtM × kMtN micro-tiles in registers for the whole kernel,
    // float32 FMA, exactly as K2 (see fused_poisson_ll.cu).
    const int ngc = (nc + kMtN - 1) / kMtN, MG = (NB + kMtM - 1) / kMtM;
    const int y_items = kGrad ? min(kThreads, MG * ngc - ys * kThreads) : 0;
    const int n_slices = y_items > 0 ? min(kThreads / y_items, kMaxSlices) : 0;
    const int slice = y_items > 0 ? tid / y_items : 0;
    const int item_l = tid - slice * y_items;
    const bool owns_du = slice < n_slices;
    const int item = ys * kThreads + item_l;
    const int mg = owns_du ? item / ngc : 0;
    const int n0d = owns_du ? (item % ngc) * kMtN : 0;
    float du[kMtM][kMtN];
#pragma unroll
    for (int i = 0; i < kMtM; ++i)
#pragma unroll
        for (int j = 0; j < kMtN; ++j) du[i][j] = 0.f;

    // the value: each forward unit's terms a thread summed into part, the
    // parts added into ll with Kahan's compensation (ll_c)
    float ll = 0.f, ll_c = 0.f;
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
        const float* ssp = sir + NS;

        // forward: unit = (16 bins, 4 n-tiles of 8 columns)
        for (int unit = warp; unit < (RT >> 4) * NG; unit += kWarps) {
            const int fb = unit / NG, ng = unit - fb * NG;
            const int r0 = fb * 16, nt0 = ng * 4;
            float acc_lo[4][4], acc_hi[4][4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc_lo[j][c] = acc_hi[j][c] = 0.f;
            // f32(X_f) · U = X_f·tf32(U) + X_f·tf32(U − tf32(U)): the widened
            // bf16 values are exact TF32 operands. n-tiles past NT multiply
            // whatever follows U's last columns and are never read.
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
            float part_v = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int r = r0 + g + ((c >> 1) << 3), col = (nt0 + j) * 8 + 2 * t + (c & 1);
                    if (r < rows && col < nc) {  // the ragged tile, the padded columns
                        const int e = r * rs + col;
                        const float i_raw = sir[e] + (acc_hi[j][c] + acc_lo[j][c]);
                        const float I = fminf(fmaxf(i_raw, -EXP_CLIP), EXP_CLIP);
                        const float rate_dt = expf(I) * dt;
                        const float spikes = ssp[e];
                        part_v += spikes * (I + log_dt) - rate_dt;
                        if (kGrad)  // the clip's gradient is 0 outside the active range
                            sir[e] = fabsf(i_raw) < EXP_CLIP ? spikes - rate_dt : 0.f;
                    }
                }
            const float y = part_v - ll_c, sum = ll + y;
            ll_c = (sum - ll) - y;
            ll = sum;
        }

        if (kGrad) {
            __syncthreads();  // the tile's dI is in shared memory
            if (lead_y && whole) copy_out(d_irest + (size_t)t0 * N, sir, rows * N);
            if (lead_y && !whole)
                for (int i = tid; i < rows * nc; i += kThreads) {
                    const int r = i / nc;
                    d_irest[(size_t)(t0 + r) * N + c0 + (i - r * nc)] = sir[i];
                }
            if (owns_du) {
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
                    for (int i = 0; i < kMtM; ++i)
#pragma unroll
                        for (int j = 0; j < kMtN; ++j) du[i][j] = fmaf(xv[i], dv[j], du[i][j]);
                }
            }
        }
        __syncthreads();  // readers of this stage are done before it is refilled
    }

    // -- this block's part of its partial row, width ceil4(NB·N + G) with
    // dU, else ceil4(G): a value per group
    const int ll_off = kGrad ? NB * N : 0, width = ll_off + G;
    const int w4 = ceil_to(width, 4) >> 2;
    float* row = part + (size_t)blockIdx.x * w4 * 4;
    if constexpr (kGrad) {
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
    const float v = block_sum(ll);
    if (lead_y && tid == 0) row[ll_off + grp] = v;

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

template <bool kGrad>
cudaError_t launch(const void* x_f, const float* u, const float* i_rest, const float* s,
                   float* d_irest, float* part, float* out, unsigned* bar, int T, int NB, int N,
                   int W, int tile_t, int grid_x, int grid_y, int smem_bytes, int device,
                   float dt, float log_dt, cudaStream_t stream) {
    static int attr_bytes[kMaxDevices];  // the shared-memory attribute set so far, per device
    if (device < 0 || device >= kMaxDevices || tile_t % 8 != 0) return cudaErrorInvalidValue;
    // a column group is all N columns, or whole n-tiles of 8
    if (W < 1 || W > N || (W < N && W % 8 != 0)) return cudaErrorInvalidValue;
    if ((size_t)smem_bytes != smem_bytes_bf16(NB, W, tile_t)) return cudaErrorInvalidValue;
    const int du_tiles = ((NB + kMtM - 1) / kMtM) * ((W + kMtN - 1) / kMtN);
    if (kGrad ? grid_y * kThreads < du_tiles : grid_y != 1) return cudaErrorInvalidValue;
    const int G = (N + W - 1) / W;
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
    int C = 1;  // see the kernel
    void* args[] = {&x, &u, &i_rest, &s, &d_irest, &part, &out, &bar,
                    &T, &NB, &N, &W, &tile_t, &dt, &log_dt, &C};
    return cudaLaunchCooperativeKernel((const void*)fused_ll_bf16_tiles<kGrad>,
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
    return (int)launch<false>(x_f, u, i_rest, s, nullptr, part, out, bar, T, NB, N, W,
                                     tile_t, grid_x, grid_y, smem_bytes, device, dt, log_dt,
                                     (cudaStream_t)stream);
}

// K4-vg: K2 on a bf16 x_f. out[0 : NB·N] = dU, out[NB·N] = ll; d_irest (T, N).
extern "C" int fused_ll_vg_bf16(const void* x_f, const float* u, const float* i_rest,
                                const float* s, float* d_irest, float* part, float* out,
                                unsigned* bar, int T, int NB, int N, int W, int tile_t, int grid_x,
                                int grid_y, int smem_bytes, int device, float dt, float log_dt,
                                void* stream) {
    return (int)launch<true>(x_f, u, i_rest, s, d_irest, part, out, bar, T, NB, N, W,
                                    tile_t, grid_x, grid_y, smem_bytes, device, dt, log_dt,
                                    (cudaStream_t)stream);
}

extern "C" const char* fused_ll_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
