// Fused coupling matmul + Poisson log-likelihood, hand-written for Hopper
// (sm_90a), bound to PyTorch through a plain C interface and ctypes
// (theano_pyglm_torch/ops/cuda_loader.py, ops/kernels.py).
//
// Replaces the Pallas TPU kernels of theano_pyglm_tpu/ops/pallas_kernels.py:
//   K1  _fwd_kernel (value only)           -> fused_ll_fwd
//   K2  _vg_kernel  (one-pass value+grad)  -> fused_ll_vg
//
//   I_raw = I_rest + X_f @ U        X_f (T, NB), U (NB, N), I_rest and S (T, N)
//   I     = clip(I_raw, ±EXP_CLIP)
//   ll    = Σ S·(I + log dt) − e^I·dt
//   K2 also: dI_rest = (S − e^I·dt)·1{|I_raw| < EXP_CLIP}   (T, N)
//            dU      = X_fᵀ @ dI_rest                       (NB, N)
// Both cotangents are for a unit output cotangent; the autograd Function
// scales them.
//
// Design. The TPU kernels carry their running sums in SMEM/VMEM scratch from
// one grid step to the next, which works because a TPU grid runs in order on
// one core. Hopper blocks run in parallel, in no order. Here a grid of
// min(n_tiles, 2·SMs) blocks strides over time tiles of tile_t bins. Each
// block stages U and one X_f tile in shared memory, computes the tile's
// currents with float32 FMA, reduces the tile's log-likelihood in float32
// and, for K2, writes dI_rest and adds X_tileᵀ @ dI_tile into a dU that is
// private to the block (shared memory, each entry owned by one thread).
// Every block writes its partial ll (and dU) to its own row of a scratch
// buffer that the wrapper allocates; a second kernel sums the rows in a
// fixed order. There are no atomics, so repeated runs give identical bits.
// The ragged last tile is masked; nothing is padded.
//
// What bounds it on an H100. Per K2 call at the flagship shape (T=60,000,
// NB=135, N=27) X_f is 32.4 MB, I_rest and S are 6.5 MB each and dI_rest is
// 6.5 MB out: ~52 MB, ~16 us of HBM time at 3.35 TB/s. The work is ~0.44
// GFMA (0.87 GFLOP), ~13 us at the non-tensor float32 rate. The kernel is
// bandwidth- and FMA-bound. This first version reads both operands of every
// FMA from shared memory, which keeps it well short of either bound;
// register tiling, TMA and wgmma are later work.

#include <cuda_runtime.h>
#include <stddef.h>

#ifndef EXP_CLIP
#error "EXP_CLIP must come from theano_pyglm_torch/ops/clipping.py as -DEXP_CLIP"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSumRows = 8;  // threads per column in sum_rows

// Sum of v over the block in a fixed order; the result is valid in thread 0.
__device__ float block_sum(float v) {
    __shared__ float warp_sums[kWarps];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    v = threadIdx.x < kWarps ? warp_sums[threadIdx.x] : 0.f;
    if (warp == 0)
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

// Shared memory: U (NB·N) | X_f tile (tile_t·NB) | K2: dI tile (tile_t·N) | K2: dU (NB·N).
// part row b: K1 [ll]; K2 [dU (NB·N), ll].
template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
fused_ll_tiles(const float* __restrict__ x_f, const float* __restrict__ u,
               const float* __restrict__ i_rest, const float* __restrict__ s,
               float* __restrict__ d_irest, float* __restrict__ part,
               int T, int NB, int N, int tile_t, float dt, float log_dt) {
    extern __shared__ float smem[];
    const int nbn = NB * N;
    float* s_u = smem;
    float* s_x = s_u + nbn;
    float* s_d = s_x + tile_t * NB;
    float* s_du = s_d + tile_t * N;
    const int tid = threadIdx.x;

    for (int i = tid; i < nbn; i += kThreads) {
        s_u[i] = u[i];
        if (kGrad) s_du[i] = 0.f;
    }
    float ll = 0.f;
    const int n_tiles = (T + tile_t - 1) / tile_t;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int t0 = tile * tile_t;
        const int rows = min(tile_t, T - t0);  // masks the ragged last tile
        __syncthreads();  // U is staged; the previous tile's readers of s_x, s_d are done
        const float* x_tile = x_f + (size_t)t0 * NB;
        for (int i = tid; i < rows * NB; i += kThreads) s_x[i] = x_tile[i];
        __syncthreads();

        const size_t base = (size_t)t0 * N;
        for (int e = tid; e < rows * N; e += kThreads) {
            const int r = e / N, n = e - r * N;
            const float* x_row = s_x + r * NB;
            float acc = 0.f;
            for (int m = 0; m < NB; ++m) acc = fmaf(x_row[m], s_u[m * N + n], acc);
            const float i_raw = i_rest[base + e] + acc;
            const float I = fminf(fmaxf(i_raw, -EXP_CLIP), EXP_CLIP);
            const float rate_dt = expf(I) * dt;
            const float spikes = s[base + e];
            ll += spikes * (I + log_dt) - rate_dt;
            if (kGrad) {
                // the clip's gradient is 0 outside the active range
                const float d = fabsf(i_raw) < EXP_CLIP ? spikes - rate_dt : 0.f;
                d_irest[base + e] = d;
                s_d[e] = d;
            }
        }
        if (kGrad) {
            __syncthreads();
            // thread tid owns the dU entries e ≡ tid (mod kThreads)
            for (int e = tid; e < nbn; e += kThreads) {
                const int m = e / N, n = e - m * N;
                float acc = s_du[e];
                for (int r = 0; r < rows; ++r) acc = fmaf(s_x[r * NB + m], s_d[r * N + n], acc);
                s_du[e] = acc;
            }
        }
    }
    const int width = kGrad ? nbn + 1 : 1;
    float* row = part + (size_t)blockIdx.x * width;
    if (kGrad)
        for (int e = tid; e < nbn; e += kThreads) row[e] = s_du[e];
    ll = block_sum(ll);
    if (tid == 0) row[width - 1] = ll;
}

// out[e] = Σ_b part[b·width + e] over n_parts rows, in a fixed order:
// kSumRows threads per column each sum a strided subset of the rows, then
// the first adds the kSumRows partial sums in order.
__global__ void sum_rows(const float* __restrict__ part, int n_parts, int width,
                         float* __restrict__ out) {
    __shared__ float partial[kSumRows][33];
    const int e = blockIdx.x * 32 + threadIdx.x;
    float acc = 0.f;
    if (e < width)
        for (int b = threadIdx.y; b < n_parts; b += kSumRows) acc += part[(size_t)b * width + e];
    partial[threadIdx.y][threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.y == 0 && e < width) {
        float total = 0.f;
        for (int y = 0; y < kSumRows; ++y) total += partial[y][threadIdx.x];
        out[e] = total;
    }
}

size_t smem_bytes(bool grad, int NB, int N, int tile_t) {
    size_t floats = (size_t)NB * N + (size_t)tile_t * NB;
    if (grad) floats += (size_t)tile_t * N + (size_t)NB * N;
    return floats * sizeof(float);
}

template <bool kGrad>
cudaError_t launch(const float* x_f, const float* u, const float* i_rest, const float* s,
                   float* d_irest, float* part, float* out, int T, int NB, int N, int tile_t,
                   int n_blocks, int device, float dt, float log_dt, cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const size_t smem = smem_bytes(kGrad, NB, N, tile_t);
    err = cudaFuncSetAttribute(fused_ll_tiles<kGrad>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    fused_ll_tiles<kGrad><<<n_blocks, kThreads, smem, stream>>>(
        x_f, u, i_rest, s, d_irest, part, T, NB, N, tile_t, dt, log_dt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int width = kGrad ? NB * N + 1 : 1;
    sum_rows<<<(width + 31) / 32, dim3(32, kSumRows), 0, stream>>>(part, n_blocks, width, out);
    return cudaGetLastError();
}

}  // namespace

// K1. out[0] = ll. part: (n_blocks, 1) scratch.
extern "C" int fused_ll_fwd(const float* x_f, const float* u, const float* i_rest,
                            const float* s, float* part, float* out, int T, int NB, int N,
                            int tile_t, int n_blocks, int device, float dt, float log_dt,
                            void* stream) {
    return (int)launch<false>(x_f, u, i_rest, s, nullptr, part, out, T, NB, N, tile_t, n_blocks,
                              device, dt, log_dt, (cudaStream_t)stream);
}

// K2. out[0 : NB·N] = dU (row-major (NB, N)), out[NB·N] = ll; d_irest (T, N).
// part: (n_blocks, NB·N + 1) scratch.
extern "C" int fused_ll_vg(const float* x_f, const float* u, const float* i_rest,
                           const float* s, float* d_irest, float* part, float* out, int T,
                           int NB, int N, int tile_t, int n_blocks, int device, float dt,
                           float log_dt, void* stream) {
    return (int)launch<true>(x_f, u, i_rest, s, d_irest, part, out, T, NB, N, tile_t, n_blocks,
                             device, dt, log_dt, (cudaStream_t)stream);
}

extern "C" const char* fused_ll_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
