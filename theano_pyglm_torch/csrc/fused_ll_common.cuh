// Helpers shared by the fused Poisson-LL kernels (fused_poisson_ll.cu: K1,
// K2; fused_poisson_ll_bf16.cu: K4-fwd, K4-vg; fused_ll_chains.cu: the four
// chain kernels): block geometry, cp.async and TMA bulk copies onto an
// mbarrier, the TF32 tensor-core product, the dealing of dU's mma tiles to
// warps, and the fixed-order sums and grid barrier that keep every launch
// bit-for-bit repeatable. Each source includes it once; everything is in an anonymous
// namespace, so each library keeps its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // ops/kernels.py THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
constexpr int kWarpTiles = 16;  // dU mma tiles a warp holds, at most (ops/kernels.py WARP_TILES)

__host__ __device__ constexpr int ceil_to(int x, int m) { return (x + m - 1) / m * m; }

// U's B-operand row stride for N columns (≡ 8 mod 16 words: conflict-free
// fragment reads), and an I_rest or S span of a tile: its rows·N words and 8
// more for the dU reads past the last neuron.
__host__ __device__ constexpr int b_stride(int N) {
    return (ceil_to(N, 8) % 16) ? ceil_to(N, 8) : ceil_to(N, 8) + 8;
}
__host__ __device__ constexpr int n_span(int N, int tile_t) { return ceil_to(tile_t * N, 4) + 8; }
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done)
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}
// One TMA bulk copy global → shared, completing on bar (16-byte aligned, a multiple of 16 bytes).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// dst[0:n] = src[0:n], shared → global, by the block: 16 bytes a thread where
// both are 16-byte aligned, else 4.
__device__ __forceinline__ void copy_out(float* dst, const float* src, int n) {
    int head = 0;
    if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
        for (int c = threadIdx.x; c < n >> 2; c += kThreads)
            reinterpret_cast<float4*>(dst)[c] = reinterpret_cast<const float4*>(src)[c];
        head = n & ~3;
    }
    for (int i = head + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// Round to TF32 (10 mantissa bits) by adding half an ulp and truncating: two
// integer operations at full rate.
__device__ __forceinline__ uint32_t to_tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = big + small, both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
    big = to_tf32(x);
    small = to_tf32(x - __uint_as_float(big));
}

// c += a·b for one m16n8k8 TF32 tile (fragments as in the PTX ISA:
// g = lane/4, t = lane%4; a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// b = B[t][g], B[t+4][g]; c = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Sum of v over the block in a fixed order; the result is valid in thread 0.
__device__ float block_sum(float v) {
    __shared__ float warp_sums[kWarps];
    __syncthreads();  // an earlier call's readers of warp_sums are done
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    v = threadIdx.x < kWarps ? warp_sums[threadIdx.x] : 0.f;
    if (warp == 0)
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
    a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
}

// dst[c] = Σ_{r0 <= r < r1} src[r·stride + c] for c < w4, in float4 columns
// and a fixed order.
__device__ void sum_rows(float4* dst, const float4* src, size_t stride, int r0, int r1, int w4) {
    if (w4 == 1) {  // one column (K1): the rows over the threads, then a fixed tree
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int r = r0 + (int)threadIdx.x; r < r1; r += kThreads) add4(acc, __ldcg(src + r * stride));
        acc = make_float4(block_sum(acc.x), block_sum(acc.y), block_sum(acc.z), block_sum(acc.w));
        if (threadIdx.x == 0) dst[0] = acc;
        return;
    }
    // up to 4 columns a thread at once, 4 rows deep, so that 16 loads are in flight
    for (int c0 = threadIdx.x; c0 < w4; c0 += 4 * kThreads) {
        float4 acc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int c = c0 + q * kThreads;
            acc[q] = c < w4 ? __ldcg(src + r0 * stride + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll 4
        for (int r = r0 + 1; r < r1; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int c = c0 + q * kThreads;
                if (c < w4) add4(acc[q], __ldcg(src + r * stride + c));
            }
#pragma unroll
        for (int q = 0; q < 4; ++q)
            if (c0 + q * kThreads < w4) dst[c0 + q * kThreads] = acc[q];
    }
}

// All blocks of the grid meet here. The grid is launched cooperatively, so
// they are all resident. bar[0] counts arrivals and is left at 0; bar[1] is
// the generation, which only grows.
__device__ void grid_barrier(unsigned* bar) {
    __syncthreads();
    if (threadIdx.x == 0) {
        volatile unsigned* gen = bar + 1;
        const unsigned g0 = *gen;  // cannot move before this block arrives
        __threadfence();
        if (atomicAdd(bar, 1u) == gridDim.x * gridDim.y - 1) {
            atomicExch(bar, 0u);
            __threadfence();
            atomicAdd(bar + 1, 1u);
        } else {
            while (*gen == g0) __nanosleep(64);
        }
        __threadfence();
    }
    __syncthreads();
}

// out[c] = Σ over the grid_x partial rows of part[·][c], for the float4
// columns c < w4 that this block owns (a slice of them per block), in a
// fixed order.
__device__ void sum_columns(const float* part, float* out, int w4, float* s_join) {
    const int tid = threadIdx.x;
    const int nb = gridDim.x * gridDim.y, b = blockIdx.y * gridDim.x + blockIdx.x;
    const int c_lo = (int)((long long)b * w4 / nb);
    const int C = (int)((long long)(b + 1) * w4 / nb) - c_lo;
    const float4* p4 = reinterpret_cast<const float4*>(part) + c_lo;
    float4* out4 = reinterpret_cast<float4*>(out) + c_lo;
    if (C == 0) return;
    if (2 * C > kThreads) {  // few blocks, wide rows: a column a thread
        sum_rows(out4, p4, w4, 0, gridDim.x, C);
        return;
    }
    if (C == 1) {  // the rows over all threads, then a fixed tree
        sum_rows(out4, p4, w4, 0, gridDim.x, 1);
        return;
    }
    // P row phases a column, then the phases in order
    const int P = kThreads / C, cl = tid % C, ph = tid / C;
    float4* red = reinterpret_cast<float4*>(s_join);
    if (ph < P) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int r = ph; r < (int)gridDim.x; r += P) add4(acc, __ldcg(p4 + (size_t)r * w4 + cl));
        red[ph * C + cl] = acc;
    }
    __syncthreads();
    if (tid < C) {
        float4 acc = red[tid];
        for (int q = 1; q < P; ++q) add4(acc, red[q * C + tid]);
        out4[tid] = acc;
    }
}

// The warps that share a grid_y slice's dU items (16 × 8 mma tiles): the
// fewest of 1, 2, 4, 8 whose runs hold at most kWarpTiles items each
// (ops/kernels.py vg_chains_items); the other warps of a group of kWarps
// split its k-steps.
__host__ __device__ constexpr int work_warps(int items) {
    return items <= kWarpTiles ? 1 : items <= 2 * kWarpTiles ? 2 : items <= 4 * kWarpTiles ? 4 : kWarps;
}

// out[c] = Σ over n_rows partial rows of part[·][c], for the float4
// columns c < w4 that this block owns (a slice of them per block), in a
// fixed order: sum_columns over n_rows rows.
__device__ void sum_part_rows(const float* part, float* out, int w4, int n_rows, float* s_join) {
    const int tid = threadIdx.x;
    const int nb = gridDim.x * gridDim.y, b = blockIdx.y * gridDim.x + blockIdx.x;
    const int c_lo = (int)((long long)b * w4 / nb);
    const int C = (int)((long long)(b + 1) * w4 / nb) - c_lo;
    const float4* p4 = reinterpret_cast<const float4*>(part) + c_lo;
    float4* out4 = reinterpret_cast<float4*>(out) + c_lo;
    if (C == 0) return;
    if (2 * C > kThreads || C == 1) {
        sum_rows(out4, p4, w4, 0, n_rows, C);
        return;
    }
    // P row phases a column, then the phases in order
    const int P = kThreads / C, cl = tid % C, ph = tid / C;
    float4* red = reinterpret_cast<float4*>(s_join);
    if (ph < P) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int r = ph; r < n_rows; r += P) add4(acc, __ldcg(p4 + (size_t)r * w4 + cl));
        red[ph * C + cl] = acc;
    }
    __syncthreads();
    if (tid < C) {
        float4 acc = red[tid];
        for (int q = 1; q < P; ++q) add4(acc, red[q * C + tid]);
        out4[tid] = acc;
    }
}

}  // namespace
