// The collapsed adjacency stage's row scan, hand-written for Hopper (sm_90a),
// bound to PyTorch through a plain C interface and ctypes
// (theano_pyglm_torch/ops/cuda_loader.py, ops/kernels.py:
// adjacency_row_scan, whose plain version adjacency_row_scan_reference is the
// same algorithm in torch).
//
// Replaces no TPU kernel: update_adjacency_collapsed is plain JAX in the
// reference package (theano_pyglm_tpu/inference/gibbs.py), a lax.scan over a
// row's entries that XLA fuses on the TPU. In PyTorch the same scan was a
// Python loop of ~350 small ops an entry: ~9,500 launches a stage, each a
// pass over every row's (T,) current. This kernel runs the whole scan of
// every row in one launch.
//
// What it computes, for each row r (chain c, postsynaptic neuron n) and its
// entries m = 0..M-1 in order, each seeing the entries before it updated:
//   I_s     = I_sub − g_cur·ψ_s                 the subsample without the edge
//   a_sub   = Σ S_sub·ψ_s · scale
//   Newton  w ← w − d1 / min(d2, −0.1·prec), from w = μ, n_newton steps, on
//           d1 = β(a_sub − dt·scale·Σ e^clip(I_s + wψ_s)·ψ_s) − (w − μ)·prec
//           d2 = β(−dt·scale·Σ e^clip(I_s + wψ_s)·ψ_s²) − prec
//   h*, s, log Z1 (the subsampled ΔLL at w*), p_birth, the proposal
//   ΔLL_prop, ΔLL_cur exact over the full T, from the rows' current I_n
//   the independence-MH test; A, W, the accept flag; I_n and I_sub updated.
// The ΔLLs are sums of per-bin differences, Σ S·(I1 − I0) − dt·(e^I1 − e^I0),
// as in the plain version: their rounding is that of the edge's own effect,
// not of the row's whole likelihood.
//
// Bounds on an H100 SXM (3.35 TB/s HBM) at the flagship stage, 16 chains,
// 432 rows × 27 entries, T = 60,000, a subsample of 16,384 bins. The floor
// is every operand read once and the current written once: ψ (2.80 GB), S
// and the current (104 MB each) read, the current written: 3.11 GB, 0.93 ms.
// This design moves more: each (row, entry) reads ψ_m's row, the previous
// entry's ψ row, S and the current (240 KB each), writes the current
// (240 KB) and gathers ψ_m's subsample (64 KB): 1.26 MB, 14.5 GB a stage,
// 4.3 ms where nothing is found in L2 (the previous entry's ψ row, just
// read, mostly is). The exponentials, 3 a bin of the full pass and one a bin
// of each of the 11 subsample passes (9 of Newton, 2 of the ΔLL at w*), are
// 4.2 G a stage: ~1 ms on the SFUs. So HBM bounds it, and the sequential
// entries, each a chain of ~13 block-wide sums, bound how much of it is in
// flight. Keeping a row's current on chip (240 KB: over a cluster's shared
// memory) would take 38 % of the design's bytes off HBM.
//
// Design:
// - One cluster of K CTAs of 512 threads owns a row for the whole scan. K is
//   1 where the rows fill the SMs (the flagship's 432 rows) and up to 8
//   where they do not (27 rows at one chain): ops/kernels.py
//   row_scan_cluster picks it from the row count and the subsample's size.
//   A CTA owns 1/K of the subsample and of the time axis.
// - The subsample's ψ_s, I_s and S_sub (16,384 bins × 4 B each) live in
//   shared memory for the n_newton + 2 passes of an entry; ψ_s is gathered
//   from ψ_m's row by the block offsets, so no (M, R, T_sub) copy exists.
// - The full-T work of an entry is one streaming pass with 16-byte loads:
//   it applies the previous entry's update to the current (written back
//   only where a later entry reads it), and sums both ΔLLs. The last
//   entry's update is never applied: nothing reads it.
// - Sums run in a fixed order with no atomics: each thread over its fixed
//   bins, warps by shuffles down to lane 0, the warps in order, the
//   cluster's CTAs in rank order through distributed shared memory. Every
//   thread of the cluster computes the same scalars from the same sums, so
//   runs repeat bit for bit.
// - ψ is float32, or bfloat16 for a bf16 design, widened to float32 where it
//   is read, as torch's promotion does.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVals = 2;  // the most values one block-wide sum carries
constexpr int kMaxDevices = 64;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kLogMix = -0.22314354805f;    // log 0.8
constexpr float kLogPrior = -1.60943791243f;  // log 0.2

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// four consecutive elements of ψ from a 16-byte (float) or 8-byte (bf16) load
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float clip(float x) { return fminf(fmaxf(x, -EXP_CLIP), EXP_CLIP); }
// x + a·b and x − a·b rounded after the product and after the sum, as torch's
// two ops round them: no contraction into one fused multiply-add, so the
// kernel's per-bin values are the plain version's.
__device__ __forceinline__ float add_mul(float x, float a, float b) { return __fadd_rn(x, __fmul_rn(a, b)); }
__device__ __forceinline__ float sub_mul(float x, float a, float b) { return __fsub_rn(x, __fmul_rn(a, b)); }
// S·(I1 − I0) − dt·(e^I1 − e^I0), op for op
__device__ __forceinline__ float dll_term(float s, float i1, float i0, float e1, float e0, float dt) {
    return __fsub_rn(__fmul_rn(s, __fsub_rn(i1, i0)), __fmul_rn(dt, __fsub_rn(e1, e0)));
}

// Sum v over the cluster, the result in every thread: warps by shuffles down
// to lane 0, the warps in order, then the K CTAs in rank order. Two buffers
// alternate, so one barrier a sum keeps a slow reader of the last sum safe.
template <int V>
__device__ __forceinline__ void cluster_sum(float (&v)[V], float* wpart, float* cpart, int& buf, int K) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v[j] += __shfl_down_sync(0xffffffffu, v[j], off);
    float* wp = wpart + buf * kWarps * kVals;
    if (lane == 0)
#pragma unroll
        for (int j = 0; j < V; ++j) wp[warp * kVals + j] = v[j];
    __syncthreads();
    if (K == 1) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
            float a = 0.f;
            for (int w = 0; w < kWarps; ++w) a += wp[w * kVals + j];
            v[j] = a;
        }
    } else {
        cg::cluster_group cluster = cg::this_cluster();
        float* cp = cpart + buf * kVals;
        if (threadIdx.x < V) {
            float a = 0.f;
            for (int w = 0; w < kWarps; ++w) a += wp[w * kVals + threadIdx.x];
            cp[threadIdx.x] = a;
        }
        cluster.sync();
#pragma unroll
        for (int j = 0; j < V; ++j) {
            float a = 0.f;
            for (int q = 0; q < K; ++q) a += cluster.map_shared_rank(cp, q)[j];
            v[j] = a;
        }
    }
    buf ^= 1;
}

// the entry's full-T terms at one bin; returns the current with the
// previous entry's update applied
template <bool kApply>
__device__ __forceinline__ float full_bin(float j, float pp, float pm, float s, float gc_prev, float gn_prev,
                                          float g_cur, float w_prop, float dt, float (&acc)[2]) {
    if (kApply) j = add_mul(sub_mul(j, gc_prev, pp), gn_prev, pp);
    const float i_wo = sub_mul(j, g_cur, pm);
    const float a = clip(j), b = clip(i_wo), c = clip(add_mul(i_wo, w_prop, pm));
    const float eb = expf(b);
    acc[0] += dll_term(s, c, b, expf(c), eb, dt);
    acc[1] += dll_term(s, a, b, expf(a), eb, dt);
    return j;
}

// One pass over the row's bins [lo, hi) of the full T: float4 groups where
// the rows are 16-byte aligned (vec), else one bin a thread.
template <bool kApply, typename P>
__device__ __forceinline__ void full_pass(float* J, const P* pprev, const P* pm, const float* S, int lo, int hi,
                                          bool vec, bool store, float gc_prev, float gn_prev, float g_cur,
                                          float w_prop, float dt, float (&acc)[2]) {
    if (vec) {
        for (int q = (lo >> 2) + threadIdx.x; q < (hi >> 2); q += kThreads) {
            float4 j = reinterpret_cast<const float4*>(J)[q];
            const float4 p = load4(pm + 4 * q), s = reinterpret_cast<const float4*>(S)[q];
            float4 pp = p;
            if (kApply) pp = load4(pprev + 4 * q);
            j.x = full_bin<kApply>(j.x, pp.x, p.x, s.x, gc_prev, gn_prev, g_cur, w_prop, dt, acc);
            j.y = full_bin<kApply>(j.y, pp.y, p.y, s.y, gc_prev, gn_prev, g_cur, w_prop, dt, acc);
            j.z = full_bin<kApply>(j.z, pp.z, p.z, s.z, gc_prev, gn_prev, g_cur, w_prop, dt, acc);
            j.w = full_bin<kApply>(j.w, pp.w, p.w, s.w, gc_prev, gn_prev, g_cur, w_prop, dt, acc);
            if (kApply && store) reinterpret_cast<float4*>(J)[q] = j;
        }
    } else {
        for (int t = lo + threadIdx.x; t < hi; t += kThreads) {
            const float pp = kApply ? widen(pprev[t]) : 0.f;
            const float j = full_bin<kApply>(J[t], pp, widen(pm[t]), S[t], gc_prev, gn_prev, g_cur, w_prop, dt, acc);
            if (kApply && store) J[t] = j;
        }
    }
}

__device__ __forceinline__ float logaddexp(float a, float b) {
    const float m = fmaxf(a, b);
    if (isinf(m) && a == b) return a;
    return m + log1pf(expf(-fabsf(a - b)));
}

// ψ (M, R, T) entry-major; offs (R, n_blk) the subsample's block offsets, or
// null for no subsample (n_blk = 1, blk = T); cur (R, T) the rows' current,
// overwritten; S (R, T); ent (R, 9, M): A, W, μ, σ, logit, u_a, u_mix,
// u_acc, z; out (3, R, M): A, W, the accept flags (0 or 1).
template <typename P>
__global__ void __launch_bounds__(kThreads, 1)
    row_scan(const P* __restrict__ psi, const int64_t* __restrict__ offs, float* __restrict__ cur,
             const float* __restrict__ S, const float* __restrict__ ent, float* __restrict__ out, int R, int M,
             int T, int n_blk, int blk, int K, int n_newton, int vec, float beta, float dt, float scale,
             float dt_scale, float beta_scale) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    __shared__ float wpart[2 * kWarps * kVals];
    __shared__ float cpart[2 * kVals];
    const int row = blockIdx.x / K, rank = blockIdx.x % K;
    const int T_sub = n_blk * blk;
    const int Ls = (T_sub + K - 1) / K;
    const int s_lo = min(T_sub, rank * Ls), n_s = min(T_sub, s_lo + Ls) - s_lo;
    int Lt = (T + K - 1) / K;
    if (vec) Lt = (Lt + 3) & ~3;
    const int t_lo = min(T, rank * Lt), t_hi = min(T, t_lo + Lt);
    float* ps = smem;           // ψ_s of the entry
    float* is = smem + Ls;      // I_s of the entry (I_sub without the edge)
    float* ss = smem + 2 * Ls;  // S_sub
    float* J = cur + (size_t)row * T;
    const float* Srow = S + (size_t)row * T;
    const int64_t* orow = offs ? offs + (size_t)row * n_blk : nullptr;
    auto bin = [&](int i) { return orow ? (int)orow[i / blk] + i % blk : i; };

    for (int i = threadIdx.x; i < n_s; i += kThreads) {
        const int t = bin(s_lo + i);
        ss[i] = Srow[t];
        is[i] = J[t];
    }
    int buf = 0;
    float gc_prev = 0.f, gn_prev = 0.f;  // the last entry's coupling before and after its update
    const P* pprev = nullptr;
    for (int m = 0; m < M; ++m) {
        const float* e = ent + (size_t)row * 9 * M + m;
        const float a_cur = e[0], w_cur = e[M], mu = e[2 * M], sig = e[3 * M], logit = e[4 * M];
        const float u_a = e[5 * M], u_mix = e[6 * M], u_acc = e[7 * M], z = e[8 * M];
        const float g_cur = a_cur * w_cur;
        const float prec = 1.f / (sig * sig);
        const P* pm = psi + ((size_t)m * R + row) * T;

        // the last entry's update of I_sub, ψ_s, I_s, and Σ S_sub·ψ_s
        float v1[1] = {0.f};
        for (int i = threadIdx.x; i < n_s; i += kThreads) {
            const float p = widen(pm[bin(s_lo + i)]);
            float x = is[i];
            if (m > 0) x = add_mul(x, gn_prev, ps[i]);
            is[i] = sub_mul(x, g_cur, p);
            ps[i] = p;
            v1[0] += __fmul_rn(ss[i], p);
        }
        cluster_sum(v1, wpart, cpart, buf, K);
        const float a_sub = v1[0] * scale;

        // Newton from the prior mean, then the curvature at w*
        float w = mu, h = 0.f;
        for (int it = 0;; ++it) {
            float v[2] = {0.f, 0.f};
            for (int i = threadIdx.x; i < n_s; i += kThreads) {
                const float p = ps[i];
                const float up = __fmul_rn(expf(clip(add_mul(is[i], w, p))), p);
                v[0] += up;
                v[1] += __fmul_rn(up, p);
            }
            cluster_sum(v, wpart, cpart, buf, K);
            const float d2 = beta * (-dt_scale * v[1]) - prec;
            if (it == n_newton) {
                h = fminf(d2, -0.1f * prec);
                break;
            }
            const float d1 = beta * (a_sub - dt_scale * v[0]) - (w - mu) * prec;
            w = w - d1 / fminf(d2, -0.1f * prec);
        }
        const float s_w = sqrtf(-1.f / h);

        // the subsampled ΔLL at w*
        float v2[1] = {0.f};
        for (int i = threadIdx.x; i < n_s; i += kThreads) {
            const float x0 = clip(is[i]), x1 = clip(add_mul(is[i], w, ps[i]));
            v2[0] += dll_term(ss[i], x1, x0, expf(x1), expf(x0), dt);
        }
        cluster_sum(v2, wpart, cpart, buf, K);
        const float zs = (w - mu) / sig;
        const float log_sig = logf(sig), log_s = logf(s_w);
        const float log_z1 = beta_scale * v2[0] - 0.5f * (zs * zs + kLog2Pi) - log_sig + 0.5f * kLog2Pi + log_s;
        const float p_birth = 1.f / (1.f + expf(-fminf(fmaxf(logit + log_z1, -3.5f), 3.5f)));
        const float a_prop = u_a < p_birth ? 1.f : 0.f;
        const float w_prior = mu + sig * z;
        const float w_birth = u_mix < 0.8f ? w + s_w * z : w_prior;
        const float w_prop = a_prop > 0.f ? w_birth : w_prior;

        // the exact ΔLLs over the full T
        float acc[2] = {0.f, 0.f};
        const bool store = m + 1 < M;
        if (m > 0)
            full_pass<true>(J, pprev, pm, Srow, t_lo, t_hi, vec, store, gc_prev, gn_prev, g_cur, w_prop, dt, acc);
        else
            full_pass<false>(J, pprev, pm, Srow, t_lo, t_hi, vec, false, gc_prev, gn_prev, g_cur, w_prop, dt, acc);
        cluster_sum(acc, wpart, cpart, buf, K);
        const float dll_prop = beta * acc[0], dll_cur = beta * acc[1];

        auto lq0 = [&](float x) {
            const float zp = (x - mu) / sig;
            return -0.5f * (zp * zp + kLog2Pi) - log_sig;
        };
        auto log_target = [&](float a, float x, float dll) { return lq0(x) + a * (dll + logit); };
        auto log_proposal = [&](float a, float x) {
            const float zq = (x - w) / s_w;
            const float lq_hat = -0.5f * (zq * zq + kLog2Pi) - log_s;
            const float l0 = lq0(x);
            return a > 0.f ? logf(p_birth) + logaddexp(kLogMix + lq_hat, kLogPrior + l0) : log1pf(-p_birth) + l0;
        };
        const float log_alpha = log_target(a_prop, w_prop, dll_prop) - log_proposal(a_prop, w_prop) -
                                log_target(a_cur, w_cur, dll_cur) + log_proposal(a_cur, w_cur);
        const bool accept = logf(u_acc) < log_alpha;
        const float a_new = accept ? a_prop : a_cur, w_new = accept ? w_prop : w_cur;
        if (rank == 0 && threadIdx.x == 0) {
            const size_t o = (size_t)row * M + m, RM = (size_t)R * M;
            out[o] = a_new;
            out[RM + o] = w_new;
            out[2 * RM + o] = accept ? 1.f : 0.f;
        }
        gc_prev = g_cur;
        gn_prev = a_new * w_new;
        pprev = pm;
    }
    if (K > 1) cg::this_cluster().sync();  // no CTA leaves while another reads its shared memory
}

template <typename P>
cudaError_t launch(const P* psi, const int64_t* offs, float* cur, const float* S, const float* ent, float* out,
                   int R, int M, int T, int n_blk, int blk, int K, int n_newton, int smem_bytes, int device,
                   float beta, float dt, float scale, float dt_scale, float beta_scale, cudaStream_t stream) {
    static int attr_bytes[kMaxDevices];  // the shared-memory attribute set so far, per device
    if (device < 0 || device >= kMaxDevices || K < 1 || K > 8 || R < 1 || M < 1 || T < 1 || n_blk < 1 ||
        blk < 1 || (long long)n_blk * blk > T || n_newton < 0)
        return cudaErrorInvalidValue;
    const int Ls = (n_blk * blk + K - 1) / K;
    if ((size_t)smem_bytes < (size_t)3 * Ls * sizeof(float)) return cudaErrorInvalidValue;
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (attr_bytes[device] < smem_bytes) {
        err = cudaFuncSetAttribute(row_scan<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
        if (err != cudaSuccess) return err;
        attr_bytes[device] = smem_bytes;
    }
    // 16-byte groups of the full-T pass where every row starts 16-byte aligned
    const int vec = T % 4 == 0 && ((uintptr_t)psi | (uintptr_t)cur | (uintptr_t)S) % 16 == 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(R * K);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = (size_t)smem_bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = K > 1 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, row_scan<P>, psi, offs, cur, S, ent, out, R, M, T, n_blk, blk, K, n_newton, vec,
                             beta, dt, scale, dt_scale, beta_scale);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

// The row scan of R rows of M entries. psi: (M, R, T) float32; offs: (R,
// n_blk) int64 block offsets of the subsample (null: none, n_blk = 1, blk =
// T); cur: (R, T) the rows' current, overwritten; S: (R, T); ent: (R, 9,
// M); out: (3, R, M). K: CTAs a row (a cluster), 1–8; smem_bytes ≥ 12 ·
// ceil(n_blk·blk / K).
extern "C" int adjacency_row_scan(const void* psi, const int64_t* offs, float* cur, const float* S,
                                  const float* ent, float* out, int R, int M, int T, int n_blk, int blk, int K,
                                  int n_newton, int smem_bytes, int device, float beta, float dt, float scale,
                                  float dt_scale, float beta_scale, void* stream) {
    return (int)launch(static_cast<const float*>(psi), offs, cur, S, ent, out, R, M, T, n_blk, blk, K, n_newton,
                       smem_bytes, device, beta, dt, scale, dt_scale, beta_scale, (cudaStream_t)stream);
}

// The same with ψ in bfloat16.
extern "C" int adjacency_row_scan_bf16(const void* psi, const int64_t* offs, float* cur, const float* S,
                                       const float* ent, float* out, int R, int M, int T, int n_blk, int blk,
                                       int K, int n_newton, int smem_bytes, int device, float beta, float dt,
                                       float scale, float dt_scale, float beta_scale, void* stream) {
    return (int)launch(static_cast<const __nv_bfloat16*>(psi), offs, cur, S, ent, out, R, M, T, n_blk, blk, K,
                       n_newton, smem_bytes, device, beta, dt, scale, dt_scale, beta_scale, (cudaStream_t)stream);
}

extern "C" const char* adjacency_row_scan_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
