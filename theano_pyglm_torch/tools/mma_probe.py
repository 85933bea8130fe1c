#!/usr/bin/env python3
"""The rate of the products the fused Poisson-LL kernels are built from, on
one CUDA card: mma.sync.m16n8k8 in TF32, mma.sync.m16n8k16 in bf16 and the
float32 FMA, each as a loop of independent products per warp (1, 4 or 16
accumulators a warp) at 8, 16 and 32 warps an SM, one block an SM. Prints
TFLOP/s for each, so that a kernel's product time can be read against what
the instruction gives at that many warps. Builds its own small source with
nvcc into ``theano_pyglm_torch/_build/``. Run from the repository root on
the GPU machine:

    python3 theano_pyglm_torch/tools/mma_probe.py
"""

import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from theano_pyglm_torch.ops import cuda_loader  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int K>
__global__ void tf32(float* out, int iters) {
    float c[K][4] = {};
    uint32_t a[4] = {threadIdx.x, threadIdx.x + 1u, threadIdx.x + 2u, threadIdx.x + 3u}, b0 = 7u, b1 = 9u;
    for (int i = 0; i < iters; ++i)
#pragma unroll
        for (int k = 0; k < K; ++k)
            asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                         : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
                         : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int K>
__global__ void bf16(float* out, int iters) {
    float c[K][4] = {};
    uint32_t a[4] = {threadIdx.x, threadIdx.x + 1u, threadIdx.x + 2u, threadIdx.x + 3u}, b0 = 7u, b1 = 9u;
    for (int i = 0; i < iters; ++i)
#pragma unroll
        for (int k = 0; k < K; ++k)
            asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                         : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
                         : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int K>
__global__ void ffma(float* out, int iters) {
    float c[K];
    const float x = 1.0001f * threadIdx.x, y = 0.9999f;
    for (int k = 0; k < K; ++k) c[k] = k;
    for (int i = 0; i < iters; ++i)
#pragma unroll
        for (int k = 0; k < K; ++k) c[k] = fmaf(x, c[k], y);
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += c[k];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
#define ENTRY(name, K) extern "C" int name##_##K(float* out, int blocks, int threads, int iters) { \
    name<K><<<blocks, threads>>>(out, iters); return (int)cudaGetLastError(); }
ENTRY(tf32, 1) ENTRY(tf32, 4) ENTRY(tf32, 16) ENTRY(bf16, 1) ENTRY(bf16, 4) ENTRY(bf16, 16) ENTRY(ffma, 16)
"""
FLOP = {"tf32": 16 * 8 * 8 * 2, "bf16": 16 * 8 * 16 * 2, "ffma": 32 * 2}  # a warp's product, a warp's FMA


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mma_probe.py needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out_dir = os.path.join(REPO, "theano_pyglm_torch", "_build", "mma_probe")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = os.path.join(out_dir, "mma_probe.cu"), os.path.join(out_dir, "mma_probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([cuda_loader._nvcc(), *cuda_loader.nvcc_flags(), "-o", lib_path, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 1024, device="cuda")
    iters = 4096
    for name, ks in (("tf32", (1, 4, 16)), ("bf16", (1, 4, 16)), ("ffma", (16,))):
        for k in ks:
            fn = getattr(lib, f"{name}_{k}")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            for warps in (8, 16, 32):
                call = lambda: fn(out.data_ptr(), sms, 32 * warps, iters)  # noqa: E731
                if call():  # too many registers for this many warps
                    print(f"{name} {k:2d} accumulators a warp, {warps:2d} warps an SM: not launched", flush=True)
                    torch.cuda.synchronize()
                    continue
                call()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                call()
                b.record()
                b.synchronize()
                ms = a.elapsed_time(b)
                flop = FLOP[name] * k * iters * warps * sms
                print(f"{name} {k:2d} accumulators a warp, {warps:2d} warps an SM: {flop / ms / 1e9:8.1f} TFLOP/s "
                      f"({ms:.3f} ms) [{card}]", flush=True)


if __name__ == "__main__":
    main()
