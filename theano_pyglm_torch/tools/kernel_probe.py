#!/usr/bin/env python3
"""Where the time of the fused Poisson-LL kernels goes, on one CUDA card.

Builds variants of ``theano_pyglm_torch/csrc/fused_poisson_ll.cu`` with one
part switched off each (the copies after the first tile, the forward
product, K2's dU product, the epilogue; or the whole body, to time the
launch alone) and times K1 and K2 through the normal wrappers at the
flagship shape (T=60,000, NB=135, N=27), warm and with the L2 flushed, plus
the full kernels at a few shorter T to separate the per-call cost from the
per-tile cost. ``--shape T,NB,N`` probes another shape instead (without
the shorter T), after printing each kernel's launch plan there. A
variant's results are wrong by design; only its time is read. Run from the
repository root on the GPU machine:

    python3 theano_pyglm_torch/tools/kernel_probe.py [--shape 60000,5,1]
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from theano_pyglm_torch.ops import cuda_loader, kernels  # noqa: E402

FLAGS = ("NO_COPY", "NO_FWD", "NO_BWD", "NO_EPI", "EXIT", "PLAIN_LAUNCH")
VARIANTS = {
    "full": (),
    "exit": ("EXIT",),  # returns at once: launch and timing overhead
    "exit_plain": ("EXIT", "PLAIN_LAUNCH"),  # the same through a non-cooperative launch
    "no_copy": ("NO_COPY",),  # only each block's first tile is copied
    "no_fwd": ("NO_FWD",),
    "no_bwd": ("NO_BWD",),
    "no_epi": ("NO_EPI",),
    "copy_only": ("NO_FWD", "NO_BWD", "NO_EPI"),
    "empty": ("NO_COPY", "NO_FWD", "NO_BWD", "NO_EPI"),
}
# (anchor in the source, what replaces it); each anchor must occur once
EDITS = [
    ("    const bool lead_y = ys == 0;\n",
     "    const bool lead_y = ys == 0;\n    if (PROBE_EXIT) return;\n"),
    ("        const int span = whole ? rows * N : 0, strided = whole ? 0 : rows * nc;\n"
     "        const int n[3] = {rows * NB, span, span};",  # nothing to copy: the barrier still completes
     "        const int keep = !(PROBE_NO_COPY && tile != blockIdx.x);\n"
     "        const int span = keep * (whole ? rows * N : 0), strided = keep * (whole ? 0 : rows * nc);\n"
     "        const int n[3] = {keep * rows * NB, span, span};"),
    ("    return cudaLaunchCooperativeKernel(",
     "    if (PROBE_PLAIN_LAUNCH) {\n"
     "        fused_ll_tiles<kGrad><<<dim3(grid_x, grid_y * G), kThreads, smem_bytes, stream>>>(\n"
     "            x_f, u, i_rest, s, d_irest, part, out, bar, T, NB, N, W, tile_t, dt, log_dt);\n"
     "        return cudaGetLastError();\n"
     "    }\n"
     "    return cudaLaunchCooperativeKernel("),
    ("for (int kk = 0; kk < KP; kk += 8) {", "for (int kk = 0; kk < (PROBE_NO_FWD ? 0 : KP); kk += 8) {"),
    ("            if (owns_du) {\n", "            if (owns_du && !PROBE_NO_BWD) {\n"),
    ("if (r < rows && n < nc) {  // the ragged",
     "if (PROBE_NO_EPI) part += acc_lo[j][c] + acc_hi[j][c];\n"
     "                    if (!PROBE_NO_EPI && r < rows && n < nc) {  // the ragged"),
]
FLAGSHIP, DT = (60_000, 135, 27), 1e-3


def build(out_dir: str) -> dict:
    src = cuda_loader.SOURCE.read_text()
    for anchor, new in EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"probe anchor not found once in the source: {anchor!r}")
        src = src.replace(anchor, new)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "probe.cu")
    with open(path, "w") as f:
        f.write(src)
    procs = {}
    for name, on in VARIANTS.items():
        flags = [f"-DPROBE_{f}={int(f in on)}" for f in FLAGS]
        out = os.path.join(out_dir, f"{name}.so")
        cmd = [cuda_loader._nvcc(), *cuda_loader.nvcc_flags(), *flags, "-o", out, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    ref = cuda_loader.load_fused_ll()
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(out)
        for fn in ("fused_ll_fwd", "fused_ll_vg", "fused_ll_error_string"):
            getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
            getattr(lib, fn).restype = getattr(ref, fn).restype
        libs[name] = lib
    return libs


def median_us(fn, flush=None, n: int = 30) -> float:
    """Device time between two CUDA events, a device sleep queued first so
    that the host is ahead; flush, if given, evicts the L2 outside the events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        if flush is not None:
            flush.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return 1e3 * float(np.median(times))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", default=",".join(map(str, FLAGSHIP)), help="T,NB,N")
    T, NB, N = (int(v) for v in p.parse_args().shape.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe.py needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    libs = build(os.path.join(REPO, "theano_pyglm_torch", "_build", "probe"))
    r = np.random.RandomState(0)
    ops = [torch.as_tensor(a, dtype=torch.float32, device="cuda").contiguous() for a in
           (0.1 * r.randn(T, NB), 0.3 * r.randn(NB, N), r.randn(T, N) - 3.0, r.poisson(0.02, (T, N)))]
    flush = torch.empty(40 * 2**20, dtype=torch.float32, device="cuda")
    one = torch.zeros(1, device="cuda")
    print(f"a one-element torch add, the same way: {median_us(lambda: one.add_(1.0)):7.1f} us", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k, grad in (("K1", False), ("K2", True)):
        print(f"{k} at T={T}, NB={NB}, N={N}: {kernels.launch_plan(T, NB, N, sms, grad)}", flush=True)
    load = cuda_loader.load_fused_ll
    try:
        for name, lib in libs.items():
            cuda_loader.load_fused_ll = lambda lib=lib: lib
            row = [f"{name:10s}"]
            for k, fn in (("K1", kernels.fused_ll_value), ("K2", kernels.fused_ll_value_and_grad)):
                call = lambda fn=fn: fn(*ops, DT)  # noqa: E731
                row.append(f"{k} warm {median_us(call):7.1f} us cold {median_us(call, flush):7.1f} us")
            print(" | ".join(row) + f"  [{card}]", flush=True)
            if name in ("full", "exit") and (T, NB, N) == FLAGSHIP:
                for tt in (528, 15_312, 30_624):  # 1 tile of 4 bins, 1 and 2 tiles of 116 per block
                    short = [t[:tt].contiguous() if t.shape[0] == T else t for t in ops]
                    k1 = median_us(lambda: kernels.fused_ll_value(*short, DT))
                    k2 = median_us(lambda: kernels.fused_ll_value_and_grad(*short, DT))
                    print(f"  T={tt}: K1 warm {k1:7.1f} us, K2 warm {k2:7.1f} us", flush=True)
    finally:
        cuda_loader.load_fused_ll = load


if __name__ == "__main__":
    main()
