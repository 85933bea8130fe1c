#!/usr/bin/env python3
"""Where the time of the fused Poisson-LL kernels goes, on one CUDA card.

Builds variants of a kernel source with one part switched off each (the
copies after each block's first tile, the forward product, the dU product,
the epilogue; or the whole body, to time the launch alone) and times the
kernels through the normal wrappers, warm and with the L2 flushed. A
variant's results are wrong by design; only its time is read.

Without ``--chains`` it probes K1 and K2 (``csrc/fused_poisson_ll.cu``) at
the flagship shape (T=60,000, NB=135, N=27), plus the full kernels at a few
shorter T to separate the per-call cost from the per-tile cost;
``--shape T,NB,N`` probes another shape instead (without the shorter T),
after printing each kernel's launch plan there. With ``--chains C`` it
probes the chain-batched value-and-gradient pair on C chains: K3-vg on a
float32 X_f and K4-vg-chains on the same X_f rounded to bf16, each in the
source that holds it. ``--tree DIR`` probes the kernels of another checkout
of the repository (its sources, wrappers and launch plans), e.g. the parent
commit unpacked under the ignored ``_archive/``. Run from the repository
root on the GPU machine:

    python3 theano_pyglm_torch/tools/kernel_probe.py [--shape 60000,5,1] [--chains 4] [--tree DIR]
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FLAGS = ("NO_COPY", "NO_FWD", "NO_BWD", "NO_EPI", "EXIT", "PLAIN_LAUNCH", "NO_TILES", "NO_DIOUT", "PROLOGUE",
         "NO_ROWS", "NO_SUMS")
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
    # where the source has the switches: no tile at all (the prologue and
    # the cross-block sums), and empty without dI_rest's copy-out
    "prologue": ("PROLOGUE",),  # returns once the first tile has landed
    "no_tiles": ("NO_TILES",),
    "no_tiles_rows": ("NO_TILES", "NO_ROWS"),  # nor the dU partial rows' writes
    "no_tiles_sums": ("NO_TILES", "NO_SUMS"),  # nor the cross-block sums after the barrier
    "empty_no_diout": ("NO_COPY", "NO_FWD", "NO_BWD", "NO_EPI", "NO_DIOUT"),
}
# a tile of no rows after each block's first: nothing to copy, the barriers still complete
_NO_COPY = ("        const int t0 = tile * tile_t, rows = min(tile_t, T - t0);\n",
            "        const int keep = !(PROBE_NO_COPY && tile != blockIdx.x);\n"
            "        const int t0 = tile * tile_t, rows = keep * min(tile_t, T - t0);\n")
_EXIT = ("    const bool lead_y = ys == 0;\n", "    const bool lead_y = ys == 0;\n    if (PROBE_EXIT) return;\n")


def _plain_launch(kernel: str, x: str) -> tuple:
    return ("    return cudaLaunchCooperativeKernel(",
            "    if (PROBE_PLAIN_LAUNCH) {\n"
            f"        {kernel}<<<dim3(grid_x, grid_y * G), kThreads, smem_bytes, stream>>>(\n"
            f"            {x}, u, i_rest, s, d_irest, part, out, bar, T, NB, N, W, tile_t, dt, log_dt, C);\n"
            "        return cudaGetLastError();\n"
            "    }\n"
            "    return cudaLaunchCooperativeKernel(")


# (anchor in the source, what replaces it) for each source file name; each
# anchor must occur once
EDITS = {
    # K1, K2, K3-fwd (and, before the chain vg kernels had a source of their own, K3-vg)
    "fused_poisson_ll.cu": [
        _EXIT, _NO_COPY, _plain_launch("fused_ll_tiles<kGrad, kChains>", "x_f"),
        ("for (int kk = 0; kk < KP; kk += 8) {", "for (int kk = 0; kk < (PROBE_NO_FWD ? 0 : KP); kk += 8) {"),
        ("            if (owns_du) {\n", "            if (owns_du && !PROBE_NO_BWD) {\n"),
        ("if (r < rows && col < nc) {  // the ragged",
         "if (PROBE_NO_EPI) part[0] += acc_lo[j][c] + acc_hi[j][c];\n"
         "                    if (!PROBE_NO_EPI && r < rows && col < nc) {  // the ragged"),
    ],
    # K4 as the parent of the redesign held it (K4-vg-chains in this template)
    "fused_poisson_ll_bf16.cu": [
        _EXIT, _NO_COPY, _plain_launch("fused_ll_bf16_tiles<kGrad, kChains>", "x"),
        ("for (int kk = 0; kk < KP; kk += 16) {", "for (int kk = 0; kk < (PROBE_NO_FWD ? 0 : KP); kk += 16) {"),
        ("const int kb_end = ceil_to(rows, 16) >> 4;", "const int kb_end = PROBE_NO_BWD ? 0 : ceil_to(rows, 16) >> 4;"),
        ("if (r < rows && col < nc) {  // the ragged",
         "if (PROBE_NO_EPI) part_v[0] += acc_lo[j][c] + acc_hi[j][c];\n"
         "                    if (!PROBE_NO_EPI && r < rows && col < nc) {  // the ragged"),
        ("if (kChains && kGrad && col < DC)", "if (!PROBE_NO_EPI && kChains && kGrad && col < DC)"),
    ],
    # K3-vg and K4-vg-chains, redesigned
    "fused_ll_vg_chains.cu": [
        _EXIT, _NO_COPY,
        ("    return cudaLaunchCooperativeKernel(",
         "    if (PROBE_PLAIN_LAUNCH) {\n"
         "        vg_chains_tiles<X><<<dim3(grid_x, grid_y), kThreads, smem_bytes, stream>>>(\n"
         "            x, u, i_rest, s, d_irest, part, out, bar, T, NB, N, C, tile_t, dt, log_dt);\n"
         "        return cudaGetLastError();\n"
         "    }\n"
         "    return cudaLaunchCooperativeKernel("),
        ("for (int kk = 0; kk < KP; kk += 16) {", "for (int kk = 0; kk < (PROBE_NO_FWD ? 0 : KP); kk += 16) {"),
        ("for (int kk = 0; kk < KP; kk += 8) {", "for (int kk = 0; kk < (PROBE_NO_FWD ? 0 : KP); kk += 8) {"),
        ("        const int kb_end = ceil_to(rows, K16) / K16;\n",
         "        const int kb_end = PROBE_NO_BWD ? 0 : ceil_to(rows, K16) / K16;\n"),
        # the products' sums stay live without the epilogue
        ("const bool live = col < CN;", "const bool live = !PROBE_NO_EPI && col < CN;"),
        ("float col_sum = 0.f;", "float col_sum = PROBE_NO_EPI ? acc[j][p] + acc[j][2 + p] : 0.f;"),
        ("    issue(blockIdx.x, 0);\n", "    if (!PROBE_NO_TILES) issue(blockIdx.x, 0);\n"),
        ("    // this warp's run of dU items",
         "    if (PROBE_PROLOGUE) {\n"
         "        asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n"
         "        mbar_wait(&s_bar[0], 0);\n"
         "        return;\n"
         "    }\n"
         "    // this warp's run of dU items"),
        ("tile < n_tiles; tile += gridDim.x, ++k) {", "tile < (PROBE_NO_TILES ? 0 : n_tiles); tile += gridDim.x, ++k) {"),
        ("    {\n        int m = m_first, n = n_first;", "    if (!PROBE_NO_ROWS) {\n        int m = m_first, n = n_first;"),
        ("    sum_part_rows(part, out", "    if (!PROBE_NO_SUMS) sum_part_rows(part, out"),
        ("        if (lead_y)\n            for (int ch = 0; ch < C; ++ch) copy_out(",
         "        if (lead_y && !PROBE_NO_DIOUT)\n            for (int ch = 0; ch < C; ++ch) copy_out("),
    ],
}
FLAGSHIP, DT = (60_000, 135, 27), 1e-3


def build(source, out_dir: str) -> dict:
    """{variant: ctypes library} of ``source`` with each variant's parts off."""
    src = source.read_text()
    for anchor, new in EDITS[source.name]:
        if src.count(anchor) != 1:
            raise RuntimeError(f"probe anchor not found once in {source.name}: {anchor!r}")
        src = src.replace(anchor, new)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"probe_{source.stem}.cu")
    with open(path, "w") as f:
        f.write(src)
    from theano_pyglm_torch.ops import cuda_loader

    procs = {}
    for name, on in VARIANTS.items():
        if not all(f"PROBE_{f}" in src for f in on):
            continue  # a switch this source does not have
        flags = [f"-DPROBE_{f}={int(f in on)}" for f in FLAGS]
        out = os.path.join(out_dir, f"{source.stem}_{name}.so")
        cmd = [cuda_loader._nvcc(), *cuda_loader.nvcc_flags(), *flags, "-I", str(source.parent), "-o", out, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(out)
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


class _Swapped:
    """While the block runs, the tree's loader hands out ``lib`` for
    ``source``, with the signatures the real build's entry points get."""

    NAMES = [f"fused_ll_{k}{sfx}" for k in ("fwd", "vg", "fwd_chains", "vg_chains") for sfx in ("", "_bf16")]

    def __init__(self, cuda_loader, source, lib):
        self.mod, self.source, self.lib = cuda_loader, source, lib

    def __enter__(self):
        self.orig = orig = self.mod._load

        def swapped(source, *rest):
            if source != self.source:
                return orig(source, *rest)
            real = orig(source, *rest)
            for name in self.NAMES + ["fused_ll_error_string"]:
                if hasattr(real, name) and hasattr(self.lib, name):
                    mine, got = getattr(self.lib, name), getattr(real, name)
                    mine.argtypes, mine.restype = got.argtypes, got.restype
            return self.lib

        self.mod._load = swapped
        return self

    def __exit__(self, *exc):
        self.mod._load = self.orig


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def probe_one_chain(T, NB, N, card, out_dir) -> None:
    """K1/K2 with each part off in turn."""
    from theano_pyglm_torch.ops import cuda_loader, kernels

    libs = build(cuda_loader.SOURCE, out_dir)
    r = np.random.RandomState(0)
    ops = [torch.as_tensor(a, dtype=torch.float32, device="cuda").contiguous() for a in
           (0.1 * r.randn(T, NB), 0.3 * r.randn(NB, N), r.randn(T, N) - 3.0, r.poisson(0.02, (T, N)))]
    flush = torch.empty(40 * 2**20, dtype=torch.float32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k, grad in (("K1", False), ("K2", True)):
        print(f"{k} at T={T}, NB={NB}, N={N}: {kernels.launch_plan(T, NB, N, sms, grad)}", flush=True)
    for name, lib in libs.items():
        with _Swapped(cuda_loader, cuda_loader.SOURCE, lib):
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


def probe_chains(T, NB, N, C, card, out_dir) -> None:
    """K3-vg and K4-vg-chains on C chains with each part off in turn, each
    built from the source of the tree that holds it."""
    from theano_pyglm_torch.ops import cuda_loader, kernels

    r = np.random.RandomState(2)
    x, u, ir, s = (torch.as_tensor(a, dtype=torch.float32, device="cuda").contiguous() for a in
                   (0.1 * r.randn(T, NB), 0.3 * r.randn(C, NB, N), r.randn(C, T, N) - 3.0, r.poisson(0.02, (T, N))))
    flush = torch.empty(40 * 2**20, dtype=torch.float32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chain_vg = getattr(cuda_loader, "SOURCE_VG_CHAINS", None)
    for k, xk, x_bytes, src in (("K3-vg", x, 4, chain_vg or cuda_loader.SOURCE),
                                ("K4-vg-chains", x.to(torch.bfloat16), 2, chain_vg or cuda_loader.SOURCE_BF16)):
        plan = kernels.launch_plan(T, NB, N, sms, True, chains=C, x_bytes=x_bytes)
        print(f"{k} at T={T}, NB={NB}, N={N}, C={C} ({src.name}): {plan}", flush=True)
        libs = build(src, out_dir)
        for name, lib in libs.items():
            with _Swapped(cuda_loader, src, lib):
                call = lambda: kernels.fused_ll_value_and_grad_chains(xk, u, ir, s, DT)  # noqa: E731
                print(f"{k} {name:10s} warm {median_us(call):7.1f} us cold {median_us(call, flush):7.1f} us"
                      f"  [{card}]", flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", default=",".join(map(str, FLAGSHIP)), help="T,NB,N")
    p.add_argument("--chains", type=int, default=0, help="probe K3-vg and K4-vg-chains on this many chains")
    p.add_argument("--tree", default=REPO, help="the checkout whose kernels are probed")
    args = p.parse_args()
    T, NB, N = (int(v) for v in args.shape.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe.py needs a CUDA device")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    card = _card()
    out_dir = os.path.join(tree, "theano_pyglm_torch", "_build", "probe")
    one = torch.zeros(1, device="cuda")
    print(f"{tree}: a one-element torch add, the same way: {median_us(lambda: one.add_(1.0)):7.1f} us", flush=True)
    if args.chains:
        probe_chains(T, NB, N, args.chains, card, out_dir)
    else:
        probe_one_chain(T, NB, N, card, out_dir)


if __name__ == "__main__":
    main()
