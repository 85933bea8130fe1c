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
after printing each kernel's launch plan there. ``--bf16`` probes K4-fwd
and K4-vg (``csrc/fused_poisson_ll_bf16.cu``) the same way, on the same X_f
rounded to bf16 (K4-fwd with the variants that mean something for a value
kernel). With ``--chains C`` it
probes the four chain-batched kernels on C chains (``--kernels`` picks
some): K3-fwd and K3-vg on a float32 X_f, K4-fwd-chains and K4-vg-chains on
the same X_f rounded to bf16, each built from the source of the tree that
holds it, a value kernel with the switches that mean something for it (no
dU switch). Variants need switches that a source of another version may
lack: those are skipped, with a note. ``--tree DIR`` probes the kernels of another checkout
of the repository (its sources, wrappers and launch plans), e.g. the parent
commit unpacked under the ignored ``_archive/``. Run from the repository
root on the GPU machine:

    python3 theano_pyglm_torch/tools/kernel_probe.py [--shape 60000,5,1] [--bf16] [--chains 4 [--kernels K3-fwd,...]] [--tree DIR]
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
         "NO_ROWS", "NO_SUMS", "NO_U", "NO_RELAYOUT", "NO_UCOPY", "NO_SPLIT", "ONE_PRODUCT", "SPLIT_U", "NO_DU",
         "NO_DI_SPLIT")
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
    # where the source stages U through shared memory: without U
    "prologue_no_u": ("PROLOGUE", "NO_U"),
    "no_tiles_no_u": ("NO_TILES", "NO_U"),
    "prologue_no_relayout": ("PROLOGUE", "NO_RELAYOUT"),  # U copied in, not laid out
    "prologue_no_ucopy": ("PROLOGUE", "NO_UCOPY"),  # U laid out from whatever stage 1 holds
    # where a value forward splits float32 operands for 3xTF32: the splits
    # off (three products of unsplit operands), or one product of three
    "no_split": ("NO_SPLIT",),
    "one_product": ("ONE_PRODUCT",),
    # K1/K2's wide-U instance: K2 without its dU phase (the forward and dI
    # only); dU without the split of dI into TF32 parts; the products only
    # (no copies after the first k-slabs and chunk, no epilogue)
    "no_du": ("NO_DU",),
    "no_di_split": ("NO_DI_SPLIT",),
    "products_only": ("NO_COPY", "NO_EPI"),
    # where the forward reads U pre-split into TF32 big and small parts:
    # U split on every k-step instead (the pre-split slots then hold U itself)
    "split_u": ("SPLIT_U",),
}
# a tile of no rows after each block's first: nothing to copy, the barriers still complete
_NO_COPY = ("        const int t0 = tile * tile_t, rows = min(tile_t, T - t0);\n",
            "        const int keep = !(PROBE_NO_COPY && tile != blockIdx.x);\n"
            "        const int t0 = tile * tile_t, rows = keep * min(tile_t, T - t0);\n")
_EXIT = ("    const bool lead_y = ys == 0;\n", "    const bool lead_y = ys == 0;\n    if (PROBE_EXIT) return;\n")
# every cooperative launch of the source through a plain one (defined after
# the runtime's headers, so that their declarations keep their names)
_PLAIN_LAUNCH = ('#include "fused_ll_common.cuh"\n',
                 '#include "fused_ll_common.cuh"\n'
                 "#define cudaLaunchCooperativeKernel(...) \\\n"
                 "    (PROBE_PLAIN_LAUNCH ? cudaLaunchKernel(__VA_ARGS__) : ::cudaLaunchCooperativeKernel(__VA_ARGS__))\n")
_NO_TILES = [("    issue(blockIdx.x, 0);\n", "    if (!PROBE_NO_TILES) issue(blockIdx.x, 0);\n"),
             ("tile < n_tiles; tile += gridDim.x, ++k) {",
              "tile < (PROBE_NO_TILES ? 0 : n_tiles); tile += gridDim.x, ++k) {")]


def _prologue(anchor: str) -> tuple:
    """Return once the first tile (and U) have landed, just before ``anchor``."""
    return (anchor, "    if (PROBE_PROLOGUE) {\n"
                    "        asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n"
                    "        mbar_wait(&s_bar[0], 0);\n"
                    "        return;\n"
                    "    }\n" + anchor)


def _no_epi(name: str, chains_line: str, line: str) -> list:
    """The epilogue off, the products' sums kept live in ``name``: an array
    of values per chain where the template held the chain instance (its
    epilogue's next line ``chains_line``), else a scalar (next line
    ``line``)."""
    head = "if (r < rows && col < nc) {  // the ragged tile, the padded columns\n" + " " * 24
    off = "if (PROBE_NO_EPI) {}{} += acc_lo[j][c] + acc_hi[j][c];\n" + " " * 20 + "if (!PROBE_NO_EPI && r < rows"
    return [(head + chains_line, off.format(name, "[0]") + head[len("if (r < rows"):] + chains_line),
            (head + line, off.format(name, "") + head[len("if (r < rows"):] + line)]


# a unit's products, kept live without the epilogue: a 16-bin unit's
# accumulators (n-tile, fragment) or a two-m-tile unit's (m-tile, n-tile,
# fragment)
_PROBE_SUM = """namespace {
template <int A, int B>
__device__ float probe_sum(const float (&a)[A][B], int j, int p) { return a[j][p] + a[j][2 + p]; }
template <int M, int A, int B>
__device__ float probe_sum(const float (&a)[M][A][B], int j, int p) { return a[0][j][p] + a[M - 1][j][2 + p]; }
}  // namespace
"""

_COMMON = [_EXIT, _NO_COPY, _PLAIN_LAUNCH, *_NO_TILES]
# (anchor in the source, what replaces it[, ALL]) for each source file name;
# an anchor occurs once or not at all (a source of another version of the
# tree), or, marked ALL, any number of times, and a variant is built only
# where all its switches are wired
ALL = "all"
EDITS = {
    # K1, K2 (and, in the trees before the chain kernels had one source, K3-fwd)
    "fused_poisson_ll.cu": _COMMON + [
        ("for (int kk = 0; kk < KP; kk += 8) {", "for (int kk = 0; kk < (PROBE_NO_FWD ? 0 : KP); kk += 8) {"),
        ("            if (owns_du) {\n", "            if (owns_du && !PROBE_NO_BWD) {\n"),
        *_no_epi("part", "const int ch = kChains ? col / N : 0;", "const int e = r * rs + col;"),
        _prologue("    // K2's dU: kMtM × kMtN micro-tiles"),
        ("    sum_columns(part, out, w4, s_join);", "    if (!PROBE_NO_SUMS) sum_columns(part, out, w4, s_join);"),
    ],
    # K4-fwd, K4-vg (and, in the trees before the chain kernels had one source, K4-fwd-chains)
    "fused_poisson_ll_bf16.cu": _COMMON + [
        ("for (int kk = 0; kk < KP; kk += 16) {", "for (int kk = 0; kk < (PROBE_NO_FWD ? 0 : KP); kk += 16) {"),
        ("for (int kk = 0; kk < KP; kk += 8) {", "for (int kk = 0; kk < (PROBE_NO_FWD ? 0 : KP); kk += 8) {"),
        ("            if (owns_du) {\n", "            if (owns_du && !PROBE_NO_BWD) {\n"),
        *_no_epi("part_v", "const int ch = kChains ? col / N : 0;", "const int e = r * rs + col;"),
        _prologue("    // K4-vg's dU: kMtM × kMtN micro-tiles"),
        ("    sum_columns(part, out, w4, s_join);", "    if (!PROBE_NO_SUMS) sum_columns(part, out, w4, s_join);"),
        # the tree whose K4 holds U split in shared memory and dU on the tensor cores
        ("const int KSV = KS8;", "const int KSV = PROBE_NO_FWD ? 0 : KS8;"),
        ("            float ir_v[E], s_v[E];\n",
         "            if (PROBE_NO_EPI) {  // the products' sums kept live\n"
         "                float v = 0.f;\n#pragma unroll\n"
         "                for (int q = 0; q < E; ++q) v += q < n_m ? am[q] : 0.f;\n"
         "                ll += v;\n                return;\n            }\n"
         "            float ir_v[E], s_v[E];\n"),
        ("const int kb_end = (rows + 7) >> 3;", "const int kb_end = PROBE_NO_BWD ? 0 : (rows + 7) >> 3;"),
        _prologue("    // the forward's units (32 bins"),
        ("    sum_part_rows(part, out", "    if (!PROBE_NO_SUMS) sum_part_rows(part, out"),
        ("    const bool staged = whole && UT + 4 <= SW;", "    const bool staged = !PROBE_NO_U && whole && UT + 4 <= SW;"),
        ("const int n_frag = KS8 * ntg * 32;", "const int n_frag = PROBE_NO_U ? 0 : KS8 * ntg * 32;"),
        ("split_tf32(lo ? dk[j * 8] : 0.f, bb[j][0], bs[j][0]);\n"
         "                            split_tf32(hi ? dk[j * 8 + 4 * rs] : 0.f, bb[j][1], bs[j][1]);",
         "if (PROBE_NO_SPLIT) {  // dI's B operand unsplit\n"
         "    bb[j][0] = __float_as_uint(lo ? dk[j * 8] : 0.f), bb[j][1] = __float_as_uint(hi ? dk[j * 8 + 4 * rs] : 0.f);\n"
         "    bs[j][0] = bs[j][1] = 0u;\n"
         "} else {\n"
         "split_tf32(lo ? dk[j * 8] : 0.f, bb[j][0], bs[j][0]);\n"
         "split_tf32(hi ? dk[j * 8 + 4 * rs] : 0.f, bb[j][1], bs[j][1]);\n}"),
        # U laid out unsplit and split on every k-step
        ("                    split_tf32(v[i][0], b.x, b.z);\n                    split_tf32(v[i][1], b.y, b.w);",
         "                    if (PROBE_SPLIT_U) b = make_uint4(__float_as_uint(v[i][0]), __float_as_uint(v[i][1]), 0u, 0u);\n"
         "                    else split_tf32(v[i][0], b.x, b.z), split_tf32(v[i][1], b.y, b.w);"),
        ("    mma_tf32(c, a, b.z, b.w);\n    mma_tf32(c, a, b.x, b.y);",
         "    uint4 q = b;\n"
         "    if (PROBE_SPLIT_U) split_tf32(__uint_as_float(b.x), q.x, q.z), split_tf32(__uint_as_float(b.y), q.y, q.w);\n"
         "    mma_tf32(c, a, q.z, q.w);\n    mma_tf32(c, a, q.x, q.y);"),
        ("        for (int r = warp; r < r_n; r += kWarps)", "        for (int r = warp; r < (PROBE_NO_ROWS ? 0 : r_n); r += kWarps)"),
        ("            if (lead_y && whole) copy_out(d_irest", "            if (!PROBE_NO_DIOUT && lead_y && whole) copy_out(d_irest"),
        ("            if (lead_y && !whole)\n#pragma unroll 4\n",
         "            if (!PROBE_NO_DIOUT && lead_y && !whole)\n#pragma unroll 4\n"),
    ],
    # K1/K2's wide-U instance (a copy switched off still completes its
    # barrier's phase: every thread arrives, thread 0 expects no bytes)
    "fused_poisson_ll_wide.cu": _COMMON + [
        ("    const bool vec = (NB & 3) == 0", "    if (PROBE_EXIT) return;\n    const bool vec = (NB & 3) == 0"),
        ("        if (step >= steps) return;\n",
         "        if (step >= steps) return;\n"
         "        if (PROBE_NO_COPY && step >= NSTG - 1) {\n"
         "            if (tid == 0) mbar_expect_tx(&s_full[step % NSTG], 0u);\n"
         "            cp_async_arrive(&s_full[step % NSTG]);\n"
         "            return;\n"
         "        }\n"),
        ("        auto issue_group = [&](int xi, int d0, int d1) {\n",
         "        auto issue_group = [&](int xi, int d0, int d1) {\n"
         "            if (PROBE_NO_COPY && xi > 0) xi = d0 = 1 << 30, d1 = -1;\n"),
        ("for (int kk = 0; kk < KSS; ++kk) {", "for (int kk = 0; kk < (PROBE_NO_FWD ? 0 : KSS); ++kk) {"),
        ("const int kl = cdiv(chunk_rows(ci), 8);", "const int kl = PROBE_NO_BWD ? 0 : cdiv(chunk_rows(ci), 8);"),
        ("for (int f = tid; f < cdiv(rows, 8) * NT * 32; f += kThreads) {",
         "for (int f = tid; f < (PROBE_NO_DI_SPLIT ? 0 : cdiv(rows, 8) * NT * 32); f += kThreads) {"),
        ("                if (j < ntw && r < rows && col < N) {",
         "                if (PROBE_NO_EPI) part_v += acc[i][j][2 * h] + acc[i][j][2 * h + 1];  // kept live\n"
         "                if (!PROBE_NO_EPI && j < ntw && r < rows && col < N) {"),
        ("        const int my_chunks = p < P && b_hi > b_lo",
         "        const int my_chunks = !PROBE_NO_DU && p < P && b_hi > b_lo"),
        ("    if (kGrad) sum_part_rows(part, out", "    if (kGrad && !PROBE_NO_SUMS) sum_part_rows(part, out"),
    ],
    # the four chain kernels: K3-fwd, K3-vg, K4-fwd-chains, K4-vg-chains
    "fused_ll_chains.cu": _COMMON + [
        ("for (int kk = 0; kk < KP; kk += 16) {", "for (int kk = 0; kk < (PROBE_NO_FWD ? 0 : KP); kk += 16) {"),
        ("for (int kk = 0; kk < KP; kk += 8) {", "for (int kk = 0; kk < (PROBE_NO_FWD ? 0 : KP); kk += 8) {"),
        ("const int kb_end = ceil_to(rows, K16) / K16;", "const int kb_end = PROBE_NO_BWD ? 0 : ceil_to(rows, K16) / K16;"),
        # the products' sums stay live without the epilogue (in both instances' epilogues)
        ("const bool live = col < CN;", "const bool live = !PROBE_NO_EPI && col < CN;", ALL),
        ("float col_sum = 0.f;", "float col_sum = PROBE_NO_EPI ? probe_sum(acc, j, p) : 0.f;", ALL),
        ("const int KPV = KP;", "const int KPV = PROBE_NO_FWD ? 0 : KP;"),
        ('#include "fused_ll_common.cuh"\n', '#include "fused_ll_common.cuh"\n' + _PROBE_SUM),
        _prologue("    // this warp's run of dU items"),
        ("        int m = m_first, n = n_first;\n#pragma unroll\n        for (int j = 0; j < kWarpTiles; ++j) {\n"
         "            if (j >= n_mine) break;",
         "        int m = m_first, n = n_first;\n#pragma unroll\n        for (int j = 0; j < kWarpTiles; ++j) {\n"
         "            if (PROBE_NO_ROWS || j >= n_mine) break;"),
        ("    sum_part_rows(part, out", "    if (!PROBE_NO_SUMS) sum_part_rows(part, out"),
        ("for (int q = 0; q < 4; ++q) split_tf32(x[i][q], ab[i][q], as[i][q]);",
         "for (int q = 0; q < 4; ++q)\n"
         "    if (PROBE_NO_SPLIT) ab[i][q] = __float_as_uint(x[i][q]), as[i][q] = 0u;\n"
         "    else split_tf32(x[i][q], ab[i][q], as[i][q]);"),
        ("split_tf32(u8[j][0], bb[j][0], bs[j][0]), split_tf32(u8[j][1], bb[j][1], bs[j][1]);",
         "if (PROBE_NO_SPLIT) bb[j][0] = __float_as_uint(u8[j][0]), bb[j][1] = __float_as_uint(u8[j][1]),\n"
         "    bs[j][0] = bs[j][1] = 0u;\n"
         "else split_tf32(u8[j][0], bb[j][0], bs[j][0]), split_tf32(u8[j][1], bb[j][1], bs[j][1]);"),
        ("for (int j = 0; j < W; ++j) mma_tf32(acc[i][j], as[i], bb[j][0], bb[j][1]);",
         "for (int j = 0; j < W && !PROBE_ONE_PRODUCT; ++j) mma_tf32(acc[i][j], as[i], bb[j][0], bb[j][1]);"),
        ("for (int j = 0; j < W; ++j) mma_tf32(acc[i][j], ab[i], bs[j][0], bs[j][1]);",
         "for (int j = 0; j < W && !PROBE_ONE_PRODUCT; ++j) mma_tf32(acc[i][j], ab[i], bs[j][0], bs[j][1]);"),
        ("for (int lo = 0, ph = 0; lo < UT; lo += cap, ++ph) {",
         "for (int lo = 0, ph = 0; lo < (PROBE_NO_U ? 0 : UT); lo += cap, ++ph) {"),
        ("    if constexpr (!kGrad) u_chunk(0);", "    if constexpr (!kGrad) if (!PROBE_NO_U) u_chunk(0);"),
        ("            // so that the reads' latencies overlap.\n",
         "            // so that the reads' latencies overlap.\n"
         "            if (!PROBE_NO_RELAYOUT)\n"),
        ("            mbar_expect_tx(&s_bar[2], (uint32_t)nb * 4);\n            if (nb) bulk_copy(",
         "            mbar_expect_tx(&s_bar[2], PROBE_NO_UCOPY ? 0u : (uint32_t)nb * 4);\n"
         "            if (nb && !PROBE_NO_UCOPY) bulk_copy("),
        ("if (lead_y)\n                for (int ch = 0; ch < C; ++ch) copy_out(",
         "if (lead_y && !PROBE_NO_DIOUT)\n                for (int ch = 0; ch < C; ++ch) copy_out("),
    ],
}
# the variants that mean something for a value-only kernel (no dU, no dI)
VALUE_VARIANTS = ("full", "exit", "exit_plain", "no_copy", "no_fwd", "no_epi", "copy_only", "empty", "prologue",
                  "products_only",
                  "no_tiles", "no_tiles_sums", "prologue_no_u", "no_tiles_no_u", "prologue_no_relayout",
                  "prologue_no_ucopy", "no_split", "one_product", "split_u")
FLAGSHIP, DT = (60_000, 135, 27), 1e-3


def build(source, out_dir: str, names=None) -> dict:
    """{variant: ctypes library} of ``source`` with each variant's parts off
    (of the variants in ``names``, default all), for every variant whose
    switches the source's anchors wire."""
    src = source.read_text()
    for anchor, new, *every in EDITS[source.name]:
        if src.count(anchor) > 1 and not every:
            raise RuntimeError(f"probe anchor found more than once in {source.name}: {anchor!r}")
        src = src.replace(anchor, new)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"probe_{source.stem}.cu")
    with open(path, "w") as f:
        f.write(src)
    from theano_pyglm_torch.ops import cuda_loader

    procs = {}
    for name, on in VARIANTS.items():
        if names is not None and name not in names:
            continue
        if not all(f"PROBE_{f}" in src for f in on):
            print(f"  ({source.name} has no switch for {name})", flush=True)
            continue
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

    NAMES = [f"fused_ll_{k}{sfx}" for k in ("fwd", "vg", "fwd_chains", "vg_chains") for sfx in ("", "_bf16")] + \
        ["fused_ll_fwd_wide", "fused_ll_vg_wide"]

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


def probe_one_chain(T, NB, N, card, out_dir, bf16=False) -> None:
    """K1/K2 (``bf16``: K4-fwd/K4-vg on the X_f rounded to bf16) with each
    part off in turn; K1/K2 from the wide-U instance's source where the
    plan takes it."""
    from theano_pyglm_torch.ops import cuda_loader, kernels

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    source = cuda_loader.SOURCE_BF16 if bf16 else cuda_loader.SOURCE
    if not bf16 and getattr(kernels.launch_plan(T, NB, N, sms, True), "k_slab", 0):
        source = cuda_loader.SOURCE_WIDE
    libs = build(source, out_dir)
    r = np.random.RandomState(0)
    ops = [torch.as_tensor(a, dtype=torch.float32, device="cuda").contiguous() for a in
           (0.1 * r.randn(T, NB), 0.3 * r.randn(NB, N), r.randn(T, N) - 3.0, r.poisson(0.02, (T, N)))]
    if bf16:
        ops[0] = ops[0].to(torch.bfloat16)
    flush = torch.empty(40 * 2**20, dtype=torch.float32, device="cuda")
    names = (("K4-fwd", "K4-vg") if bf16 else ("K1", "K2"))
    for k, grad in zip(names, (False, True)):
        plan = kernels.launch_plan(T, NB, N, sms, grad, x_bytes=ops[0].element_size())
        print(f"{k} at T={T}, NB={NB}, N={N} ({source.name}): {plan}", flush=True)
    for name, lib in libs.items():
        with _Swapped(cuda_loader, source, lib):
            row = [f"{name:10s}"]
            for k, fn in zip(names, (kernels.fused_ll_value, kernels.fused_ll_value_and_grad)):
                if fn is kernels.fused_ll_value and name not in VALUE_VARIANTS:
                    row.append(f"{k} -")
                    continue
                call = lambda fn=fn: fn(*ops, DT)  # noqa: E731
                row.append(f"{k} warm {median_us(call):7.1f} us cold {median_us(call, flush):7.1f} us")
            print(" | ".join(row) + f"  [{card}]", flush=True)
            if name in ("full", "exit") and (T, NB, N) == FLAGSHIP:
                for tt in (528, 15_312, 30_624):  # 1 tile of 4 bins, 1 and 2 tiles of 116 per block
                    short = [t[:tt].contiguous() if t.shape[0] == T else t for t in ops]
                    k1 = median_us(lambda: kernels.fused_ll_value(*short, DT))
                    k2 = median_us(lambda: kernels.fused_ll_value_and_grad(*short, DT))
                    print(f"  T={tt}: {names[0]} warm {k1:7.1f} us, {names[1]} warm {k2:7.1f} us", flush=True)


CHAIN_KERNELS = {  # name: (LAUNCHES key, gradient, bf16 X_f)
    "K3-fwd": ("fwd_chains", False, False), "K3-vg": ("vg_chains", True, False),
    "K4-fwd-chains": ("fwd_chains_bf16", False, True), "K4-vg-chains": ("vg_chains_bf16", True, True)}


def _source_of(cuda_loader, key: str):
    """The source that holds entry point ``fused_ll_<key>`` in the tree."""
    return next(src for src, names in cuda_loader.ENTRY_POINTS.items() if key in names)


def probe_chains(T, NB, N, C, card, out_dir, which) -> None:
    """The chain kernels in ``which`` on C chains with each part off in
    turn, each built from the source of the tree that holds it: K3-fwd and
    K3-vg on a float32 X_f, K4-fwd-chains and K4-vg-chains on the same X_f
    rounded to bf16."""
    from theano_pyglm_torch.ops import cuda_loader, kernels

    r = np.random.RandomState(2)
    x, u, ir, s = (torch.as_tensor(a, dtype=torch.float32, device="cuda").contiguous() for a in
                   (0.1 * r.randn(T, NB), 0.3 * r.randn(C, NB, N), r.randn(C, T, N) - 3.0, r.poisson(0.02, (T, N))))
    flush = torch.empty(40 * 2**20, dtype=torch.float32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    built = {}
    for k in which:
        key, grad, bf16 = CHAIN_KERNELS[k]
        xk = x.to(torch.bfloat16) if bf16 else x
        src = _source_of(cuda_loader, key)
        plan = kernels.launch_plan(T, NB, N, sms, grad, chains=C, x_bytes=2 if bf16 else 4)
        print(f"{k} at T={T}, NB={NB}, N={N}, C={C} ({src.name}): {plan}", flush=True)
        if src not in built:
            built[src] = build(src, out_dir)
        fn = kernels.fused_ll_value_and_grad_chains if grad else kernels.fused_ll_value_chains
        for name, lib in built[src].items():
            if not grad and name not in VALUE_VARIANTS:
                continue
            with _Swapped(cuda_loader, src, lib):
                call = lambda: fn(xk, u, ir, s, DT)  # noqa: E731
                print(f"{k} {name:10s} warm {median_us(call):7.1f} us cold {median_us(call, flush):7.1f} us"
                      f"  [{card}]", flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", default=",".join(map(str, FLAGSHIP)), help="T,NB,N")
    p.add_argument("--chains", type=int, default=0, help="probe the chain kernels on this many chains")
    p.add_argument("--bf16", action="store_true", help="without --chains: probe K4-fwd and K4-vg")
    p.add_argument("--kernels", default=",".join(CHAIN_KERNELS),
                   help="with --chains: which of " + ", ".join(CHAIN_KERNELS))
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
        probe_chains(T, NB, N, args.chains, card, out_dir, args.kernels.split(","))
    else:
        probe_one_chain(T, NB, N, card, out_dir, bf16=args.bf16)


if __name__ == "__main__":
    main()
