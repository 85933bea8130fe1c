#!/usr/bin/env python3
"""Smoke test of the PyTorch port (theano_pyglm_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device (built for an
H100, sm_90a):

    python3 chip_smoke.py

Phases, each of which raises on a mismatch or a non-finite value:

1. Setup: TF32 off for matmuls and convolutions, build the hand-written CUDA
   kernels from theano_pyglm_torch/csrc/ with nvcc (one process per source,
   started together), read the card's name and power limit.
2. Kernels K1 (value) and K2 (value+grad) of the fused Poisson
   log-likelihood against their plain PyTorch version at the flagship shape
   (T=60,000, N·B=135, N=27), with a clipped case, bit-for-bit repeatability,
   one launch per call, and the median device time of 50 calls each, warm
   and with the 50 MB L2 flushed, beside the plain version's, the bound
   (bytes read and written once over 3.35 TB/s, or float32 operations over
   67 TFLOP/s, whichever is longer) and the roofline share of the cold time.
   Then K3 (K3-fwd and K3-vg, the chain-batched pair) on the flagship's 4
   chains: against its plain version (with a clipped case) and against
   K1/K2 on each chain alone, bit for bit repeated, one launch per call,
   warm and cold times beside the plain version's and K1/K2's on the 4
   chains in turn, its bound (X_f and S read once for all chains) and share.
3. The flagship slice through the public API: make_model →
   Population.sample → simulate (T=60,000) → prepare_data →
   smart_initialize → map_fit → 20 adaptive HMC transitions of 10 leapfrog
   steps on the continuous block with A fixed. The kernels' launch counts
   are zeroed before and read after; every L-BFGS evaluation and leapfrog
   kick must have gone through K2 and every value-only log-joint through K1.
4. The inner-loop number: value+grad of the full log-joint in evals/s,
   through K2 and through the plain per-neuron torch path.
5. The flagship's Gibbs sampler on phase 3's population, data and MAP fit:
   theano_pyglm_torch.scripts.rgc_flagship.run with 4 chains, 40 warmup and
   10 sampling sweeps of the full sweep (glm Laplace block, HMC on the
   impulse logits and the latent locations, weight hypers, collapsed (A, W)
   birth-death, rotation), one batched sweep over the 4 chains, then R-hat,
   ESS and link-prediction AUC. The kernels' launch counts over the run must
   equal what the batched sweep implies: every likelihood evaluation one K3
   launch for all chains, none of K1/K2; every leaf finite, A binary, accept
   rates in range; psi, the log-joint and the glm Laplace mode of chain 0's
   final state on the card in float32 against the CPU in float64; one sweep
   of the 4 chains batched against the same sweep at C = 1 on each chain in
   turn, from the same state and generators: each chain within 1 % of its
   own run's elements (margin decisions in float32) and ten times nearer
   it than any other chain's (config 4 likewise). Printed: the 4-chain batched sweep and each stage alone at
   C = 4, and beside them the same code at C = 1 on the 4 chains in turn:
   ms per sweep, synchronizing calls, device activities, busy time and idle
   share.
6. Acceptance configs 1-4 (theano_pyglm_torch/scripts/acceptance.py) at
   their full N and T, depth cut. For each: K1/K2 against the plain version
   at the config's shape, as in phase 2, and K3 at its sampler's chains
   (configs 2-4); then, with the launch counts set to 0 just before and read
   just after, the config's path, where every likelihood evaluation must
   have gone through K1/K2 (fits) or K3 (samplers). Config 1 (N=1,
   T=60,000): MAP at least the truth's log-joint. Config 2 (ER N=10,
   T=240,000): 3-fold cross-validated lambda over [1, 3, 10], sparse MAP,
   the posterior-support sampler with 2 chains x (20 + 10) sweeps; K2
   launches equal to the training segments summed over the evaluations.
   Config 3 (N=10, T=30,000): MAP, 4 chains x (20 + 10) sweeps. Config 4
   (SBM N=16, T=60,000, planted partition): 4 chains x (40 annealed warmup
   + 10) sweeps, launches as the sweep implies, types, pi and B in range,
   no synchronizing call in the batched discrete stage or the full sweep
   (timed as in phase 5, beside C = 1 in turn), and the
   collapsed type conditionals and the log-joint of chain 0's final state
   on the card against the CPU in float64.
7. The sampler's model variants, each path with the launch counts set to
   0 just before it and read just after. 7a: spatiotemporal_glm at N=27,
   T=60,000 with its own widths (D_stim=25, stimulus and impulse bases of
   5): simulate, prepare_data, smart init, MAP, 4 chains x (40 + 10)
   sweeps of the bilinear glm block; launches exactly as implied, glm
   acceptance above 0.5, both sub-blocks' Laplace modes (1e-4 rel. L2) and
   the log-joint (1e-5 rel.) of chain 0's final state against the CPU in
   float64, 0 synchronizing calls in the glm stage and the full sweep,
   stage times and device busy time. 7b: standard_glm at N=27, T=60,000
   with the stimulus type 'shared' (DB=5), 1 chain x (40 + 10): launches,
   0 synchronizing calls in the glm stage, both sub-blocks' modes against
   the CPU. 7c: config 3's shape (N=10, T=30,000) with softplus, then with
   Bernoulli observations, 1 chain x 10 sweeps of the autograd branches: no
   fused launch, _bin_ll_derivs against the CPU (1e-4). 7d: phase 3's
   flagship, 1 chain x (40 + 10) with glm_update='hmc' and again with
   bias_update='ars': launches, accept rates, one host round trip per ARS
   pass (counted by the sync debug mode), the whitening factor against the
   CPU (1e-5). 7e: K1/K2 against the plain version at the held-out shape
   (T=12,000), as in phase 2, then the predictive log-likelihood of 7a's 40
   draws on the last 20 % of a fresh simulation of 7a's generating
   parameters: one K1 launch per draw, above a prior draw's. 7f: 7a's
   model, 2 chains x 30 sweeps checkpointed every 10, uninterrupted and
   stopped at 20 then resumed: the kept draws and final states equal bit
   for bit.
8. Long recordings at N=100, T=600,000 (10 min at 1 ms), B=5: the model,
   planted network and stimulus of
   theano_pyglm_torch/scripts/stretch_streaming.py. 8a: K1/K2 against the
   plain version as in phase 2 at the path's three shapes, all in two
   column groups of U: (600,000, 500, 100) resident, (65,536, 500, 100)
   one block, (10,176, 500, 100) the ragged last block, each with the bound
   of X_f read once and read once per group. 8b: simulate, mean rate in
   1-20 Hz. 8c: MAP on the streamed design (time_chunk=65,536, no X_imp):
   K2 launches 10 x the value+grad evaluations and K1 10 x the value-only
   ones, the MAP log-joint at least the truth's, and the device memory one
   streamed value+grad evaluation adds below the 1.2 GB design. 8d: the
   resident log-likelihood at the MAP point equal to the streamed one
   (1e-5 rel.), then 1 chain x (40 + 10) sweeps with row_batch=4:
   launches as the sweep implies, leaves finite, A binary, ms per sweep,
   and one sweep of each stage alone.
   8e: the card's float32 streamed log-joint and gradient at the truth
   against the CPU's float64 (1e-5 rel., 1e-4 rel. L2), over the full T if
   the CPU's projected time is under 60 s, else over the first two blocks.
9. The harness at the flagship's width, N=27, 60 s: a .mat fixture
   (utils/rgc.py), binned by the native binner and by numpy, the same
   counts; K1/K2 against the plain version as in phase 2 at fit_rgc's
   training shape (T=48,000); scripts/fit_rgc.py on it (MAP, 40 + 20 sweeps, report); then
   cli generate, map and mcmc (40 + 20): every output written (the figure
   where matplotlib is installed), every likelihood evaluation through K1
   or K2 and both launched.
10. The bf16 spike design (Population(design_dtype=torch.bfloat16)), K4.
   10a: K4-fwd and K4-vg (no chain axis: U float32) and K4-fwd-chains and
   K4-vg-chains (4 chains: U and dI rounded to bf16) against their plain
   versions at the flagship shape, with a clipped case, bit-for-bit
   repeats, one launch per call, warm and cold median times of 50 calls
   beside the plain version's and beside K1/K2/K3 on the widened X_f, the
   bound (bf16 X_f bytes; the chain kernels' bf16 products at 989 TFLOP/s)
   and share; the chain pair likewise at configs 2-4's shapes. 10b: phase
   3's spikes, stimulus and model with a bf16 design: prepare_data, smart
   init, MAP (K4-vg launches equal to the L-BFGS evaluations), then
   rgc_flagship.run with 4 chains x (20 + 10) batched sweeps (K4-chains
   launches as the sweep implies, none of K1-K3 or of K4 without a chain
   axis), leaves finite, A binary; the card's bf16 log-joints at the final
   state against the CPU's bf16 (1e-5 rel., with and without a chain
   axis); bf16 against float32 at the float32 MAP point (log-joint,
   gradient and coupling current, reported); the bf16 batched sweep's ms
   beside the float32 one's in turns. 10c: one batched bf16 sweep against
   C = 1 in turn, each with a chain axis of 1 (the chain semantics, K4-chains
   only), at phase 5's limits.

Depths cut to keep the script near 10 minutes once phases 8-9 came (their
widths, N and T, are not cut; no warmup is cut): the kept sweeps of phase
5, config 4 and 7a from 20 to 10, the per-stage timings from 5 sweeps to
3. Every sampler run with 40 warmup sweeps (the least for which
inference/mcmc.py's warmup_schedule opens the mass-matrix windows) adapts
the diagonal mass of each HMC block its model has: the impulse block (imp)
in phases 5, 6 (config 4), 7a, 7b, 7d, 8d and 9; the latent locations in
phases 5 and 7d; the whitened glm-HMC block in 7d (glm_update='hmc').
Configs 2 and 3 keep their 20 warmup sweeps (step size only), as before.
Phase 10's sampler runs 20 warmup sweeps (step size only): its depth is
cut before any other phase's.

The samplers of more than one chain (phases 5, 6 configs 2-4, 7a, 7f) run
one batched sweep over their chains and launch K3; the one-chain samplers
(7b, 7c, 7d, 8d, 9) run the same sweep at C = 1, where K1/K2 carry the
likelihood. With a bf16 design (phase 10) every sampler evaluation is a
K4-chains launch, at any C.

The line before the last two is one JSON object describing the kernels
K1, K2, K3-fwd and K3-vg (times and errors from phase 2) and the four K4
(from 10a), with launches summed over the paths of phases 3, 5, 6, 7, 8, 9
and 10, each of which must have launched at least once; the next the
card's name and power limit; the last
is {"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result.
"""

import json
import math
from collections import Counter
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from theano_pyglm_torch import Population, make_model  # noqa: E402
from theano_pyglm_torch.inference import ars, gibbs  # noqa: E402
from theano_pyglm_torch.inference.hmc import hmc_adaptive_step, hmc_init  # noqa: E402
from theano_pyglm_torch.inference.map import cross_validate_lambda, map_fit, sparse_map_fit, split_params  # noqa: E402
from theano_pyglm_torch.inference.mcmc import SWEEP_STAGES, _glm_theta0, gibbs_sample, make_sweep  # noqa: E402
from theano_pyglm_torch.inference.mcmc import chain_state, init_mcmc_state, stack_states  # noqa: E402
from theano_pyglm_torch.inference.mcmc import whitening_factor  # noqa: E402
from theano_pyglm_torch.inference.predictive import predictive_log_likelihood  # noqa: E402
from theano_pyglm_torch.inference.smart_init import smart_initialize  # noqa: E402
from theano_pyglm_torch.ops import kernels  # noqa: E402
from theano_pyglm_torch.ops.cuda_loader import SOURCE, SOURCE_BF16, build_all, load_fused_ll, load_fused_ll_bf16  # noqa: E402
from theano_pyglm_torch.parallel import gibbs_sample_chains  # noqa: E402
from theano_pyglm_torch.scripts import acceptance, rgc_flagship  # noqa: E402
from theano_pyglm_torch.utils.diagnostics import adjusted_rand_index  # noqa: E402

N = 27  # neurons (the flagship, scripts/rgc_flagship.py)
T = 60_000  # 1 ms bins
DT = 1e-3
SEED = 0
HMC_TRANSITIONS, LEAPFROG_STEPS = 20, 10
GIBBS_CHAINS, GIBBS_WARMUP, GIBBS_SAMPLES = 4, 40, 10  # 40: the least warmup with adaptation windows
REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published peak rates
FP32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12  # bf16 × bf16 on the tensor cores, dense


def median_ms(fn, n: int = 50, warmup: int = 3, flush=None, device_only: bool = True) -> float:
    """Median over n calls, each timed between two CUDA events.

    device_only: a device-side sleep is queued before the first event, so the
    host has queued the whole call before the device reaches it and the
    events bracket device time alone (without it, as in the first port's
    numbers, a call whose host work outlasts its kernels is timed by the
    host). flush: a buffer larger than the 50 MB L2, written before the
    first event.
    """
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(2_000_000)
        if flush is not None:
            flush.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(k: str, ops, x_reads: int = 1) -> tuple:
    """(ms, resource): the least time the card could take for kernel k on
    these operands: each input read once (at its element size: a bf16 X_f
    is 2 bytes), each output written once, against the multiply-adds of the
    product(s): float32 operations at FP32_FLOP_PER_S, the chain kernels'
    bf16 × bf16 products of a bf16 X_f (K4-chains) at BF16_FLOP_PER_S.
    ``x_reads``: count X_f that many times (the kernels read it once per
    column group). K3's operands carry C chains of U and I_rest: C times the
    products and outputs, one read of X_f and S."""
    x, u, ir, s = ops
    T, NB = x.shape
    N = u.shape[-1]
    C = u.shape[0] if u.ndim == 3 else 1
    nbytes = sum(t.numel() * t.element_size() for t in ops) + (x_reads - 1) * x.numel() * x.element_size()
    flops = 2 * T * NB * N * C
    if k.startswith("vg"):
        nbytes += 4 * C * (T * N + NB * N + 1)  # dI_rest, dU, ll
        flops *= 2  # X_fᵀ @ dI_rest
    else:
        nbytes += 4 * C
    rate = BF16_FLOP_PER_S if "chains" in k and x.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


F32_KERNELS = ("fwd", "vg", "fwd_chains", "vg_chains")  # K1, K2, K3-fwd, K3-vg
BF16_KERNELS = tuple(k + "_bf16" for k in F32_KERNELS)  # K4-fwd, K4-vg, K4-fwd-chains, K4-vg-chains
KERNELS = F32_KERNELS + BF16_KERNELS  # kernels.LAUNCHES' keys
assert set(KERNELS) == set(kernels.LAUNCHES)


def zero_launches() -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    kernels.LAUNCHES.update({k: 0 for k in KERNELS})


def launches_of(**counts) -> dict:
    """Launch counts of every kernel: those given, the rest 0."""
    return {**dict.fromkeys(KERNELS, 0), **counts}


# --- phase 1 ----------------------------------------------------------------


def setup() -> str:
    require(torch.cuda.is_available(), "no CUDA device: chip_smoke.py runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    built = build_all()  # one nvcc per source, started together
    load_fused_ll()
    load_fused_ll_bf16()
    log(f"built {', '.join(os.path.relpath(p, REPO) for p, _ in built.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    for _, build_log in built.values():
        for line in build_log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    card = gpu_name_and_power()
    log(f"gpu: {card}")
    return card


# --- phase 2 ----------------------------------------------------------------


def _kernel_operands(dev, T, N, clip_entries=0, on_device=False):
    """X_f (T, 5N), U, I_rest and S in float32 on the card, from numpy
    (or, ``on_device``, from a CUDA generator: the long recording's 300M
    draws), both seeded with SEED."""
    NB = N * 5
    if on_device:
        g = torch.Generator(device=dev).manual_seed(SEED)
        f = dict(dtype=torch.float32, device=dev, generator=g)
        x, u = 0.1 * torch.randn((T, NB), **f), 0.3 * torch.randn((NB, N), **f)
        ir = torch.randn((T, N), **f) - 3.0
        s = torch.poisson(torch.full((T, N), 0.02, device=dev), generator=g)
        if clip_entries:
            idx = torch.randperm(T * N, device=dev, generator=g)[:clip_entries]
            ir.view(-1)[idx] = torch.where(torch.arange(clip_entries, device=dev) % 2 == 0, 45.0, -45.0)
        return [x, u, ir, s]
    r = np.random.RandomState(SEED)
    x = 0.1 * r.randn(T, NB)
    u = 0.3 * r.randn(NB, N)
    ir = r.randn(T, N) - 3.0
    s = r.poisson(0.02, (T, N))
    if clip_entries:
        idx = r.choice(T * N, clip_entries, replace=False)
        ir.reshape(-1)[idx] = np.where(np.arange(clip_entries) % 2 == 0, 45.0, -45.0)
    return [torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous() for a in (x, u, ir, s)]


def check_kernels(dev, T, N, label, card, on_device=False) -> dict:
    """K1/K2 against the plain version at (T, NB=5N, N): value 1e-5
    relative, dU 1e-5 relative L2, dI_rest rtol=1e-5 / atol=1e-6 — float32
    sums over up to 60M terms taken in another order. Then bit-for-bit
    repeats, one launch per call, and the median times, with the bound of
    the single read and, where U is cut into G column groups, of X_f read G
    times."""
    max_err = {"fwd": 0.0, "vg": 0.0}
    for clip_entries in (0, 500):
        ops = _kernel_operands(dev, T, N, clip_entries, on_device)
        ll_r, du_r, dir_r = kernels.fused_poisson_ll_reference(*ops, DT)
        v = kernels.fused_ll_value(*ops, DT)
        ll, du, dir_ = kernels.fused_ll_value_and_grad(*ops, DT)
        torch.cuda.synchronize()
        ref = float(ll_r)
        rel_v, rel_ll = abs(float(v) - ref) / abs(ref), abs(float(ll) - ref) / abs(ref)
        rel_du = float(torch.linalg.norm(du - du_r) / torch.linalg.norm(du_r))
        err_dir = float((dir_ - dir_r).abs().max())
        log(f"{label} T={T} N={N}, kernels vs plain (clipped entries {clip_entries}): K1 value rel {rel_v:.3e}; "
            f"K2 value rel {rel_ll:.3e}, dU rel-L2 {rel_du:.3e}, dI_rest max abs {err_dir:.3e}")
        require(math.isfinite(float(v)) and math.isfinite(float(ll)), "non-finite kernel value")
        require(rel_v <= 1e-5, f"K1 value rel err {rel_v}")
        require(rel_ll <= 1e-5, f"K2 value rel err {rel_ll}")
        require(rel_du <= 1e-5, f"K2 dU rel-L2 err {rel_du}")
        torch.testing.assert_close(dir_, dir_r, rtol=1e-5, atol=1e-6)
        if clip_entries:
            require(int((dir_ == 0).sum()) >= clip_entries, "clip mask not applied")
        else:
            max_err["fwd"] = abs(float(v) - ref)
            max_err["vg"] = max(abs(float(ll) - ref), float((du - du_r).abs().max()), err_dir)

    ops = _kernel_operands(dev, T, N, on_device=on_device)
    launches = dict(kernels.LAUNCHES)
    a, b = kernels.fused_ll_value_and_grad(*ops, DT), kernels.fused_ll_value_and_grad(*ops, DT)
    require(all(torch.equal(x, y) for x, y in zip(a, b)), "K2 not bit-for-bit repeatable")
    require(torch.equal(kernels.fused_ll_value(*ops, DT), kernels.fused_ll_value(*ops, DT)),
            "K1 not bit-for-bit repeatable")
    require(kernels.LAUNCHES == {**launches, "fwd": launches["fwd"] + 2, "vg": launches["vg"] + 2},
            f"not one launch per call: {launches} -> {kernels.LAUNCHES}")
    log("kernels repeat bit for bit, one launch per call")

    fns = {
        "fwd": (lambda: kernels.fused_ll_value(*ops, DT),
                lambda: kernels.fused_poisson_ll_value_reference(*ops, DT)),
        "vg": (lambda: kernels.fused_ll_value_and_grad(*ops, DT),
               lambda: kernels.fused_poisson_ll_reference(*ops, DT)),
    }
    flush = torch.empty(40 * 2**20, dtype=torch.float32, device=dev)  # 160 MB
    stats = {}
    for k, (kern, plain) in fns.items():
        warm, cold = median_ms(kern), median_ms(kern, flush=flush)
        plain_warm, plain_cold = median_ms(plain), median_ms(plain, flush=flush)
        enqueue = median_ms(kern, device_only=False)
        bound_ms, bound_by = bound(k, ops)
        share = bound_ms / cold
        plan = kernels.launch_plan(T, 5 * N, N, kernels._sm_count(dev.index), k == "vg")
        log(f"{label} T={T} NB={5 * N} N={N}, median of 50 calls, {k}: kernel {warm:.4f} ms warm, "
            f"{cold:.4f} ms cold; plain torch {plain_warm:.4f} ms warm, {plain_cold:.4f} ms cold; "
            f"bound {bound_ms:.4f} ms ({bound_by}); roofline share of the cold time {100 * share:.1f} %; "
            f"host-inclusive events (the first port's method) {enqueue:.4f} ms [{card}]")
        if plan.groups > 1:
            g_ms, g_by = bound(k, ops, x_reads=plan.groups)
            log(f"  {k}: {plan.groups} column groups of {plan.group_cols}, tile {plan.tile_t}, grid "
                f"{plan.grid_x} x {plan.grid_y * plan.groups}; with X_f read {plan.groups} times the bound is "
                f"{g_ms:.4f} ms ({g_by}), share {100 * g_ms / cold:.1f} %")
        if warm < bound_ms:
            log(f"  {k}: the warm time beats the HBM bound because X_f ({ops[0].numel() * 4 / 1e6:.1f} MB) "
                f"stays in the 50 MB L2; no share is taken from it")
        stats[k] = {"max_abs_err": max_err[k], "ms": warm, "cold_ms": cold, "plain_ms": plain_warm,
                    "plain_cold_ms": plain_cold, "bound_ms": bound_ms, "bound_by": bound_by,
                    "share": share, "library_ms": None}
    return stats


def _chain_operands(dev, T, N, C, clip_entries=0):
    """X_f (T, 5N), C chains of U (C, 5N, N) and I_rest (C, T, N), and S
    (T, N) in float32 on the card, from numpy seeded with SEED."""
    NB = 5 * N
    r = np.random.RandomState(SEED + 2)
    x = 0.1 * r.randn(T, NB)
    u = 0.3 * r.randn(C, NB, N)
    ir = r.randn(C, T, N) - 3.0
    s = r.poisson(0.02, (T, N))
    if clip_entries:
        idx = r.choice(C * T * N, clip_entries, replace=False)
        ir.reshape(-1)[idx] = np.where(np.arange(clip_entries) % 2 == 0, 45.0, -45.0)
    return [torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous() for a in (x, u, ir, s)]


def _rel(a, b) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def check_chain_kernels(dev, T, N, C, label, card) -> dict:
    """K3-fwd and K3-vg on C chains at (T, NB=5N, N) against the plain
    version, K1/K2's limits: each chain's value 1e-5 relative, dU 1e-5
    relative L2, dI_rest rtol=1e-5 / atol=1e-6, with a clipped case; each
    chain against K1/K2 on that chain alone, the same limits; bit-for-bit
    repeats, one launch per call; the median times of 50 calls, warm and
    L2-cold, beside the plain version's and beside K1/K2 launched on the C
    chains in turn; the bound (X_f and S read once for all chains) and the
    roofline share of the cold time."""
    max_err = {}
    for clip_entries in (0, 500):
        ops = _chain_operands(dev, T, N, C, clip_entries)
        ll_r, du_r, dir_r = kernels.fused_poisson_ll_chains_reference(*ops, DT)
        v = kernels.fused_ll_value_chains(*ops, DT)
        ll, du, dir_ = kernels.fused_ll_value_and_grad_chains(*ops, DT)
        torch.cuda.synchronize()
        rel_v = float(((v - ll_r).abs() / ll_r.abs()).max())
        rel_ll = float(((ll - ll_r).abs() / ll_r.abs()).max())
        rel_du, err_dir = _rel(du, du_r), float((dir_ - dir_r).abs().max())
        require(bool(torch.isfinite(v).all() and torch.isfinite(ll).all()), f"{label}: non-finite K3 value")
        require(rel_v <= 1e-5, f"{label}: K3-fwd value rel err {rel_v}")
        require(rel_ll <= 1e-5, f"{label}: K3-vg value rel err {rel_ll}")
        require(rel_du <= 1e-5, f"{label}: K3-vg dU rel-L2 err {rel_du}")
        torch.testing.assert_close(dir_, dir_r, rtol=1e-5, atol=1e-6)
        # each chain alone through K1/K2
        worst = {"value": 0.0, "dU": 0.0, "dI_rest": 0.0}
        for c in range(C):
            u_c, ir_c = ops[1][c].contiguous(), ops[2][c].contiguous()
            ll_c, du_c, dir_c = kernels.fused_ll_value_and_grad(ops[0], u_c, ir_c, ops[3], DT)
            v_c = kernels.fused_ll_value(ops[0], u_c, ir_c, ops[3], DT)
            worst["value"] = max(worst["value"], abs(float(ll[c]) - float(ll_c)) / abs(float(ll_c)),
                                 abs(float(v[c]) - float(v_c)) / abs(float(v_c)))
            worst["dU"] = max(worst["dU"], _rel(du[c], du_c))
            worst["dI_rest"] = max(worst["dI_rest"], float((dir_[c] - dir_c).abs().max()))
            torch.testing.assert_close(dir_[c], dir_c, rtol=1e-5, atol=1e-6)
        require(worst["value"] <= 1e-5 and worst["dU"] <= 1e-5, f"{label}: K3 against K1/K2 per chain {worst}")
        log(f"{label} T={T} N={N} C={C}, K3 vs plain (clipped entries {clip_entries}): K3-fwd value rel "
            f"{rel_v:.3e}; K3-vg value rel {rel_ll:.3e}, dU rel-L2 {rel_du:.3e}, dI_rest max abs {err_dir:.3e}; "
            f"against K1/K2 on each chain alone: value rel {worst['value']:.3e}, dU rel-L2 {worst['dU']:.3e}, "
            f"dI_rest max abs {worst['dI_rest']:.3e}")
        if clip_entries:
            require(int((dir_ == 0).sum()) >= clip_entries, f"{label}: K3 clip mask not applied")
        else:
            max_err["fwd_chains"] = float((v - ll_r).abs().max())
            max_err["vg_chains"] = max(float((ll - ll_r).abs().max()), float((du - du_r).abs().max()), err_dir)

    ops = _chain_operands(dev, T, N, C)
    launches = dict(kernels.LAUNCHES)
    a, b = kernels.fused_ll_value_and_grad_chains(*ops, DT), kernels.fused_ll_value_and_grad_chains(*ops, DT)
    require(all(torch.equal(x, y) for x, y in zip(a, b)), f"{label}: K3-vg not bit-for-bit repeatable")
    require(torch.equal(kernels.fused_ll_value_chains(*ops, DT), kernels.fused_ll_value_chains(*ops, DT)),
            f"{label}: K3-fwd not bit-for-bit repeatable")
    want = {**launches, "fwd_chains": launches["fwd_chains"] + 2, "vg_chains": launches["vg_chains"] + 2}
    require(kernels.LAUNCHES == want, f"{label}: K3 not one launch per call: {launches} -> {kernels.LAUNCHES}")
    log(f"{label}: K3 repeats bit for bit, one launch per call")

    x, u, ir, s = ops
    per = [(u[c].contiguous(), ir[c].contiguous()) for c in range(C)]
    fns = {
        "fwd_chains": (lambda: kernels.fused_ll_value_chains(*ops, DT),
                       lambda: kernels.fused_poisson_ll_chains_value_reference(*ops, DT),
                       lambda: [kernels.fused_ll_value(x, u_c, ir_c, s, DT) for u_c, ir_c in per]),
        "vg_chains": (lambda: kernels.fused_ll_value_and_grad_chains(*ops, DT),
                      lambda: kernels.fused_poisson_ll_chains_reference(*ops, DT),
                      lambda: [kernels.fused_ll_value_and_grad(x, u_c, ir_c, s, DT) for u_c, ir_c in per]),
    }
    flush = torch.empty(40 * 2**20, dtype=torch.float32, device=dev)  # 160 MB
    stats = {}
    for k, (kern, plain, in_turn) in fns.items():
        warm, cold = median_ms(kern), median_ms(kern, flush=flush)
        plain_warm, plain_cold = median_ms(plain), median_ms(plain, flush=flush)
        turn_warm, turn_cold = median_ms(in_turn), median_ms(in_turn, flush=flush)
        bound_ms, bound_by = bound(k, ops)
        share = bound_ms / cold
        plan = kernels.launch_plan(T, 5 * N, N, kernels._sm_count(dev.index), k == "vg_chains", chains=C)
        log(f"{label} T={T} NB={5 * N} N={N} C={C}, median of 50 calls, {k}: kernel {warm:.4f} ms warm, "
            f"{cold:.4f} ms cold; plain torch {plain_warm:.4f} ms warm, {plain_cold:.4f} ms cold; "
            f"K1/K2 on the {C} chains in turn {turn_warm:.4f} ms warm, {turn_cold:.4f} ms cold; bound "
            f"{bound_ms:.4f} ms ({bound_by}); roofline share of the cold time {100 * share:.1f} %; tile "
            f"{plan.tile_t}, grid {plan.grid_x} x {plan.grid_y}, {plan.smem_bytes} B of shared memory [{card}]")
        stats[k] = {"max_abs_err": max_err[k], "ms": warm, "cold_ms": cold, "plain_ms": plain_warm,
                    "plain_cold_ms": plain_cold, "k1k2_in_turn_ms": turn_warm, "k1k2_in_turn_cold_ms": turn_cold,
                    "bound_ms": bound_ms, "bound_by": bound_by, "share": share, "library_ms": None}
    return stats


# --- phase 3 ----------------------------------------------------------------


class CountingPopulation(Population):
    """A Population that counts its log-joint and log-likelihood evaluations,
    with and without a gradient, so the launch counts can be held against
    them."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.evals = {"grad": 0, "value": 0}
        self.ll_evals = {"grad": 0, "value": 0}

    def log_joint(self, params, data):
        self.evals["grad" if torch.is_grad_enabled() else "value"] += 1
        return super().log_joint(params, data)

    def log_likelihood(self, params, data):
        self.ll_evals["grad" if torch.is_grad_enabled() else "value"] += 1
        return super().log_likelihood(params, data)


def flagship_slice(dev) -> dict:
    spec = make_model("distance_weighted_model", N, bias={"mu": 3.0, "sigma": 0.4})
    pop = CountingPopulation(spec, device=dev)  # float32, use_fused=True
    require(pop.dtype == torch.float32 and pop.use_fused, "the slice runs the fused float32 path")
    g_host = torch.Generator().manual_seed(SEED)
    g_dev = torch.Generator(device=dev).manual_seed(SEED)
    true = pop.sample(g_host)
    stim = np.random.RandomState(SEED + 1).randn(T, 1).astype(np.float32)

    t0 = time.perf_counter()
    S, rates = pop.simulate(g_dev, true, T, stim=stim)
    torch.cuda.synchronize()
    t_sim = time.perf_counter() - t0
    n_spikes, mean_rate = float(S.sum()), float(rates.mean())
    log(f"simulate: {n_spikes:.0f} spikes, mean rate {mean_rate:.2f} Hz "
        f"({n_spikes / (T * DT * N):.2f} Hz empirical) in {t_sim:.2f} s")
    require(bool(torch.isfinite(rates).all()) and math.isfinite(n_spikes), "non-finite simulation")
    require(mean_rate < 1000.0, f"runaway coupling: mean rate {mean_rate} Hz")

    t0 = time.perf_counter()
    data = pop.prepare_data(S, stim=stim)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    log(f"prepare_data: X_imp {tuple(data['X_imp'].shape)}, X_stim {tuple(data['X_stim'].shape)} "
        f"in {t_prep:.3f} s")

    t0 = time.perf_counter()
    init = smart_initialize(pop, data, g_host)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    with torch.no_grad():
        lp_true = float(pop.log_joint(true, data))
        lp_init = float(pop.log_joint(init, data))

    launches0, evals0 = dict(kernels.LAUNCHES), dict(pop.ll_evals)
    t0 = time.perf_counter()
    fit, lp_map, iters = map_fit(pop, data, init)
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t0
    lp_map = float(lp_map)
    map_grad_evals = pop.ll_evals["grad"] - evals0["grad"]
    map_vg = kernels.LAUNCHES["vg"] - launches0["vg"]
    log(f"log-joint: truth {lp_true:.3f}, smart init {lp_init:.3f} ({t_init:.2f} s), "
        f"MAP {lp_map:.3f} after {iters} L-BFGS iterations / {map_grad_evals} value+grad "
        f"evaluations in {t_map:.2f} s")
    require(all(math.isfinite(v) for v in (lp_true, lp_init, lp_map)), "non-finite log-joint")
    require(lp_map >= lp_init, f"MAP {lp_map} below the smart init {lp_init}")
    require(map_vg >= map_grad_evals > 0, f"K2 launches {map_vg} < L-BFGS evaluations {map_grad_evals}")

    q0, frozen = split_params(fit)  # A, the discrete adjacency, stays fixed

    def logp(q):
        return pop.log_joint({**frozen, **q}, data)

    launches1, evals1 = dict(kernels.LAUNCHES), dict(pop.evals)
    t0 = time.perf_counter()
    state = hmc_init(q0, logp, step_size=1e-3)
    accepted = []
    for _ in range(HMC_TRANSITIONS):
        prev = state.log_prob
        state = hmc_adaptive_step(g_dev, logp, state, n_steps=LEAPFROG_STEPS)
        accepted.append(bool(state.log_prob != prev))
    torch.cuda.synchronize()
    t_hmc = time.perf_counter() - t0
    hmc_vg = kernels.LAUNCHES["vg"] - launches1["vg"]
    hmc_fwd = kernels.LAUNCHES["fwd"] - launches1["fwd"]
    log(f"HMC: {sum(accepted)}/{HMC_TRANSITIONS} accepted, accept-rate EMA {float(state.accept_rate):.4f}, "
        f"step size {float(state.step_size):.3e}, log-joint {float(state.log_prob):.3f}, "
        f"{pop.evals['grad'] - evals1['grad']} value+grad and {pop.evals['value'] - evals1['value']} "
        f"value-only evaluations in {t_hmc:.2f} s")
    require(math.isfinite(float(state.log_prob)), "non-finite HMC log-density")
    require(all(bool(torch.isfinite(v).all()) for v in state.position.values()), "non-finite HMC position")
    require(hmc_vg >= 2 * LEAPFROG_STEPS * HMC_TRANSITIONS, f"K2 launches during HMC: {hmc_vg}")
    require(hmc_fwd >= HMC_TRANSITIONS, f"K1 launches during HMC: {hmc_fwd}")
    return {"pop": pop, "params": fit, "data": data, "spec": spec, "true": true, "stim": stim}


# --- phase 4 ----------------------------------------------------------------


def evals_per_sec(pop, params, data, n: int = 100) -> float:
    """bench.py's metric: value+grad of the full log-joint over the
    continuous block, each gradient consumed by a tiny update."""
    q, frozen = split_params(params)
    q = {k: v.detach().clone() for k, v in q.items()}

    def step():
        qq = {k: v.requires_grad_(True) for k, v in q.items()}
        val = pop.log_joint({**frozen, **qq}, data)
        grads = torch.autograd.grad(val, list(qq.values()))
        with torch.no_grad():
            for (k, v), g in zip(qq.items(), grads):
                q[k] = v.detach() + 1e-9 * g

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def inner_loop(sl, card: str) -> None:
    fused = sl["pop"]
    plain = Population(sl["spec"], use_fused=False, device=fused.device)
    runs = []
    for name, pop in (("plain", plain), ("fused", fused), ("fused", fused), ("plain", plain)):
        runs.append((name, evals_per_sec(pop, sl["params"], sl["data"])))
    for name, rate in runs:
        log(f"inner loop N={N} T={T} value+grad, {name}: {rate:.1f} evals/s [{card}]")


# --- phase 5 ----------------------------------------------------------------


def count_syncs(fn):
    """(fn(), the synchronizing CUDA calls it made as 'file:line' of the
    Python caller, one entry each), found by PyTorch's sync debug mode, which
    warns at each one."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = [f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
    return out, where


def device_busy_ms(fn) -> tuple:
    """(wall ms, summed ms of the device's activities, their count) of one
    call of fn, from torch.profiler's trace (one stream: no overlap)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall, sum(e.time_range.elapsed_us() for e in on_device) / 1e3, len(on_device)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def _require_sweep_launches(what, launches, ll_evals, chains, sweeps, bf16=False) -> None:
    """Kernel launches of a sampler run as the sweep implies. Per batched
    sweep only the impulse block evaluates the fused likelihood, once for
    all chains: a value-only re-anchoring of its log-density, then one HMC
    transition of L leapfrog steps, two gradients a step and a value-only
    end point. With C > 1 chains each evaluation is one K3 launch, and K1/K2
    launch none (K3-vg = sweeps·2L, K3-fwd = sweeps·2, whatever C is); one
    chain is K1/K2's (K2 = sweeps·2L, K1 = sweeps·2). A bf16 design
    (``bf16``): every evaluation one K4-chains launch, one chain included
    (the batched sweep carries a chain axis), and no other kernel."""
    per = {"fwd": sweeps * 2, "vg": sweeps * 2 * LEAPFROG_STEPS}
    if bf16:
        want = launches_of(fwd_chains_bf16=per["fwd"], vg_chains_bf16=per["vg"])
    elif chains > 1:
        want = launches_of(fwd_chains=per["fwd"], vg_chains=per["vg"])
    else:
        want = launches_of(**per)
    require(launches == want, f"{what}: kernel launches {launches} != {want} implied by the sweep")
    require(ll_evals == {"grad": per["vg"], "value": per["fwd"]},
            f"{what}: likelihood evaluations {ll_evals}: some took the plain path on the card")


def _require_chains(what, states, samples) -> None:
    for c, st in enumerate(states):
        for k, v in st["params"].items():
            require(bool(torch.isfinite(v).all()), f"{what}, chain {c}: non-finite {k}")
        A = st["params"]["A"]
        require(bool(((A == 0) | (A == 1)).all()), f"{what}, chain {c}: A not binary")
    for k, v in samples.items():
        require(bool(np.isfinite(v).all()), f"{what}: non-finite samples of {k}")
    require(bool(np.isin(samples["A"], (0.0, 1.0)).all()), f"{what}: sampled A not binary")


def _require_accept_rates(what, diag, glm_floor=0.5) -> None:
    """As phase 5: HMC blocks in (0, 1], the glm block above ``glm_floor``
    (the Laplace block's 0.5; 0 for HMC), birth-death above 0."""
    for name in ("imp", "latent"):
        if f"accept_rate_{name}" in diag:
            acc = np.asarray(diag[f"accept_rate_{name}"])
            require(bool(((acc > 0) & (acc <= 1)).all()), f"{what}: {name} accept rates {acc}")
    acc = np.asarray(diag["accept_rate_glm"])
    require(bool(((acc > glm_floor) & (acc <= 1)).all()), f"{what}: glm accept rates {acc}")
    require(bool((np.asarray(diag["accept_rate_adjacency"]) > 0).all()),
            f"{what}: birth-death accept rates {diag['accept_rate_adjacency']}")


def gibbs_phase(sl, card: str) -> dict:
    """The flagship's sampler through rgc_flagship.run; returns the kernels'
    launches over the run."""
    pop, data, true, fit = sl["pop"], sl["data"], sl["true"], sl["params"]
    launches0, ll0 = dict(kernels.LAUNCHES), dict(pop.ll_evals)
    t0 = time.perf_counter()
    samples, diag, states, summary = rgc_flagship.run(
        pop, data, true, fit, seed=SEED, n_chains=GIBBS_CHAINS, n_iters=GIBBS_SAMPLES,
        n_warmup=GIBBS_WARMUP, thin=1, n_leapfrog=LEAPFROG_STEPS, init_jitter=0.05,
        chunk_size=GIBBS_SAMPLES,
    )
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] - launches0[k] for k in launches0}
    ll_evals = {k: pop.ll_evals[k] - ll0[k] for k in ll0}
    log(f"Gibbs: {GIBBS_CHAINS} chains x ({GIBBS_WARMUP} warmup + {GIBBS_SAMPLES} samples) in {t_run:.2f} s "
        f"({1e3 * t_run / (GIBBS_WARMUP + GIBBS_SAMPLES):.1f} ms per 4-chain sweep, sampler and summary) "
        f"[{card}]; launches {launches}; likelihood evaluations {ll_evals}")
    _require_sweep_launches("Gibbs", launches, ll_evals, GIBBS_CHAINS, GIBBS_WARMUP + GIBBS_SAMPLES)
    _require_chains("Gibbs", states, samples)
    _require_accept_rates("Gibbs", diag)
    min_ess = min(v["min_ess"] for v in summary["convergence"].values())
    log(f"accept rates: glm {diag['accept_rate_glm']}, imp {diag['accept_rate_imp']}, "
        f"latent {diag['accept_rate_latent']}, adjacency {diag['accept_rate_adjacency']}")
    log(f"link-prediction AUC {summary['link_prediction_auc']}, smallest ESS {min_ess:.2f} "
        f"(20 draws: reported, not checked) [{card}]")

    # card (float32) against the CPU (float64) on chain 0's final state
    p0 = states[0]["params"]
    cpu = Population(sl["spec"], device="cpu", dtype=torch.float64)
    data64 = cpu.prepare_data(data["S"].cpu().double(), stim=sl["stim"])
    p64 = {k: v.detach().cpu().double() for k, v in p0.items()}
    theta0 = _glm_theta0(pop, data, fit, "basis")
    with torch.no_grad():
        err_psi = rel_l2(gibbs.compute_psi(pop, p0, data), gibbs.compute_psi(cpu, p64, data64))
        lj32, lj64 = float(pop.log_joint(p0, data)), float(cpu.log_joint(p64, data64))
        th32, _ = gibbs.glm_laplace_fit(pop, p0, data, theta0)
        th64, _ = gibbs.glm_laplace_fit(cpu, p64, data64, theta0.cpu().double())
    err_lj, err_th = abs(lj32 - lj64) / abs(lj64), rel_l2(th32, th64)
    log(f"card f32 vs CPU f64 on chain 0's final state: psi rel-L2 {err_psi:.3e}, log-joint rel {err_lj:.3e} "
        f"({lj32:.3f} vs {lj64:.3f}), Laplace theta* rel-L2 {err_th:.3e}")
    require(err_psi <= 1e-5, f"psi rel err {err_psi}")
    require(err_lj <= 1e-5, f"log-joint rel err {err_lj}")
    require(err_th <= 1e-4, f"Laplace theta* rel err {err_th}")

    time_sweeps(pop, data, fit, stack_states(states), card, check_modes=True)
    return launches


def _mismatch(x, y) -> tuple:
    """(elements that differ, elements, A entries that differ) over every
    tensor leaf of two one-chain states: a discrete leaf's unequal entries,
    a float leaf's entries off by more than 1e-4 of its largest magnitude."""
    n_off = n = a_off = 0
    for path, a, b in _tensor_leaves(x, y):
        require(a.shape == b.shape and a.dtype == b.dtype, f"{path}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        if a.is_floating_point():
            off = (a - b).abs() > 1e-4 * max(float(b.abs().max()) if b.numel() else 0.0, 1e-30)
        else:
            off = a != b
        n_off, n = n_off + int(off.sum()), n + a.numel()
        if path.endswith(".A"):
            a_off += int(off.sum())
    return n_off, n, a_off


def _require_modes_agree(pop, sweep, state, label) -> None:
    """One sweep of the C chains batched and one at C = 1 on each chain in
    turn, from the same state with generators seeded alike. On the CPU in
    float64 the two are equal draw for draw (tests/test_torch_batched_chains.py).
    On the card, in float32, K3 and K1/K2 (and the batched and per-chain
    products) sum in other orders, so a decision at the margin can go the
    other way (an adjacency entry flipped in one chain of 4 here): each
    chain's state may differ from its own C = 1 run in at most 1 % of its
    elements (a discrete entry unequal, a float entry off by more than 1e-4
    of its leaf's largest magnitude), and must differ from every other
    chain's C = 1 run in ten times as many (a chain given another chain's
    draws or K3 slot differs from its own run everywhere)."""
    C = state["params"]["A"].shape[0]

    def gens():
        return [torch.Generator(device=pop.device).manual_seed(SEED + 30 + c) for c in range(C)]

    g = gens()
    batched = sweep(g, state, False, 1.0)
    g = gens()
    one = [sweep([g[c]], stack_states([chain_state(state, c)]), False, 1.0) for c in range(C)]
    got = [chain_state(batched, c) for c in range(C)]
    want = [chain_state(one[c], 0) for c in range(C)]
    seen = []
    for c in range(C):
        off, n, a_off = _mismatch(got[c], want[c])
        other = min(_mismatch(got[c], want[d])[0] for d in range(C) if d != c)
        seen.append(f"chain {c}: {off} of {n} ({a_off} of A), against the nearest other chain {other}")
        require(off <= n // 100, f"{label}chain {c}: {off} of {n} elements differ from its C = 1 run")
        require(10 * off < other, f"{label}chain {c}: {off} elements differ from its own C = 1 run, "
                                  f"{other} from another chain's")
    log(f"{label}one sweep, {C} chains batched against C = 1 on each in turn, the same generators; "
        f"elements that differ: {'; '.join(seen)}")


def time_sweeps(pop, data, fit, state, card, label="", stages=SWEEP_STAGES, check_modes=False,
                **sweep_kw) -> dict:
    """The full sweep and each of ``stages`` alone on the C chains of the
    batched ``state``: one batched sweep of all C chains and, where C > 1,
    as the comparison, the same code at C = 1 on each chain in turn (with
    ``check_modes``, first held to agree chain by chain over one sweep:
    :func:`_require_modes_agree`). For each: ms per sweep over 3 sweeps, the
    synchronizing calls of one sweep, then (last) the device's activities,
    busy ms and idle share of one sweep under torch.profiler. Returns
    {stage or None: the batched sweep's synchronizing calls}."""
    n_rep = 3  # depth cut (see the module note)
    C = state["params"]["A"].shape[0]
    gens = [torch.Generator(device=pop.device).manual_seed(SEED + 10 + c) for c in range(C)]
    sweeps = {None: make_sweep(pop, data, n_leapfrog=LEAPFROG_STEPS, fisher_params=fit, **sweep_kw)}
    if check_modes and C > 1:
        _require_modes_agree(pop, sweeps[None], state, label)
    sweeps.update({s: make_sweep(pop, data, n_leapfrog=LEAPFROG_STEPS, fisher_params=fit, stages=(s,),
                                 diagnostic=True, **sweep_kw) for s in stages})

    def batched(sweep, st):
        return sweep(gens, st, False, 1.0)

    def in_turn(sweep, sts):
        return [sweep([g], s, False, 1.0) for g, s in zip(gens, sts)]

    runs = {f"{C} chains batched": (batched, state)}
    if C > 1:
        runs[f"C=1 x {C} in turn"] = (in_turn, [stack_states([chain_state(state, c)]) for c in range(C)])
    count_syncs(lambda: None)  # the debug mode's first switch synchronizes once itself
    timed, syncs_of = {}, {}
    for how, (run, st0) in runs.items():
        for stage, sweep in sweeps.items():
            st = run(sweep, st0)  # first use: lazy library set-up
            st, syncs = count_syncs(lambda: run(sweep, st))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_rep):
                st = run(sweep, st)
            torch.cuda.synchronize()
            timed[how, stage] = (1e3 * (time.perf_counter() - t0) / n_rep, st)
            if run is batched:
                syncs_of[stage] = syncs
            log(f"{label}{'full sweep' if stage is None else 'stage ' + stage}, {how}: {timed[how, stage][0]:.3f} "
                f"ms per sweep ({n_rep} sweeps); {len(syncs)} synchronizing calls {sorted(set(syncs))} [{card}]")
    # profiled last: once the profiler has attached, host launches stay slower
    for (how, stage), (ms, st) in timed.items():
        run, sweep = runs[how][0], sweeps[stage]
        wall, busy, n_dev = device_busy_ms(lambda: run(sweep, st))
        log(f"{label}{'full sweep' if stage is None else 'stage ' + stage}, {how}, under torch.profiler: {n_dev} "
            f"device activities taking {busy:.3f} ms ({wall:.3f} ms wall profiled); against the unprofiled "
            f"{ms:.3f} ms the device idles {100 * (1 - busy / ms):.1f} % [{card}]")
    return syncs_of


# --- phase 6 ----------------------------------------------------------------


#: (T, N) of acceptance configs 1-4 at full size (scripts/acceptance.py)
ACCEPT_SHAPES = {1: (60_000, 1), 2: (240_000, 10), 3: (30_000, 10), 4: (60_000, 16)}
XV_LAMBDAS, XV_FOLDS, XV_ITER = [1.0, 3.0, 10.0], 3, 100  # the full run: 8 lambdas, 300 iterations
POST_CHAINS, POST_WARMUP, POST_SAMPLES = 2, 20, 10  # the full run: 2 x (200 + 400)
C3_CHAINS, C3_WARMUP, C3_SAMPLES = 4, 20, 10  # the full run: 4 x (500 + 1,000)
C4_CHAINS, C4_WARMUP, C4_SAMPLES = 4, 40, 10  # the full run: 4 x (1,000 + 2,000)


class XVPopulation(CountingPopulation):
    """Also records, while ``segments`` is a list, the number of training
    segments of each penalized-objective evaluation: a log-prior with a
    gradient opens an evaluation, each log-likelihood with a gradient adds
    a segment to it."""

    segments = None

    def log_prior(self, params):
        if self.segments is not None and torch.is_grad_enabled():
            self.segments.append(0)
        return super().log_prior(params)

    def log_likelihood(self, params, data):
        if self.segments is not None and torch.is_grad_enabled():
            self.segments[-1] += 1
        return super().log_likelihood(params, data)


def _counted(pop):
    """(launches, likelihood evaluations) so far, to difference later."""
    return dict(kernels.LAUNCHES), dict(pop.ll_evals)


def _since(pop, before) -> tuple:
    launches0, ll0 = before
    return ({k: kernels.LAUNCHES[k] - launches0[k] for k in launches0},
            {k: pop.ll_evals[k] - ll0[k] for k in ll0})


def _add(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def _require_all_fused(what, launches, ll_evals) -> None:
    """Every likelihood evaluation of one parameter set went through a
    kernel: K2 for each one with a gradient, K1 for each value-only one."""
    require(launches == launches_of(vg=ll_evals["grad"], fwd=ll_evals["value"]),
            f"{what}: launches {launches} against likelihood evaluations {ll_evals}")


def accept_config1(dev, card) -> dict:
    """Config 1: standard GLM N=1, MAP from the smart init, at least the
    truth's log-joint (JAX's map_beats_truth). Returns the MAP's launches."""
    T1, _ = ACCEPT_SHAPES[1]
    t0 = time.perf_counter()
    pop, true, S, stim = acceptance.data1(dev, T1, pop_cls=CountingPopulation)
    data = pop.prepare_data(S, stim=stim)
    init = smart_initialize(pop, data)
    before = _counted(pop)
    fit, lp_map, iters = map_fit(pop, data, init)
    launches, ll_evals = _since(pop, before)
    grad_evals = ll_evals["grad"]
    with torch.no_grad():
        lp_true = float(pop.log_joint(true, data))
    torch.cuda.synchronize()
    log(f"config 1 (standard_glm N=1, T={T1}): {float(S.sum()):.0f} spikes; MAP log-joint {float(lp_map):.3f} "
        f"against the truth's {lp_true:.3f} after {iters} L-BFGS iterations, {grad_evals} value+grad evaluations; "
        f"launches {launches}; {time.perf_counter() - t0:.2f} s [{card}]")
    require(math.isfinite(float(lp_map)) and float(lp_map) >= lp_true - 1e-3,
            f"config 1: MAP {float(lp_map)} below the truth {lp_true}")
    require(launches["vg"] >= grad_evals > 0, f"config 1: K2 launches {launches['vg']} < evaluations {grad_evals}")
    _require_all_fused("config 1 MAP", launches, ll_evals)
    return launches


def accept_config2(dev, card) -> dict:
    """Config 2: ER N=10 with planted weights, T=240,000: 3-fold
    cross-validated lambda, sparse MAP at the best lambda, the collapsed
    (A, W) posterior-support sampler, the three support metrics (with the
    Wald refit). Returns the launches of these calls, summed."""
    T2, _ = ACCEPT_SHAPES[2]
    t0 = time.perf_counter()
    pop, true, S, stim = acceptance.data2(dev, T2, pop_cls=XVPopulation)
    torch.cuda.synchronize()
    t_sim = time.perf_counter() - t0
    data = pop.prepare_data(S, stim=stim)
    init = smart_initialize(pop, data)
    init["A"] = torch.ones_like(init["A"])

    before, pop.segments = _counted(pop), []
    t0 = time.perf_counter()
    best, fits, scores = cross_validate_lambda(pop, S, stim, init, XV_LAMBDAS, max_iter=XV_ITER, n_folds=XV_FOLDS)
    torch.cuda.synchronize()
    t_xv = time.perf_counter() - t0
    launches, ll_evals = _since(pop, before)
    path = dict(launches)
    segments, pop.segments = pop.segments, None
    off = ~torch.eye(pop.N, dtype=torch.bool, device=pop.device)
    l1 = {lam: float(f["W"][off].abs().sum()) for lam, f in zip(XV_LAMBDAS, fits)}
    log(f"config 2 (ER N=10, T={T2}, simulated in {t_sim:.2f} s): cross-validation over {XV_LAMBDAS}, "
        f"{XV_FOLDS} folds, {XV_ITER} iterations: best {best}, scores {[round(v, 3) for v in scores]}, "
        f"fold-0 off-diagonal L1 {l1}; {len(segments)} evaluations over "
        f"{dict(sorted(Counter(segments).items()))} training segments (count of each); launches {launches}; "
        f"{t_xv:.2f} s [{card}]")
    require(all(math.isfinite(v) for v in scores), f"config 2: non-finite scores {scores}")
    require(l1[10.0] < l1[1.0], f"config 2: lambda=10 fit L1 {l1[10.0]} not below lambda=1's {l1[1.0]}")
    require(set(segments) == {1, 2}, f"config 2: training segments per evaluation {set(segments)}, want 1 and 2")
    require(launches["vg"] == sum(segments), f"config 2: K2 launches {launches['vg']} != sum over "
            f"evaluations of the training segments {sum(segments)}")
    require(launches["fwd"] >= len(XV_LAMBDAS) * XV_FOLDS, f"config 2: K1 launches {launches['fwd']} < held-out scores")
    _require_all_fused("config 2 cross-validation", launches, ll_evals)

    before = _counted(pop)
    params, lp, iters = sparse_map_fit(pop, data, init, best, max_iter=XV_ITER)
    launches, ll_evals = _since(pop, before)
    log(f"config 2: sparse MAP at lambda={best}: penalized log-posterior {float(lp):.3f}, {iters} iterations, "
        f"launches {launches}")
    require(math.isfinite(float(lp)) and launches["vg"] > 0, "config 2: sparse MAP")
    _require_all_fused("config 2 sparse MAP", launches, ll_evals)
    path = _add(path, launches)

    before = _counted(pop)
    t0 = time.perf_counter()
    samples, diag, states = gibbs_sample_chains(
        pop, data, 9, n_chains=POST_CHAINS, n_samples=POST_SAMPLES, n_warmup=POST_WARMUP,
        chunk_size=POST_SAMPLES, init_params=dict(params), init_jitter=0.05,
    )
    torch.cuda.synchronize()
    t_post = time.perf_counter() - t0
    launches, ll_evals = _since(pop, before)
    _require_sweep_launches("config 2 sampler", launches, ll_evals, POST_CHAINS, POST_WARMUP + POST_SAMPLES)
    _require_chains("config 2 sampler", states, samples)
    path = _add(path, launches)
    before = _counted(pop)
    support = acceptance.support_estimates(pop, data, params, samples["A"], true["A"].cpu().numpy(), XV_ITER)
    launches, ll_evals = _since(pop, before)
    _require_all_fused("config 2 Wald refit", launches, ll_evals)
    path = _add(path, launches)
    log(f"config 2: posterior-support sampler {POST_CHAINS} x ({POST_WARMUP} + {POST_SAMPLES}) sweeps in "
        f"{t_post:.2f} s ({1e3 * t_post / (POST_WARMUP + POST_SAMPLES):.1f} ms per {POST_CHAINS}-chain sweep), "
        f"launches {launches} [{card}]; support F1 (reported only) lasso "
        f"{support['support_recovery_lasso']['f1']:.3f}, Wald {support['support_recovery_wald']['f1']:.3f}, "
        f"posterior median {support['support_recovery']['f1']:.3f}")
    return path


def accept_config3(dev, card) -> dict:
    """Config 3: N=10, T=30,000, MAP then 4 jittered chains. Returns the
    launches of the MAP and the sampler, summed."""
    T3, _ = ACCEPT_SHAPES[3]
    pop, true, S, stim = acceptance.data3(dev, T3, pop_cls=CountingPopulation)
    data = pop.prepare_data(S, stim=stim)
    before = _counted(pop)
    fit, lp, iters = map_fit(pop, data, smart_initialize(pop, data), max_iter=300)
    path, ll_evals = _since(pop, before)
    _require_all_fused("config 3 MAP", path, ll_evals)
    before = _counted(pop)
    t0 = time.perf_counter()
    samples, diag, states = gibbs_sample_chains(
        pop, data, 3, n_chains=C3_CHAINS, n_samples=C3_SAMPLES, n_warmup=C3_WARMUP, chunk_size=C3_SAMPLES,
        init_params=fit, init_jitter=0.05,
    )
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches, ll_evals = _since(pop, before)
    sweeps = C3_WARMUP + C3_SAMPLES
    _require_sweep_launches("config 3", launches, ll_evals, C3_CHAINS, sweeps)
    _require_chains("config 3", states, samples)
    _require_accept_rates("config 3", diag)
    conv = diag["convergence"]
    log(f"config 3 (ER N=10, T={T3}): MAP {float(lp):.3f} in {iters} iterations; {C3_CHAINS} chains x "
        f"({C3_WARMUP} + {C3_SAMPLES}) sweeps in {t_run:.2f} s ({1e3 * t_run / sweeps:.1f} ms per "
        f"{C3_CHAINS}-chain sweep) [{card}]; launches {launches}; accept glm {diag['accept_rate_glm']}, imp "
        f"{diag['accept_rate_imp']}, adjacency {diag['accept_rate_adjacency']}; max R-hat W "
        f"{conv['W']['max_rhat']:.3f}, min ESS W {conv['W']['min_ess']:.2f} (reported only)")
    return _add(path, launches)


def accept_config4(dev, card) -> dict:
    """Config 4: SBM N=16 with the planted partition, T=60,000: 4 chains
    with annealed warmup through gibbs_sample_chains, exact launches, the
    discrete stage and the full sweep without a synchronizing call, the
    card's float32 against the CPU's float64 on chain 0's final state.
    Returns the sampler's launches."""
    T4, N4 = ACCEPT_SHAPES[4]
    pop, true, S, stim = acceptance.data4(dev, T4, pop_cls=CountingPopulation)
    data = pop.prepare_data(S, stim=stim)
    init = smart_initialize(pop, data)
    before = _counted(pop)
    t0 = time.perf_counter()
    samples, diag, states = gibbs_sample_chains(
        pop, data, 5, n_chains=C4_CHAINS, n_samples=C4_SAMPLES, n_warmup=C4_WARMUP, chunk_size=C4_SAMPLES,
        init_params=init, anneal_frac=0.5,
    )
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches, ll_evals = _since(pop, before)
    path = launches
    sweeps = C4_WARMUP + C4_SAMPLES
    _require_sweep_launches("config 4", launches, ll_evals, C4_CHAINS, sweeps)
    _require_chains("config 4", states, samples)
    K, alpha0, b0, b1 = gibbs._sbm_hyperparams(pop)
    for c, st in enumerate(states):
        p = st["params"]
        y, pi, Bm = p["y"], p["pi"], p["Bm"]
        require(y.dtype == torch.int64 and bool(((y >= 0) & (y < K)).all()), f"config 4, chain {c}: y {y}")
        require(bool((pi > 0).all()) and abs(float(pi.sum()) - 1.0) <= 1e-5, f"config 4, chain {c}: pi {pi}")
        require(bool(((Bm > 0) & (Bm < 1)).all()), f"config 4, chain {c}: B {Bm}")
    require(bool(((samples["y"] >= 0) & (samples["y"] < K)).all()), "config 4: sampled y out of range")
    aris = [float(np.mean([adjusted_rand_index(samples["y"][i, c], acceptance.Y4)
                           for i in range(C4_SAMPLES)])) for c in range(C4_CHAINS)]
    log(f"config 4 (SBM N={N4}, T={T4}): {C4_CHAINS} chains x ({C4_WARMUP} warmup, annealed over half, + "
        f"{C4_SAMPLES}) sweeps in {t_run:.2f} s ({1e3 * t_run / sweeps:.1f} ms per {C4_CHAINS}-chain sweep, "
        f"sampler and summary) [{card}]; launches {launches}; accept glm {diag['accept_rate_glm']}, imp "
        f"{diag['accept_rate_imp']}, adjacency {diag['accept_rate_adjacency']}; planted-partition ARI per "
        f"chain over the {C4_SAMPLES} draws {[round(a, 3) for a in aris]} (reported only)")

    syncs = time_sweeps(pop, data, init, stack_states(states), card, label="config 4 ", stages=("discrete",),
                        check_modes=True)
    require(not syncs["discrete"] and not syncs[None], f"config 4: synchronizing calls {syncs}")

    # card (float32) against the CPU (float64) on chain 0's final state
    p0 = states[0]["params"]
    cpu = Population(pop.spec, device="cpu", dtype=torch.float64)
    data64 = cpu.prepare_data(data["S"].cpu().double(), stim=stim)
    p64 = {k: v.detach().cpu().double() if v.is_floating_point() else v.cpu() for k, v in p0.items()}
    err_cond = 0.0
    for n in range(N4):
        q32 = torch.softmax(gibbs._collapsed_type_logits(p0["A"], p0["y"], n, K, alpha0, b0, b1), 0)
        q64 = torch.softmax(gibbs._collapsed_type_logits(p64["A"], p64["y"], n, K, alpha0, b0, b1), 0)
        err_cond = max(err_cond, float((q32.cpu().double() - q64).abs().max()))
    with torch.no_grad():
        lj32, lj64 = float(pop.log_joint(p0, data)), float(cpu.log_joint(p64, data64))
    err_lj = abs(lj32 - lj64) / abs(lj64)
    log(f"config 4, card f32 vs CPU f64 on chain 0's final state: collapsed type conditionals max abs "
        f"{err_cond:.3e} over {N4} neurons; log-joint rel {err_lj:.3e} ({lj32:.3f} vs {lj64:.3f})")
    require(err_cond <= 1e-4, f"config 4: type conditionals abs err {err_cond}")
    require(err_lj <= 1e-5, f"config 4: log-joint rel err {err_lj}")
    return path


ACCEPT_RUNS = {1: accept_config1, 2: accept_config2, 3: accept_config3, 4: accept_config4}
#: the chains of each config's batched sampler (K3's C at its shape)
ACCEPT_SAMPLER_CHAINS = {2: POST_CHAINS, 3: C3_CHAINS, 4: C4_CHAINS}
#: the kernels each config's path launches: MAP-like fits K1/K2, the samplers K3
ACCEPT_KERNELS = {1: ("fwd", "vg"), 2: F32_KERNELS, 3: F32_KERNELS, 4: ("fwd_chains", "vg_chains")}


def acceptance_phase(dev, card) -> dict:
    """Configs 1-4: K1/K2 against the plain version at each config's shape
    (not counted), then the config. Each config returns the launches of its
    path's calls alone (MAP, cross-validation, sparse MAP, samplers), each
    counted from just before the call to just after: not those of its
    timing sweeps, of the truth's log-joint or of the card-vs-CPU checks.
    Returns them summed over the configs."""
    total = launches_of()
    for c, run in ACCEPT_RUNS.items():
        T_c, N_c = ACCEPT_SHAPES[c]
        check_kernels(dev, T_c, N_c, f"config {c}", card)
        if ACCEPT_SAMPLER_CHAINS.get(c):
            check_chain_kernels(dev, T_c, N_c, ACCEPT_SAMPLER_CHAINS[c], f"config {c}", card)
        zero_launches()
        t0 = time.perf_counter()
        path = run(dev, card)
        torch.cuda.synchronize()
        log(f"config {c}: done in {time.perf_counter() - t0:.2f} s; launches on its path {path}, in all "
            f"{dict(kernels.LAUNCHES)}")
        require(all(path[k] > 0 for k in ACCEPT_KERNELS[c]), f"config {c}: a kernel of the path never launched: {path}")
        total = _add(total, path)
    return total


# --- phase 7 ----------------------------------------------------------------


ST_CHAINS, ST_WARMUP, ST_SAMPLES = 4, 40, 10  # depth cut (see the module note)
SHARED_WARMUP, SHARED_SAMPLES = 40, 10
GENERIC_WARMUP, GENERIC_SAMPLES = 5, 5
HMC_WARMUP, HMC_SAMPLES, ARS_CHUNK = 40, 10, 10
RESUME_CHAINS, RESUME_WARMUP, RESUME_SAMPLES, RESUME_EVERY = 2, 10, 20, 10


def _simulated(pop, seed, T_, label, true=None):
    """(true, S, stim): ``true`` or else a prior draw from a host generator,
    a white (T, D_stim) stimulus, spikes simulated on the card."""
    if true is None:
        true = pop.sample(torch.Generator().manual_seed(seed))
    stim = np.random.RandomState(seed + 1).randn(T_, pop.D_stim).astype(np.float32)
    t0 = time.perf_counter()
    S, rates = pop.simulate(torch.Generator(device=pop.device).manual_seed(seed), true, T_, stim=stim)
    torch.cuda.synchronize()
    mean_rate = float(rates.mean())
    log(f"{label}: simulated N={pop.N}, T={T_}: {float(S.sum()):.0f} spikes, mean rate {mean_rate:.2f} Hz, "
        f"in {time.perf_counter() - t0:.2f} s")
    require(bool(torch.isfinite(rates).all()) and mean_rate < 1000.0, f"{label}: simulation, mean rate {mean_rate}")
    return true, S, stim


def _cpu64(pop, data, stim, params):
    """The same population, data and params on the CPU in float64."""
    cpu = Population(pop.spec, device="cpu", dtype=torch.float64)
    data64 = cpu.prepare_data(data["S"].cpu().double(), stim=stim)
    p64 = {k: v.detach().cpu().double() if v.is_floating_point() else v.cpu() for k, v in params.items()}
    return cpu, data64, p64


def _sampler_ms(label, t_run, chains, sweeps, card) -> str:
    ms = 1e3 * t_run / sweeps
    return (f"{label}: {chains} chain(s) x {sweeps} sweeps in {t_run:.2f} s: {ms:.1f} ms per {chains}-chain sweep, "
            f"{ms / chains:.1f} ms per chain-sweep [{card}]")


def variants_st(dev, card) -> dict:
    """7a: spatiotemporal_glm at N=27, T=60,000, D_stim=25, stimulus and
    impulse bases of 5: simulate, prepare_data, smart init, MAP, 4 chains of
    the sweep with the bilinear glm block; launches, finiteness, accept
    rates, card f32 vs CPU f64 of both sub-blocks' modes and the log-joint,
    stage times with 0 synchronizing calls in the glm stage and the full
    sweep. Returns (the path's launches, what 7e and 7f reuse)."""
    spec = make_model("spatiotemporal_glm", N)
    pop = CountingPopulation(spec, device=dev)
    true, S, stim = _simulated(pop, SEED + 70, T, "7a spatiotemporal_glm")
    data = pop.prepare_data(S, stim=stim)
    require(tuple(data["X_st"].shape) == (T, 25, 5), f"7a: X_st {tuple(data['X_st'].shape)}")
    init = smart_initialize(pop, data, torch.Generator().manual_seed(SEED))
    before = _counted(pop)
    t0 = time.perf_counter()
    fit, lp, iters = map_fit(pop, data, init)
    torch.cuda.synchronize()
    path, ll_evals = _since(pop, before)
    log(f"7a MAP: log-joint {float(lp):.3f} after {iters} iterations in {time.perf_counter() - t0:.2f} s; "
        f"launches {path}, likelihood evaluations {ll_evals}")
    require(math.isfinite(float(lp)), "7a: non-finite MAP")
    _require_all_fused("7a MAP", path, ll_evals)

    before = _counted(pop)
    t0 = time.perf_counter()
    samples, diag, states = gibbs_sample_chains(
        pop, data, SEED, n_chains=ST_CHAINS, n_samples=ST_SAMPLES, n_warmup=ST_WARMUP, chunk_size=ST_SAMPLES,
        init_params=fit, init_jitter=0.05,
    )
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches, ll_evals = _since(pop, before)
    sweeps = ST_WARMUP + ST_SAMPLES
    log(_sampler_ms("7a sampler", t_run, ST_CHAINS, sweeps, card) + f"; launches {launches}; accept glm "
        f"{diag['accept_rate_glm']}, imp {diag['accept_rate_imp']}")
    _require_sweep_launches("7a sampler", launches, ll_evals, ST_CHAINS, sweeps)
    _require_chains("7a sampler", states, samples)
    _require_accept_rates("7a sampler", diag)
    path = _add(path, launches)

    p0 = states[0]["params"]
    cpu, data64, p64 = _cpu64(pop, data, stim, p0)
    theta0 = _glm_theta0(pop, data, fit, "spatiotemporal")
    with torch.no_grad():
        fits32 = gibbs.glm_laplace_fit_st(pop, p0, data, theta0)
        fits64 = gibbs.glm_laplace_fit_st(cpu, p64, data64, {k: v.cpu().double() for k, v in theta0.items()})
        lj32, lj64 = float(pop.log_joint(p0, data)), float(cpu.log_joint(p64, data64))
    errs = [rel_l2(a[0], b[0]) for a, b in zip(fits32, fits64)]
    err_lj = abs(lj32 - lj64) / abs(lj64)
    log(f"7a card f32 vs CPU f64 on chain 0's final state: Laplace theta* rel-L2 (a) [bias, w_s] {errs[0]:.3e}, "
        f"(b) w_t {errs[1]:.3e}; log-joint rel {err_lj:.3e} ({lj32:.3f} vs {lj64:.3f})")
    require(max(errs) <= 1e-4, f"7a: Laplace theta* rel err {errs}")
    require(err_lj <= 1e-5, f"7a: log-joint rel err {err_lj}")
    syncs = time_sweeps(pop, data, fit, stack_states(states), card, label="7a ", stages=("glm", "imp"))
    require(not syncs["glm"] and not syncs[None], f"7a: synchronizing calls {syncs}")
    return path, {"pop": pop, "data": data, "fit": fit, "true": true, "samples": samples}


def variants_shared(dev, card) -> dict:
    """7b: standard_glm at N=27, T=60,000 with its stimulus section's type
    set to 'shared' (DB=5): 1 chain; launches, 0 synchronizing calls in the
    glm stage, card vs CPU of both sub-blocks' modes."""
    spec = make_model("standard_glm", N)
    spec["bkgd"]["type"] = "shared"
    pop = CountingPopulation(spec, device=dev)
    true, S, stim = _simulated(pop, SEED + 71, T, "7b shared stimulus")
    data = pop.prepare_data(S, stim=stim)
    require(tuple(data["X_stim"].shape) == (T, 5), f"7b: X_stim {tuple(data['X_stim'].shape)}")
    init = smart_initialize(pop, data, torch.Generator().manual_seed(SEED))
    before = _counted(pop)
    t0 = time.perf_counter()
    samples, diag, state = gibbs_sample(
        pop, data, torch.Generator(device=dev).manual_seed(SEED + 71), n_samples=SHARED_SAMPLES,
        n_warmup=SHARED_WARMUP, chunk_size=SHARED_SAMPLES, init_params=init,
    )
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    path, ll_evals = _since(pop, before)
    sweeps = SHARED_WARMUP + SHARED_SAMPLES
    log(_sampler_ms("7b sampler", t_run, 1, sweeps, card) + f"; launches {path}; accept glm "
        f"{diag['accept_rate_glm']:.3f}, imp {diag['accept_rate_imp']:.3f}")
    _require_sweep_launches("7b sampler", path, ll_evals, 1, sweeps)
    _require_chains("7b sampler", [state], samples)
    _require_accept_rates("7b sampler", diag)

    p0 = state["params"]
    cpu, data64, p64 = _cpu64(pop, data, stim, p0)
    theta0 = _glm_theta0(pop, data, init, "shared")
    with torch.no_grad():
        fits32 = gibbs.glm_laplace_fit_shared(pop, p0, data, theta0)
        fits64 = gibbs.glm_laplace_fit_shared(cpu, p64, data64, {k: v.cpu().double() for k, v in theta0.items()})
    errs = [rel_l2(a[0], b[0]) for a, b in zip(fits32, fits64)]
    log(f"7b card f32 vs CPU f64 on the final state: Laplace theta* rel-L2 (a) [bias, gain] {errs[0]:.3e}, "
        f"(b) w_stim_shared {errs[1]:.3e}")
    require(max(errs) <= 1e-4, f"7b: Laplace theta* rel err {errs}")
    syncs = time_sweeps(pop, data, init, stack_states([state]), card, label="7b ", stages=("glm",))
    require(not syncs["glm"], f"7b: synchronizing calls in the glm stage {syncs['glm']}")
    return (path,)


def variants_generic(dev, card) -> dict:
    """7c: sparse_weighted_model at config 3's shape (N=10, T=30,000, its
    planted weights) with softplus, then with Bernoulli observations: the
    autograd branches, no fused kernel; card vs CPU of _bin_ll_derivs."""
    total = launches_of()
    for what, override in (("softplus", {"nlin": {"type": "softplus"}}),
                           ("bernoulli", {"observation": {"type": "bernoulli"}})):
        T3, N3 = ACCEPT_SHAPES[3]
        spec = make_model("sparse_weighted_model", N3, **override)
        spec["bias"] = {"mu": 2.5, "sigma": 0.4}
        t0 = time.perf_counter()
        pop, true, S, stim = acceptance._simulate(CountingPopulation(spec, device=dev), T3, 2,
                                                  acceptance._planted_er_weights(30))
        torch.cuda.synchronize()
        log(f"7c {what}: simulated N={N3}, T={T3}: {float(S.sum()):.0f} spikes in {time.perf_counter() - t0:.2f} s")
        data = pop.prepare_data(S, stim=stim)
        init = smart_initialize(pop, data)
        before = _counted(pop)
        t0 = time.perf_counter()
        samples, diag, state = gibbs_sample(
            pop, data, torch.Generator(device=dev).manual_seed(SEED + 72), n_samples=GENERIC_SAMPLES,
            n_warmup=GENERIC_WARMUP, chunk_size=GENERIC_SAMPLES, init_params=init,
        )
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        launches, ll_evals = _since(pop, before)
        log(_sampler_ms(f"7c {what} sampler", t_run, 1, GENERIC_WARMUP + GENERIC_SAMPLES, card)
            + f"; launches {launches}; accept glm {diag['accept_rate_glm']:.3f}, imp {diag['accept_rate_imp']:.3f}, "
            f"adjacency {diag['accept_rate_adjacency']:.3f}")
        require(launches == launches_of(), f"7c {what}: the fused op launched {launches}")
        _require_chains(f"7c {what}", [state], samples)
        p0 = state["params"]
        cpu, data64, p64 = _cpu64(pop, data, stim, p0)
        with torch.no_grad():
            I32, I64 = pop.total_current(p0, data), cpu.total_current(p64, data64)
        d32 = gibbs._bin_ll_derivs(data["S"], I32, pop.observation, pop.nlin, pop.dt)
        d64 = gibbs._bin_ll_derivs(data64["S"], I64, cpu.observation, cpu.nlin, cpu.dt)
        errs = [rel_l2(a, b) for a, b in zip(d32, d64)]
        log(f"7c {what}, card f32 vs CPU f64 _bin_ll_derivs at the final state: d1 rel-L2 {errs[0]:.3e}, "
            f"d2 {errs[1]:.3e}")
        require(max(errs) <= 1e-4, f"7c {what}: derivative rel err {errs}")
        total = _add(total, launches)
    return (total,)


def variants_hmc_ars(sl, card) -> dict:
    """7d: the flagship's population, data and MAP fit, 1 chain with
    glm_update='hmc', then with bias_update='ars': launches, accept rates,
    one host round trip per ARS pass, card vs CPU of the whitening factor."""
    pop, data, fit = sl["pop"], sl["data"], sl["params"]
    src = open(ars.__file__).read().splitlines()
    where = os.path.relpath(ars.__file__, REPO)
    to_host = f"{where}:{next(i + 1 for i, l in enumerate(src) if '.cpu()' in l)}"
    to_card = f"{where}:{next(i + 1 for i, l in enumerate(src) if 'torch.as_tensor(new_bias' in l)}"
    passes = []
    update = ars.update_bias_ars

    def counted(rng, pop_, params, data_):
        out, syncs = count_syncs(lambda: update(rng, pop_, params, data_))
        passes.append(syncs)
        return out

    path = launches_of()
    sweeps = HMC_WARMUP + HMC_SAMPLES
    for what, kw in (("glm_update='hmc'", {"glm_update": "hmc"}), ("bias_update='ars'", {"bias_update": "ars"})):
        before = _counted(pop)
        ars.update_bias_ars = counted
        t0 = time.perf_counter()
        try:
            samples, diag, state = gibbs_sample(
                pop, data, torch.Generator(device=pop.device).manual_seed(SEED + 73), n_samples=HMC_SAMPLES,
                n_warmup=HMC_WARMUP, chunk_size=ARS_CHUNK, init_params=fit, **kw,
            )
            torch.cuda.synchronize()
        finally:
            ars.update_bias_ars = update
        t_run = time.perf_counter() - t0
        launches, ll_evals = _since(pop, before)
        log(_sampler_ms(f"7d {what}", t_run, 1, sweeps, card) + f"; launches {launches}; accept "
            + ", ".join(f"{k[12:]} {v:.3f}" for k, v in diag.items() if k.startswith("accept_rate")))
        _require_sweep_launches(f"7d {what}", launches, ll_evals, 1, sweeps)
        _require_chains(f"7d {what}", [state], samples)
        _require_accept_rates(f"7d {what}", diag, glm_floor=0.0)
        path = _add(path, launches)
    n_pass = sweeps // ARS_CHUNK
    log(f"7d ARS: {len(passes)} passes, synchronizing calls of each {passes} (one to the host at {to_host}; "
        f"the copy back at {to_card})")
    require(len(passes) == n_pass, f"7d: {len(passes)} ARS passes, want one per chunk: {n_pass}")
    for syncs in passes:
        require(syncs.count(to_host) == 1 and set(syncs) <= {to_host, to_card} and syncs.count(to_card) <= 1,
                f"7d: an ARS pass is not one host round trip: {syncs}")

    R32 = whitening_factor(data["X_stim"])
    R64 = whitening_factor(_cpu64(pop, data, sl["stim"], fit)[1]["X_stim"])
    err = rel_l2(R32, R64)
    log(f"7d whitening factor R, card f32 vs CPU f64: rel-L2 {err:.3e}")
    require(err <= 1e-5, f"7d: whitening factor rel err {err}")
    return (path,)


def variants_predictive(st, card) -> dict:
    """7e: the predictive log-likelihood of 7a's draws on the last 20 % of
    a fresh simulation of 7a's generating parameters: one K1 launch per
    draw, finite, above a prior draw's."""
    pop, true = st["pop"], st["true"]
    _, S, stim = _simulated(pop, SEED + 74, T, "7e fresh simulation", true=true)
    T_tr = int(0.8 * T)
    data_ho = pop.prepare_data(S[T_tr:], stim=stim[T_tr:])
    draws = {k: v.reshape((-1,) + v.shape[2:]) for k, v in st["samples"].items()}
    K = len(draws["bias"])
    before = _counted(pop)
    t0 = time.perf_counter()
    pll = float(predictive_log_likelihood(pop, draws, data_ho))
    t_pll = time.perf_counter() - t0
    launches, ll_evals = _since(pop, before)
    with torch.no_grad():
        prior = float(pop.log_likelihood(pop.sample(torch.Generator().manual_seed(SEED + 75)), data_ho))
        at_truth = float(pop.log_likelihood(true, data_ho))
    log(f"7e predictive log-likelihood of {K} draws on {T - T_tr} held-out bins: {pll:.3f} in {t_pll:.3f} s "
        f"(a prior draw {prior:.3f}, the truth {at_truth:.3f}); launches {launches} [{card}]")
    require(launches == launches_of(fwd=K) and ll_evals == {"grad": 0, "value": K},
            f"7e: launches {launches}, evaluations {ll_evals}, want one K1 per draw ({K})")
    require(math.isfinite(pll) and pll > prior, f"7e: predictive {pll} not above a prior draw's {prior}")
    return (launches,)


def _tensor_leaves(a, b, where="states"):
    """(path, a's tensor, b's tensor) for every tensor leaf of two nestings
    of dicts, lists and tuples (HMCState records, by field name) of the same
    structure."""
    if isinstance(a, torch.Tensor):
        yield where, a, b
    elif hasattr(a, "_fields"):
        for k in a._fields:
            yield from _tensor_leaves(getattr(a, k), getattr(b, k), f"{where}.{k}")
    elif isinstance(a, dict):
        for k in a:
            yield from _tensor_leaves(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _tensor_leaves(x, y, f"{where}[{i}]")


def variants_resume(st, card) -> dict:
    """7f: 7a's model, 2 chains x 30 sweeps checkpointed every 10: an
    uninterrupted run, then one stopped at sweep 20 and resumed to 30; the
    kept draws and final states equal to the last bit."""
    pop, data, fit = st["pop"], st["data"], st["fit"]
    kw = dict(n_chains=RESUME_CHAINS, n_warmup=RESUME_WARMUP, chunk_size=RESUME_EVERY, init_params=fit,
              init_jitter=0.05)
    before = _counted(pop)
    t0 = time.perf_counter()
    full = gibbs_sample_chains(pop, data, SEED + 76, n_samples=RESUME_SAMPLES, **kw)
    with tempfile.TemporaryDirectory() as d:
        gibbs_sample_chains(pop, data, SEED + 76, n_samples=RESUME_SAMPLES - RESUME_EVERY, checkpoint_dir=d,
                            checkpoint_every=RESUME_EVERY, **kw)
        calls = []
        resumed = gibbs_sample_chains(pop, data, SEED + 76, n_samples=RESUME_SAMPLES, checkpoint_dir=d,
                                      checkpoint_every=RESUME_EVERY, resume=True,
                                      callback=lambda ph, it, s: calls.append((ph, it)), **kw)
        files = sorted(os.listdir(d))
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches, ll_evals = _since(pop, before)
    sweeps = 2 * (RESUME_WARMUP + RESUME_SAMPLES)  # the full run, then 20 + 10
    require(calls == [("sample", RESUME_SAMPLES)], f"7f: the resumed run's chunks {calls}")
    _require_sweep_launches("7f", launches, ll_evals, RESUME_CHAINS, sweeps)
    differ = [k for k in full[0] if not np.array_equal(full[0][k], resumed[0][k])]
    differ += [where for where, a, b in _tensor_leaves(full[2], resumed[2]) if not torch.equal(a, b)]
    log(f"7f exact resume, {RESUME_CHAINS} chains x {RESUME_WARMUP + RESUME_SAMPLES} sweeps, checkpoint every "
        f"{RESUME_EVERY}: uninterrupted, stopped at {RESUME_WARMUP + RESUME_SAMPLES - RESUME_EVERY} and resumed in "
        f"{t_run:.2f} s; files {files}; launches {launches}; leaves that differ: {differ or 'none'} [{card}]")
    require(not differ, f"7f: resumed run differs from the uninterrupted one in {differ}")
    return (launches,)


def _path(label, run) -> tuple:
    """One path of phase 7, with the launch counts set to 0 just before it:
    returns what ``run`` returns, (the path's launches, ...)."""
    zero_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    log(f"{label}: done in {time.perf_counter() - t0:.2f} s; launches on its path {out[0]}")
    return out


def variants_phase(dev, card, sl) -> dict:
    """Phase 7. Returns the launches of its paths summed (7c launches none)."""
    t0 = time.perf_counter()
    total, st = _path("7a", lambda: variants_st(dev, card))
    for label, run in (("7b", lambda: variants_shared(dev, card)), ("7c", lambda: variants_generic(dev, card)),
                       ("7d", lambda: variants_hmc_ars(sl, card))):
        total = _add(total, _path(label, run)[0])
    # the held-out segment is the phase's one new kernel shape
    check_kernels(dev, T - int(0.8 * T), N, "7e held-out", card)
    for label, run in (("7e", lambda: variants_predictive(st, card)), ("7f", lambda: variants_resume(st, card))):
        total = _add(total, _path(label, run)[0])
    log(f"phase 7: {time.perf_counter() - t0:.2f} s")
    return total


# --- phase 8 ----------------------------------------------------------------

#: the long recording: N=100, 10 min at 1 ms, B=5 (scripts/stretch_streaming.py)
N_LONG, T_LONG = 100, 600_000
# 8d: 40 warmup sweeps, the least with adaptation windows
LONG_WARMUP, LONG_SAMPLES, LONG_ROW_BATCH = 40, 10, 4


def _grads(pop, params, data) -> tuple:
    """(log-joint, {leaf: gradient}) over the continuous block, float64 on the CPU."""
    opt, frozen = split_params(params)
    opt = {k: v.detach().clone().requires_grad_(True) for k, v in opt.items()}
    val = pop.log_joint({**frozen, **opt}, data)
    val.backward()
    return float(val.detach()), {k: v.grad.detach().cpu().double() for k, v in opt.items()}


def long_recording_phase(dev, card) -> dict:
    """Phase 8. Returns the launches of its paths (streamed MAP, resident
    log-likelihood, the sampler), summed."""
    from theano_pyglm_torch.scripts import stretch_streaming as stretch

    t_phase = time.perf_counter()
    C = stretch.TIME_CHUNK
    n_blocks = -(-T_LONG // C)
    # (a) the kernels at the path's three shapes: resident, one block, the ragged last block
    for T_, label in ((T_LONG, "8a resident"), (C, "8a block"), (T_LONG - (n_blocks - 1) * C, "8a last block")):
        check_kernels(dev, T_, N_LONG, label, card, on_device=True)
        torch.cuda.empty_cache()

    # (b) the recording
    spec, pop_res, true, stim = stretch.planted(dev, N_LONG, T_LONG, pop_cls=CountingPopulation)
    t0 = time.perf_counter()
    S, rates = stretch.simulate(pop_res, true, T_LONG, stim)
    torch.cuda.synchronize()
    rate = float(rates.mean())
    log(f"8b: simulated N={N_LONG}, T={T_LONG} in {time.perf_counter() - t0:.2f} s [{card}]; "
        f"{float(S.sum()):.0f} spikes, mean rate {rate:.2f} Hz")
    require(1.0 <= rate <= 20.0, f"8b: mean rate {rate} Hz outside 1-20 Hz")
    del rates

    # (c) streamed MAP: no design in the data, one launch per block per evaluation
    launches = launches_of()
    pop_s = CountingPopulation(spec, time_chunk=C, device=dev)
    data_s = pop_s.prepare_data(S, stim=stim, materialize_design=False)
    require("X_imp" not in data_s and "_X_imp_mean" not in data_s, "8c: the streamed data hold a design")
    t0 = time.perf_counter()
    before = _counted(pop_s)
    fit, lp_map, iters = stretch.fit_streamed(pop_s, data_s)
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t0
    with torch.no_grad():
        lp_true = float(pop_s.log_joint(true, data_s))
    got, evals = _since(pop_s, before)
    launches = _add(launches, got)
    log(f"8c: streamed MAP (time_chunk={C}, {n_blocks} blocks) log-joint {float(lp_map):.3f} against the "
        f"truth's {lp_true:.3f} in {iters} L-BFGS iterations, {t_map:.2f} s [{card}]; likelihood "
        f"evaluations (the truth's included) {evals}, launches {got}")
    require(got == launches_of(vg=n_blocks * evals["grad"], fwd=n_blocks * evals["value"]) and evals["grad"] > 0,
            f"8c: launches {got} != {n_blocks} x evaluations {evals}")
    require(math.isfinite(float(lp_map)) and float(lp_map) >= lp_true,
            f"8c: MAP {float(lp_map)} below the truth {lp_true}")
    design_bytes = T_LONG * N_LONG * pop_s.B_imp * 4
    opt, frozen = split_params(fit)
    opt = {k: v.detach().clone().requires_grad_(True) for k, v in opt.items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    pop_s.log_joint({**frozen, **opt}, data_s).backward()
    torch.cuda.synchronize()
    added = torch.cuda.max_memory_allocated(dev) - base
    log(f"8c: one streamed value+grad evaluation adds {added / 1e9:.3f} GB of device memory at its peak; "
        f"the materialized design would take {design_bytes / 1e9:.3f} GB")
    require(added < design_bytes, f"8c: a streamed evaluation added {added} B >= the design's {design_bytes} B")
    del opt

    # (d) resident: the same log-likelihood at the MAP point, then one chain
    data = pop_res.prepare_data(S, stim=stim)
    before = _counted(pop_res)
    with torch.no_grad():
        ll_res = float(pop_res.log_likelihood(fit, data))
        got, _ = _since(pop_res, before)
        ll_str = float(pop_s.log_likelihood(fit, data_s))
    launches = _add(launches, got)
    err = abs(ll_res - ll_str) / abs(ll_res)
    log(f"8d: log-likelihood at the MAP point, resident {ll_res:.3f} (launches {got}) against streamed "
        f"{ll_str:.3f}: rel {err:.3e}")
    require(got == launches_of(fwd=1), f"8d: the resident evaluation launched {got}")
    require(err <= 1e-5, f"8d: resident vs streamed log-likelihood rel err {err}")
    before = _counted(pop_res)
    t0 = time.perf_counter()
    samples, diag, state = gibbs_sample(
        pop_res, data, torch.Generator(device=dev).manual_seed(SEED), n_samples=LONG_SAMPLES,
        n_warmup=LONG_WARMUP, init_params=fit, row_batch=LONG_ROW_BATCH, n_leapfrog=LEAPFROG_STEPS,
    )
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    got, evals = _since(pop_res, before)
    launches = _add(launches, got)
    sweeps = LONG_WARMUP + LONG_SAMPLES
    log(f"8d: 1 chain x ({LONG_WARMUP} + {LONG_SAMPLES}) sweeps, row_batch={LONG_ROW_BATCH}, in {t_run:.2f} s: "
        f"{1e3 * t_run / sweeps:.1f} ms per sweep [{card}]; launches {got}; accept rates glm "
        f"{diag['accept_rate_glm']:.3f}, imp {diag['accept_rate_imp']:.3f}, adjacency "
        f"{diag['accept_rate_adjacency']:.3f}; peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    _require_sweep_launches("8d", got, evals, 1, sweeps)
    _require_chains("8d", [state], samples)
    stage_ms = {}
    for stage in SWEEP_STAGES:  # one sweep of each stage alone, host clock
        sweep = make_sweep(pop_res, data, n_leapfrog=LEAPFROG_STEPS, fisher_params=fit, stages=(stage,),
                           diagnostic=True, row_batch=LONG_ROW_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep(torch.Generator(device=dev).manual_seed(SEED + 1), state, False, 1.0)
        torch.cuda.synchronize()
        stage_ms[stage] = 1e3 * (time.perf_counter() - t0)
    log("8d: one sweep of each stage alone, ms: " + ", ".join(f"{k} {v:.1f}" for k, v in stage_ms.items())
        + f" [{card}]")
    del data, state, samples

    # (e) card float32 against CPU float64, streamed, at the truth (where the
    # gradient is far from 0): the full T if the CPU takes under 60 s, else
    # the first two blocks
    T_cmp = 2 * C
    cpu = Population(spec, device="cpu", dtype=torch.float64, time_chunk=C)
    p64 = {k: v.detach().cpu().double() for k, v in true.items()}
    t0 = time.perf_counter()
    cpu_val, cpu_grad = _grads(cpu, p64, cpu.prepare_data(S[:T_cmp].cpu().double(), stim=stim[:T_cmp],
                                                         materialize_design=False))
    t_cpu = time.perf_counter() - t0
    projected = t_cpu * T_LONG / T_cmp
    if projected < 60.0:
        T_cmp = T_LONG
        cpu_val, cpu_grad = _grads(cpu, p64, cpu.prepare_data(S.cpu().double(), stim=stim,
                                                             materialize_design=False))
        log(f"8e: the full T on the CPU (two blocks took {t_cpu:.1f} s, the full T projected {projected:.1f} s)")
    else:
        log(f"8e: cut to the first two blocks, T={T_cmp}: the CPU took {t_cpu:.1f} s for them, the full "
            f"T={T_LONG} projected {projected:.1f} s (over 60 s)")
    gpu_val, gpu_grad = _grads(pop_s, true, pop_s.prepare_data(S[:T_cmp], stim=stim[:T_cmp],
                                                             materialize_design=False))
    err_v = abs(gpu_val - cpu_val) / abs(cpu_val)
    err_g = {k: float(torch.linalg.norm(gpu_grad[k] - cpu_grad[k]) / torch.linalg.norm(cpu_grad[k]))
             for k in cpu_grad}
    log(f"8e: card f32 vs CPU f64, streamed log-joint at the truth over T={T_cmp}: {gpu_val:.3f} vs "
        f"{cpu_val:.3f}, rel {err_v:.3e}; gradient rel-L2 " + ", ".join(f"{k} {e:.2e}" for k, e in err_g.items()))
    require(err_v <= 1e-5, f"8e: log-joint rel err {err_v}")
    require(max(err_g.values()) <= 1e-4, f"8e: gradient rel-L2 errors {err_g}")
    log(f"phase 8: {time.perf_counter() - t_phase:.2f} s; launches on its paths {launches}")
    return launches


# --- phase 9 ----------------------------------------------------------------

N_HARNESS, T_HARNESS_SEC = 27, 60.0  # the flagship's width, 60 s at 1 ms
HARNESS_WARMUP, HARNESS_SAMPLES = 40, 20  # 40: the least warmup with adaptation windows


class _CountEvaluations:
    """Counts every Population's log-likelihood evaluations while active
    (the harness builds its own populations)."""

    def __enter__(self):
        self.evals = 0
        self._orig = orig = Population.log_likelihood

        def counted(pop, params, data):
            self.evals += 1
            return orig(pop, params, data)

        Population.log_likelihood = counted
        return self

    def __exit__(self, *exc):
        Population.log_likelihood = self._orig


def _harness_path(label, run) -> dict:
    """One harness path with the launch counts set to 0 just before it: every
    likelihood evaluation must have launched K1 or K2, and both ran."""
    zero_launches()
    t0 = time.perf_counter()
    with _CountEvaluations() as counted:
        run()
    torch.cuda.synchronize()
    got = dict(kernels.LAUNCHES)
    log(f"{label}: {time.perf_counter() - t0:.2f} s; likelihood evaluations {counted.evals}, launches {got}")
    require(got["fwd"] > 0 and got["vg"] > 0, f"{label}: a kernel never launched: {got}")
    require(sum(got.values()) == counted.evals,
            f"{label}: {counted.evals} likelihood evaluations against launches {got}")
    return got


def harness_phase(dev, card) -> dict:
    """Phase 9, in a temporary directory. Returns the launches of fit_rgc and
    the cli map and mcmc."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_harness_") as work:
        return _harness(dev, card, work)


def _harness(dev, card, work) -> dict:
    from theano_pyglm_torch import cli
    from theano_pyglm_torch.scripts import fit_rgc
    from theano_pyglm_torch.utils.binning import bin_spikes, native_available
    from theano_pyglm_torch.utils.io import load_results
    from theano_pyglm_torch.utils.rgc import load_rgc_mat, save_rgc_fixture_mat

    t_phase = time.perf_counter()
    fixture = os.path.join(work, "rgc_fixture.mat")
    t0 = time.perf_counter()
    save_rgc_fixture_mat(fixture, N=N_HARNESS, T_sec=T_HARNESS_SEC, seed=SEED, device=dev)
    rec = load_rgc_mat(fixture)
    T_ = int(round(rec["T_sec"] / DT))
    native = bin_spikes(rec["times"], rec["neurons"], T_, DT, rec["N"])
    plain = bin_spikes(rec["times"], rec["neurons"], T_, DT, rec["N"], use_native=False)
    log(f"9: fixture N={rec['N']}, {T_HARNESS_SEC:.0f} s: {len(rec['times'])} events in "
        f"{time.perf_counter() - t0:.2f} s; native binner built {native_available()}, "
        f"native == numpy: {np.array_equal(native, plain)}")
    require(native_available() and np.array_equal(native, plain), "9: the native binner differs from numpy")

    # fit_rgc trains on the first 80 % of the recording: the phase's one new kernel shape
    check_kernels(dev, int(0.8 * T_), N_HARNESS, "9 fit_rgc training", card)
    rgc_dir = os.path.join(work, "rgc")
    launches = _harness_path("9 fit_rgc", lambda: fit_rgc.main([
        "--dataFile", fixture, "--resultsDir", rgc_dir, "--n_samples", str(HARNESS_SAMPLES),
        "--n_warmup", str(HARNESS_WARMUP), "--seed", str(SEED)]))
    with open(os.path.join(rgc_dir, "rgc_fit_report.json")) as f:
        report = json.load(f)
    numbers = [report["map"][k] for k in ("log_joint_train", "heldout_loglik", "ks_mean")]
    numbers += [report["mcmc"][k] for k in ("heldout_predictive_loglik", "ks_mean_posterior_rate")]
    log(f"9 fit_rgc report: MAP {report['map']['log_joint_train']:.3f} in {report['map']['iters']} iterations, "
        f"held-out {report['map']['heldout_loglik']:.3f}, KS {report['map']['ks_mean']:.4f} (null "
        f"{report['map']['ks_null_mean']:.4f}); MCMC predictive {report['mcmc']['heldout_predictive_loglik']:.3f}, "
        f"glm accept {report['mcmc']['accept_rate_glm']} [{card}]")
    require(all(math.isfinite(v) for v in numbers), f"9: non-finite values in the fit_rgc report {numbers}")
    require(os.path.exists(os.path.join(rgc_dir, "rgc_fit_params.npz")), "9: fit_rgc wrote no parameters")

    cli_dir = os.path.join(work, "cli")
    flags = ["--model", "sparse_weighted_model", "-r", cli_dir, "--seed", str(SEED)]
    t0 = time.perf_counter()
    cli.main(["generate", "-N", str(N_HARNESS), "-T", str(T_HARNESS_SEC), *flags])
    log(f"9 cli generate: {time.perf_counter() - t0:.2f} s")
    data_file = os.path.join(cli_dir, "synth_data.npz")
    launches = _add(launches, _harness_path("9 cli map", lambda: cli.main(["map", "-d", data_file, *flags])))
    launches = _add(launches, _harness_path("9 cli mcmc", lambda: cli.main([
        "mcmc", "-d", data_file, "--n_samples", str(HARNESS_SAMPLES), "--n_warmup", str(HARNESS_WARMUP), *flags])))
    outputs = ["synth_data.npz", "map_results.npz", "mcmc_samples.npz", "mcmc_metrics.jsonl"]
    try:
        import matplotlib  # noqa: F401  (the figure is drawn where matplotlib is installed)

        outputs.append("map_results.png")
    except ImportError:
        log("9: matplotlib is not installed here: the cli skips its figure, map_results.png")
    for name in outputs:
        require(os.path.getsize(os.path.join(cli_dir, name)) > 0, f"9: the cli wrote no {name}")
    res = load_results(os.path.join(cli_dir, "mcmc_samples.npz"))
    require(all(np.isfinite(v).all() for v in res["samples"].values()), "9: non-finite cli samples")
    require(res["samples"]["W"].shape == (HARNESS_SAMPLES, N_HARNESS, N_HARNESS), "9: cli samples misshapen")
    log(f"phase 9: {time.perf_counter() - t_phase:.2f} s; launches on its paths {launches}")
    return launches

# --- phase 10 ---------------------------------------------------------------


BF16_CHAINS, BF16_WARMUP, BF16_SAMPLES = 4, 20, 10  # depth cut (see the module note)


def _bf16_operands(dev, T, N, C, clip_entries=0):
    """:func:`_chain_operands` with X_f rounded to bf16."""
    x, u, ir, s = _chain_operands(dev, T, N, C, clip_entries)
    return [x.to(torch.bfloat16), u, ir, s]


def check_bf16_kernels(dev, T, N, C, label, card, one_chain=True) -> dict:
    """K4-fwd-chains and K4-vg-chains on C chains at (T, NB=5N, N) and, with
    ``one_chain``, K4-fwd and K4-vg on chain 0 without a chain axis, against
    their plain versions (float32 sums in another order: each value 1e-5
    relative, dU 1e-5 relative L2, dI_rest rtol=1e-5 / atol=1e-6), with a
    clipped case; bit-for-bit repeats, one launch per call; the median
    times of 50 calls, warm and L2-cold, beside the plain version's and
    beside the float32 kernel on the same widened X_f (K1, K2, K3-fwd,
    K3-vg) in the same call; the bound (a bf16 X_f read once; the chain
    kernels' products at the bf16 rate) and the roofline share."""
    def one(ops):
        return [ops[0], ops[1][0].contiguous(), ops[2][0].contiguous(), ops[3]]

    pairs = [("fwd_chains_bf16", kernels.fused_ll_value_chains, kernels.fused_poisson_ll_chains_value_reference,
              lambda o: o),
             ("vg_chains_bf16", kernels.fused_ll_value_and_grad_chains, kernels.fused_poisson_ll_chains_reference,
              lambda o: o)]
    if one_chain:
        pairs += [("fwd_bf16", kernels.fused_ll_value, kernels.fused_poisson_ll_value_reference, one),
                  ("vg_bf16", kernels.fused_ll_value_and_grad, kernels.fused_poisson_ll_reference, one)]
    max_err = {}
    for clip_entries in (0, 500):
        all_ops = _bf16_operands(dev, T, N, C, clip_entries)
        for k, kern, plain, pick in pairs:
            ops = pick(all_ops)
            got, want = kern(*ops, DT), plain(*ops, DT)
            torch.cuda.synchronize()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            rel_v = float(((got[0] - want[0]).abs() / want[0].abs()).max())
            require(bool(torch.isfinite(got[0]).all()), f"{label}: non-finite {k} value")
            require(rel_v <= 1e-5, f"{label}: {k} value rel err {rel_v}")
            msg = f"value rel {rel_v:.3e}"
            err = float((got[0] - want[0]).abs().max())
            if len(got) == 3:
                rel_du = _rel(got[1], want[1])
                require(rel_du <= 1e-5, f"{label}: {k} dU rel-L2 err {rel_du}")
                torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)
                err_dir = float((got[2] - want[2]).abs().max())
                msg += f", dU rel-L2 {rel_du:.3e}, dI_rest max abs {err_dir:.3e}"
                err = max(err, float((got[1] - want[1]).abs().max()), err_dir)
                if clip_entries:
                    n_clipped = int((ops[2].abs() > 40.0).sum())
                    require(n_clipped > 0 and int((got[2] == 0).sum()) >= n_clipped,
                            f"{label}: {k} clip mask not applied")
            if not clip_entries:
                max_err[k] = err
            log(f"{label} T={T} N={N} C={C}, {k} vs plain (clipped entries {clip_entries}): {msg}")

    all_ops = _bf16_operands(dev, T, N, C)
    wide = [all_ops[0].float()] + all_ops[1:]
    launches = dict(kernels.LAUNCHES)
    for k, kern, _, pick in pairs:
        a, b = kern(*pick(all_ops), DT), kern(*pick(all_ops), DT)
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        require(all(torch.equal(x, y) for x, y in zip(a, b)), f"{label}: {k} not bit-for-bit repeatable")
    want = {**launches, **{k: launches[k] + 2 for k, *_ in pairs}}
    require(kernels.LAUNCHES == want, f"{label}: K4 not one launch per call: {launches} -> {kernels.LAUNCHES}")
    log(f"{label}: K4 repeats bit for bit, one launch per call")

    flush = torch.empty(40 * 2**20, dtype=torch.float32, device=dev)  # 160 MB
    f32_of = {"fwd_bf16": kernels.fused_ll_value, "vg_bf16": kernels.fused_ll_value_and_grad,
              "fwd_chains_bf16": kernels.fused_ll_value_chains, "vg_chains_bf16": kernels.fused_ll_value_and_grad_chains}
    stats = {}
    for k, kern, plain, pick in pairs:
        ops, ops32 = pick(all_ops), pick(wide)
        warm, cold = median_ms(lambda: kern(*ops, DT)), median_ms(lambda: kern(*ops, DT), flush=flush)
        plain_warm, plain_cold = median_ms(lambda: plain(*ops, DT)), median_ms(lambda: plain(*ops, DT), flush=flush)
        f32_warm = median_ms(lambda: f32_of[k](*ops32, DT))
        f32_cold = median_ms(lambda: f32_of[k](*ops32, DT), flush=flush)
        bound_ms, bound_by = bound(k, ops)
        share = bound_ms / cold
        plan = kernels.launch_plan(T, 5 * N, N, kernels._sm_count(dev.index), k.startswith("vg"),
                                   chains=C if "chains" in k else None, x_bytes=2)
        log(f"{label} T={T} NB={5 * N} N={N}{f' C={C}' if 'chains' in k else ''}, median of 50 calls, {k}: kernel "
            f"{warm:.4f} ms warm, {cold:.4f} ms cold; plain torch {plain_warm:.4f} ms warm, {plain_cold:.4f} ms "
            f"cold; the float32 kernel on the widened X_f {f32_warm:.4f} ms warm, {f32_cold:.4f} ms cold; bound "
            f"{bound_ms:.4f} ms ({bound_by}); roofline share of the cold time {100 * share:.1f} %; tile "
            f"{plan.tile_t}, grid {plan.grid_x} x {plan.grid_y * plan.groups}, {plan.smem_bytes} B of shared "
            f"memory [{card}]")
        stats[k] = {"max_abs_err": max_err[k], "ms": warm, "cold_ms": cold, "plain_ms": plain_warm,
                    "plain_cold_ms": plain_cold, "f32_kernel_ms": f32_warm, "f32_kernel_cold_ms": f32_cold,
                    "bound_ms": bound_ms, "bound_by": bound_by, "share": share, "library_ms": None}
    return stats


def _bf16_state_rel(pop32, pop16, params, data32, data16) -> tuple:
    """(log-joint relative delta, gradient rel-L2 over the continuous
    block, coupling current rel-L2) of the bf16 design against float32 at
    ``params``."""
    def value_and_grad(pop, data):
        q, frozen = split_params(params)
        q = {k: v.detach().clone().requires_grad_(True) for k, v in q.items()}
        val = pop.log_joint({**frozen, **q}, data)
        grads = torch.autograd.grad(val, list(q.values()))
        return float(val.detach()), torch.cat([g.reshape(-1) for g in grads])

    v32, g32 = value_and_grad(pop32, data32)
    v16, g16 = value_and_grad(pop16, data16)
    with torch.no_grad():
        i32 = gibbs._coupling_current(pop32, params, data32)
        i16 = gibbs._coupling_current(pop16, params, data16)
    return abs(v16 - v32) / abs(v32), rel_l2(g16, g32), rel_l2(i16, i32)


def bf16_phase(sl, card: str) -> dict:
    """10b and 10c: the flagship with design_dtype=torch.bfloat16 on phase
    3's spikes, stimulus and model; returns the kernels' launches on its
    paths (smart init and MAP; the sampler)."""
    dev = sl["pop"].device
    pop32, data32 = sl["pop"], sl["data"]
    pop = CountingPopulation(sl["spec"], device=dev, design_dtype=torch.bfloat16)
    t_phase = time.perf_counter()
    zero_launches()
    evals0 = dict(pop.ll_evals)
    t0 = time.perf_counter()
    data = pop.prepare_data(data32["S"], stim=sl["stim"])
    require(data["X_imp"].dtype == torch.bfloat16 and data["_X_imp_mean"].dtype == torch.float32,
            "10b: prepare_data did not cast the design")
    init = smart_initialize(pop, data, torch.Generator().manual_seed(SEED))
    fit, lp_map, iters = map_fit(pop, data, init)
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t0
    ll_evals = {k: pop.ll_evals[k] - evals0[k] for k in evals0}
    path = dict(kernels.LAUNCHES)
    with torch.no_grad():
        lp_init = float(pop.log_joint(init, data))
    log(f"10b bf16 design: prepare_data, smart init and MAP in {t_map:.2f} s: log-joint {float(lp_map):.3f} after "
        f"{iters} L-BFGS iterations (smart init {lp_init:.3f}); likelihood evaluations {ll_evals}; launches {path}")
    require(math.isfinite(float(lp_map)) and float(lp_map) >= lp_init, f"10b: MAP {lp_map} below the init {lp_init}")
    require(path == launches_of(vg_bf16=ll_evals["grad"], fwd_bf16=ll_evals["value"]) and ll_evals["grad"] > 0,
            f"10b: MAP launches {path} against likelihood evaluations {ll_evals}")

    rel_lj, rel_g, rel_i = _bf16_state_rel(pop32, pop, sl["params"], data32, data)
    log(f"10b bf16 against float32 at the float32 MAP point: log-joint rel {rel_lj:.3e}, gradient rel-L2 "
        f"{rel_g:.3e}, coupling current rel-L2 {rel_i:.3e}")
    require(all(math.isfinite(v) for v in (rel_lj, rel_g, rel_i)), "10b: non-finite bf16 against float32")

    zero_launches()
    ll0 = dict(pop.ll_evals)
    t0 = time.perf_counter()
    samples, diag, states, summary = rgc_flagship.run(
        pop, data, sl["true"], fit, seed=SEED, n_chains=BF16_CHAINS, n_iters=BF16_SAMPLES,
        n_warmup=BF16_WARMUP, thin=1, n_leapfrog=LEAPFROG_STEPS, init_jitter=0.05, chunk_size=BF16_SAMPLES,
    )
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    ll_evals = {k: pop.ll_evals[k] - ll0[k] for k in ll0}
    sweeps = BF16_WARMUP + BF16_SAMPLES
    log(f"10b bf16 Gibbs: {BF16_CHAINS} chains x ({BF16_WARMUP} + {BF16_SAMPLES}) in {t_run:.2f} s "
        f"({1e3 * t_run / sweeps:.1f} ms per 4-chain sweep, sampler and summary) [{card}]; launches {launches}; "
        f"likelihood evaluations {ll_evals}")
    _require_sweep_launches("10b bf16 Gibbs", launches, ll_evals, BF16_CHAINS, sweeps, bf16=True)
    _require_chains("10b bf16 Gibbs", states, samples)
    _require_accept_rates("10b bf16 Gibbs", diag)
    min_ess = min(v["min_ess"] for v in summary["convergence"].values())
    max_rhat = max(v["max_rhat"] for v in summary["convergence"].values())
    log(f"10b bf16: accept rates glm {diag['accept_rate_glm']}, imp {diag['accept_rate_imp']}, adjacency "
        f"{diag['accept_rate_adjacency']}; link-prediction AUC {summary['link_prediction_auc']}, smallest ESS "
        f"{min_ess:.2f}, largest R-hat {max_rhat:.3f} (10 draws: reported, not checked)")
    path = _add(path, launches)

    # the card's bf16 against the CPU's bf16 at the final state, both semantics
    batched = stack_states(states)["params"]
    cpu = Population(sl["spec"], device="cpu", design_dtype=torch.bfloat16)
    data_cpu = cpu.prepare_data(data32["S"].cpu(), stim=sl["stim"])
    p_cpu = {k: v.detach().cpu() for k, v in batched.items()}
    with torch.no_grad():
        got_c, want_c = pop.log_joint(batched, data).cpu(), cpu.log_joint(p_cpu, data_cpu)
        p0, p0_cpu = {k: v[0] for k, v in batched.items()}, {k: v[0] for k, v in p_cpu.items()}
        got_1, want_1 = float(pop.log_joint(p0, data)), float(cpu.log_joint(p0_cpu, data_cpu))
    err_c = float(((got_c - want_c).abs() / want_c.abs()).max())
    err_1 = abs(got_1 - want_1) / abs(want_1)
    log(f"10b card bf16 vs CPU bf16 at the final state: chains' log-joints rel {err_c:.3e}; chain 0 without a "
        f"chain axis rel {err_1:.3e} ({got_1:.3f} vs {want_1:.3f})")
    require(err_c <= 1e-5 and err_1 <= 1e-5, f"10b: card against CPU {err_c}, {err_1}")

    # 10c: one batched sweep against C = 1 in turn, a chain axis of 1 each
    # (the chain semantics): K4-chains only
    state16 = stack_states(states)
    sweep16 = make_sweep(pop, data, n_leapfrog=LEAPFROG_STEPS, fisher_params=fit)
    before = dict(kernels.LAUNCHES)
    _require_modes_agree(pop, sweep16, state16, "10c bf16: ")
    modes = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    require(all(modes[k] == 0 for k in KERNELS if k not in ("fwd_chains_bf16", "vg_chains_bf16")),
            f"10c: the chain semantics launched another kernel: {modes}")

    # the bf16 batched sweep beside the float32 one, from the same params
    state32 = init_mcmc_state(pop32, batched)
    sweep32 = make_sweep(pop32, data32, n_leapfrog=LEAPFROG_STEPS, fisher_params=sl["params"])
    gens = [torch.Generator(device=dev).manual_seed(SEED + 40 + c) for c in range(BF16_CHAINS)]
    timed = []
    for name, sweep, st in (("bf16", sweep16, state16), ("float32", sweep32, state32),
                            ("float32", sweep32, state32), ("bf16", sweep16, state16)):
        st = sweep(gens, st, False, 1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            st = sweep(gens, st, False, 1.0)
        torch.cuda.synchronize()
        timed.append(f"{name} {1e3 * (time.perf_counter() - t0) / 3:.3f}")
    log(f"10b the 4-chain batched sweep, ms per sweep over 3 sweeps, in turns: {'; '.join(timed)} [{card}]")
    log(f"phase 10b-c: {time.perf_counter() - t_phase:.2f} s; launches on its paths {path}")
    require(all(path[k] == 0 for k in F32_KERNELS), f"phase 10 launched a float32 kernel: {path}")
    require(all(path[k] > 0 for k in BF16_KERNELS), f"a K4 kernel of phase 10's path never launched: {path}")
    return path


def main() -> None:
    t_start = time.perf_counter()
    card = setup()
    dev = torch.device("cuda", torch.cuda.current_device())
    one = torch.zeros(1, device=dev)
    floor = median_ms(lambda: one.add_(1.0))
    log(f"timing floor: a one-element torch add timed as the kernels are takes {floor:.4f} ms")
    kstats = check_kernels(dev, T, N, "flagship", card)
    kstats.update(check_chain_kernels(dev, T, N, GIBBS_CHAINS, "flagship", card))

    zero_launches()
    sl = flagship_slice(dev)
    launches = dict(kernels.LAUNCHES)
    log(f"launches during the slice: {launches}")
    require(launches["fwd"] > 0 and launches["vg"] > 0, "a kernel of the path never launched")

    inner_loop(sl, card)

    zero_launches()
    gibbs_launches = gibbs_phase(sl, card)
    require(gibbs_launches["fwd_chains"] > 0 and gibbs_launches["vg_chains"] > 0,
            f"a kernel of the Gibbs path never launched: {gibbs_launches}")
    require(gibbs_launches["fwd"] == 0 and gibbs_launches["vg"] == 0,
            f"the 4-chain sampler launched K1/K2: {gibbs_launches}")
    launches = _add(launches, gibbs_launches)

    launches = _add(launches, acceptance_phase(dev, card))
    launches = _add(launches, variants_phase(dev, card, sl))

    torch.cuda.empty_cache()
    launches = _add(launches, long_recording_phase(dev, card))
    torch.cuda.empty_cache()
    launches = _add(launches, harness_phase(dev, card))

    # phase 10: the bf16 design (K4) on phase 3's flagship
    t0 = time.perf_counter()
    kstats.update(check_bf16_kernels(dev, T, N, BF16_CHAINS, "10a flagship", card))
    for c in (2, 3, 4):
        T_c, N_c = ACCEPT_SHAPES[c]
        check_bf16_kernels(dev, T_c, N_c, ACCEPT_SAMPLER_CHAINS[c], f"10a config {c}", card, one_chain=False)
    log(f"phase 10a: {time.perf_counter() - t0:.2f} s")
    launches = _add(launches, bf16_phase(sl, card))

    log(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s in all, the kernels' build included [{card}]")
    require(all(launches[k] > 0 for k in KERNELS), f"a kernel was never launched on the main paths: {launches}")
    # the bf16 instances (K4) replace the same TPU kernels and chain rules on a bf16 X_f
    replaces = {"fwd": "theano_pyglm_tpu/ops/pallas_kernels.py:73",
                "vg": "theano_pyglm_tpu/ops/pallas_kernels.py:100",
                "fwd_chains": "theano_pyglm_tpu/ops/pallas_kernels.py:213",
                "vg_chains": "theano_pyglm_tpu/ops/pallas_kernels.py:164"}
    names = {"fwd": "K1 fused_ll_fwd", "vg": "K2 fused_ll_vg",
             "fwd_chains": "K3-fwd fused_ll_fwd_chains", "vg_chains": "K3-vg fused_ll_vg_chains",
             "fwd_bf16": "K4-fwd fused_ll_fwd_bf16", "vg_bf16": "K4-vg fused_ll_vg_bf16",
             "fwd_chains_bf16": "K4-fwd-chains fused_ll_fwd_chains_bf16",
             "vg_chains_bf16": "K4-vg-chains fused_ll_vg_chains_bf16"}
    # library_ms is null: no single PyTorch call computes the fused value or value+grad
    print(json.dumps({"kernels": [
        {"name": names[k], "route": "cuda",
         "source": os.path.relpath(SOURCE_BF16 if k in BF16_KERNELS else SOURCE, REPO),
         "replaces": replaces[k.removesuffix("_bf16")], "launches": launches[k], **kstats[k]}
        for k in KERNELS
    ]}), flush=True)
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
