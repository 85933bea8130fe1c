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
   (the least time the card could take: bytes read and written once over
   3.35 TB/s, or the products as the card can do them at their accuracy,
   float32-accurate ones as 3xTF32 at 495 TFLOP/s, whichever is longer; see
   bound()) and the roofline share of the cold time. Then K3 (K3-fwd and
   K3-vg, the chain-batched pair; the four chain kernels are built from
   csrc/fused_ll_chains.cu) on the flagship's 4 chains: against its plain version (with a clipped case) and against
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
   launch for all chains, none of K1/K2, and one row-scan launch
   (csrc/adjacency_rows.cu) a batched adjacency stage; every leaf finite, A binary, accept
   rates in range; psi, the log-joint and the glm Laplace mode of chain 0's
   final state on the card in float32 against the CPU in float64; one sweep
   of the 4 chains batched against the same sweep at C = 1 on each chain in
   turn, from the same state and generators: each chain within 1 % of its
   own run's elements (margin decisions in float32) and ten times nearer
   it than any other chain's (config 4 likewise). Printed: the 4-chain batched sweep and each stage alone at
   C = 4, and beside them the same code at C = 1 on the 4 chains in turn:
   ms per sweep, synchronizing calls, device activities, busy time and idle
   share. Then the row scan at 4 and 16 chains on phase 3's data: against
   its plain version (A and accept flags equal, W within 1e-5, up to each
   row's first decision within float32's rounding bound of its sums), bit
   for bit repeated, one launch a call, and its device time warm and cold
   beside the plain version's, its bound (every operand read once, the
   current written once) and the traffic of its design (ψ_m, the previous
   entry's ψ, S and the current read, and the current written, for every
   entry). In every path the row-scan launches must be those the sweep's
   adjacency stage calls imply: one a call and row batch where the stage
   takes the exp-Poisson row scan on the card, and none of the torch entry
   loop's.
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
   stage times and device busy time, the batched glm stage with at most
   half the device activities of C = 1 x 4 in turn (each glm update runs
   once a sweep for all chains). 7b: standard_glm at N=27, T=60,000
   with the stimulus type 'shared' (DB=5), 4 chains x (40 + 10) in one
   batched sweep: launches (K3, no K1/K2), 0 synchronizing calls in the glm
   stage and the full sweep, both sub-blocks' modes of chain 0 against the
   CPU, stage times and activities as 7a's. 7c: config 3's shape (N=10, T=30,000) with softplus, then with
   Bernoulli observations, 1 chain x 10 sweeps of the autograd branches: no
   fused launch, _bin_ll_derivs against the CPU (1e-4). 7d: phase 3's
   flagship, 1 chain x (40 + 10) with glm_update='hmc' and again with
   bias_update='ars': launches, accept rates, one host round trip per ARS
   pass (counted by the sync debug mode), the whitening factor against the
   CPU (1e-5). 7e: K1/K2 against the plain version at the held-out shape
   (T=12,000), as in phase 2, then the predictive log-likelihood of 7a's 40
   draws on the last 20 % of a fresh simulation of 7a's generating
   parameters: blocks of 32 and 8 draws, each one evaluation with a chain
   axis, so K3-fwd launches as chain_groups cuts each block (4 + 1 at
   N=27), above a prior draw's. 7f: 7a's
   model, 2 chains x 30 sweeps checkpointed every 10, uninterrupted and
   stopped at 20 then resumed: the kept draws and final states equal bit
   for bit.
8. Long recordings at N=100, T=600,000 (10 min at 1 ms), B=5: the model,
   planted network and stimulus of
   theano_pyglm_torch/scripts/stretch_streaming.py. 8a: K1/K2 against the
   plain version as in phase 2 at the path's three shapes, all through
   their wide-U instance (csrc/fused_poisson_ll_wide.cu: U too wide to stay
   in shared memory), each call counted in kernels.WIDE_LAUNCHES too:
   (600,000, 500, 100) resident, (65,536, 500, 100) one block, (10,176,
   500, 100) the ragged last block, each with the bound of X_f read once
   and, for K2, read twice as that instance reads it. 8b: simulate, mean rate in
   1-20 Hz. 8c: MAP on the streamed design (time_chunk=65,536, no X_imp):
   K2 launches 10 x the value+grad evaluations and K1 10 x the value-only
   ones, the MAP log-joint at least the truth's, and the device memory one
   streamed value+grad evaluation adds below the 1.2 GB design. 8d: the
   resident log-likelihood at the MAP point equal to the streamed one
   (1e-5 rel.), then 1 chain x (40 + 10) sweeps with row_batch=4:
   launches as the sweep implies (25 row-scan launches an adjacency stage,
   the 24 replayed row batches counted), leaves finite, A binary, ms per
   sweep, and one sweep of each stage alone.
   8e: the card's float32 streamed log-joint and gradient at the truth
   against the CPU's float64 (1e-5 rel., 1e-4 rel. L2), over the full T if
   the CPU's projected time is under 60 s, else over the first two blocks.
9. The harness at the flagship's width, N=27, 60 s: a .mat fixture
   (utils/rgc.py), binned by the native binner and by numpy, the same
   counts; K1/K2 against the plain version as in phase 2 at fit_rgc's
   training shape (T=48,000); scripts/fit_rgc.py on it (MAP, 40 + 20 sweeps, report); then
   cli generate, map and mcmc (40 + 20): every output written (the figure
   where matplotlib is installed), every likelihood evaluation through K1
   or K2 (a block of predictive draws through K3-fwd, a launch per group
   of chain_groups) and both launched.
10. The bf16 spike design (Population(design_dtype=torch.bfloat16)), K4.
   10a: K4-fwd and K4-vg (no chain axis: U float32) and K4-fwd-chains and
   K4-vg-chains (4 chains: U and dI rounded to bf16) against their plain
   versions at the flagship shape, with a clipped case, bit-for-bit
   repeats, one launch per call, warm and cold median times of 50 calls
   beside the plain version's and beside K1/K2/K3 on the widened X_f, the
   bound (bf16 X_f bytes; bf16 × float32 products as 2 TF32 products, the
   chain kernels' bf16 × bf16 products at 989 TFLOP/s)
   and share; K4-fwd and K4-vg likewise at configs 1-4's shapes and at
   the long recording's three (N=100, in K4's four column groups, with the
   bound of X_f read once a group too), the chain pair at configs 2-4's
   sampler chains. 10b: phase
   3's spikes, stimulus and model with a bf16 design: prepare_data, smart
   init, MAP (K4-vg launches equal to the L-BFGS evaluations), then
   rgc_flagship.run with 4 chains x (20 + 10) batched sweeps (K4-chains
   launches as the sweep implies, none of K1-K3 or of K4 without a chain
   axis; one launch of the row scan's bf16 instance a stage), leaves
   finite, A binary; the row scan's bf16 instance against its plain version
   on that ψ at 4 chains, as in phase 5; the card's bf16 log-joints at the final
   state against the CPU's bf16 (1e-5 rel., with and without a chain
   axis); bf16 against float32 at the float32 MAP point (log-joint,
   gradient and coupling current, reported); the bf16 batched sweep's ms
   beside the float32 one's in turns. 10c: one batched bf16 sweep against
   C = 1 in turn, each with a chain axis of 1 (the chain semantics, K4-chains
   only), at phase 5's limits.
11. The multi-GPU layer (theano_pyglm_torch/parallel/, entry.py) at one
   rank: a process group of one, NCCL on cuda:0 (a local TCP store on a
   free port). 11a: rgc_flagship.run on a 'chains' mesh with phase 5's
   population, data, MAP fit, seed and depth: its samples, diagnostics and
   final states equal phase 5's bit for bit, its launches phase 5's; ms per
   sweep beside phase 5's. 11b: at phase 3's MAP point on a 'neurons' mesh,
   make_sharded_value_and_grad (one K2 launch) against the unsharded value
   and gradient (1e-6 rel.); local_log_likelihood over three blocks of 9
   neurons, one K2 launch each, against the full log-likelihood (value
   1e-5 rel., gradient 1e-4 rel. L2); parallel_map_fit from phase 3's init
   against map_fit's log-joint (1e-5 rel.), one K2 launch an evaluation
   with a gradient and K1 for each without; value+grad evals/s of the
   sharded objective beside the unsharded one's in turns. 11c: entry()'s
   value against the population's log-joint (1e-6 rel.), then
   dryrun_multichip over the card(s), and the group shut down. Several
   ranks run on the CPU only (gloo, tests/test_torch_parallel.py): NCCL
   takes no two ranks on one GPU.

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

The samplers of more than one chain (phases 5, 6 configs 2-4, 7a, 7b, 7f)
run one batched sweep over their chains and launch K3; the one-chain
samplers (7c, 7d, 8d, 9) run the same sweep at C = 1, where K1/K2 carry the
likelihood. With a bf16 design (phase 10) every sampler evaluation is a
K4-chains launch, at any C.

The line before the last two is one JSON object describing the kernels
K1, K2, K3-fwd and K3-vg (times and errors from phase 2), the four K4
(from 10a), K1's and K2's wide-U instance (8a at T=600,000) and the row
scan's two instances (phases 5 and 10b), with
launches summed over the paths of phases 3, 5, 6, 7, 8, 9, 10 and 11
(K1's and K2's without their wide-U instance's, which phase 8's paths
make), each of which must have launched at least once; the next the
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
from theano_pyglm_torch.inference import ars, gibbs, mcmc, row_scan  # noqa: E402
from theano_pyglm_torch.inference.hmc import hmc_adaptive_step, hmc_init  # noqa: E402
from theano_pyglm_torch.inference.map import (  # noqa: E402
    cross_validate_lambda, map_fit, sparse_map_fit, split_params, value_and_grad)
from theano_pyglm_torch.inference.mcmc import SWEEP_STAGES, _glm_theta0, gibbs_sample, make_sweep  # noqa: E402
from theano_pyglm_torch.inference.mcmc import chain_state, init_mcmc_state, stack_states  # noqa: E402
from theano_pyglm_torch.inference.mcmc import whitening_factor  # noqa: E402
from theano_pyglm_torch.inference.predictive import predictive_log_likelihood  # noqa: E402
from theano_pyglm_torch.inference.smart_init import smart_initialize  # noqa: E402
from theano_pyglm_torch.ops import kernels  # noqa: E402
from theano_pyglm_torch.ops.cuda_loader import (  # noqa: E402
    SOURCE, SOURCE_BF16, SOURCE_CHAINS, SOURCE_ROWS, SOURCE_WIDE, build_all, load_adjacency_rows, load_fused_ll,
    load_fused_ll_bf16, load_fused_ll_chains, load_fused_ll_wide)
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
TF32_FLOP_PER_S = 495e12  # TF32 on the tensor cores, dense
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
    these operands, the larger of two times. Bytes: each input read once
    (at its element size: a bf16 X_f is 2 bytes), each output written once,
    over HBM_BYTES_PER_S. Operations: the products' multiply-adds as the
    card can do them at their accuracy: float32-accurate products (a float32
    X_f: K1-K3) as 3xTF32 on the tensor cores, 3 × the operations at
    TF32_FLOP_PER_S; bf16 × float32 products (K4-fwd, K4-vg: a bf16 X_f with
    U and dI in float32) as 2 × the operations at TF32_FLOP_PER_S; bf16 ×
    bf16 products (K4-chains: U and dI rounded) at BF16_FLOP_PER_S.
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
    if x.dtype != torch.bfloat16:
        t_ops = 3 * flops / TF32_FLOP_PER_S
    elif "chains" in k:
        t_ops = flops / BF16_FLOP_PER_S
    else:
        t_ops = 2 * flops / TF32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


F32_KERNELS = ("fwd", "vg", "fwd_chains", "vg_chains")  # K1, K2, K3-fwd, K3-vg
BF16_KERNELS = tuple(k + "_bf16" for k in F32_KERNELS)  # K4-fwd, K4-vg, K4-fwd-chains, K4-vg-chains
KERNELS = F32_KERNELS + BF16_KERNELS  # kernels.LAUNCHES' keys
assert set(KERNELS) == set(kernels.LAUNCHES)


# Row-scan launches since the last zero_launches() that the adjacency
# stage's calls imply (spy_adjacency_stage), and those of the paths before.
ROW_SCANS_IMPLIED = dict.fromkeys(kernels.ROW_SCAN_LAUNCHES, 0)
ROW_SCANS_ON_PATHS = dict.fromkeys(kernels.ROW_SCAN_LAUNCHES, 0)


def spy_adjacency_stage() -> None:
    """Have every call of the sweep's adjacency stage add the row-scan
    launches it implies to ROW_SCANS_IMPLIED: one a row batch where the
    stage takes the exp-Poisson row scan on the card (A sampled, weights),
    none otherwise."""
    stage = mcmc.update_adjacency_collapsed

    def spied(generator, pop, params, data, *args, row_batch=None, **kw):
        X = data.get("X_imp")
        if (data["S"].is_cuda and X is not None and not pop.graph.fixed_A and pop.weights.has_W
                and pop.nlin.name == "exp" and pop.observation.name == "poisson"):
            rows = params["A"][..., 0].numel()  # C·N
            key = "row_scan_bf16" if X.dtype == torch.bfloat16 else "row_scan"
            ROW_SCANS_IMPLIED[key] += -(-rows // int(row_batch or rows))
        return stage(generator, pop, params, data, *args, row_batch=row_batch, **kw)

    mcmc.update_adjacency_collapsed = spied


def require_row_scans(what: str) -> None:
    """The row-scan launches since the last zero_launches() are those the
    adjacency stage's calls imply: one a call and row batch, so on the card
    the exp-Poisson stage never ran the torch entry loop."""
    require(kernels.ROW_SCAN_LAUNCHES == ROW_SCANS_IMPLIED,
            f"{what}: row-scan launches {kernels.ROW_SCAN_LAUNCHES}, the adjacency stage implies {ROW_SCANS_IMPLIED}")


def zero_launches() -> None:
    """Every kernel's launch count to 0, just before a path is driven; the
    row scans of the path before are checked and added to
    ROW_SCANS_ON_PATHS."""
    require_row_scans("the path before")
    for k in ROW_SCANS_ON_PATHS:
        ROW_SCANS_ON_PATHS[k] += kernels.ROW_SCAN_LAUNCHES[k]
    kernels.ROW_SCAN_LAUNCHES.update(dict.fromkeys(ROW_SCANS_ON_PATHS, 0))
    ROW_SCANS_IMPLIED.update(dict.fromkeys(ROW_SCANS_ON_PATHS, 0))
    kernels.LAUNCHES.update({k: 0 for k in KERNELS})
    kernels.WIDE_LAUNCHES.update({k: 0 for k in kernels.WIDE_LAUNCHES})


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
    load_fused_ll_wide()
    load_fused_ll_bf16()
    load_fused_ll_chains()
    load_adjacency_rows()
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
    times. Where the plan takes K1/K2's wide-U instance, every call is
    checked to have launched it, and K2's bound is also given with X_f read
    twice, as that instance reads it."""
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
    launches, wide = dict(kernels.LAUNCHES), dict(kernels.WIDE_LAUNCHES)
    a, b = kernels.fused_ll_value_and_grad(*ops, DT), kernels.fused_ll_value_and_grad(*ops, DT)
    require(all(torch.equal(x, y) for x, y in zip(a, b)), "K2 not bit-for-bit repeatable")
    require(torch.equal(kernels.fused_ll_value(*ops, DT), kernels.fused_ll_value(*ops, DT)),
            "K1 not bit-for-bit repeatable")
    require(kernels.LAUNCHES == {**launches, "fwd": launches["fwd"] + 2, "vg": launches["vg"] + 2},
            f"not one launch per call: {launches} -> {kernels.LAUNCHES}")
    plans = {k: kernels.launch_plan(T, 5 * N, N, kernels._sm_count(dev.index), k == "vg") for k in ("fwd", "vg")}
    for k, plan in plans.items():
        want = wide[k] + (2 if plan.k_slab else 0)
        require(kernels.WIDE_LAUNCHES[k] == want,
                f"{k}: {kernels.WIDE_LAUNCHES[k] - wide[k]} of 2 calls through the wide-U instance, plan {plan}")
        if plan.k_slab:
            log(f"  {k}: the wide-U instance (csrc/fused_poisson_ll_wide.cu, fused_ll_{k}_wide) took every call: "
                f"tiles of {plan.tile_t} bins ({plan.m_warps} x {_warps_along_n(plan)} warps, {plan.m_tiles} m-tiles "
                f"a warp), k-slabs of {plan.k_slab} in {plan.stages} stages, grid {plan.grid_x}"
                + (f", dU in {plan.du_parts} parts over chunks of {plan.du_chunk} bins" if k == "vg" else ""))
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
        plan = plans[k]
        log(f"{label} T={T} NB={5 * N} N={N}, median of 50 calls, {k}: kernel {warm:.4f} ms warm, "
            f"{cold:.4f} ms cold; plain torch {plain_warm:.4f} ms warm, {plain_cold:.4f} ms cold; "
            f"bound {bound_ms:.4f} ms ({bound_by}); roofline share of the cold time {100 * share:.1f} %; "
            f"host-inclusive events (the first port's method) {enqueue:.4f} ms [{card}]")
        if plan.groups > 1:
            g_ms, g_by = bound(k, ops, x_reads=plan.groups)
            log(f"  {k}: {plan.groups} column groups of {plan.group_cols}, tile {plan.tile_t}, grid "
                f"{plan.grid_x} x {plan.grid_y * plan.groups}; with X_f read {plan.groups} times the bound is "
                f"{g_ms:.4f} ms ({g_by}), share {100 * g_ms / cold:.1f} %")
        if plan.k_slab and k == "vg":
            g_ms, g_by = bound(k, ops, x_reads=2)
            log(f"  {k}: with X_f read twice (the forward, then dU) the bound is {g_ms:.4f} ms ({g_by}), "
                f"share {100 * g_ms / cold:.1f} %")
        if warm < bound_ms:
            log(f"  {k}: the warm time beats the HBM bound because X_f ({ops[0].numel() * 4 / 1e6:.1f} MB) "
                f"stays in the 50 MB L2; no share is taken from it")
        stats[k] = {"max_abs_err": max_err[k], "ms": warm, "cold_ms": cold, "plain_ms": plain_warm,
                    "plain_cold_ms": plain_cold, "bound_ms": bound_ms, "bound_by": bound_by,
                    "share": share, "library_ms": None}
    return stats


def _warps_along_n(plan) -> int:
    """The warps of the wide-U instance's tile that share its n-tiles."""
    return kernels.WARPS // plan.m_warps


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
    return {"pop": pop, "params": fit, "data": data, "spec": spec, "true": true, "stim": stim, "init": init,
            "lp_map": lp_map}


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
    (the batched sweep carries a chain axis), and no other kernel. The row
    scans since the last zero_launches() as the adjacency stage's calls
    imply (require_row_scans)."""
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
    require_row_scans(what)


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
    launches0, ll0, rows0 = dict(kernels.LAUNCHES), dict(pop.ll_evals), dict(kernels.ROW_SCAN_LAUNCHES)
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
    rows = {k: kernels.ROW_SCAN_LAUNCHES[k] - rows0[k] for k in rows0}
    sweeps = GIBBS_WARMUP + GIBBS_SAMPLES
    require(rows == {"row_scan": sweeps, "row_scan_bf16": 0},
            f"Gibbs: row-scan launches {rows}, not one a batched adjacency stage ({sweeps})")
    log(f"Gibbs: {GIBBS_CHAINS} chains x ({GIBBS_WARMUP} warmup + {GIBBS_SAMPLES} samples) in {t_run:.2f} s "
        f"({1e3 * t_run / (GIBBS_WARMUP + GIBBS_SAMPLES):.1f} ms per 4-chain sweep, sampler and summary) "
        f"[{card}]; launches {launches}; likelihood evaluations {ll_evals}; row-scan launches {rows}")
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

    sl["phase5"] = {"samples": samples, "diag": diag, "states": states, "launches": launches, "t_run": t_run}
    time_sweeps(pop, data, fit, stack_states(states), card, check_modes=True)
    return launches


def _row_scan_operands(dev, chains, pop=None, data=None, seed=SEED):
    """The row-scan kernel's operands as one adjacency stage of ``chains``
    chains passes them (params drawn from the prior; without ``pop`` and
    ``data`` a flagship-shaped problem with Poisson spikes at ~20 Hz)."""
    if pop is None:
        pop = Population(make_model("distance_weighted_model", N, bias={"mu": 3.0, "sigma": 0.4}), device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        S = torch.poisson(torch.full((T, N), 0.02, device=dev), generator=g)
        data = pop.prepare_data(S, stim=np.random.RandomState(seed).randn(T, 1).astype(np.float32))
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    samples = [pop.sample(g) for _ in range(chains)]
    params = {k: torch.stack([p[k] for p in samples]) for k in samples[0]}
    gens = [torch.Generator(device=dev).manual_seed(seed + 10 + c) for c in range(chains)]
    calls, scan = [], row_scan.adjacency_row_scan

    def recorded(psi, cur, S_n, ent, offs=None, blk=0, **kw):
        calls.append(((psi, cur.clone(), S_n, ent, offs, blk), kw))
        return scan(psi, cur, S_n, ent, offs, blk, **kw)

    before = dict(kernels.ROW_SCAN_LAUNCHES)
    row_scan.adjacency_row_scan = recorded
    try:
        gibbs.update_adjacency_collapsed(gens, pop, params, data)
    finally:
        row_scan.adjacency_row_scan = scan
    require(len(calls) == 1, f"the stage made {len(calls)} row-scan calls, not one")
    key = "row_scan_bf16" if calls[0][0][0].dtype == torch.bfloat16 else "row_scan"
    made = {k: kernels.ROW_SCAN_LAUNCHES[k] - before[k] for k in before}
    require(made == {**dict.fromkeys(before, 0), key: 1}, f"the stage made row-scan launches {made}, not one")
    return calls[0]


def row_scan_bound(psi, offs, blk) -> tuple:
    """(floor ms, design ms) of the row scan over HBM_BYTES_PER_S. The
    floor: every operand read once (ψ, S, the current, the entries and the
    offsets) and the current and the (3, R, M) result written once. The
    design: the bytes the kernel moves if nothing is found in L2 — per row,
    the subsample's S and current read once; per entry ψ_m's row, S and the
    current read, ψ_m's subsample gathered, and, from the second entry, the
    previous entry's ψ read and (but for the last) the current written."""
    M, R, T_ = psi.shape
    es = psi.element_size()
    T_sub = T_ if offs is None else offs.shape[1] * blk
    n_offs = 0 if offs is None else offs.numel()
    floor = psi.numel() * es + 3 * 4 * R * T_ + 4 * R * 9 * M + 8 * n_offs + 4 * 3 * R * M
    per_row = (8 * T_sub + M * T_ * (es + 8) + M * T_sub * es + (M - 1) * T_ * es + max(M - 2, 0) * 4 * T_
               + 4 * 9 * M + 4 * 3 * M)
    design = R * per_row + 8 * n_offs
    return 1e3 * floor / HBM_BYTES_PER_S, 1e3 * design / HBM_BYTES_PER_S


def check_row_scan(dev, card, pop=None, data=None, chains=(4, 16)) -> dict:
    """The adjacency stage's row scan at the flagship shape, at each of
    ``chains`` (ψ float32, or bf16 for a bf16 design): the stage's own call
    one launch, the kernel against its plain version on the same operands
    (A, accept flags equal and W within 1e-5 of max(|W|, σ) up to each row's
    first decision within float32's rounding bound of its sums), one launch
    a call, bit-for-bit repeats; then the kernel's median device time warm
    and with the L2 flushed, the plain version's, its bound and its design's
    traffic. Returns the statistics of the last of ``chains``. The launch
    counts are as they were before: the check's launches count on no path."""
    stats, saved = {}, dict(kernels.ROW_SCAN_LAUNCHES)
    flush = torch.empty(40 * 2**20, dtype=torch.float32, device=dev)  # 160 MB
    for C in chains:
        (psi, cur, S_n, ent, offs, blk), kw = _row_scan_operands(dev, C, pop, data)
        key = "row_scan_bf16" if psi.dtype == torch.bfloat16 else "row_scan"
        before = dict(kernels.ROW_SCAN_LAUNCHES)
        got = [row_scan.adjacency_row_scan(psi, cur.clone(), S_n, ent, offs, blk, **kw) for _ in range(2)]
        torch.cuda.synchronize()
        made = {k: kernels.ROW_SCAN_LAUNCHES[k] - before[k] for k in before}
        require(made == {**dict.fromkeys(before, 0), key: 2}, f"row scan: launches {made} for two calls")
        require(all(torch.equal(a, b) for a, b in zip(*got)), "row scan: not bit-for-bit repeatable")
        A_k, W_k, acc_k = got[0]
        A_p, W_p, acc_p, open_p = row_scan.adjacency_row_scan_reference(psi, cur, S_n, ent, offs, blk, **kw,
                                                                        margins=True)
        R, M = A_p.shape
        first = torch.where(open_p.any(1), open_p.int().argmax(1), torch.full((R,), M, device=dev))
        before_open = torch.arange(M, device=dev)[None] < first[:, None]
        w_err = float(torch.where(before_open, (W_k - W_p).abs() / torch.maximum(W_p.abs(), ent[:, 3]), 0.0).max())
        agree = bool((((A_k == A_p) & (acc_k == acc_p)) | ~before_open).all())
        n_open = int((first < M).sum())
        K = kernels.row_scan_cluster(R, T if offs is None else offs.shape[1] * blk, kernels._sm_count(dev.index))
        label = f"row scan {psi.dtype} C={C}"
        log(f"{label} ({R} rows, {K} CTAs a row), kernel vs plain: A and accept flags "
            f"{'agree' if agree else 'DIFFER'} before each row's first open decision, W error {w_err:.3e} of "
            f"max(|W|, sigma); {n_open} of {R} rows meet an open decision; acceptance {float(acc_k.mean()):.4f} "
            f"(plain {float(acc_p.mean()):.4f})")
        require(agree and w_err <= 1e-5, f"{label}: the kernel and the plain version disagree")
        require(n_open <= 0.01 * R or C < 16, f"{label}: {n_open} of {R} rows meet an open decision")

        work = cur.clone()  # overwritten by every call: the kernel's time does not depend on the values
        kern = lambda: row_scan.adjacency_row_scan(psi, work, S_n, ent, offs, blk, **kw)  # noqa: E731
        plain = lambda: row_scan.adjacency_row_scan_reference(psi, cur, S_n, ent, offs, blk, **kw)  # noqa: E731
        warm, cold = median_ms(kern, n=20), median_ms(kern, n=20, flush=flush)
        plain_warm = median_ms(plain, n=3, warmup=1)
        bound_ms, design_ms = row_scan_bound(psi, offs, blk)
        log(f"{label} T={T} N={N}, median device time: kernel {warm:.4f} ms warm, {cold:.4f} ms cold; "
            f"plain torch {plain_warm:.4f} ms warm; bound {bound_ms:.4f} ms (every operand read once, the "
            f"current written once), share of the cold time {100 * bound_ms / cold:.1f} %; the design's "
            f"traffic {design_ms:.4f} ms (psi_m, the previous psi, S and the current read, the current "
            f"written, every entry), {100 * design_ms / cold:.1f} % of the cold time [{card}]")
        stats = {"max_abs_err": float((W_k - W_p).abs().max()), "ms": warm, "cold_ms": cold, "plain_ms": plain_warm,
                 "plain_cold_ms": None, "bound_ms": bound_ms, "bound_by": "bytes", "share": bound_ms / cold,
                 "library_ms": None}
        del psi, cur, S_n, ent, work, got
        torch.cuda.empty_cache()
    kernels.ROW_SCAN_LAUNCHES.update(saved)
    return stats


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
    ({stage or None: the batched sweep's synchronizing calls},
    {stage or None: (the batched sweep's device activities, those of
    C = 1 in turn or None where C = 1)})."""
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
    activities = {}
    for (how, stage), (ms, st) in timed.items():
        run, sweep = runs[how][0], sweeps[stage]
        wall, busy, n_dev = device_busy_ms(lambda: run(sweep, st))
        activities.setdefault(stage, [None, None])[0 if run is batched else 1] = n_dev
        log(f"{label}{'full sweep' if stage is None else 'stage ' + stage}, {how}, under torch.profiler: {n_dev} "
            f"device activities taking {busy:.3f} ms ({wall:.3f} ms wall profiled); against the unprofiled "
            f"{ms:.3f} ms the device idles {100 * (1 - busy / ms):.1f} % [{card}]")
    return syncs_of, {k: tuple(v) for k, v in activities.items()}


def _require_batched_glm(label, activities) -> None:
    """The glm stage batched over the chains: at most half the device
    activities of the same stage at C = 1 on each chain in turn (one
    chain's update, not C of them, in a batched sweep)."""
    batched, in_turn = activities["glm"]
    require(2 * batched <= in_turn, f"{label}: the batched glm stage has {batched} device activities, "
                                    f"C = 1 in turn {in_turn}: not batched over the chains")


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


# K1's and K2's launches through their wide-U instance on the counted paths
WIDE_ON_PATHS = dict.fromkeys(kernels.WIDE_LAUNCHES, 0)


def _counted(pop):
    """(launches, likelihood evaluations, wide-U launches) so far, to
    difference later."""
    return dict(kernels.LAUNCHES), dict(pop.ll_evals), dict(kernels.WIDE_LAUNCHES)


def _since(pop, before) -> tuple:
    """(launches, likelihood evaluations) since ``before``; the wide-U
    instance's launches since then are added to WIDE_ON_PATHS."""
    launches0, ll0, wide0 = before
    for k in wide0:
        WIDE_ON_PATHS[k] += kernels.WIDE_LAUNCHES[k] - wide0[k]
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

    syncs, _ = time_sweeps(pop, data, init, stack_states(states), card, label="config 4 ", stages=("discrete",),
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
    sweep, the batched glm stage with at most half the device activities of
    C = 1 x 4 in turn. Returns (the path's launches, what 7e and 7f
    reuse)."""
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
    syncs, activities = time_sweeps(pop, data, fit, stack_states(states), card, label="7a ", stages=("glm", "imp"))
    require(not syncs["glm"] and not syncs[None], f"7a: synchronizing calls {syncs}")
    _require_batched_glm("7a", activities)
    return path, {"pop": pop, "data": data, "fit": fit, "true": true, "samples": samples}


def variants_shared(dev, card) -> dict:
    """7b: standard_glm at N=27, T=60,000 with its stimulus section's type
    set to 'shared' (DB=5): 4 chains in one batched sweep (K3, no K1/K2);
    launches, finiteness, accept rates, card vs CPU of both sub-blocks'
    modes on chain 0's final state, stage times with 0 synchronizing calls
    in the glm stage and the full sweep, the batched glm stage with at most
    half the device activities of C = 1 x 4 in turn."""
    spec = make_model("standard_glm", N)
    spec["bkgd"]["type"] = "shared"
    pop = CountingPopulation(spec, device=dev)
    true, S, stim = _simulated(pop, SEED + 71, T, "7b shared stimulus")
    data = pop.prepare_data(S, stim=stim)
    require(tuple(data["X_stim"].shape) == (T, 5), f"7b: X_stim {tuple(data['X_stim'].shape)}")
    init = smart_initialize(pop, data, torch.Generator().manual_seed(SEED))
    before = _counted(pop)
    t0 = time.perf_counter()
    samples, diag, states = gibbs_sample_chains(
        pop, data, SEED + 71, n_chains=ST_CHAINS, n_samples=SHARED_SAMPLES, n_warmup=SHARED_WARMUP,
        chunk_size=SHARED_SAMPLES, init_params=init, init_jitter=0.05,
    )
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    path, ll_evals = _since(pop, before)
    sweeps = SHARED_WARMUP + SHARED_SAMPLES
    log(_sampler_ms("7b sampler", t_run, ST_CHAINS, sweeps, card) + f"; launches {path}; accept glm "
        f"{diag['accept_rate_glm']}, imp {diag['accept_rate_imp']}")
    _require_sweep_launches("7b sampler", path, ll_evals, ST_CHAINS, sweeps)
    _require_chains("7b sampler", states, samples)
    _require_accept_rates("7b sampler", diag)

    p0 = states[0]["params"]
    cpu, data64, p64 = _cpu64(pop, data, stim, p0)
    theta0 = _glm_theta0(pop, data, init, "shared")
    with torch.no_grad():
        fits32 = gibbs.glm_laplace_fit_shared(pop, p0, data, theta0)
        fits64 = gibbs.glm_laplace_fit_shared(cpu, p64, data64, {k: v.cpu().double() for k, v in theta0.items()})
    errs = [rel_l2(a[0], b[0]) for a, b in zip(fits32, fits64)]
    log(f"7b card f32 vs CPU f64 on chain 0's final state: Laplace theta* rel-L2 (a) [bias, gain] {errs[0]:.3e}, "
        f"(b) w_stim_shared {errs[1]:.3e}")
    require(max(errs) <= 1e-4, f"7b: Laplace theta* rel err {errs}")
    syncs, activities = time_sweeps(pop, data, init, stack_states(states), card, label="7b ", stages=("glm",))
    require(not syncs["glm"] and not syncs[None], f"7b: synchronizing calls {syncs}")
    _require_batched_glm("7b", activities)
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
    a fresh simulation of 7a's generating parameters: each block of draws
    one evaluation with a chain axis (the JAX package's lax.map(...,
    batch_size)), so the K3-fwd launches (K1 for a group of one) that
    chain_groups gives each block, the K draws each evaluated once; finite,
    above a prior draw's."""
    pop, true = st["pop"], st["true"]
    _, S, stim = _simulated(pop, SEED + 74, T, "7e fresh simulation", true=true)
    T_tr = int(0.8 * T)
    data_ho = pop.prepare_data(S[T_tr:], stim=stim[T_tr:])
    draws = {k: v.reshape((-1,) + v.shape[2:]) for k, v in st["samples"].items()}
    K = len(draws["bias"])
    blocks = []  # the chain axis of each evaluation
    evaluate = pop.log_likelihood
    pop.log_likelihood = lambda params, data: (blocks.append(len(params["bias"])), evaluate(params, data))[1]
    before = _counted(pop)
    t0 = time.perf_counter()
    try:
        pll = float(predictive_log_likelihood(pop, draws, data_ho))
    finally:
        del pop.log_likelihood
    t_pll = time.perf_counter() - t0
    launches, ll_evals = _since(pop, before)
    with torch.no_grad():
        prior = float(pop.log_likelihood(pop.sample(torch.Generator().manual_seed(SEED + 75)), data_ho))
        at_truth = float(pop.log_likelihood(true, data_ho))
    log(f"7e predictive log-likelihood of {K} draws on {T - T_tr} held-out bins: {pll:.3f} in {t_pll:.3f} s "
        f"(a prior draw {prior:.3f}, the truth {at_truth:.3f}); launches {launches} [{card}]")
    NB = pop.N * pop.B_imp
    groups = [c for b in blocks for c in kernels.chain_groups(NB, pop.N, b)]
    want = launches_of(fwd_chains=sum(c > 1 for c in groups), fwd=sum(c == 1 for c in groups))
    require(sum(blocks) == K and launches == want and ll_evals == {"grad": 0, "value": len(blocks)},
            f"7e: launches {launches}, evaluations {ll_evals} of blocks {blocks}, want {want} for {K} draws")
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


def long_recording_phase(dev, card) -> tuple:
    """Phase 8. Returns the launches of its paths (streamed MAP, resident
    log-likelihood, the sampler, the streamed gradient of 8e), summed; the
    wide-U instance's launches on those paths; and its 8a statistics at the
    resident shape."""
    from theano_pyglm_torch.scripts import stretch_streaming as stretch

    t_phase = time.perf_counter()
    C = stretch.TIME_CHUNK
    n_blocks = -(-T_LONG // C)
    # (a) the kernels at the path's three shapes: resident, one block, the ragged last block
    for T_, label in ((T_LONG, "8a resident"), (C, "8a block"), (T_LONG - (n_blocks - 1) * C, "8a last block")):
        got = check_kernels(dev, T_, N_LONG, label, card, on_device=True)
        if T_ == T_LONG:
            wide_stats = got
        torch.cuda.empty_cache()
    wide0 = dict(WIDE_ON_PATHS)

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
    before, rows0 = _counted(pop_res), dict(kernels.ROW_SCAN_LAUNCHES)
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
    rows = {k: kernels.ROW_SCAN_LAUNCHES[k] - rows0[k] for k in rows0}
    batches = -(-N_LONG // LONG_ROW_BATCH)  # the first eager, the rest replayed from a CUDA graph
    require(rows == {"row_scan": sweeps * batches, "row_scan_bf16": 0},
            f"8d: row-scan launches {rows}, not one a row batch ({batches} an adjacency stage, {sweeps} stages)")
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
    wide = {k: WIDE_ON_PATHS[k] - wide0[k] for k in wide0}
    log(f"phase 8: {time.perf_counter() - t_phase:.2f} s; launches on its paths {launches}, of K1/K2 through "
        f"the wide-U instance {wide}")
    require(wide["fwd"] > 0 and wide["vg"] > 0, f"phase 8: the wide-U instance never launched: {wide}")
    return launches, wide, wide_stats


# --- phase 9 ----------------------------------------------------------------

N_HARNESS, T_HARNESS_SEC = 27, 60.0  # the flagship's width, 60 s at 1 ms
HARNESS_WARMUP, HARNESS_SAMPLES = 40, 20  # 40: the least warmup with adaptation windows


class _CountEvaluations:
    """Counts every Population's log-likelihood evaluations while active
    (the harness builds its own populations), and the launches each should
    make: one, or with a chain axis (the predictive log-likelihood's blocks
    of draws) one per group of chain_groups."""

    def __enter__(self):
        self.evals = self.launches = 0
        self._orig = orig = Population.log_likelihood

        def counted(pop, params, data):
            self.evals += 1
            bias = params["bias"]
            C = bias.shape[0] if bias.ndim > 1 else None
            self.launches += 1 if C is None else len(kernels.chain_groups(pop.N * pop.B_imp, pop.N, C))
            return orig(pop, params, data)

        Population.log_likelihood = counted
        return self

    def __exit__(self, *exc):
        Population.log_likelihood = self._orig


def _harness_path(label, run) -> dict:
    """One harness path with the launch counts set to 0 just before it: every
    likelihood evaluation must have launched K1 or K2 (K3-fwd for each group
    of a block of predictive draws), and K1 and K2 both ran."""
    zero_launches()
    t0 = time.perf_counter()
    with _CountEvaluations() as counted:
        run()
    torch.cuda.synchronize()
    got = dict(kernels.LAUNCHES)
    log(f"{label}: {time.perf_counter() - t0:.2f} s; likelihood evaluations {counted.evals}, launches {got}")
    require(got["fwd"] > 0 and got["vg"] > 0, f"{label}: a kernel never launched: {got}")
    require(sum(got.values()) == counted.launches,
            f"{label}: {counted.evals} likelihood evaluations ({counted.launches} launches) against launches {got}")
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


def _bf16_operands(dev, T, N, C, clip_entries=0, on_device=False):
    """:func:`_chain_operands` with X_f rounded to bf16; ``on_device``: one
    chain of :func:`_kernel_operands` drawn on the card (the long
    recording's sizes)."""
    if on_device:
        x, u, ir, s = _kernel_operands(dev, T, N, clip_entries, on_device=True)
        return [x.to(torch.bfloat16), u[None], ir[None], s]
    x, u, ir, s = _chain_operands(dev, T, N, C, clip_entries)
    return [x.to(torch.bfloat16), u, ir, s]


def check_bf16_kernels(dev, T, N, C, label, card, one_chain=True, chains=True, on_device=False) -> dict:
    """With ``chains``, K4-fwd-chains and K4-vg-chains on C chains at (T,
    NB=5N, N) and, with ``one_chain``, K4-fwd and K4-vg on chain 0 without a
    chain axis, against their plain versions (float32 sums in another order:
    each value 1e-5 relative, dU 1e-5 relative L2, dI_rest rtol=1e-5 /
    atol=1e-6), with a clipped case; bit-for-bit repeats, one launch per
    call; the median times of 50 calls, warm and L2-cold, beside the plain
    version's and beside the float32 kernel on the same widened X_f (K1,
    K2, K3-fwd, K3-vg) in the same call; the bound (a bf16 X_f read once;
    the chain kernels' products at the bf16 rate; with K4's column groups
    also X_f read once a group) and the roofline share. ``on_device``: one
    chain's operands drawn on the card (the long recording's sizes)."""
    def one(ops):
        return [ops[0], ops[1][0].contiguous(), ops[2][0].contiguous(), ops[3]]

    pairs = []
    if chains:
        pairs += [("fwd_chains_bf16", kernels.fused_ll_value_chains,
                   kernels.fused_poisson_ll_chains_value_reference, lambda o: o),
                  ("vg_chains_bf16", kernels.fused_ll_value_and_grad_chains, kernels.fused_poisson_ll_chains_reference,
                   lambda o: o)]
    if one_chain:
        pairs += [("fwd_bf16", kernels.fused_ll_value, kernels.fused_poisson_ll_value_reference, one),
                  ("vg_bf16", kernels.fused_ll_value_and_grad, kernels.fused_poisson_ll_reference, one)]
    max_err = {}
    for clip_entries in (0, 500):
        all_ops = _bf16_operands(dev, T, N, C, clip_entries, on_device)
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

        del all_ops
        torch.cuda.empty_cache()
    all_ops = _bf16_operands(dev, T, N, C, on_device=on_device)
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
        if plan.groups > 1:
            g_ms, g_by = bound(k, ops, x_reads=plan.groups)
            log(f"  {k}: {plan.groups} column groups of at most {plan.group_cols}; with X_f read {plan.groups} times "
                f"the bound is {g_ms:.4f} ms ({g_by}), share {100 * g_ms / cold:.1f} %")
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
    paths (smart init and MAP; the sampler) and the row scan's bf16
    statistics (check_row_scan)."""
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
    require(kernels.ROW_SCAN_LAUNCHES == {"row_scan": 0, "row_scan_bf16": sweeps},
            f"10b bf16 Gibbs: row-scan launches {kernels.ROW_SCAN_LAUNCHES}, not one bf16 launch a stage ({sweeps})")
    _require_chains("10b bf16 Gibbs", states, samples)
    _require_accept_rates("10b bf16 Gibbs", diag)
    min_ess = min(v["min_ess"] for v in summary["convergence"].values())
    max_rhat = max(v["max_rhat"] for v in summary["convergence"].values())
    log(f"10b bf16: accept rates glm {diag['accept_rate_glm']}, imp {diag['accept_rate_imp']}, adjacency "
        f"{diag['accept_rate_adjacency']}; link-prediction AUC {summary['link_prediction_auc']}, smallest ESS "
        f"{min_ess:.2f}, largest R-hat {max_rhat:.3f} (10 draws: reported, not checked)")
    path = _add(path, launches)
    row_stats = check_row_scan(dev, card, pop, data, chains=(BF16_CHAINS,))

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
    return path, row_stats


# --- phase 11 ---------------------------------------------------------------


def _rel_grads(got: dict, want: dict) -> float:
    """The largest rel-L2 error over the leaves of two gradient dicts."""
    return max(rel_l2(got[k], want[k]) for k in want)


def _runs_differ(got, want) -> list:
    """The leaves in which two (samples, diagnostics, states) of a chains
    run differ at all; the convergence table compared as a whole."""
    differ = [k for k in want[0] if not np.array_equal(got[0][k], want[0][k])]
    differ += [k for k in want[1] if k != "convergence" and not np.array_equal(got[1][k], want[1][k])]
    if json.dumps(got[1]["convergence"], sort_keys=True) != json.dumps(want[1]["convergence"], sort_keys=True):
        differ.append("convergence")
    return differ + [w for w, a, b in _tensor_leaves(got[2], want[2]) if not torch.equal(a, b)]


def host_profile(fn, n: int = 20) -> tuple:
    """({operator: self CPU ms a call}, device ms a call, wall ms a call) of
    ``n`` calls of fn under torch.profiler (which slows the host; run after
    the timings)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / n
    cpu = {e.key: e.self_cpu_time_total / 1e3 / n for e in prof.key_averages()}
    on_device = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n
    return cpu, on_device, wall


def vg_evals_per_sec(vg, params, data, n: int = 100) -> float:
    """evals_per_sec of phase 4 through ``vg(params, data) -> (value,
    grads)``, which differentiates in every floating leaf (the
    neuron-sharded objective's form): each gradient of the continuous block
    consumed by a tiny update."""
    q, frozen = split_params(params)
    q = {k: v.detach().clone() for k, v in q.items()}

    def step():
        _, grads = vg({**frozen, **q}, data)
        for k in q:
            q[k] = q[k] + 1e-9 * grads[k]

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def multi_gpu_phase(sl, card) -> dict:
    """11: the multi-GPU layer at one rank (a process group of one, NCCL on
    cuda:0): 11a the flagship's sampler on a 'chains' mesh against phase 5's
    run; 11b the neuron-sharded objective, the column split in three blocks
    and the sharded MAP; 11c the entry module. Returns the launches of its
    paths."""
    from theano_pyglm_torch import entry as entry_module
    from theano_pyglm_torch.entry import _free_port
    from theano_pyglm_torch.parallel import distributed
    from theano_pyglm_torch.parallel.map import parallel_map_fit
    from theano_pyglm_torch.parallel.mesh import chain_mesh, neuron_mesh
    from theano_pyglm_torch.parallel.neurons import local_log_likelihood, make_sharded_value_and_grad

    t_phase = time.perf_counter()
    pop, data, true, fit = sl["pop"], sl["data"], sl["true"], sl["params"]
    dev = pop.device
    require(distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=dev),
            "11: no process group of one rank")
    try:
        # 11a: phase 5's run, the chains on a mesh of one rank
        mesh = chain_mesh()
        require(mesh.size == 1 and mesh.group is not None, f"11a: {mesh}")
        p5 = sl["phase5"]
        zero_launches()
        t0 = time.perf_counter()
        samples, diag, states, _ = rgc_flagship.run(
            pop, data, true, fit, seed=SEED, n_chains=GIBBS_CHAINS, n_iters=GIBBS_SAMPLES,
            n_warmup=GIBBS_WARMUP, thin=1, n_leapfrog=LEAPFROG_STEPS, init_jitter=0.05,
            chunk_size=GIBBS_SAMPLES, mesh=mesh,
        )
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        path = dict(kernels.LAUNCHES)
        sweeps = GIBBS_WARMUP + GIBBS_SAMPLES
        differ = _runs_differ((samples, diag, states), (p5["samples"], p5["diag"], p5["states"]))
        log(f"11a flagship sampler on a 'chains' mesh of one NCCL rank, {GIBBS_CHAINS} chains x ({GIBBS_WARMUP} + "
            f"{GIBBS_SAMPLES}): {t_run:.2f} s, {1e3 * t_run / sweeps:.1f} ms per 4-chain sweep (phase 5: "
            f"{1e3 * p5['t_run'] / sweeps:.1f}) [{card}]; launches {path}; against phase 5's run, leaves that "
            f"differ: {differ or 'none'}")
        require(not differ, f"11a: the mesh run differs from phase 5's in {differ}")
        require(path == p5["launches"], f"11a: launches {path} against phase 5's {p5['launches']}")

        # 11a: the same run checkpointed every chunk on the mesh, stopped
        # after warmup sweep 30 and resumed: the mesh run's draws to the bit
        stop_at = GIBBS_WARMUP - GIBBS_SAMPLES

        class _Stop(Exception):
            pass

        def stop(phase, done, _states):
            if phase == "warmup" and done == stop_at:
                raise _Stop

        kw = dict(n_chains=GIBBS_CHAINS, n_samples=GIBBS_SAMPLES, n_warmup=GIBBS_WARMUP, thin=1,
                  n_leapfrog=LEAPFROG_STEPS, chunk_size=GIBBS_SAMPLES, init_params=fit, init_jitter=0.05,
                  mesh=mesh, checkpoint_every=GIBBS_SAMPLES)
        before = _counted(pop)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            try:
                gibbs_sample_chains(pop, data, SEED, checkpoint_dir=d, callback=stop, **kw)
                require(False, "11a: the checkpointed run was not stopped")
            except _Stop:
                pass
            resumed = gibbs_sample_chains(pop, data, SEED, checkpoint_dir=d, resume=True, **kw)
            files = sorted(os.listdir(d))
        torch.cuda.synchronize()
        t_resume = time.perf_counter() - t0
        launches, _ = _since(pop, before)
        path = _add(path, launches)
        differ = _runs_differ(resumed, (samples, diag, states))
        log(f"11a the mesh run checkpointed every {GIBBS_SAMPLES} sweeps, stopped after sweep {stop_at} and resumed "
            f"in {t_resume:.2f} s; files {files}; launches {launches}; against the uninterrupted mesh run, leaves "
            f"that differ: {differ or 'none'} [{card}]")
        require(not differ, f"11a: the resumed mesh run differs from the uninterrupted one in {differ}")

        # 11b: the neuron-sharded objective at phase 3's MAP point
        nmesh = neuron_mesh()
        vg = make_sharded_value_and_grad(pop, nmesh, fit, data)
        before = _counted(pop)
        val_s, grads_s = vg(fit, data)
        launches, ll_evals = _since(pop, before)
        require(launches == launches_of(vg=1), f"11b: the sharded value+grad launched {launches}")
        path = _add(path, launches)
        before = _counted(pop)
        val_u, grads_u = value_and_grad(lambda p: -pop.log_joint(p, data), fit)
        require(_since(pop, before)[0] == launches_of(vg=1), "11b: the unsharded value+grad is one K2 launch")
        err_v, err_g = abs(float(val_s) - float(val_u)) / abs(float(val_u)), _rel_grads(grads_s, grads_u)
        log(f"11b sharded -log-joint at the MAP point {float(val_s):.6f} against unsharded {float(val_u):.6f}: "
            f"rel {err_v:.3e}, gradients rel-L2 at most {err_g:.3e}")
        require(err_v <= 1e-6 and err_g <= 1e-6, f"11b: sharded value {err_v}, gradients {err_g}")

        blocks = [(lo, lo + N // 3) for lo in range(0, N, N // 3)]
        before = _counted(pop)
        val_b, grads_b = value_and_grad(
            lambda p: -sum(local_log_likelihood(pop, p, data, lo, hi) for lo, hi in blocks), fit)
        launches, _ = _since(pop, before)
        require(launches == launches_of(vg=len(blocks)), f"11b: the column blocks launched {launches}")
        path = _add(path, launches)
        val_f, grads_f = value_and_grad(lambda p: -pop.log_likelihood(p, data), fit)
        err_v, err_g = abs(float(val_b) - float(val_f)) / abs(float(val_f)), _rel_grads(grads_b, grads_f)
        log(f"11b the log-likelihood in {len(blocks)} blocks of {N // 3} neurons (one K2 launch each) against the "
            f"full: value rel {err_v:.3e}, gradients rel-L2 at most {err_g:.3e}")
        require(err_v <= 1e-5 and err_g <= 1e-4, f"11b: blocks value {err_v}, gradients {err_g}")

        before = _counted(pop)
        t0 = time.perf_counter()
        fit_p, lp_p, iters = parallel_map_fit(pop, data, sl["init"], nmesh)
        torch.cuda.synchronize()
        t_map = time.perf_counter() - t0
        launches, ll_evals = _since(pop, before)
        path = _add(path, launches)
        err = abs(float(lp_p) - sl["lp_map"]) / abs(sl["lp_map"])
        log(f"11b parallel_map_fit from phase 3's init: log-joint {float(lp_p):.3f} (map_fit {sl['lp_map']:.3f}, rel "
            f"{err:.3e}) after {iters} iterations in {t_map:.2f} s; launches {launches}, likelihood evaluations "
            f"{ll_evals} [{card}]")
        require(err <= 1e-5, f"11b: parallel_map_fit's log-joint {float(lp_p)} against map_fit's {sl['lp_map']}")
        _require_all_fused("11b parallel_map_fit", launches, ll_evals)

        # the like-for-like comparison: both differentiate in every floating
        # leaf (phase 4's metric takes the continuous block only)
        def vg_u(params, data):
            return value_and_grad(lambda p: -pop.log_joint(p, data), params)

        rates = [f"phase 4's metric (the continuous block) {evals_per_sec(pop, fit, data):.1f}"]
        for name in ("unsharded", "sharded", "sharded", "unsharded"):
            rates.append(f"{name} {vg_evals_per_sec(vg if name == 'sharded' else vg_u, fit, data):.1f}")
        log(f"11b value+grad evals/s of the -log-joint at N={N} T={T}, every floating leaf, in turns: "
            f"{', '.join(rates)} [{card}]")
        # where the sharded evaluation's extra time goes, under torch.profiler
        cpu_s, dev_s, wall_s = host_profile(lambda: vg(fit, data))
        cpu_u, dev_u, wall_u = host_profile(lambda: vg_u(fit, data))
        extra = sorted(set(cpu_s) | set(cpu_u), key=lambda k: cpu_u.get(k, 0.0) - cpu_s.get(k, 0.0))[:10]
        log(f"11b under torch.profiler, ms a value+grad, sharded / unsharded: wall {wall_s:.3f} / {wall_u:.3f}, "
            f"host self time summed over operators {sum(cpu_s.values()):.3f} / {sum(cpu_u.values()):.3f}, device "
            f"{dev_s:.4f} / {dev_u:.4f}; the operators with the most extra host time: "
            + "; ".join(f"{k} {cpu_s.get(k, 0.0):.4f} / {cpu_u.get(k, 0.0):.4f}" for k in extra) + f" [{card}]")

        # 11c: the entry module
        fn, (opt, edata) = entry_module.entry(device=dev)
        zero_launches()
        val_e, _ = fn(opt, edata)
        epop, eparams, edata2 = entry_module._flagship(device=dev)
        with torch.no_grad():
            lj = float(epop.log_joint(eparams, edata2))
        launches = dict(kernels.LAUNCHES)
        path = _add(path, launches)
        err = abs(float(val_e) - lj) / abs(lj)
        log(f"11c entry(): log-joint {float(val_e):.4f} against the population's {lj:.4f} (rel {err:.3e}); "
            f"launches {launches}")
        require(err <= 1e-6, f"11c: entry's value {float(val_e)} against the log-joint {lj}")
        require(launches == launches_of(vg=1, fwd=1), f"11c: launches {launches}")
        t0 = time.perf_counter()
        entry_module.dryrun_multichip(torch.cuda.device_count())
        log(f"11c dryrun_multichip({torch.cuda.device_count()}) passed in {time.perf_counter() - t0:.2f} s")
    finally:
        distributed.shutdown()
    log(f"phase 11: {time.perf_counter() - t_phase:.2f} s; launches on its paths {path}")
    return path


def main() -> None:
    t_start = time.perf_counter()
    card = setup()
    spy_adjacency_stage()
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
    row_stats = {"row_scan": check_row_scan(dev, card, sl["pop"], sl["data"])}

    launches = _add(launches, acceptance_phase(dev, card))
    launches = _add(launches, variants_phase(dev, card, sl))

    torch.cuda.empty_cache()
    long_launches, wide_launches, wide_stats = long_recording_phase(dev, card)
    launches = _add(launches, long_launches)
    torch.cuda.empty_cache()
    launches = _add(launches, harness_phase(dev, card))

    # phase 10: the bf16 design (K4) on phase 3's flagship
    t0 = time.perf_counter()
    kstats.update(check_bf16_kernels(dev, T, N, BF16_CHAINS, "10a flagship", card))
    for c in (1, 2, 3, 4):  # K4 at each config's shape; the chain pair at its sampler's chains
        T_c, N_c = ACCEPT_SHAPES[c]
        check_bf16_kernels(dev, T_c, N_c, ACCEPT_SAMPLER_CHAINS.get(c, 1), f"10a config {c}", card,
                           chains=c in ACCEPT_SAMPLER_CHAINS)
    # K4 at the long recording's three shapes (phase 8a's), in its column groups
    for T_, label in ((T_LONG, "resident"), (65_536, "block"), (10_176, "last block")):
        check_bf16_kernels(dev, T_, N_LONG, 1, f"10a N={N_LONG} {label}", card, chains=False, on_device=True)
        torch.cuda.empty_cache()
    log(f"phase 10a: {time.perf_counter() - t0:.2f} s")
    bf16_launches, row_stats["row_scan_bf16"] = bf16_phase(sl, card)
    launches = _add(launches, bf16_launches)
    launches = _add(launches, multi_gpu_phase(sl, card))

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
    sources = {k: SOURCE_CHAINS if "chains" in k else SOURCE_BF16 if k in BF16_KERNELS else SOURCE
               for k in KERNELS}
    # library_ms is null: no single PyTorch call computes the fused value or value+grad.
    # K1 and K2 count their wide-U instance's launches too; the line gives
    # that instance its own entries (its launches and its 8a resident
    # statistics) and K1's and K2's the rest.
    entries = [{"name": names[k], "route": "cuda", "source": os.path.relpath(sources[k], REPO),
                "replaces": replaces[k.removesuffix("_bf16")],
                "launches": launches[k] - wide_launches.get(k, 0), **kstats[k]} for k in KERNELS]
    entries += [{"name": f"{names[k].split()[0]}-wide fused_ll_{k}_wide", "route": "cuda",
                 "source": os.path.relpath(SOURCE_WIDE, REPO), "replaces": replaces[k],
                 "launches": wide_launches[k], **wide_stats[k]} for k in ("fwd", "vg")]
    # the row scan replaces no TPU kernel: update_adjacency_collapsed is plain JAX there
    require_row_scans("phase 11")
    entries += [{"name": f"row-scan adjacency_{k}", "route": "cuda", "source": os.path.relpath(SOURCE_ROWS, REPO),
                 "replaces": None, "launches": ROW_SCANS_ON_PATHS[k] + kernels.ROW_SCAN_LAUNCHES[k], **row_stats[k]}
                for k in ROW_SCANS_ON_PATHS]
    require(all(e["launches"] > 0 for e in entries), f"a kernel was never launched on the main paths: {entries}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
