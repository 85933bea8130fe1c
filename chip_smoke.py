#!/usr/bin/env python3
"""Smoke test of the PyTorch port (theano_pyglm_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device (built for an
H100, sm_90a):

    python3 chip_smoke.py

Phases, each of which raises on a mismatch or a non-finite value:

1. Setup: TF32 off for matmuls and convolutions, build the hand-written CUDA
   kernels from theano_pyglm_torch/csrc/ with nvcc, read the card's name
   and power limit.
2. Kernels K1 (value) and K2 (value+grad) of the fused Poisson
   log-likelihood against their plain PyTorch version at the flagship shape
   (T=60,000, N·B=135, N=27), with a clipped case, bit-for-bit repeatability
   and the median time of 50 calls each.
3. The flagship slice through the public API: make_model →
   Population.sample → simulate (T=60,000) → prepare_data →
   smart_initialize → map_fit → 20 adaptive HMC transitions of 10 leapfrog
   steps on the continuous block with A fixed. The kernels' launch counts
   are zeroed before and read after; every L-BFGS evaluation and leapfrog
   kick must have gone through K2 and every value-only log-joint through K1.
4. The inner-loop number: value+grad of the full log-joint in evals/s,
   through K2 and through the plain per-neuron torch path.

The line before the last two is one JSON object describing the kernels, the
next the card's name and power limit; the last is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from theano_pyglm_torch import Population, make_model  # noqa: E402
from theano_pyglm_torch.inference.hmc import hmc_adaptive_step, hmc_init  # noqa: E402
from theano_pyglm_torch.inference.map import map_fit, split_params  # noqa: E402
from theano_pyglm_torch.inference.smart_init import smart_initialize  # noqa: E402
from theano_pyglm_torch.ops import kernels  # noqa: E402
from theano_pyglm_torch.ops.cuda_loader import SOURCE, build_fused_ll, load_fused_ll  # noqa: E402

N = 27  # neurons (the flagship, scripts/rgc_flagship.py)
T = 60_000  # 1 ms bins
DT = 1e-3
SEED = 0
HMC_TRANSITIONS, LEAPFROG_STEPS = 20, 10
REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def median_ms(fn, n: int = 50, warmup: int = 3) -> float:
    """Median over n calls, each timed between two CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --- phase 1 ----------------------------------------------------------------


def setup() -> str:
    require(torch.cuda.is_available(), "no CUDA device: chip_smoke.py runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    path, build_log = build_fused_ll()
    load_fused_ll()
    log(f"built {os.path.relpath(path, REPO)} in {time.perf_counter() - t0:.2f} s")
    for line in build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    card = gpu_name_and_power()
    log(f"gpu: {card}")
    return card


# --- phase 2 ----------------------------------------------------------------


def _kernel_operands(dev, clip_entries=0):
    NB = N * 5
    r = np.random.RandomState(SEED)
    x = 0.1 * r.randn(T, NB)
    u = 0.3 * r.randn(NB, N)
    ir = r.randn(T, N) - 3.0
    s = r.poisson(0.02, (T, N))
    if clip_entries:
        idx = r.choice(T * N, clip_entries, replace=False)
        ir.reshape(-1)[idx] = np.where(np.arange(clip_entries) % 2 == 0, 45.0, -45.0)
    return [torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous() for a in (x, u, ir, s)]


def check_kernels(dev) -> dict:
    """K1/K2 against the plain version: value 1e-5 relative, dU 1e-5 relative
    L2, dI_rest rtol=1e-5 / atol=1e-6 — float32 sums over 1.6M terms taken
    in another order."""
    max_err = {"fwd": 0.0, "vg": 0.0}
    for clip_entries in (0, 500):
        ops = _kernel_operands(dev, clip_entries)
        ll_r, du_r, dir_r = kernels.fused_poisson_ll_reference(*ops, DT)
        v = kernels.fused_ll_value(*ops, DT)
        ll, du, dir_ = kernels.fused_ll_value_and_grad(*ops, DT)
        torch.cuda.synchronize()
        ref = float(ll_r)
        rel_v, rel_ll = abs(float(v) - ref) / abs(ref), abs(float(ll) - ref) / abs(ref)
        rel_du = float(torch.linalg.norm(du - du_r) / torch.linalg.norm(du_r))
        err_dir = float((dir_ - dir_r).abs().max())
        log(f"kernels vs plain (clipped entries {clip_entries}): K1 value rel {rel_v:.3e}; "
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

    ops = _kernel_operands(dev)
    a, b = kernels.fused_ll_value_and_grad(*ops, DT), kernels.fused_ll_value_and_grad(*ops, DT)
    require(all(torch.equal(x, y) for x, y in zip(a, b)), "K2 not bit-for-bit repeatable")
    require(torch.equal(kernels.fused_ll_value(*ops, DT), kernels.fused_ll_value(*ops, DT)),
            "K1 not bit-for-bit repeatable")
    log("kernels repeat bit for bit")

    timing = {
        "fwd": (median_ms(lambda: kernels.fused_ll_value(*ops, DT)),
                median_ms(lambda: kernels.fused_poisson_ll_value_reference(*ops, DT))),
        "vg": (median_ms(lambda: kernels.fused_ll_value_and_grad(*ops, DT)),
               median_ms(lambda: kernels.fused_poisson_ll_reference(*ops, DT))),
    }
    for k, (ms, plain) in timing.items():
        log(f"median of 50 calls, {k}: kernel {ms:.4f} ms, plain torch {plain:.4f} ms")
    return {k: {"max_abs_err": max_err[k], "ms": timing[k][0], "plain_ms": timing[k][1]} for k in timing}


# --- phase 3 ----------------------------------------------------------------


class CountingPopulation(Population):
    """A Population that counts its log-joint evaluations, with and without a
    gradient, so the launch counts can be held against them."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.evals = {"grad": 0, "value": 0}

    def log_joint(self, params, data):
        self.evals["grad" if torch.is_grad_enabled() else "value"] += 1
        return super().log_joint(params, data)


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

    launches0, evals0 = dict(kernels.LAUNCHES), dict(pop.evals)
    t0 = time.perf_counter()
    fit, lp_map, iters = map_fit(pop, data, init)
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t0
    lp_map = float(lp_map)
    map_grad_evals = pop.evals["grad"] - evals0["grad"]
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
    return {"pop": pop, "params": fit, "data": data, "spec": spec}


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


def main() -> None:
    card = setup()
    dev = torch.device("cuda", torch.cuda.current_device())
    kstats = check_kernels(dev)

    kernels.LAUNCHES.update(fwd=0, vg=0)
    sl = flagship_slice(dev)
    launches = dict(kernels.LAUNCHES)
    log(f"launches during the slice: {launches}")
    require(launches["fwd"] > 0 and launches["vg"] > 0, "a kernel of the path never launched")

    inner_loop(sl, card)

    src = os.path.relpath(SOURCE, REPO)
    replaces = {"fwd": "theano_pyglm_tpu/ops/pallas_kernels.py:73",
                "vg": "theano_pyglm_tpu/ops/pallas_kernels.py:100"}
    names = {"fwd": "K1 fused_ll_fwd", "vg": "K2 fused_ll_vg"}
    print(json.dumps({"kernels": [
        {"name": names[k], "route": "cuda", "source": src, "replaces": replaces[k],
         "launches": launches[k], **kstats[k]}
        for k in ("fwd", "vg")
    ]}), flush=True)
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
