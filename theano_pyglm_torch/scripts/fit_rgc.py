#!/usr/bin/env python3
"""Real-data fitting harness on the PyTorch port: .mat or event file → bin
→ MAP and MCMC → time-rescaling KS and held-out predictive report.

The counterpart of ``scripts/fit_rgc.py``, with the same flags and report,
plus ``--device`` (default ``cuda``). It takes

  - a Pillow-style .mat (SpTimes cell array, stim, dtStim; the format is in
    ``theano_pyglm_torch/utils/rgc.py``), or
  - an event-format .npz (spike_times/spike_neurons/N/T_sec/dt[, stim,
    stim_dt], read by ``theano_pyglm_torch/utils/io.py``),

bins the events (the C binner where it builds), fits MAP and then
(optionally) MCMC on the first ``--train_frac`` of the recording, and
writes ``rgc_fit_report.json`` with per-neuron KS statistics and held-out
log-likelihoods, and ``rgc_fit_params.npz`` with the MAP fit.

No real RGC recording ships with the repository; ``--make-fixture`` writes a
synthetic one in the .mat format so that the pipeline runs end to end:

    python3 -m theano_pyglm_torch.scripts.fit_rgc --make-fixture /tmp/rgc_fixture.mat
    python3 -m theano_pyglm_torch.scripts.fit_rgc --dataFile /tmp/rgc_fixture.mat
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataFile", "-d", type=str, default=None)
    ap.add_argument("--resultsDir", "-r", type=str, default="results/rgc")
    ap.add_argument("--model", "-m", type=str, default="sparse_weighted_model")
    ap.add_argument("--dt", type=float, default=1e-3, help="bin width (s)")
    ap.add_argument("--train_frac", type=float, default=0.8)
    ap.add_argument("--map_iters", type=int, default=500)
    ap.add_argument("--n_samples", type=int, default=200)
    ap.add_argument("--n_warmup", type=int, default=None)
    ap.add_argument("--skip-mcmc", action="store_true")
    ap.add_argument("--make-fixture", type=str, default=None, metavar="PATH",
                    help="write a synthetic Pillow-format .mat fixture and exit")
    ap.add_argument("--fixture-N", type=int, default=8)
    ap.add_argument("--fixture-T", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda", help="torch device (cuda, or cpu)")
    return ap


def main(argv=None) -> dict | None:
    """Run the harness with ``argv`` (default: the command line). Returns
    the report dict (None after ``--make-fixture``)."""
    ap = _parser()
    args = ap.parse_args(argv)

    if args.make_fixture:
        from theano_pyglm_torch.utils.rgc import save_rgc_fixture_mat

        save_rgc_fixture_mat(args.make_fixture, N=args.fixture_N, T_sec=args.fixture_T, seed=args.seed,
                             device=args.device)
        print(f"fixture written: {args.make_fixture}")
        return None
    if not args.dataFile:
        ap.error("--dataFile required (or --make-fixture)")

    from theano_pyglm_torch import Population, make_model
    from theano_pyglm_torch.inference import gibbs_sample, map_fit
    from theano_pyglm_torch.inference.predictive import map_heldout_log_likelihood, predictive_log_likelihood
    from theano_pyglm_torch.inference.smart_init import smart_initialize
    from theano_pyglm_torch.ops.convolve import upsample_stim
    from theano_pyglm_torch.utils.binning import bin_spikes, native_available
    from theano_pyglm_torch.utils.io import load_data, segment_data
    from theano_pyglm_torch.utils.ks import time_rescaling_ks

    # --- load and bin ---------------------------------------------------------
    t0 = time.time()
    if os.path.splitext(args.dataFile)[1].lower() == ".mat":
        from theano_pyglm_torch.utils.rgc import load_rgc_mat

        rec = load_rgc_mat(args.dataFile)
        N = int(rec["N"])
        T = int(round(rec["T_sec"] / args.dt))
        S = bin_spikes(rec["times"], rec["neurons"], T, args.dt, N)
    else:
        rec = load_data(args.dataFile)
        S = np.asarray(rec["S"])
        N = S.shape[1]
    stim, stim_dt = rec.get("stim"), rec.get("stim_dt")
    print(f"loaded {args.dataFile}: N={N}, T={S.shape[0]} bins, "
          f"{int(S.sum())} spikes, native binner={native_available()}", flush=True)

    # --- model and split ------------------------------------------------------
    spec = make_model(args.model, N)
    if stim is None:
        spec["bkgd"] = {"type": "none"}
    pop = Population(spec, device=args.device)
    if stim is not None and stim_dt is not None and stim_dt != args.dt:
        stim = upsample_stim(torch.as_tensor(np.asarray(stim, np.float64)), float(stim_dt), args.dt,
                             S.shape[0]).numpy()
    (S_tr, stim_tr), (S_ho, stim_ho) = segment_data(S, stim, args.train_frac)
    data_tr = pop.prepare_data(S_tr, stim=stim_tr)
    data_ho = pop.prepare_data(S_ho, stim=stim_ho)

    report = {"dataFile": args.dataFile, "N": N, "T_bins": int(S.shape[0]),
              "n_spikes": int(S.sum()), "model": args.model,
              "native_binner": bool(native_available()), "device": str(pop.device)}

    def rates(params, data) -> np.ndarray:
        with torch.no_grad():
            return pop.nlin.rate(pop.total_current(params, data)).cpu().numpy()

    # --- MAP ------------------------------------------------------------------
    init = smart_initialize(pop, data_tr)
    params_map, logp, iters = map_fit(pop, data_tr, init, max_iter=args.map_iters)
    ll_ho_map = float(map_heldout_log_likelihood(pop, params_map, data_ho))
    rates_ho = rates(params_map, data_ho)
    ks, pv, _ = time_rescaling_ks(rates_ho, S_ho, pop.dt)
    # the null: a homogeneous rate per neuron (bias only)
    null_rates = np.broadcast_to(S_tr.mean(0) / pop.dt, S_ho.shape)
    ks0, _, _ = time_rescaling_ks(null_rates, S_ho, pop.dt)
    report["map"] = {
        "log_joint_train": float(logp),
        "iters": int(iters),
        "heldout_loglik": ll_ho_map,
        "ks_mean": float(np.nanmean(ks)),
        "ks_per_neuron": [round(float(k), 4) for k in ks],
        "ks_null_mean": float(np.nanmean(ks0)),
        "ks_beats_null": bool(np.nanmean(ks) < np.nanmean(ks0)),
        "wall_s": round(time.time() - t0, 1),
    }
    print("MAP:", json.dumps(report["map"]), flush=True)

    # --- MCMC -----------------------------------------------------------------
    if not args.skip_mcmc:
        t0 = time.time()
        samples, diag, _ = gibbs_sample(
            pop, data_tr, torch.Generator(device=pop.device).manual_seed(args.seed),
            n_samples=args.n_samples, n_warmup=args.n_warmup, init_params=params_map,
            chunk_size=min(100, args.n_samples),
        )
        pll = float(predictive_log_likelihood(pop, samples, data_ho))
        post_mean_rates = np.zeros_like(rates_ho)
        take = np.linspace(0, args.n_samples - 1, min(32, args.n_samples)).astype(int)
        for i in take:
            p_i = {k: torch.as_tensor(v[i], device=pop.device) for k, v in samples.items()}
            post_mean_rates += rates(p_i, data_ho)
        post_mean_rates /= len(take)
        ks_mcmc, _, _ = time_rescaling_ks(post_mean_rates, S_ho, pop.dt)
        report["mcmc"] = {
            "n_samples": args.n_samples,
            "accept_rate_glm": round(float(diag.get("accept_rate_glm", np.nan)), 3),
            "heldout_predictive_loglik": pll,
            "predictive_beats_map_point": bool(pll >= ll_ho_map),
            "ks_mean_posterior_rate": float(np.nanmean(ks_mcmc)),
            "wall_s": round(time.time() - t0, 1),
        }
        print("MCMC:", json.dumps(report["mcmc"]), flush=True)

    os.makedirs(args.resultsDir, exist_ok=True)
    out = os.path.join(args.resultsDir, "rgc_fit_report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    np.savez_compressed(os.path.join(args.resultsDir, "rgc_fit_params.npz"),
                        **{k: v.cpu().numpy() for k, v in params_map.items()})
    print(f"report → {out}")
    return report


if __name__ == "__main__":
    main()
