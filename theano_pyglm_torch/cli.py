"""Command-line harness — port of :mod:`theano_pyglm_tpu.cli` (the
reference's ``test/`` scripts): synthetic data, MAP fitting and full MCMC,
each a function that the ``scripts/`` wrappers call or that a program calls
with parsed flags.

  generate_synth_data: make_model → sample → simulate → save
  fit_map:             load → smart init → (sparse, cross-validated) MAP → save
  fit_mcmc:            load → gibbs_sample[_chains] → save

    python -m theano_pyglm_torch.cli {generate|map|mcmc} [flags] [--device cpu]

Every random draw comes from torch generators seeded from ``--seed``. The
work runs on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from theano_pyglm_torch import Population, make_model
from theano_pyglm_torch.inference import cross_validate_lambda, gibbs_sample, map_fit, sparse_map_fit
from theano_pyglm_torch.inference.smart_init import smart_initialize
from theano_pyglm_torch.parallel import gibbs_sample_chains
from theano_pyglm_torch.utils.io import load_data, parse_cmd_line_args, save_results
from theano_pyglm_torch.utils.metrics import MetricsWriter, timer

__all__ = ["generate_synth_data", "fit_map", "fit_mcmc", "main"]


def _np(params: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def _build_population(args, data=None):
    N = int(data["S"].shape[1]) if data is not None else args.N
    spec = make_model(args.model, N)
    if args.dt:
        spec["dt"] = args.dt
    return Population(spec, device=args.device)


def generate_synth_data(args):
    """Sample a model from its prior, simulate ``args.T`` seconds of spikes
    (and a white stimulus where the model has one) and save them with the
    generating parameters to ``<resultsDir>/synth_data.npz``."""
    pop = _build_population(args)
    g = torch.Generator(device=pop.device).manual_seed(args.seed)
    params = pop.sample(g)
    T = int(round(args.T / pop.dt))
    stim = None
    if pop.basis_stim is not None:
        stim = torch.randn((T, pop.D_stim), generator=g, device=pop.device).cpu().numpy()
    with timer("simulate", echo=True):
        S, rates = pop.simulate(g, params, T, stim=stim)
        S, mean_rate = S.cpu().numpy(), float(rates.mean())
    out = os.path.join(args.resultsDir, "synth_data.npz")
    payload = {"S": S, "dt": pop.dt, "model": args.model, "true_params": _np(params)}
    if stim is not None:
        payload["stim"] = stim
    save_results(out, payload)
    print(f"generated {float(S.sum()):.0f} spikes over {args.T:.0f}s, "
          f"N={pop.N}, mean rate {mean_rate:.2f} Hz -> {out}")
    return out


def _load_problem(args):
    raw = load_data(args.dataFile)
    pop = _build_population(args, raw)
    data = pop.prepare_data(raw["S"], stim=raw.get("stim"))
    return pop, data, raw


def fit_map(args):
    """MAP from the smart initialization: plain, sparse (``--lam``) or
    sparse with λ cross-validated (``--xv``); saves
    ``<resultsDir>/map_results.npz`` and a summary figure."""
    pop, data, raw = _load_problem(args)
    init = smart_initialize(pop, data)
    with timer("map", echo=True):
        if args.xv:
            lambdas = [0.1, 1.0, 10.0, 100.0]
            best, fits, scores = cross_validate_lambda(pop, data["S"], raw.get("stim"), init, lambdas)
            print(f"xv: best lambda={best} scores={scores}")
            params, logp, iters = sparse_map_fit(pop, data, init, best)
        elif args.lam is not None:
            params, logp, iters = sparse_map_fit(pop, data, init, args.lam)
        else:
            params, logp, iters = map_fit(pop, data, init)
        logp = float(logp)
    out = os.path.join(args.resultsDir, "map_results.npz")
    save_results(out, {"params": _np(params), "log_joint": logp, "iters": int(iters)})
    print(f"MAP log-joint {logp:.3f} in {int(iters)} iters -> {out}")
    from theano_pyglm_torch.plotting import plot_results

    try:
        plot_results(pop, params, raw.get("true_params"), data, os.path.join(args.resultsDir, "map_results.png"))
    except ImportError as e:  # the figure needs matplotlib, which a GPU host may lack
        print(f"(plotting skipped: {e})")
    return out


def fit_mcmc(args):
    """Gibbs/HMC from the smart initialization, one chain (with checkpoints
    and ``--resume``) or ``--n_chains`` chains; saves
    ``<resultsDir>/mcmc_samples.npz`` and a JSONL trace of the glm block's
    acceptance and step size at every chunk end."""
    pop, data, raw = _load_problem(args)
    init = smart_initialize(pop, data)
    metrics = MetricsWriter(os.path.join(args.resultsDir, "mcmc_metrics.jsonl"))

    def cb(phase, it, state):
        states = state if isinstance(state, list) else [state]
        metrics.log(
            it,
            phase=phase,
            accept=float(np.mean([float(s["glm"].accept_rate) for s in states])),
            step_size=float(np.mean([float(s["glm"].step_size) for s in states])),
        )

    with timer("mcmc", echo=True):
        if args.n_chains > 1:
            samples, diag, _ = gibbs_sample_chains(
                pop, data, args.seed,
                n_chains=args.n_chains, n_samples=args.n_samples,
                n_warmup=args.n_warmup, init_params=init, callback=cb,
            )
        else:
            samples, diag, _ = gibbs_sample(
                pop, data, torch.Generator(device=pop.device).manual_seed(args.seed),
                n_samples=args.n_samples, n_warmup=args.n_warmup,
                init_params=init, callback=cb,
                checkpoint_dir=os.path.join(args.resultsDir, "checkpoints"),
                checkpoint_every=args.checkpoint_every,
                resume=args.resume,
            )
    metrics.close()
    out = os.path.join(args.resultsDir, "mcmc_samples.npz")
    save_results(out, {"samples": samples,
                       "diagnostics": {k: v for k, v in diag.items() if not isinstance(v, dict)}})
    print(f"MCMC done: {args.n_samples} samples -> {out}")
    print(f"diagnostics: {diag}")
    return out


def main(argv=None):
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("generate", "map", "mcmc"):
        print("usage: python -m theano_pyglm_torch.cli {generate|map|mcmc} [flags]")
        return 2
    cmd, rest = argv[0], argv[1:]
    args = parse_cmd_line_args(rest)
    if cmd == "generate":
        return generate_synth_data(args)
    if cmd == "map":
        return fit_map(args)
    return fit_mcmc(args)


if __name__ == "__main__":
    main()
