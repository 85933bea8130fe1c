"""IO and command-line utilities — port of :mod:`theano_pyglm_tpu.utils.io`
(numpy only).

The reference's flags (--dataFile, --resultsDir, --model, --N, ...), data
files in .npz (preferred), .pkl or .mat (scipy.io), results files, and the
train/validation split of the time axis (``segment_data``). Event-format
.npz files are binned on load by :func:`theano_pyglm_torch.utils.binning.bin_spikes`
(the C binner, or its numpy path, which gives the same counts bit for bit).
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from theano_pyglm_torch.utils.binning import bin_spikes

__all__ = ["parse_cmd_line_args", "load_data", "save_results", "load_results", "segment_data"]


def parse_cmd_line_args(argv=None, description: str = "theano_pyglm_torch harness"):
    """The reference's CLI flags."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--dataFile", "-d", type=str, default=None, help="input data file (.npz/.pkl/.mat)")
    p.add_argument("--resultsDir", "-r", type=str, default="results", help="output directory")
    p.add_argument("--model", "-m", type=str, default="standard_glm", help="model template name")
    p.add_argument("--N", "-N", type=int, default=2, help="number of neurons")
    p.add_argument("--T", "-T", type=float, default=60.0, help="duration in seconds")
    p.add_argument("--dt", type=float, default=1e-3, help="bin width (s)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sampleFile", type=str, default=None, help="MCMC sample/checkpoint file")
    p.add_argument("--n_samples", type=int, default=1000)
    p.add_argument("--n_warmup", type=int, default=None)
    p.add_argument("--n_chains", type=int, default=1)
    p.add_argument("--lam", type=float, default=None, help="sparsity penalty (MAP)")
    p.add_argument("--xv", action="store_true", help="cross-validate the sparsity penalty")
    p.add_argument("--resume", action="store_true", help="resume MCMC from the checkpoint dir")
    p.add_argument("--checkpoint_every", type=int, default=0, help="checkpoint cadence (0 = per chunk)")
    p.add_argument("--device", type=str, default="cuda", help="torch device (cuda, or cpu)")
    return p.parse_args(argv)


def load_data(path: str) -> dict:
    """Load a data dict with keys S (T,N), dt, and optionally stim/stim_dt.

    Event-format files (keys ``spike_times``/``spike_neurons`` + ``dt``,
    ``T_sec``, ``N``) are binned on load (:func:`bin_spikes`)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        with np.load(path, allow_pickle=True) as f:
            out = {k: f[k] if f[k].shape else f[k].item() for k in f.files}
        if "S" not in out and "spike_times" in out:
            dt = float(out.get("dt", 1e-3))
            T = int(round(float(out["T_sec"]) / dt))
            out["S"] = bin_spikes(out["spike_times"], out["spike_neurons"], T, dt, int(out["N"]))
        return out
    if ext in (".pkl", ".pickle"):
        with open(path, "rb") as f:
            return pickle.load(f)
    if ext == ".mat":
        from scipy.io import loadmat

        raw = loadmat(path)
        return {k: v for k, v in raw.items() if not k.startswith("__")}
    raise ValueError(f"unknown data format {ext!r}")


def save_results(path: str, results: dict) -> None:
    """Save a results dict (.npz for arrays, one level of nested dicts
    flattened as 'outer/inner'; .pkl otherwise)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        flat = {}
        for k, v in results.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    flat[f"{k}/{kk}"] = np.asarray(vv)
            else:
                flat[k] = np.asarray(v)
        np.savez_compressed(path, **flat)
    else:
        with open(path, "wb") as f:
            pickle.dump(results, f)


def load_results(path: str) -> dict:
    """Load what :func:`save_results` wrote."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        with np.load(path, allow_pickle=True) as f:
            out: dict = {}
            for k in f.files:
                if "/" in k:
                    a, b = k.split("/", 1)
                    out.setdefault(a, {})[b] = f[k]
                else:
                    out[k] = f[k]
            return out
    with open(path, "rb") as f:
        return pickle.load(f)


def segment_data(S, stim=None, train_frac: float = 0.8):
    """Split the time axis into train/validation segments. Returns
    ((S_tr, stim_tr), (S_va, stim_va))."""
    T = S.shape[0]
    T_tr = int(T * train_frac)
    tr = (S[:T_tr], None if stim is None else stim[:T_tr])
    va = (S[T_tr:], None if stim is None else stim[T_tr:])
    return tr, va
