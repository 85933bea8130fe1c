"""RGC-style recordings in Pillow et al. (2008)'s .mat layout — port of
:mod:`theano_pyglm_tpu.utils.rgc` on the port's ``Population``.

The reference fits the 27-cell primate retinal ganglion cell recording of
Pillow et al. 2008 from a .mat file holding per-cell spike-time vectors and
the full-field binary stimulus. That file is not redistributable, so this
module holds the format: a ``SpTimes`` cell array (seconds), a ``stim``
frame matrix with frame interval ``dtStim`` and an optional ``duration``;
a loader that takes the cell-array shapes scipy.io produces; and a writer
of a synthetic recording in exactly that layout
(``theano_pyglm_torch/scripts/fit_rgc.py`` drives it end to end).

Event-format .npz files are read by :func:`theano_pyglm_torch.utils.io.load_data`;
this module is the .mat side.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_rgc_mat", "save_rgc_fixture_mat", "make_synthetic_rgc"]


def _cell_to_list(sp):
    """Flatten a scipy.io cell array (object ndarray of arrays) to a list of
    1-D float arrays, taking (N,1), (1,N) and (N,) layouts and scalar cells."""
    sp = np.asarray(sp)
    if sp.dtype != object:
        # a plain 2-D array: rows are neurons (padded with NaN)
        return [row[np.isfinite(row)].astype(np.float64) for row in np.atleast_2d(sp)]
    out = []
    for cell in sp.ravel():
        arr = np.asarray(cell, dtype=np.float64).ravel()
        out.append(arr[np.isfinite(arr)])
    return out


def load_rgc_mat(path: str) -> dict:
    """Load a Pillow-style RGC .mat file.

    Expected variables:
      SpTimes: cell array of per-neuron spike-time vectors (seconds)
      stim:    (T_frames, D) stimulus frames (optional)
      dtStim:  stimulus frame interval in seconds (required with stim)
      duration: recording length in seconds (optional; else the stimulus
                extent, else the last spike)

    Returns dict(times, neurons, N, T_sec[, stim, stim_dt]) in event
    format, for :func:`theano_pyglm_torch.utils.binning.bin_spikes`.
    """
    from scipy.io import loadmat

    raw = loadmat(path)
    if "SpTimes" not in raw:
        raise ValueError(f"{path!r} has no 'SpTimes' variable (keys: "
                         f"{[k for k in raw if not k.startswith('__')]})")
    per_neuron = _cell_to_list(raw["SpTimes"])
    N = len(per_neuron)
    times = np.concatenate(per_neuron) if N else np.zeros(0)
    neurons = np.concatenate(
        [np.full(len(t), n, dtype=np.int64) for n, t in enumerate(per_neuron)]
    ) if N else np.zeros(0, np.int64)
    order = np.argsort(times, kind="stable")
    out = {"times": times[order], "neurons": neurons[order], "N": N}

    stim = raw.get("stim")
    dt_stim = raw.get("dtStim")
    if stim is not None and stim.size:
        stim = np.asarray(stim, np.float64)
        if stim.ndim == 1:
            stim = stim[:, None]
        if dt_stim is None:
            raise ValueError("stim present but no dtStim frame interval")
        out["stim"] = stim
        out["stim_dt"] = float(np.asarray(dt_stim).ravel()[0])

    if "duration" in raw:
        out["T_sec"] = float(np.asarray(raw["duration"]).ravel()[0])
    elif "stim" in out:
        out["T_sec"] = out["stim"].shape[0] * out["stim_dt"]
    else:
        out["T_sec"] = float(times.max()) if times.size else 0.0
    return out


def make_synthetic_rgc(N: int = 8, T_sec: float = 20.0, dt: float = 1e-3,
                       stim_dt: float = 0.01, D_stim: int = 1, seed: int = 0, device=None):
    """Simulate an RGC-style recording from the port's sparse network GLM:
    returns (per_neuron_times, stim, true_params, spec).

    The binary full-field flicker comes from numpy (``seed``); parameters
    and spikes from torch generators on the population's device (the card
    unless ``device="cpu"``), seeded with ``seed`` and ``seed + 1``. Spike
    times are placed mid-bin, so binning at the same dt is exact.
    """
    from theano_pyglm_torch import Population, make_model

    spec = make_model("sparse_weighted_model", N)
    spec["bias"] = {"mu": 2.5, "sigma": 0.3}
    spec["bkgd"]["D_stim"] = D_stim
    pop = Population(spec, device=device)
    true = pop.sample(torch.Generator(device=pop.device).manual_seed(seed))
    T = int(round(T_sec / dt))
    rng = np.random.RandomState(seed)
    n_frames = int(np.ceil(T_sec / stim_dt))
    stim = (rng.rand(n_frames, D_stim) < 0.5).astype(np.float64) * 2.0 - 1.0
    S, _ = pop.simulate(torch.Generator(device=pop.device).manual_seed(seed + 1), true, T,
                        stim=stim, stim_dt=stim_dt)
    S = S.cpu().numpy()
    per_neuron = []
    for n in range(N):
        bins = np.repeat(np.arange(T), S[:, n].astype(int))
        per_neuron.append((bins + 0.5) * dt)
    return per_neuron, stim, true, spec


def save_rgc_fixture_mat(path: str, N: int = 8, T_sec: float = 20.0,
                         dt: float = 1e-3, stim_dt: float = 0.01,
                         D_stim: int = 1, seed: int = 0, device=None) -> dict:
    """Write a synthetic recording as a Pillow-format .mat fixture (SpTimes
    cell array, stim, dtStim, duration). Returns the generating truth as
    {"true": params, "spec": spec}."""
    from scipy.io import savemat

    per_neuron, stim, true, spec = make_synthetic_rgc(
        N=N, T_sec=T_sec, dt=dt, stim_dt=stim_dt, D_stim=D_stim, seed=seed, device=device
    )
    cell = np.empty((len(per_neuron), 1), dtype=object)
    for i, t in enumerate(per_neuron):
        cell[i, 0] = t.reshape(-1, 1)
    savemat(path, {
        "SpTimes": cell,
        "stim": stim,
        "dtStim": np.asarray(stim_dt),
        "duration": np.asarray(T_sec),
    })
    return {"true": true, "spec": spec}
