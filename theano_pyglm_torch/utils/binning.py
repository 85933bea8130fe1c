"""Spike-event binning on the host — port of
:mod:`theano_pyglm_tpu.utils.binning`, with its own copy of the C source.

``bin_spikes(times, neurons, T, dt, N)`` turns event-format spike data into
the dense (T, N) count matrix that ``Population.prepare_data`` consumes.
The C binner (``theano_pyglm_torch/native/fastbin.c``) is compiled at first
use with the system C compiler (``$CC``, else ``cc``) into
``theano_pyglm_torch/_build/`` (listed in ``.gitignore``), named by a hash
of the source and the flags, and loaded through ctypes. On a machine
without a C compiler the numpy scatter path runs instead; both compute
times·(1/dt) truncated, so they give the same counts bit for bit.
:func:`native_available` says which path ``bin_spikes`` takes. This is
host code; nothing here touches the GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["bin_spikes", "native_available"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "fastbin.c"
BUILD_DIR = _PKG / "_build"
_CFLAGS = ["-O3", "-shared", "-fPIC"]


@functools.lru_cache(maxsize=None)
def _load():
    """The built C binner with its signature declared, or None when it
    cannot be built (no compiler) or loaded."""
    cc = os.environ.get("CC", "cc")
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join([cc, *_CFLAGS]).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"fastbin_{digest}.so"
    try:
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            subprocess.run([cc, *_CFLAGS, "-o", str(tmp), str(SOURCE)], check=True, capture_output=True)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.bin_events.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_longlong,
        ctypes.c_double,
        ctypes.c_longlong,
        ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.bin_events.restype = None
    return lib


def native_available() -> bool:
    """True when ``bin_spikes`` runs the C binner."""
    return _load() is not None


def _bin_numpy(times, neurons, T, dt, N):
    out = np.zeros((T, N), dtype=np.float32)
    # the C binner's expression: a division instead of the multiplication
    # by 1/dt would put some boundary events in the next bin
    t = (times * (1.0 / dt)).astype(np.int64)
    ok = (t >= 0) & (t < T) & (neurons >= 0) & (neurons < N)
    np.add.at(out, (t[ok], neurons[ok]), 1.0)
    return out


def bin_spikes(times, neurons, T: int, dt: float, N: int, use_native: bool = True) -> np.ndarray:
    """Bin spike events into (T, N) float32 counts; events outside the grid
    or with an unknown neuron are dropped.

    Args:
      times: (n_events,) spike times in seconds.
      neurons: (n_events,) integer neuron ids.
      T: number of bins; dt: bin width (s); N: number of neurons.
      use_native: take the C binner where it builds (else numpy).
    """
    times = np.ascontiguousarray(np.asarray(times, dtype=np.float64))
    neurons = np.ascontiguousarray(np.asarray(neurons, dtype=np.int64))
    if times.shape != neurons.shape or times.ndim != 1:
        raise ValueError("times and neurons must be 1-D arrays of equal length")
    lib = _load() if use_native else None
    if lib is None:
        return _bin_numpy(times, neurons, T, dt, N)
    out = np.zeros((T, N), dtype=np.float32)
    lib.bin_events(
        times.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        neurons.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        ctypes.c_longlong(times.shape[0]),
        ctypes.c_double(dt),
        ctypes.c_longlong(T),
        ctypes.c_longlong(N),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out
