"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

The sources in ``theano_pyglm_torch/csrc/`` have a plain C interface:
``fused_poisson_ll.cu`` (K1-K3) and ``fused_poisson_ll_bf16.cu`` (K4, the
bfloat16 design), both including ``fused_ll_common.cuh``, the helpers they
share. At first use :func:`build_all` compiles each with nvcc for Hopper
(``sm_90a``), one process per source, all started together, into a shared
library under ``theano_pyglm_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source, the header and the flags so a stale build is
never loaded; :func:`load_fused_ll` and :func:`load_fused_ll_bf16` open
them with ctypes. The clip constant comes from
:mod:`theano_pyglm_torch.ops.clipping` as ``-DEXP_CLIP``.

No step falls back: a missing nvcc or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from theano_pyglm_torch.ops.clipping import EXP_CLIP

__all__ = [
    "SOURCE",
    "SOURCE_BF16",
    "BUILD_DIR",
    "nvcc_flags",
    "build_all",
    "load_fused_ll",
    "load_fused_ll_bf16",
]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "fused_poisson_ll.cu"
SOURCE_BF16 = _PKG / "csrc" / "fused_poisson_ll_bf16.cu"
HEADER = _PKG / "csrc" / "fused_ll_common.cuh"  # included by both sources
BUILD_DIR = _PKG / "_build"


def nvcc_flags() -> list[str]:
    return [
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        f"-DEXP_CLIP={EXP_CLIP!r}f",
        "-Xptxas", "-v",
    ]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise FileNotFoundError("nvcc not found on PATH or under $CUDA_HOME/bin")
    return str(path)


def _target(source: Path) -> Path:
    """The library of ``source`` under BUILD_DIR, named by the hash of the
    source, the header it includes and the flags."""
    text = source.read_bytes() + HEADER.read_bytes() + " ".join(nvcc_flags()).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{digest}.so"


def _start(source: Path):
    """(library path, the nvcc process building it, or None when built)."""
    out = _target(source)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *nvcc_flags(), "-o", str(tmp), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return out, (proc, tmp)


def _finish(out: Path, job) -> tuple[Path, str]:
    if job is None:
        return out, ""
    proc, tmp = job
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{text}")
    os.replace(tmp, out)
    return out, text


def build_all(sources=None) -> dict:
    """Compile the libraries of ``sources`` (default: both) that are not
    built yet, one nvcc process each, all started together. Returns
    {source: (library path, nvcc's output; empty when it was built)}."""
    jobs = {src: _start(src) for src in (sources or (SOURCE, SOURCE_BF16))}
    return {src: _finish(*job) for src, job in jobs.items()}


@functools.lru_cache(maxsize=None)
def _load(source: Path, suffix: str) -> ctypes.CDLL:
    """The library of ``source``, built if it is not yet, with the C
    signatures of its entry points ``fused_ll_{fwd,vg,fwd_chains,vg_chains}``
    + ``suffix`` declared."""
    path, _ = build_all((source,))[source]
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # (x_f, u, i_rest, s, [d_irest], part, out, barrier,
    #  T, NB, N, W (one chain) or C (chains), tile_t, grid_x, grid_y, smem_bytes, device, dt, log_dt, stream)
    for name, n_ptr in (("fwd", 7), ("vg", 8), ("fwd_chains", 7), ("vg_chains", 8)):
        fn = getattr(lib, f"fused_ll_{name}{suffix}")
        fn.argtypes = [ptr] * n_ptr + [i32] * 9 + [f32, f32, ptr]
        fn.restype = i32
    lib.fused_ll_error_string.argtypes = [i32]
    lib.fused_ll_error_string.restype = ctypes.c_char_p
    return lib


def load_fused_ll() -> ctypes.CDLL:
    """The K1-K3 library (float32 X_f)."""
    return _load(SOURCE, "")


def load_fused_ll_bf16() -> ctypes.CDLL:
    """The K4 library (bfloat16 X_f): K1-K3's entry points with ``_bf16``
    names."""
    return _load(SOURCE_BF16, "_bf16")
