"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

The sources in ``theano_pyglm_torch/csrc/`` have a plain C interface. At
first use, :func:`build_fused_ll` compiles ``fused_poisson_ll.cu`` with
nvcc for Hopper (``sm_90a``) into a shared library under
``theano_pyglm_torch/_build/`` (listed in ``.gitignore``), named by a hash
of the source and the flags so a stale build is never loaded, and
:func:`load_fused_ll` opens it with ctypes. The clip constant comes from
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

__all__ = ["SOURCE", "BUILD_DIR", "nvcc_flags", "build_fused_ll", "load_fused_ll"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "fused_poisson_ll.cu"
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


def build_fused_ll() -> tuple[Path, str]:
    """Compile the fused Poisson-LL library if it is not built yet.

    Returns (path of the shared library, nvcc's output; empty when the
    library was already built).
    """
    flags = nvcc_flags()
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"fused_poisson_ll_{digest}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *flags, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_fused_ll() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    path, _ = build_fused_ll()
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # (x_f, u, i_rest, s, [d_irest], part, out, barrier,
    #  T, NB, N, W, tile_t, grid_x, grid_y, smem_bytes, device, dt, log_dt, stream)
    lib.fused_ll_fwd.argtypes = [ptr] * 7 + [i32] * 9 + [f32, f32, ptr]
    lib.fused_ll_fwd.restype = i32
    lib.fused_ll_vg.argtypes = [ptr] * 8 + [i32] * 9 + [f32, f32, ptr]
    lib.fused_ll_vg.restype = i32
    # K3: (x_f, u, i_rest, s, [d_irest], part, out, barrier,
    #  T, NB, N, C, tile_t, grid_x, grid_y, smem_bytes, device, dt, log_dt, stream)
    lib.fused_ll_fwd_chains.argtypes = [ptr] * 7 + [i32] * 9 + [f32, f32, ptr]
    lib.fused_ll_fwd_chains.restype = i32
    lib.fused_ll_vg_chains.argtypes = [ptr] * 8 + [i32] * 9 + [f32, f32, ptr]
    lib.fused_ll_vg_chains.restype = i32
    lib.fused_ll_error_string.argtypes = [i32]
    lib.fused_ll_error_string.restype = ctypes.c_char_p
    return lib
