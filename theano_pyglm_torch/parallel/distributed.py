"""Several processes, one GPU each — port of
:mod:`theano_pyglm_tpu.parallel.distributed`.

The JAX package stitches its processes into one global device set under a
single controller. The port follows PyTorch's idiom instead: one process a
GPU (``torchrun --nproc_per_node k``), each running the same program, joined
by a ``torch.distributed`` process group. NCCL joins ranks on CUDA devices,
gloo ranks on the CPU (the tests); the backend follows the device and never
falls back. A mesh (:mod:`theano_pyglm_torch.parallel.mesh`) covers the
ranks of the group.

Usage, in each process (arguments, or torchrun's environment: MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK):

    from theano_pyglm_torch.parallel import distributed as dist
    dist.initialize()
    mesh = dist.global_chain_mesh()
    samples, diag, _ = gibbs_sample_chains(pop, data, seed, n_chains=C, mesh=mesh, ...)
    # every rank holds the full (n, C, ...) stacks: the chains sampler
    # gathers its chunks in chain order as it copies them to the host
    dist.shutdown()

A single process (no coordinator, world size 1) sets up nothing:
``initialize`` returns False and a mesh has size 1, without collectives.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as torch_dist

__all__ = ["initialize", "is_distributed", "local_device", "global_chain_mesh", "allgather_samples", "shutdown"]


def _rank_device(device) -> torch.device:
    """This rank's device: ``device`` as given, or cuda:<LOCAL_RANK> for
    None or a bare "cuda"; without a CUDA device only the CPU, asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to join gloo ranks on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> bool:
    """Join this process to the run's process group. ``coordinator_address``
    is "host:port" of rank 0's store (default MASTER_ADDR:MASTER_PORT);
    ``num_processes`` the world size (default WORLD_SIZE, else 1);
    ``process_id`` this rank (default RANK, else 0); ``device`` this rank's
    device (default cuda:<LOCAL_RANK>; NCCL on a CUDA device, gloo on the
    CPU). Returns True once a group is set up (also if one already was),
    False for a single process: no coordinator, or a world size of 1 read
    from the environment. A group of one rank is set up only when
    ``num_processes=1`` is passed with an address."""
    if torch_dist.is_available() and torch_dist.is_initialized():
        return True
    if coordinator_address is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    asked = num_processes is not None
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator_address is None or (num_processes <= 1 and not asked):
        return False
    dev = _rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch_dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
    )
    return True


def is_distributed() -> bool:
    """True while this process belongs to a process group."""
    return torch_dist.is_available() and torch_dist.is_initialized()


def local_device() -> Optional[torch.device]:
    """This rank's device, as :func:`initialize` chose it (the current CUDA
    device of an NCCL rank, the CPU of a gloo one); None without a group."""
    if not is_distributed():
        return None
    if torch_dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_chain_mesh(n_devices: Optional[int] = None):
    """The 'chains' mesh over every rank of the group: the same as
    :func:`theano_pyglm_torch.parallel.mesh.chain_mesh` (a size-1 mesh in
    a single process)."""
    from theano_pyglm_torch.parallel.mesh import chain_mesh

    return chain_mesh(n_devices)


def allgather_samples(samples: dict) -> dict:
    """Identity — kept for the JAX package's API.

    The chains sampler (``gibbs_sample_chains``) already gathers every
    rank's chains as it copies each chunk to the host, so every rank's
    ``samples`` hold the complete (n_samples, n_chains, ...) stacks.
    Gathering again would repeat every chain once per rank — (n, P·C, ...)
    with identical chain blocks — inflating downstream ESS and corrupting
    R̂. This function therefore returns its input unchanged."""
    return samples


def shutdown() -> None:
    """Leave and destroy the process group (a no-op without one)."""
    if is_distributed():
        torch_dist.destroy_process_group()
