"""Meshes of ranks — port of :mod:`theano_pyglm_tpu.parallel.mesh`.

The JAX package's mesh is a list of local devices over which XLA shards
arrays and places the collectives. In the port a mesh is the process group
of :mod:`theano_pyglm_torch.parallel.distributed` seen from one rank: a
small frozen record of the axis it splits, the world size, this rank, its
device and the group. Work is split by rank and the collectives are written
out here. Two axes of parallelism exist in this model family:

  'chains'  — independent MCMC chains, a contiguous block of them a rank;
  'neurons' — the postsynaptic neurons of the likelihood, which factorizes
              over them, a contiguous block of them a rank.

Without a process group a mesh has size 1, no device of its own (tensors
stay where they are) and no collectives: the JAX mesh of one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as torch_dist

from theano_pyglm_torch.parallel import distributed

__all__ = ["Mesh", "chain_mesh", "neuron_mesh", "shard_chains", "replicate", "gather_chains", "barrier"]


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh: the ``axis`` it splits ('chains' or
    'neurons'), the world ``size``, this ``rank``, this rank's ``device``
    (None without a group) and the process ``group`` (None: no collectives)."""

    axis: str
    size: int = 1
    rank: int = 0
    device: Optional[torch.device] = None
    group: Any = None

    def block(self, n: int) -> tuple:
        """[lo, hi): this rank's contiguous share of ``n`` items (chains or
        neurons); ``n`` must split evenly over the ranks."""
        if n % self.size:
            raise ValueError(f"{n} {self.axis} do not split evenly over a mesh of {self.size} ranks")
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k


def _mesh(axis: str, n_devices: Optional[int]) -> Mesh:
    if not distributed.is_distributed():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} ranks needs a process group of {n_devices} (initialize)")
        return Mesh(axis)
    size = torch_dist.get_world_size()
    if n_devices not in (None, size):
        raise ValueError(f"the mesh covers the process group's {size} ranks, not {n_devices}")
    return Mesh(axis, size, torch_dist.get_rank(), distributed.local_device(), torch_dist.group.WORLD)


def chain_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The 'chains' mesh over every rank of the process group; ``n_devices``
    must be None or the world size."""
    return _mesh("chains", n_devices)


def neuron_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The 'neurons' mesh over every rank of the process group."""
    return _mesh("neurons", n_devices)


def _tree_map(fn, x):
    """``fn`` on every tensor of a nesting of dicts, lists, tuples and
    named tuples (HMCState records); other leaves pass through."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tree_map(fn, v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return x


def shard_chains(tree, mesh: Mesh):
    """This rank's contiguous block of the leading (chain) axis of every
    tensor, on the rank's device."""

    def take(x):
        lo, hi = mesh.block(x.shape[0])
        x = x[lo:hi]
        return x if mesh.device is None else x.to(mesh.device)

    return _tree_map(take, tree)


def replicate(tree, mesh: Mesh):
    """Every tensor broadcast from rank 0 onto this rank's device, so every
    rank holds rank 0's values; the inputs are left as they are. Without a
    group, the tree as it is."""
    if mesh.group is None:
        return tree

    def bcast(x):
        x = x.to(mesh.device)
        x = x.contiguous() if mesh.rank == 0 else x.clone(memory_format=torch.contiguous_format)
        torch_dist.broadcast(x, src=0, group=mesh.group)
        return x

    return _tree_map(bcast, tree)


def gather_chains(tree, mesh: Optional[Mesh], dim: int = 0):
    """Every rank's block of the chain axis ``dim`` of every tensor,
    concatenated in rank order: the tensors of all chains, on every rank.
    One ``all_gather`` a tensor; without a mesh or a group, the tree as it
    is."""
    if mesh is None or mesh.group is None:
        return tree

    def gather(x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        torch_dist.all_gather(parts, x, group=mesh.group)
        return torch.cat(parts, dim)

    return _tree_map(gather, tree)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh (a no-op without a group)."""
    if mesh.group is None:
        return
    if mesh.device is not None and mesh.device.type == "cuda":
        torch_dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        torch_dist.barrier(group=mesh.group)
