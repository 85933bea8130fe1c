"""Checkpoints for exact resume — port of
:mod:`theano_pyglm_tpu.utils.checkpoints`.

A checkpoint holds the complete sampler state: the params, every HMC
block's state (of all chains, batched), each chain's ``torch.Generator``
state (CPU or CUDA) and the iteration, so a resumed chain continues exactly (the same draws, the same
step sizes). One file per step, ``ckpt_<step>.pt``, written with
``torch.save`` (the JAX package uses orbax) and read back with
``weights_only=True``: :class:`HMCState` records are stored as tagged
dicts. The newest ``max_to_keep`` checkpoints are kept.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from theano_pyglm_torch.inference.hmc import HMCState

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_NAME = re.compile(r"ckpt_(\d+)\.pt$")
_HMC_TAG = "__HMCState__"


def _encode(x):
    if isinstance(x, HMCState):
        return {_HMC_TAG: {k: _encode(v) for k, v in x._asdict().items()}}
    if isinstance(x, dict):
        return {k: _encode(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_encode(v) for v in x]
    return x


def _decode(x, device):
    if isinstance(x, dict):
        if set(x) == {_HMC_TAG}:
            return HMCState(**_decode(x[_HMC_TAG], device))
        return {k: _decode(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [_decode(v, device) for v in x]
    if isinstance(x, torch.Tensor) and device is not None:
        return x.to(device)
    return x


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:09d}.pt")


def save_checkpoint(directory: str, step: int, state, generators, max_to_keep: int = 3) -> None:
    """Persist sampler state at iteration ``step``. ``state`` is any nesting
    of dicts, lists, :class:`HMCState` records and tensors (the MCMC state
    of one chain, or the chains' batched state, every tensor with a leading
    chain axis); ``generators`` the chains' generators, whose states are
    saved. The file is written under a
    temporary name and renamed, so a run cut off while saving leaves the
    previous checkpoints intact; then all but the newest ``max_to_keep``
    are deleted."""
    os.makedirs(directory, exist_ok=True)
    payload = {
        "step": int(step),
        "state": _encode(state),
        "generators": [g.get_state() for g in generators],
    }
    tmp = _path(directory, step) + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, _path(directory, step))
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(_path(directory, old))


def latest_step(directory: str) -> Optional[int]:
    """The newest checkpointed iteration in ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None, map_location=None):
    """Restore (state, generator states, step) of ``step`` (default: the
    newest). The state's tensors move to ``map_location`` when given;
    generator states stay on the CPU, where ``Generator.set_state`` takes
    them."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory!r}")
    payload = torch.load(_path(directory, step), map_location="cpu", weights_only=True)
    return _decode(payload["state"], map_location), payload["generators"], payload["step"]
