"""The log-joint split over postsynaptic neurons — port of
:mod:`theano_pyglm_tpu.parallel.neurons`.

The likelihood factorizes over postsynaptic neurons: neuron n's term reads
its row of the parameters (bias, stimulus weights, its row of A, W and the
filters), its column of the spikes and the whole presynaptic design. The
JAX package shards those rows and columns over a device mesh with
``shard_map`` and sums the shards' terms with one ``psum``.

The port splits the work, not the parameters. Every rank holds all of
them; rank r of a 'neurons' mesh of k ranks owns postsynaptic neurons
[r·N/k, (r+1)·N/k) and evaluates only their term
(:func:`local_log_likelihood`): its columns of S, of the non-coupling
current and of the coupling operand U (``combined_weights``) against the
whole presynaptic design — on a CUDA device one fused-kernel launch (K2
with a gradient, K1 without) on a U of N/k columns — and its own columns'
Poisson normalizer Σ log S!. One ``all_reduce(SUM)`` of [value, gradient]
per evaluation joins the ranks, so every rank holds the same value and
gradient. The prior is evaluated on every rank from the same parameters
and added outside the reduction, so it is counted once.

Two cases of the JAX package's sharded path are not copied. Its fused
branch (``use_pallas``) under ``shard_map`` reshapes U with the global N
and adds the full recording's normalizer on every shard
(``models/population.py:331``, :342); and it splits the global
``w_stim_shared`` of the 'shared' background over the neurons. The port
shards no parameter, so it gives the unsharded log-joint in both.

N must be a multiple of the mesh's size.
"""

from __future__ import annotations

import torch
import torch.distributed as torch_dist

from theano_pyglm_torch.inference.map import value_and_grad

__all__ = ["neuron_partition_specs", "local_log_likelihood", "sharded_log_likelihood",
           "make_sharded_value_and_grad"]

#: leaves with one row per postsynaptic neuron that the likelihood reads
_POST_KEYS = ("bias", "w_stim", "w_stim_s", "w_stim_t", "gain", "w_ir", "A", "W")


def neuron_partition_specs(params: dict, data: dict, axis: str = "neurons"):
    """Which leaves a rank takes a block of, as (params, data) dicts of
    partition specs in the JAX package's form: ``(axis,)`` for a block of
    the leading (postsynaptic) axis, ``(None, axis)`` for S's columns,
    ``()`` for a leaf used whole. Only the likelihood's postsynaptic rows
    are split; the hyperparameters, the latent types and locations and
    the global ``w_stim_shared`` are used whole (the JAX package also
    splits locs, y and w_stim_shared)."""
    p_specs = {k: ((axis,) if k in _POST_KEYS else ()) for k in params}
    d_specs = {k: ((None, axis) if k == "S" else ()) for k in data}
    return p_specs, d_specs


def _local_data(data: dict, lo: int, hi: int) -> dict:
    """The data of postsynaptic neurons [lo, hi): their columns of S and
    their own normalizer; the presynaptic designs whole."""
    if "X_imp" not in data:
        raise ValueError("the neuron-sharded likelihood needs the materialized design (prepare_data's X_imp)")
    S = data["S"][:, lo:hi].contiguous()
    return {**data, "S": S, "_neg_log_S_factorial": -torch.lgamma(S + 1.0).sum()}


def _rows(params: dict, lo: int, hi: int) -> dict:
    return {k: (v[lo:hi] if k in _POST_KEYS else v) for k, v in params.items()}


def local_log_likelihood(pop, params, data, lo: int, hi: int) -> torch.Tensor:
    """The spike log-likelihood of postsynaptic neurons [lo, hi) alone (one
    chain's params): the population's likelihood on their rows of the
    parameters and their columns of the spikes, against the whole design.
    Summed over blocks that cover 0..N it is ``pop.log_likelihood``."""
    return pop.log_likelihood(_rows(params, lo, hi), _local_data(data, lo, hi))


class _RankSum(torch.autograd.Function):
    """Σ over the ranks of a group of each rank's term ``local(leaves)``,
    with its gradient. ``forward`` evaluates the local term and its
    gradient in the leaves that need one, then makes one
    ``all_reduce(SUM)`` of [value, gradient]; ``backward`` scales the
    summed gradient by the cotangent. Every rank gets the same sums."""

    @staticmethod
    def forward(ctx, local, group, *leaves):
        need = ctx.needs_input_grad[2:]
        # a value-only call stays value-only (K1 on a CUDA device)
        with torch.enable_grad() if any(need) else torch.no_grad():
            xs = [x.detach().requires_grad_(n) for x, n in zip(leaves, need)]
            val = local(xs)
            wrt = [x for x, n in zip(xs, need) if n]
            grads = torch.autograd.grad(val, wrt, allow_unused=True) if wrt else ()
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, grads)]
        flat = torch.cat([val.detach().reshape(1)] + [g.reshape(-1) for g in grads])
        if group is not None:
            torch_dist.all_reduce(flat, group=group)
        summed, at = [], 1
        for g in grads:
            summed.append(flat[at : at + g.numel()].view_as(g))
            at += g.numel()
        ctx.save_for_backward(*summed)
        ctx.need = need
        return flat[0].clone()

    @staticmethod
    def backward(ctx, g):
        summed = iter(ctx.saved_tensors)
        return (None, None, *((g * next(summed)) if n else None for n in ctx.need))


def _local_view(lo: int, hi: int):
    """``data -> its neurons [lo, hi)``, built once per data dict."""
    cache = {}

    def get(data):
        if cache.get("of") is not data:
            cache.update(of=data, local=_local_data(data, lo, hi))
        return cache["local"]

    return get


def sharded_log_likelihood(pop, params, local_data, mesh) -> torch.Tensor:
    """The full spike log-likelihood as the sum over the mesh's ranks of
    each rank's neurons' term, differentiable in every floating leaf of
    ``params`` that needs a gradient: one local evaluation and one
    all-reduce per call. ``local_data``: the rank's data (``_local_view``)."""
    lo, hi = mesh.block(pop.N)
    keys = [k for k, v in params.items() if isinstance(v, torch.Tensor) and v.is_floating_point()]

    def term(xs):
        return pop.log_likelihood(_rows({**params, **dict(zip(keys, xs))}, lo, hi), local_data)

    return _RankSum.apply(term, mesh.group, *(params[k] for k in keys))


def make_sharded_value_and_grad(pop, mesh, params: dict, data: dict, axis: str = "neurons"):
    """``fn(params, data) -> (value, grads)`` of −log_joint with the
    postsynaptic neurons split over ``mesh``: value a scalar tensor, grads a
    dict over the floating leaves of ``params``. Every rank gets the same
    value and gradient; the prior's part is computed on each rank alone.
    ``params`` and ``data`` fix nothing but are checked: N must be a
    multiple of the mesh's size, and the design materialized."""
    if mesh.axis != axis:
        raise ValueError(f"a {mesh.axis!r} mesh, not a {axis!r} mesh")
    lo, hi = mesh.block(pop.N)
    local_of = _local_view(lo, hi)
    local_of(data)

    def fn(params, data):
        local = local_of(data)
        return value_and_grad(lambda p: -(sharded_log_likelihood(pop, p, local, mesh) + pop.log_prior(p)), params)

    return fn
