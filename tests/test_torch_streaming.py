"""Long recordings in the port: the time-chunked and streamed-design
likelihood against the JAX package (tests/test_loglik.py:196-261), the
fused per-block path, the memory bound of the streamed design, and the
column groups of the CUDA kernels' launch plan.

Inputs are numpy-seeded; parameters are drawn by the port and carried into
JAX (torch_parity.build_pair_light). Float64 on the CPU: value 1e-9
relative, gradient 1e-7 relative L2 (the blocks sum the bins in another
order than JAX's padded ``lax.map``)."""

import jax
import numpy as np
import pytest
import torch

import theano_pyglm_torch as pt
import theano_pyglm_tpu as tpu
from theano_pyglm_tpu.inference.map import split_params as split_j
from theano_pyglm_torch.inference.map import split_params
from theano_pyglm_torch.models import population as population_mod
from theano_pyglm_torch.ops import kernels
from torch_parity import build_pair_light, rel_err, to_np

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ll_and_grad_torch(pop, params, data):
    opt, frozen = split_params(params)
    opt = {k: v.clone().requires_grad_(True) for k, v in opt.items()}
    val = pop.log_joint({**frozen, **opt}, data)
    val.backward()
    return float(val.detach()), {k: v.grad for k, v in opt.items()}


def _ll_and_grad_jax(pop, params, data):
    opt, frozen = split_j(params)
    val, g = jax.value_and_grad(lambda o: pop.log_joint({**frozen, **o}, data))(opt)
    return float(val), g


def _streamed_pair(spec, T, chunk, seed=0):
    """(pop_j, pop_t, params_j, params_t, data_j, data_t), both streamed:
    only S and the Poisson normalizer (JAX's own prepare_data, which builds
    no design in this mode, and the port's)."""
    import jax.numpy as jnp

    pop_j = tpu.Population(spec, time_chunk=chunk)
    pop_t = pt.Population(spec, device="cpu", dtype=F64, time_chunk=chunk)
    params_t = pop_t.sample(torch.Generator().manual_seed(seed))
    S = np.random.RandomState(seed).poisson(0.05, size=(T, spec["N"])).astype(float)
    data_t = pop_t.prepare_data(S, materialize_design=False)
    data_j = pop_j.prepare_data(S, materialize_design=False)
    params_j = {k: jnp.asarray(to_np(v)) for k, v in params_t.items()}
    return pop_j, pop_t, params_j, params_t, data_j, data_t


@pytest.mark.parametrize("streamed", [False, True])
def test_chunked_log_joint_matches_jax(streamed):
    """T=700 in blocks of 128 (materialized design, with stimulus) and
    T=900 in blocks of 200 (streamed design, no stimulus): neither divides
    T, so the last block is ragged."""
    if streamed:
        spec = pt.make_model("sparse_weighted_model", 3, bkgd={"type": "none"})
        pop_j, pop_t, p_j, p_t, d_j, d_t = _streamed_pair(spec, 900, 200)
        assert "X_imp" not in d_t and "_X_imp_mean" not in d_t
    else:
        spec = pt.make_model("sparse_weighted_model", 3)
        _, _, p_j, p_t, d_j, d_t = build_pair_light(spec, T=700)
        pop_j = tpu.Population(spec, time_chunk=128)
        pop_t = pt.Population(spec, device="cpu", dtype=F64, time_chunk=128)
    want, g_want = _ll_and_grad_jax(pop_j, p_j, d_j)
    got, g_got = _ll_and_grad_torch(pop_t, p_t, d_t)
    assert abs(got - want) <= 1e-9 * abs(want), (got, want)
    assert set(g_got) == set(g_want)
    for k in g_want:
        assert rel_err(g_got[k], g_want[k]) <= 1e-7, k


def test_chunked_and_streamed_match_unchunked_in_the_port():
    """The port against itself: chunked (materialized) and streamed equal
    the monolithic path (value 1e-12 / 1e-10 relative, gradient 1e-9 /
    1e-8 relative L2). Streaming skips the centering, which moves a
    constant between the bias and the coupling terms only."""
    spec = pt.make_model("sparse_weighted_model", 3, bkgd={"type": "none"})
    pop = pt.Population(spec, device="cpu", dtype=F64)
    pop_c = pt.Population(spec, device="cpu", dtype=F64, time_chunk=128)
    params = pop.sample(torch.Generator().manual_seed(0))
    S, _ = pop.simulate(torch.Generator().manual_seed(1), params, 700)
    data = pop.prepare_data(S)
    data_s = pop_c.prepare_data(S, materialize_design=False)
    ref, g_ref = _ll_and_grad_torch(pop, params, data)
    for d, tol_v, tol_g in ((data, 1e-12, 1e-9), (data_s, 1e-10, 1e-8)):
        got, g_got = _ll_and_grad_torch(pop_c, params, d)
        assert abs(got - ref) <= tol_v * abs(ref), (got, ref)
        for k in g_ref:
            assert rel_err(g_got[k], g_ref[k]) <= tol_g, k


def test_streamed_without_time_chunk_raises():
    spec = pt.make_model("sparse_weighted_model", 2, bkgd={"type": "none"})
    pop = pt.Population(spec, device="cpu", dtype=F64)
    params = pop.sample(torch.Generator().manual_seed(0))
    data = pop.prepare_data(np.zeros((300, 2)), materialize_design=False)
    assert set(data) == {"S", "_neg_log_S_factorial"}
    with pytest.raises(ValueError, match="materialize_design"):
        pop.log_likelihood(params, data)
    # a time_chunk at least T long streams nothing either
    pop_long = pt.Population(spec, device="cpu", dtype=F64, time_chunk=300)
    with pytest.raises(ValueError, match="materialize_design"):
        pop_long.log_likelihood(params, data)


def test_fused_per_block_matches_unchunked_float32(monkeypatch):
    """The float32 fused path (the kernels' plain version on the CPU), one
    call per block, chunked and streamed, against the unchunked fused call:
    value 1e-5 relative, gradient 1e-4 relative L2 (float32 sums in
    another order)."""
    spec = pt.make_model("sparse_weighted_model", 4)
    pop = pt.Population(spec, device="cpu")
    pop_c = pt.Population(spec, device="cpu", time_chunk=256)
    params = pop.sample(torch.Generator().manual_seed(0))
    stim = np.random.RandomState(1).randn(1000, 1).astype(np.float32)
    S, _ = pop.simulate(torch.Generator().manual_seed(1), params, 1000, stim=stim)
    data = pop.prepare_data(S, stim=stim)
    assert pop._fused_active(data)
    calls = []
    real = kernels.fused_poisson_ll

    def spy(x_f, *rest):
        calls.append(x_f.shape[0])
        return real(x_f, *rest)

    ref, g_ref = _ll_and_grad_torch(pop, params, data)
    monkeypatch.setattr(population_mod, "fused_poisson_ll", spy)
    for d in (data, pop_c.prepare_data(S, stim=stim, materialize_design=False)):
        calls.clear()
        got, g_got = _ll_and_grad_torch(pop_c, params, d)
        assert calls == [256, 256, 256, 232]  # one fused call per block
        assert abs(got - ref) <= 1e-5 * abs(ref), (got, ref)
        for k in g_ref:
            assert rel_err(g_got[k], g_ref[k]) <= 1e-4, k


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_streamed_evaluation_never_builds_the_full_design(monkeypatch, dtype):
    """Value and gradient on streamed data, fused (float32) and plain
    (float64): every design the population builds covers one block and its
    L-bin halo, never all T bins."""
    spec = pt.make_model("sparse_weighted_model", 3, bkgd={"type": "none"})
    T, C = 1200, 300
    pop = pt.Population(spec, device="cpu", dtype=dtype, time_chunk=C)
    params = pop.sample(torch.Generator().manual_seed(0))
    S = np.random.RandomState(0).poisson(0.05, (T, 3))
    rows = []
    real = population_mod.convolve_with_basis

    def spy(x, basis, *a, **k):
        rows.append(x.shape[0])
        return real(x, basis, *a, **k)

    monkeypatch.setattr(population_mod, "convolve_with_basis", spy)
    data = pop.prepare_data(S, materialize_design=False)
    assert rows == []
    _ll_and_grad_torch(pop, params, data)
    assert rows and max(rows) == C + pop.L_imp < T
    # the plain path rebuilds each block again in the backward pass
    assert len(rows) == (T // C) * (1 if dtype == torch.float32 else 2)


# --- the CUDA kernels' column groups (plain functions of the shapes) ---------

H100_SMS = 132
#: every (T, NB, N) of PERF.md's kernel table before column groups
ONE_GROUP_SHAPES = [(60_000, 135, 27), (60_000, 5, 1), (240_000, 50, 10), (30_000, 50, 10),
                    (60_000, 80, 16), (12_000, 135, 27)]
#: the long recording (N=100, T=600,000, B=5): resident, one block, the ragged last block
STRETCH_SHAPES = [(600_000, 500, 100), (65_536, 500, 100), (10_176, 500, 100)]


@pytest.mark.parametrize("grad", [False, True])
def test_launch_plan_column_groups(grad):
    for shape in ONE_GROUP_SHAPES:
        plan = kernels.launch_plan(*shape, H100_SMS, grad)
        assert (plan.groups, plan.group_cols) == (1, shape[2]), shape
    for T, NB, N in STRETCH_SHAPES:
        # U does not stay resident in one group: the wide-U instance, all N
        # columns in every block (tests/test_torch_kernels.py::test_wide_launch_plan)
        assert kernels._smem_bytes(NB, N, 4) > kernels.SMEM_LIMIT
        plan = kernels.launch_plan(T, NB, N, H100_SMS, grad)
        assert plan.k_slab > 0 and (plan.groups, plan.group_cols, plan.grid_y) == (1, N, 1)
        assert plan.smem_bytes == kernels._smem_bytes_wide(NB, N, plan.tile_t, plan.k_slab, plan.stages,
                                                           plan.du_chunk) <= kernels.SMEM_LIMIT
        assert plan.grid_x <= H100_SMS
        assert plan.du_parts == (kernels.wide_du_runs(NB, N)[2] if grad else 0)
    # past what the wide instance takes (N ≳ 900), the resident instance's column groups
    T, NB, N = 64, 200, 1040
    plan = kernels.launch_plan(T, NB, N, H100_SMS, grad)
    assert plan.k_slab == 0 and plan.groups == -(-N // plan.group_cols) > 1 and plan.group_cols % 8 == 0
    for W in {plan.group_cols, N - (plan.groups - 1) * plan.group_cols}:
        assert kernels._smem_bytes(NB, W, plan.tile_t) <= kernels.SMEM_LIMIT
    assert plan.smem_bytes == kernels._smem_bytes(NB, plan.group_cols, plan.tile_t)
    assert plan.grid_x * plan.grid_y * plan.groups <= H100_SMS
    assert plan.grid_y == (-(-kernels.du_tiles(NB, plan.group_cols) // kernels.THREADS) if grad else 1)
    # one group fewer would not fit
    fewer = -(-N // (plan.groups - 1))
    fewer = N if plan.groups == 2 else -(-fewer // 8) * 8
    assert kernels._smem_bytes(NB, fewer, 4) > kernels.SMEM_LIMIT


def test_column_groups_of_the_plain_version_concatenate_to_the_whole():
    """What K1/K2 compute per group, concatenated over the groups (dU and
    dI_rest by columns, the value summed), is the whole: column n of the
    currents depends on column n of U alone. Float64, 1e-12."""
    T, NB, N = 700, 500, 100
    W = kernels._group_cols(NB, N, lambda W: kernels._smem_bytes(NB, W, 4))  # the resident instance's groups
    r = np.random.RandomState(0)
    x, u = 0.1 * r.randn(T, NB), 0.3 * r.randn(NB, N)
    ir, s = r.randn(T, N) - 3.0, r.poisson(0.05, (T, N)).astype(float)
    ir.reshape(-1)[r.choice(T * N, 50, replace=False)] = 45.0  # clipped entries
    x, u, ir, s = (torch.as_tensor(a) for a in (x, u, ir, s))
    ll, du, dir_ = kernels.fused_poisson_ll_reference(x, u, ir, s, 1e-3)
    parts = [kernels.fused_poisson_ll_reference(x, u[:, c:c + W], ir[:, c:c + W], s[:, c:c + W], 1e-3)
             for c in range(0, N, W)]
    assert len(parts) > 1
    assert abs(float(sum(p[0] for p in parts)) - float(ll)) <= 1e-12 * abs(float(ll))
    torch.testing.assert_close(torch.cat([p[1] for p in parts], 1), du, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(torch.cat([p[2] for p in parts], 1), dir_, rtol=0, atol=0)
    values = [kernels.fused_poisson_ll_value_reference(x, u[:, c:c + W], ir[:, c:c + W], s[:, c:c + W], 1e-3)
              for c in range(0, N, W)]
    assert abs(float(sum(values)) - float(ll)) <= 1e-12 * abs(float(ll))
