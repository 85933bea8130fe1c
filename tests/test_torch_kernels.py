"""The fused Poisson log-likelihood op of the PyTorch port (ops/kernels.py).

On the CPU: the plain torch version and the autograd op against the JAX
Pallas op in interpret mode, in float32 with x64 off as in
tests/test_pallas.py. On a CUDA device (tests marked ``cuda``, skipped
elsewhere): the hand-written kernels K1/K2 against the plain version.

The module imports no JAX at top level, so the ``cuda`` tests also run where
JAX is absent: ``python -m pytest --noconftest -o addopts="" -m cuda
tests/test_torch_kernels.py``.
"""

import math

import numpy as np
import pytest
import torch

import theano_pyglm_torch as pt
from theano_pyglm_torch.inference.map import split_params
from theano_pyglm_torch.ops import kernels
from theano_pyglm_torch.ops.cuda_loader import nvcc_flags
from theano_pyglm_torch.ops.kernels import (
    fused_ll_value,
    fused_ll_value_and_grad,
    fused_poisson_ll,
    fused_poisson_ll_reference,
    fused_poisson_ll_value_reference,
)
from theano_pyglm_torch.utils.convert import params_from_numpy

DT = 1e-3


def _inputs(T, NB, N, seed=0, i_shift=1.0, clip_bins=0):
    """float32 numpy operands; ``clip_bins`` entries of I_rest pushed past ±40."""
    r = np.random.RandomState(seed)
    x = (0.1 * r.randn(T, NB)).astype(np.float32)
    u = (0.3 * r.randn(NB, N)).astype(np.float32)
    ir = (r.randn(T, N) + i_shift).astype(np.float32)
    s = r.poisson(0.05, (T, N)).astype(np.float32)
    if clip_bins:
        idx = r.choice(T * N, clip_bins, replace=False)
        ir.reshape(-1)[idx] = np.where(np.arange(clip_bins) % 2 == 0, 45.0, -45.0)
    return x, u, ir, s


def _torch(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.fixture
def f32_jax():
    """The Pallas path is float32: x64 off for the test, as in test_pallas.py."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", False)
    yield jax
    jax.config.update("jax_enable_x64", True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc to build and launch the kernels")
    return torch.device("cuda")


# --- CPU: plain version and autograd op against the JAX Pallas op --------


def _jax_value_and_grad(jax, x, u, ir, s):
    from theano_pyglm_tpu.ops.pallas_kernels import fused_poisson_ll as jax_fused

    f = lambda u_, ir_: jax_fused(x, u_, ir_, s, DT, True)  # noqa: E731
    val, (gu, gir) = jax.value_and_grad(f, argnums=(0, 1))(u, ir)
    return float(val), np.asarray(gu), np.asarray(gir)


@pytest.mark.parametrize("clip_bins", [0, 40])
def test_reference_matches_jax_pallas_op(f32_jax, clip_bins):
    """T=700 (not tile-aligned). float32 sums in another order: value 1e-4
    relative, dU and dI_rest rtol=1e-4, atol=1e-5 (test_pallas.py:37-39)."""
    x, u, ir, s = _inputs(700, 15, 3, clip_bins=clip_bins)
    want, gu_w, gir_w = _jax_value_and_grad(f32_jax, x, u, ir, s)
    ll, du, dir_ = fused_poisson_ll_reference(*_torch(x, u, ir, s), DT)
    assert abs(float(ll) - want) < 1e-4 * abs(want)
    np.testing.assert_allclose(du.numpy(), gu_w, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dir_.numpy(), gir_w, rtol=1e-4, atol=1e-5)
    if clip_bins:
        assert (dir_.numpy() == 0).sum() >= clip_bins
    v = fused_poisson_ll_value_reference(*_torch(x, u, ir, s), DT)
    assert abs(float(v) - want) < 1e-4 * abs(want)


def test_autograd_op_matches_jax(f32_jax):
    """The autograd op scales the unit-cotangent residuals by the incoming
    cotangent (here 2.5); tolerances as above."""
    x, u, ir, s = _inputs(700, 15, 3, seed=1)
    want, gu_w, gir_w = _jax_value_and_grad(f32_jax, x, u, ir, s)
    xt, ut, irt, st = _torch(x, u, ir, s)
    ut.requires_grad_(True)
    irt.requires_grad_(True)
    ll = fused_poisson_ll(xt, ut, irt, st, DT)
    assert abs(float(ll.detach()) - want) < 1e-4 * abs(want)
    (2.5 * ll).backward()
    np.testing.assert_allclose(ut.grad.numpy(), 2.5 * gu_w, rtol=1e-4, atol=2.5e-5)
    np.testing.assert_allclose(irt.grad.numpy(), 2.5 * gir_w, rtol=1e-4, atol=2.5e-5)


def test_population_fused_matches_jax_pallas(f32_jax):
    """Population(use_fused=True) against JAX Population(use_pallas=True) in
    float32, at test_pallas.py:122-142's tolerances."""
    import theano_pyglm_tpu as tpu
    from theano_pyglm_tpu.inference.map import split_params as split_j

    jax = f32_jax
    spec = tpu.make_model("sparse_weighted_model", 3, bkgd={"type": "none"})
    pop_j = tpu.Population(spec, use_pallas=True)
    pop_t = pt.Population(spec, device="cpu", use_fused=True)
    params_j = pop_j.sample(jax.random.PRNGKey(0))
    params_t = params_from_numpy({k: np.asarray(v) for k, v in params_j.items()}, device="cpu")
    S = np.random.RandomState(0).poisson(0.05, (600, 3)).astype("f")
    d_j, d_t = pop_j.prepare_data(S), pop_t.prepare_data(S)
    assert pop_t._fused_active(d_t)

    ll_j = float(pop_j.log_likelihood(params_j, d_j))
    ll_t = float(pop_t.log_likelihood(params_t, d_t))
    assert abs(ll_t - ll_j) < 1e-3 * max(1.0, abs(ll_j))

    opt_j, fr_j = split_j(params_j)
    g_j = jax.grad(lambda o: pop_j.log_joint({**fr_j, **o}, d_j))(opt_j)
    opt_t, fr_t = split_params(params_t)
    opt_t = {k: v.clone().requires_grad_(True) for k, v in opt_t.items()}
    pop_t.log_joint({**fr_t, **opt_t}, d_t).backward()
    for k in g_j:
        np.testing.assert_allclose(opt_t[k].grad.numpy(), np.asarray(g_j[k]), rtol=2e-3, atol=2e-4)


# --- CPU: routing, validation, build flags -------------------------------


def test_autograd_op_routes_value_only_to_k1(monkeypatch):
    """Under no_grad (or with no operand needing a gradient) the op takes the
    value-only wrapper; with a gradient it takes the one-pass value+grad."""
    calls = []
    monkeypatch.setattr(kernels, "fused_ll_value", lambda *a: calls.append("fwd") or fused_ll_value(*a))
    monkeypatch.setattr(
        kernels, "fused_ll_value_and_grad", lambda *a: calls.append("vg") or fused_ll_value_and_grad(*a)
    )
    x, u, ir, s = _torch(*_inputs(100, 6, 2))
    u.requires_grad_(True)
    fused_poisson_ll(x, u, ir, s, DT).backward()
    with torch.no_grad():
        fused_poisson_ll(x, u * 1.0, ir, s, DT)
    fused_poisson_ll(x, u.detach(), ir, s, DT)
    assert calls == ["vg", "fwd", "fwd"]


def test_cpu_path_counts_no_launch():
    before = dict(kernels.LAUNCHES)
    x, u, ir, s = _torch(*_inputs(100, 6, 2))
    fused_ll_value(x, u, ir, s, DT)
    fused_ll_value_and_grad(x, u, ir, s, DT)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("bad", ["u_shape", "s_shape", "empty", "meta_device"])
def test_wrappers_reject_bad_operands(bad):
    x, u, ir, s = _torch(*_inputs(50, 6, 2))
    if bad == "u_shape":
        u = u[:5]
    elif bad == "s_shape":
        s = s[:, :1]
    elif bad == "empty":
        x, ir, s = x[:0], ir[:0], s[:0]
    else:
        x = x.to("meta")
    for fn in (fused_ll_value, fused_ll_value_and_grad):
        with pytest.raises(ValueError):
            fn(x, u, ir, s, DT)


# --- CPU: the launch geometry of the CUDA kernels --------------------------

H100_SMS = 132


def _pr1_accepts(NB, N):
    """The shapes the first CUDA version took: U, a block-private dU and one
    64-bin tile of X and dI in 227 KB of shared memory."""
    return 4 * (2 * NB * N + 64 * (NB + N)) <= 227 * 1024


def _block_tiles(plan, T):
    """The kernels' loop: block b takes tiles b, b + grid_x, ... of
    [i·tile_t, min(T, (i+1)·tile_t))."""
    return [
        [(i * plan.tile_t, min(T, (i + 1) * plan.tile_t)) for i in range(b, plan.n_tiles, plan.grid_x)]
        for b in range(plan.grid_x)
    ]


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("T", [1, 63, 700, 60_000, kernels.TILE_MAX * H100_SMS * 2 + 1])
def test_launch_plan_tiles_cover_time_once(T, grad):
    """Every bin in exactly one tile; tiles are multiples of 4 bins (16-byte
    aligned spans); every block gets a tile and no block more than one tile
    above another."""
    plan = kernels.launch_plan(T, 135, 27, H100_SMS, grad)
    assert plan.tile_t % 4 == 0 and 4 <= plan.tile_t <= kernels.TILE_MAX
    per_block = _block_tiles(plan, T)
    spans = sorted(span for tiles in per_block for span in tiles)
    assert spans[0][0] == 0 and spans[-1][1] == T
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(t0 < t1 for t0, t1 in spans)
    counts = [len(tiles) for tiles in per_block]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1
    assert plan.grid_x <= H100_SMS and plan.grid_y == 1
    assert plan.smem_bytes <= kernels.SMEM_LIMIT


def test_launch_plan_flagship():
    """T=60,000, NB=135, N=27 on 132 SMs: one block per SM, 518 tiles of 116
    bins (the longest block 2 % above the mean), within 227 KB."""
    for grad in (False, True):
        plan = kernels.launch_plan(60_000, 135, 27, H100_SMS, grad)
        assert (plan.tile_t, plan.n_tiles, plan.grid_x, plan.grid_y) == (116, 518, 132, 1)
        assert plan.smem_bytes <= 227 * 1024
        longest = max(len(t) for t in _block_tiles(plan, 60_000)) * plan.tile_t
        assert longest <= 1.03 * 60_000 / H100_SMS


@pytest.mark.parametrize("N", [1, 2, 3, 5, 27, 54, 100, 400, 800])
def test_launch_plan_takes_every_shape_the_first_version_took(N):
    """Up to the largest NB the first version accepted, K1 and K2 still
    fit; K2 splits its dU micro-tiles over grid_y past 256 of them."""
    nb_max = max(nb for nb in range(1, 2000) if _pr1_accepts(nb, N))
    for NB in (1, nb_max // 2 or 1, nb_max):
        for grad in (False, True):
            plan = kernels.launch_plan(1000, NB, N, H100_SMS, grad)
            assert plan.smem_bytes <= kernels.SMEM_LIMIT
            assert plan.grid_y == (-(-kernels.du_tiles(NB, N) // kernels.THREADS) if grad else 1)


def _largest_nb(N, one_group=False):
    """The largest NB the wrapper takes at N: in column groups of 8 (or of
    N, where N < 8), or with all N columns in one group."""
    W = N if one_group else min(N, 8)
    nb = 1
    while kernels._smem_bytes(nb + 1, W, 4) <= kernels.SMEM_LIMIT:
        nb += 1
    return nb


def test_launch_plan_raises_beyond_the_limit():
    """The raise is left only where not even a column group of 8 fits at a
    4-bin tile; one NB past what a single group takes plans groups."""
    for N in (1, 27):
        nb = _largest_nb(N)
        kernels.launch_plan(100, nb, N, H100_SMS, True)
        with pytest.raises(ValueError, match="shared memory"):
            kernels.launch_plan(100, nb + 1, N, H100_SMS, True)
    nb1 = _largest_nb(27, one_group=True)
    assert kernels.launch_plan(100, nb1, 27, H100_SMS, True).groups == 1
    plan = kernels.launch_plan(100, nb1 + 1, 27, H100_SMS, True)
    assert plan.groups > 1 and plan.smem_bytes <= kernels.SMEM_LIMIT
    with pytest.raises(ValueError):
        kernels.launch_plan(0, 135, 27, H100_SMS, True)


def test_build_flags_target_hopper_and_carry_the_clip():
    flags = nvcc_flags()
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-DEXP_CLIP=40.0f" in flags  # from ops/clipping.py, the single source


# --- CUDA: the hand kernels against the plain version --------------------


def _check_against_reference(x, u, ir, s):
    """float32 sums over up to 1.6M terms taken in another order: value 1e-5
    relative, dU 1e-5 relative L2, dI_rest rtol=1e-5 / atol=1e-6."""
    ll_r, du_r, dir_r = fused_poisson_ll_reference(x, u, ir, s, DT)
    ll, du, dir_ = fused_ll_value_and_grad(x, u, ir, s, DT)
    v = fused_ll_value(x, u, ir, s, DT)
    torch.cuda.synchronize()
    for got in (ll, v):
        assert abs(float(got) - float(ll_r)) <= 1e-5 * abs(float(ll_r))
    assert float(torch.linalg.norm(du - du_r) / torch.linalg.norm(du_r)) <= 1e-5
    torch.testing.assert_close(dir_, dir_r, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "T,NB,N,clip_bins",
    [
        (700, 15, 3, 0),
        (700, 15, 3, 40),
        (60_000, 135, 27, 200),
        (3, 135, 27, 0),  # less than one tile
        (1001, 5, 1, 0),  # N=1: one 8-neuron n-tile, mostly padding
        (2000, 25, 5, 20),  # N=5, not a multiple of the 7-neuron dU micro-tile
        (1500, 77, 9, 0),  # odd NB
        (300, "largest", 27, 0),  # the largest NB·N the wrapper takes: 4 column groups, dU over grid_y
        (300, "one_group", 27, 0),  # the largest NB·N in one group: dU split over grid_y
        (2001, 460, 92, 20),  # N ≥ 89 at NB = 5N: two column groups of 48 and 44
        (10_176, 500, 100, 50),  # the long recording's last block: groups of 56 and 44
        (1003, 640, 128, 0),  # four groups of 32
    ],
)
def test_kernels_match_reference_on_card(cuda, T, NB, N, clip_bins):
    torch.backends.cuda.matmul.allow_tf32 = False
    if NB in ("largest", "one_group"):
        NB = _largest_nb(N, one_group=NB == "one_group")
    arrays = _inputs(T, NB, N, i_shift=-3.0 if T > 1000 else 1.0, clip_bins=clip_bins)
    before = dict(kernels.LAUNCHES)
    _check_against_reference(*_torch(*arrays, device=cuda))
    assert kernels.LAUNCHES == {**before, "fwd": before["fwd"] + 1, "vg": before["vg"] + 1}


@pytest.mark.cuda
def test_kernels_are_deterministic_on_card(cuda):
    """One launch per call, and the same bits every call: the ticketed
    fixed-order sums, also after a call on another shape has used the
    tickets."""
    ops = _torch(*_inputs(60_000, 135, 27, i_shift=-3.0), device=cuda)
    small = _torch(*_inputs(700, 15, 3), device=cuda)
    before = dict(kernels.LAUNCHES)
    a = fused_ll_value_and_grad(*ops, DT)
    fused_ll_value_and_grad(*small, DT)
    b = fused_ll_value_and_grad(*ops, DT)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(fused_ll_value(*ops, DT), fused_ll_value(*ops, DT))
    assert kernels.LAUNCHES == {**before, "fwd": before["fwd"] + 2, "vg": before["vg"] + 3}


@pytest.mark.cuda
def test_column_groups_repeat_bit_for_bit_on_card(cuda):
    """N=100 in two column groups: one launch per call and the same bits
    every call (the groups' values are added in group order)."""
    ops = _torch(*_inputs(10_176, 500, 100, i_shift=-3.0), device=cuda)
    assert kernels.launch_plan(10_176, 500, 100, kernels._sm_count(cuda.index or 0), True).groups > 1
    before = dict(kernels.LAUNCHES)
    a, b = fused_ll_value_and_grad(*ops, DT), fused_ll_value_and_grad(*ops, DT)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(fused_ll_value(*ops, DT), fused_ll_value(*ops, DT))
    assert kernels.LAUNCHES == {**before, "fwd": before["fwd"] + 2, "vg": before["vg"] + 2}


@pytest.mark.cuda
def test_population_on_card_matches_cpu(cuda):
    """The same parameters and data: the CUDA fused float32 log-joint and its
    gradient against the CPU's plain float64 path, 1e-4 relative (float32)."""
    spec = pt.make_model("distance_weighted_model", 5)
    S = np.random.RandomState(0).poisson(0.05, (3000, 5)).astype(np.float32)
    stim = np.random.RandomState(1).randn(3000, 1).astype(np.float32)
    base = pt.Population(spec, device="cpu", dtype=torch.float64).sample(torch.Generator().manual_seed(0))
    results = []
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        pop = pt.Population(spec, device=device, dtype=dtype)
        params = {k: v.to(device, dtype) if v.is_floating_point() else v.to(device) for k, v in base.items()}
        data = pop.prepare_data(S, stim=stim)
        opt, frozen = split_params(params)
        opt = {k: v.clone().requires_grad_(True) for k, v in opt.items()}
        val = pop.log_joint({**frozen, **opt}, data)
        val.backward()
        results.append((float(val.detach()), {k: v.grad.double().cpu() for k, v in opt.items()}))
    (v_gpu, g_gpu), (v_cpu, g_cpu) = results
    assert math.isfinite(v_gpu) and abs(v_gpu - v_cpu) <= 1e-4 * abs(v_cpu)
    for k in g_cpu:
        err = float(torch.linalg.norm(g_gpu[k] - g_cpu[k]) / torch.linalg.norm(g_cpu[k]))
        assert err <= 1e-4, k


@pytest.mark.cuda
def test_row_batches_replayed_as_a_cuda_graph_give_the_same_update(cuda, monkeypatch):
    """On the card the collapsed adjacency stage replays its full row batches
    after the first as a CUDA graph (N=9, two rows a batch: one eager, three
    replayed, one ragged): the same A and W as every batch run eagerly, bit
    for bit."""
    from theano_pyglm_torch.inference import gibbs

    pop = pt.Population(pt.make_model("sparse_weighted_model", 9, bkgd={"type": "none"}), device=cuda)
    p = pop.sample(torch.Generator(device=cuda).manual_seed(0))
    S = torch.poisson(torch.full((3000, 9), 0.02, device=cuda), generator=torch.Generator(device=cuda).manual_seed(1))
    d = pop.prepare_data(S)
    out = []
    for graphed in (False, True):
        monkeypatch.setattr(gibbs, "GRAPH_ROW_BATCHES", graphed)
        out.append(gibbs.update_adjacency_collapsed(torch.Generator(device=cuda).manual_seed(2), pop, p, d,
                                                    row_batch=2))
    assert torch.equal(out[0]["A"], out[1]["A"]) and torch.equal(out[0]["W"], out[1]["W"])
