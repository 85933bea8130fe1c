"""The chain-batched sampler of the PyTorch port: K3 (ops/kernels.py), the
model over a leading chain axis, and the sweep over C chains at once.

On the CPU: K3's plain version and autograd op against the JAX package's
fused op under ``vmap`` over chains (its ``custom_vmap`` rules) in float32;
the batched log-joint and its gradient against ``jax.vmap`` of JAX's
log-joint in float64; the batched sweep against one-chain runs with the same
generators, draw for draw; K3's launch plan. On a CUDA device (tests marked
``cuda``, skipped elsewhere): K3 against its plain version and against K1/K2
on each chain alone.

JAX is imported inside the tests that compare with it, so the ``cuda`` tests
also run where JAX is absent: ``python -m pytest --noconftest -o addopts=""
-m cuda tests/test_torch_batched_chains.py``.
"""

import numpy as np
import pytest
import torch

import theano_pyglm_torch as pt
from theano_pyglm_torch.inference import gibbs, mcmc
from theano_pyglm_torch.inference.hmc import HMCState
from theano_pyglm_torch.inference.map import split_params
from theano_pyglm_torch.inference.mcmc import chain_state, init_mcmc_state, make_sweep, stack_states
from theano_pyglm_torch.ops import kernels
from theano_pyglm_torch.ops.kernels import (
    fused_ll_value_and_grad,
    fused_ll_value_and_grad_chains,
    fused_ll_value_chains,
    fused_poisson_ll,
    fused_poisson_ll_chains,
    fused_poisson_ll_chains_reference,
    fused_poisson_ll_chains_value_reference,
)
from theano_pyglm_torch.utils.convert import params_from_numpy

DT = 1e-3
H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(T, NB, N, C, seed=0, i_shift=1.0, clip_bins=0):
    """float32 numpy operands of C chains: X_f (T, NB), U (C, NB, N),
    I_rest (C, T, N), S (T, N); ``clip_bins`` entries of I_rest past ±40."""
    r = np.random.RandomState(seed)
    x = (0.1 * r.randn(T, NB)).astype(np.float32)
    u = (0.3 * r.randn(C, NB, N)).astype(np.float32)
    ir = (r.randn(C, T, N) + i_shift).astype(np.float32)
    s = r.poisson(0.05, (T, N)).astype(np.float32)
    if clip_bins:
        idx = r.choice(C * T * N, clip_bins, replace=False)
        ir.reshape(-1)[idx] = np.where(np.arange(clip_bins) % 2 == 0, 45.0, -45.0)
    return x, u, ir, s


def _torch(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.fixture
def f32_jax():
    """The fused op is float32: x64 off for the test, as in test_pallas.py."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", False)
    yield jax
    jax.config.update("jax_enable_x64", True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc to build and launch the kernels")
    return torch.device("cuda")


# --- CPU: K3's plain version and autograd op against JAX's chain rules ------


def _jax_chains(jax, x, u, ir, s, weights=None):
    """JAX's fused op vmapped over the chains of u and ir (x and s shared):
    the (C,) values and the gradients of Σ_c w_c·ll_c (unit weights: each
    chain's own unit-cotangent residuals)."""
    import jax.numpy as jnp
    from theano_pyglm_tpu.ops.pallas_kernels import fused_poisson_ll as jax_fused

    w = jnp.ones(u.shape[0], jnp.float32) if weights is None else jnp.asarray(weights)
    per_chain = jax.vmap(lambda u_, ir_: jax_fused(x, u_, ir_, s, DT, True), in_axes=(0, 0))
    vals = per_chain(u, ir)
    gu, gir = jax.grad(lambda u_, ir_: jnp.sum(w * per_chain(u_, ir_)), argnums=(0, 1))(u, ir)
    return np.asarray(vals), np.asarray(gu), np.asarray(gir)


@pytest.mark.parametrize("clip_bins", [0, 40])
def test_chains_reference_matches_jax_chain_rules(f32_jax, clip_bins):
    """C=3 chains, T=700 (not tile-aligned). float32 sums in another order:
    each value 1e-4 relative, dU and dI_rest rtol=1e-4, atol=1e-5 (the
    tolerances of test_torch_kernels.py's K1/K2 reference test)."""
    x, u, ir, s = _inputs(700, 15, 3, 3, clip_bins=clip_bins)
    want, gu_w, gir_w = _jax_chains(f32_jax, x, u, ir, s)
    ll, du, dir_ = fused_poisson_ll_chains_reference(*_torch(x, u, ir, s), DT)
    np.testing.assert_allclose(ll.numpy(), want, rtol=1e-4)
    np.testing.assert_allclose(du.numpy(), gu_w, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dir_.numpy(), gir_w, rtol=1e-4, atol=1e-5)
    if clip_bins:
        assert (dir_.numpy() == 0).sum() >= clip_bins
    v = fused_poisson_ll_chains_value_reference(*_torch(x, u, ir, s), DT)
    np.testing.assert_allclose(v.numpy(), want, rtol=1e-4)


def test_chains_autograd_op_scales_each_chain_by_its_cotangent(f32_jax):
    """The autograd op's backward multiplies chain c's residuals by entry c
    of the (C,) cotangent: against JAX's gradient of Σ_c w_c·ll_c, at the
    tolerances above (atol scaled by the largest weight)."""
    x, u, ir, s = _inputs(700, 15, 3, 4, seed=1)
    w = np.array([2.5, -1.0, 0.5, 3.0], np.float32)
    want, gu_w, gir_w = _jax_chains(f32_jax, x, u, ir, s, w)
    xt, ut, irt, st = _torch(x, u, ir, s)
    ut.requires_grad_(True)
    irt.requires_grad_(True)
    ll = kernels.FusedPoissonLLChains.apply(xt, ut, irt, st, DT)
    np.testing.assert_allclose(ll.detach().numpy(), want, rtol=1e-4)
    (torch.as_tensor(w) * ll).sum().backward()
    np.testing.assert_allclose(ut.grad.numpy(), gu_w, rtol=1e-4, atol=3e-5)
    np.testing.assert_allclose(irt.grad.numpy(), gir_w, rtol=1e-4, atol=3e-5)


def test_chains_op_routes_and_broadcasts(monkeypatch):
    """The public op: K3-vg with a gradient, K3-fwd without; a U or I_rest
    without the chain axis is broadcast; one chain goes through the chain
    wrapper (whose chain_groups send it to K1/K2 on the card); no chain axis
    at all is K1/K2's scalar; X_f or S with the chain axis runs K1/K2
    chain by chain. Every route gives each
    chain's own value (1e-6 relative, float32)."""
    calls = []
    for name in ("fused_ll_value_chains", "fused_ll_value_and_grad_chains", "fused_ll_value",
                 "fused_ll_value_and_grad"):
        fn = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _n=name, _f=fn: calls.append(_n) or _f(*a))
    x, u, ir, s = _torch(*_inputs(120, 6, 2, 3))

    def each(x_c, u_c, ir_c, s_c):
        return torch.stack([fused_poisson_ll(x_c(c), u_c(c), ir_c(c), s_c(c), DT) for c in range(3)])

    def close(got, want):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)

    def routed(*ops):
        calls.clear()
        out = fused_poisson_ll(*ops, DT)
        return out, list(calls)

    u.requires_grad_(True)
    got, route = routed(x, u, ir, s)
    assert route == ["fused_ll_value_and_grad_chains"]
    close(got, each(lambda c: x, lambda c: u[c], lambda c: ir[c], lambda c: s))
    u = u.detach()
    with torch.no_grad():
        got, route = routed(x, u[0], ir, s)
        assert route == ["fused_ll_value_chains"]
        close(got, each(lambda c: x, lambda c: u[0], lambda c: ir[c], lambda c: s))
        got, route = routed(x, u, ir[1], s)
        assert route == ["fused_ll_value_chains"]
        close(got, each(lambda c: x, lambda c: u[c], lambda c: ir[1], lambda c: s))
        got, route = routed(x, u[:1], ir[:1], s)
        assert got.shape == (1,) and route == ["fused_ll_value_chains"]
        close(got, each(lambda c: x, lambda c: u[0], lambda c: ir[0], lambda c: s)[:1])
        got, route = routed(x, u[2], ir[2], s)
        assert got.shape == () and route == ["fused_ll_value"]
        close(got, each(lambda c: x, lambda c: u[2], lambda c: ir[2], lambda c: s)[0])
        with pytest.raises(ValueError, match="no operand carries a chain axis"):
            fused_poisson_ll_chains(x, u[2], ir[2], s, DT)
        xs = torch.stack([x, 2.0 * x, 0.5 * x])
        got, route = routed(xs, u, ir, s)
        assert route == ["fused_ll_value"] * 3
        close(got, each(lambda c: xs[c], lambda c: u[c], lambda c: ir[c], lambda c: s))


def test_chains_wrappers_reject_bad_operands():
    x, u, ir, s = _torch(*_inputs(50, 6, 2, 3))
    for bad in ((x, u[:, :5], ir, s), (x, u, ir[:2], s), (x, u, ir, s[:, :1]), (x, u[0], ir, s),
                (x[:0], u, ir[:, :0], s[:0])):
        for fn in (fused_ll_value_chains, fused_ll_value_and_grad_chains):
            with pytest.raises(ValueError):
                fn(*bad, DT)


# --- CPU: K3's launch geometry ---------------------------------------------


def test_chains_launch_plan():
    """The flagship at C = 4: U (135, 108) in one group, tiles of 60 bins,
    K3-vg's dU in 126 mma tiles in one grid_y slice, within 227 KB. Configs
    3 and 4 at C = 4 plan too. An uncovered shape raises a ValueError that
    names it: C·N too wide for one group beside a 4-bin tile, or C past
    MAX_CHAINS."""
    for grad in (False, True):
        plan = kernels.launch_plan(60_000, 135, 27, H100_SMS, grad, chains=4)
        assert (plan.groups, plan.grid_y, plan.tile_t, plan.grid_x) == (1, 1, 60, H100_SMS)
        assert plan.smem_bytes <= kernels.SMEM_LIMIT
    assert kernels.mma_tiles(135, 27, chains=4) == 126
    for T, NB, N in ((30_000, 50, 10), (60_000, 80, 16), (240_000, 50, 10)):
        plan = kernels.launch_plan(T, NB, N, H100_SMS, True, chains=4)
        assert plan.groups == 1 and plan.grid_y == 1 and plan.smem_bytes <= kernels.SMEM_LIMIT
    with pytest.raises(ValueError, match=r"K3 at NB=500, N=100, C=2"):
        kernels.launch_plan(600_000, 500, 100, H100_SMS, True, chains=2)
    with pytest.raises(ValueError, match=r"C=9"):
        kernels.launch_plan(1000, 15, 3, H100_SMS, True, chains=kernels.MAX_CHAINS + 1)
    # K1/K2's plans are those of before: no chain argument, C = 1
    assert kernels.launch_plan(60_000, 135, 27, H100_SMS, True).tile_t == 116


def test_chain_groups():
    """The chains of one call in groups that K3 takes, as even as they can
    be, in chain order; a group of one is K1/K2's call. N = 60 (NB = 300)
    takes 2 chains a launch, C = 9 is past MAX_CHAINS, N = 89 and N = 100
    take no two, and C = 1 is always K1/K2. Every group of two or more
    plans; the whole C does not where it is cut."""
    cases = [
        ((300, 60, 4), (2, 2)),
        ((135, 27, 4), (4,)),
        ((135, 27, 9), (5, 4)),
        ((135, 27, 17), (6, 6, 5)),
        ((270, 54, 9), (2, 2, 2, 2, 1)),
        ((445, 89, 3), (1, 1, 1)),
        ((500, 100, 2), (1, 1)),
        ((15, 3, 1), (1,)),
    ]
    for (NB, N, C), want in cases:
        got = kernels.chain_groups(NB, N, C)
        assert got == want, (NB, N, C, got)
        for c in set(got) - {1}:
            for grad in (False, True):
                plan = kernels.launch_plan(1000, NB, N, H100_SMS, grad, chains=c)
                assert plan.groups == 1 and plan.smem_bytes <= kernels.SMEM_LIMIT
        if len(got) > 1 and C <= kernels.MAX_CHAINS:
            with pytest.raises(ValueError, match=rf"K3 at NB={NB}, N={N}, C={C}"):
                kernels.launch_plan(1000, NB, N, H100_SMS, True, chains=C)
    # K1/K2 plan every shape whose chains go one by one, a U too wide for shared memory and all
    assert kernels.launch_plan(1000, 445, 89, H100_SMS, True, chains=1).k_slab > 0
    with pytest.raises(ValueError):
        kernels.chain_groups(135, 27, 0)


# the shapes of every chain-batched value-and-gradient call: the flagship,
# configs 2-4 and N = 60 (NB = 5N)
VG_SHAPES = [(135, 27), (50, 10), (80, 16), (300, 60)]


@pytest.mark.parametrize("NB,N", VG_SHAPES)
@pytest.mark.parametrize("C", range(1, 9))
def test_vg_chains_items_own_each_du_tile_once(NB, N, C):
    """The mirror of K3-vg's and K4-vg-chains' dU work: for every group of
    chain_groups (K3-vg takes 2 or more chains, K4-vg-chains any), each
    (m-tile, n-tile) of dU (NB × C·N) is owned exactly once in every
    k-slice; a warp's run is m-major and contiguous, at most WARP_TILES
    items, so it covers at most ceil(items / n-tiles) + 1 m-tiles and the
    kernel's A fragment of X_fᵀ serves every n-tile of its m-tile in a
    group; the k-slices times the item-warps are the block's 8 warps."""
    for x_bytes in (4, 2):
        for c in set(kernels.chain_groups(NB, N, C)):
            if x_bytes == 4 and c == 1:
                continue  # K1/K2's call
            plan = kernels.launch_plan(60_000, NB, N, H100_SMS, True, chains=c, x_bytes=x_bytes)
            MT, NT = -(-NB // 16), -(-(c * N) // 8)
            runs = kernels.vg_chains_items(NB, N, c, plan.grid_y)
            ks = kernels.vg_chains_k_slices(NB, N, c, plan.grid_y)
            assert len(runs) == plan.grid_y * kernels.WARPS and kernels.WARPS % ks == 0
            assert sorted({k for k, _ in runs}) == list(range(ks))
            for k in range(ks):
                owned = [item for kk, run in runs if kk == k for item in run]
                assert sorted(owned) == [(m, n) for m in range(MT) for n in range(NT)], (c, k)
            for _, run in runs:
                assert len(run) <= kernels.WARP_TILES
                flat = [m * NT + n for m, n in run]
                assert flat == list(range(flat[0], flat[0] + len(flat))) if run else True
                if run:
                    assert len({m for m, _ in run}) <= -(-len(run) // NT) + 1


@pytest.mark.parametrize("bf16", [False, True])
def test_vg_chains_plans_and_shared_memory(bf16):
    """K3-vg's and K4-vg-chains' plans at every path's shape (the flagship
    at C = 4 and 7f's C = 2, configs 2-4, N = 60) and every group that
    chain_groups gives at NB = 5N up to N = 64: one column group, the tile
    a multiple of 4 (bf16: 8) and at most 16 bins a unit of 8 n-tiles per
    warp allows, the shared memory the source's layout (the mirror) within
    SMEM_LIMIT; and the chain kernels take every group K3 took before (the
    old layout at a 4-bin tile fits wherever the new one is asked to)."""
    x_bytes = 2 if bf16 else 4
    shapes = [(60_000, 135, 27, 4), (60_000, 135, 27, 2), (240_000, 50, 10, 2), (30_000, 50, 10, 4),
              (60_000, 80, 16, 4), (30_000, 300, 60, 2)]
    shapes += [(1000, 5 * n, n, c) for n in range(1, 65) for C in (2, 4, 8)
               for c in set(kernels.chain_groups(5 * n, n, C)) if c > 1 or bf16]
    for T, NB, N, C in shapes:
        plan = kernels.launch_plan(T, NB, N, H100_SMS, True, chains=C, x_bytes=x_bytes)
        assert plan.groups == 1 and plan.group_cols == N
        assert plan.tile_t % (8 if bf16 else 4) == 0 and plan.tile_t <= kernels._unit_rows_cap(N, C)
        assert plan.smem_bytes == kernels._smem_bytes_chains(NB, N, C, plan.tile_t, bf16, grad=True)
        assert plan.smem_bytes <= kernels.SMEM_LIMIT
        assert plan.grid_y == -(-kernels.mma_tiles(NB, N, C) // (kernels.WARPS * kernels.WARP_TILES))
    flag = kernels.launch_plan(60_000, 135, 27, H100_SMS, True, chains=4, x_bytes=x_bytes)
    assert (flag.tile_t, flag.grid_x, flag.grid_y) == ((64, H100_SMS, 1) if bf16 else (60, H100_SMS, 1))


# the shapes of the chain samplers' value calls (T, NB, N, C): the flagship at
# C = 4 and 7f's C = 2, configs 2-4, N = 60's groups of 2
VALUE_SHAPES = [(60_000, 135, 27, 4), (60_000, 135, 27, 2), (240_000, 50, 10, 2), (30_000, 50, 10, 4),
                (60_000, 80, 16, 4), (30_000, 300, 60, 2)]


@pytest.mark.parametrize("bf16", [False, True])
def test_value_chains_plans_and_shared_memory(bf16):
    """K3-fwd's and K4-fwd-chains' plans (the value-only instances of the
    chain source) at every path's shape and every group that chain_groups
    gives at NB = 5N up to N = 64: one column group, one grid_y slice, the
    tile a multiple of 4 (bf16: 8) within the unit cap (units of 32 bins ×
    up to VALUE_TILES n-tiles, one a warp), the shared memory
    the source's layout (the mirror) within SMEM_LIMIT: U and two stages,
    no dI copy, so the gradient instance's less K4's bf16 dI columns. At
    the flagship: tiles of 60 (64) bins on every SM, 199,520 (138,112) B."""
    x_bytes = 2 if bf16 else 4
    shapes = VALUE_SHAPES + [(1000, 5 * n, n, c) for n in range(1, 65) for C in (2, 4, 8)
                             for c in set(kernels.chain_groups(5 * n, n, C)) if c > 1 or bf16]
    for T, NB, N, C in shapes:
        plan = kernels.launch_plan(T, NB, N, H100_SMS, False, chains=C, x_bytes=x_bytes)
        assert (plan.groups, plan.group_cols, plan.grid_y) == (1, N, 1)
        assert plan.tile_t % (8 if bf16 else 4) == 0 and plan.tile_t <= kernels._unit_rows_cap(N, C, grad=False)
        assert plan.smem_bytes == kernels._smem_bytes_chains(NB, N, C, plan.tile_t, bf16, grad=False)
        assert plan.smem_bytes <= kernels.SMEM_LIMIT
        di = 4 * -(-(C * N) // 8) * 8 * kernels._odd4(-(-plan.tile_t // 16) * 8) if bf16 else 0
        assert kernels._smem_bytes_chains(NB, N, C, plan.tile_t, bf16, grad=True) - plan.smem_bytes == di
    flag = kernels.launch_plan(60_000, 135, 27, H100_SMS, False, chains=4, x_bytes=x_bytes)
    want = (64, H100_SMS, 138_112) if bf16 else (60, H100_SMS, 199_520)
    assert (flag.tile_t, flag.grid_x, flag.smem_bytes) == want


def _tiles_of(plan, T):
    return [[(i * plan.tile_t, min(T, (i + 1) * plan.tile_t)) for i in range(b, plan.n_tiles, plan.grid_x)]
            for b in range(plan.grid_x)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("C", range(1, 9))
def test_value_chains_tiles_cover_time_once(C, bf16):
    """The value calls of C chains at the flagship's widths (a group of one
    float32 chain is K1's call): every bin in exactly one tile, over T from
    one bin to past two tiles a block, no block more than one tile above
    another (the launch plan's balance)."""
    x_bytes = 2 if bf16 else 4
    for T in (1, 63, 700, 60_000, kernels.TILE_MAX * H100_SMS * 2 + 1):
        plan = kernels.launch_plan(T, 135, 27, H100_SMS, False, chains=C, x_bytes=x_bytes)
        if C == 1 and not bf16:
            assert plan == kernels.launch_plan(T, 135, 27, H100_SMS, False)
        per_block = _tiles_of(plan, T)
        spans = sorted(span for tiles in per_block for span in tiles)
        assert spans[0][0] == 0 and spans[-1][1] == T
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        counts = [len(tiles) for tiles in per_block]
        assert min(counts) >= 1 and max(counts) - min(counts) <= 1


# the most chains a launch at NB = 5N, as N grows: (first N, last N, chains)
MOST_CHAINS = [(1, 33, 8), (34, 35, 7), (36, 38, 6), (39, 43, 5), (44, 46, 4), (47, 53, 3), (54, 64, 2),
               (65, 100, 1)]


def test_chain_groups_are_pinned():
    """chain_groups gives the groups it gave under the chain kernels'
    first layout at every N up to 100 at NB = 5N (8 chains a launch up to
    N = 33, 4 up to 46, 3 up to 53, 2 up to 64, then one), and at the
    paths' shapes: the value and gradient calls of a sampler share their
    groups, and the sums of a call do not change with the layout."""
    for lo, hi, most in MOST_CHAINS:
        for n in range(lo, hi + 1):
            assert kernels.chain_groups(5 * n, n, most) == (most,), n
            if most < kernels.MAX_CHAINS:
                assert len(kernels.chain_groups(5 * n, n, most + 1)) == 2, n
    pinned = {(135, 27, 4): (4,), (50, 10, 2): (2,), (50, 10, 4): (4,), (80, 16, 4): (4,), (300, 60, 4): (2, 2),
              (135, 27, 9): (5, 4), (135, 27, 17): (6, 6, 5), (170, 34, 8): (4, 4), (235, 47, 4): (2, 2),
              (265, 53, 3): (3,), (325, 65, 2): (1, 1)}
    for (NB, N, C), want in pinned.items():
        assert kernels.chain_groups(NB, N, C) == want, (NB, N, C)


def test_chain_library_holds_the_four_chain_kernels():
    """The four chain kernels' entry points are in the chain source's
    library and in no other; K1/K2 and K4-fwd/K4-vg keep theirs."""
    from theano_pyglm_torch.ops import cuda_loader

    ep = cuda_loader.ENTRY_POINTS
    assert set(ep) == set(cuda_loader.SOURCES)
    assert ep[cuda_loader.SOURCE_CHAINS] == ("fwd_chains", "vg_chains", "fwd_chains_bf16", "vg_chains_bf16")
    assert ep[cuda_loader.SOURCE] == ("fwd", "vg") and ep[cuda_loader.SOURCE_BF16] == ("fwd_bf16", "vg_bf16")
    for name in ("fwd_chains", "fwd_chains_bf16"):
        assert [src.name for src, names in ep.items() if name in names] == ["fused_ll_chains.cu"]
    # K1/K2's wide-U instance counts under K1's and K2's keys
    assert ep[cuda_loader.SOURCE_WIDE] == ("fwd_wide", "vg_wide")
    assert sorted(n for src, names in ep.items() if src != cuda_loader.SOURCE_WIDE for n in names) == \
        sorted(kernels.LAUNCHES)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the kernel rounds it: add half an ulp of the
    10-bit mantissa and clear the 13 bits below it (bit masking)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def test_3xtf32_du_emulation_meets_float64():
    """K3-vg's dU = X_fᵀ·dI in its arithmetic, emulated: X_f and dI split
    into TF32 big and small parts by bit masking, each 8-bin k-step's
    products a_small·b_big, a_big·b_small, a_big·b_big added in turn into a
    float32 sum per 64-bin tile (each product step exact, then rounded),
    the tiles' sums into the block's in float32, the blocks' in order. At
    the flagship's widths (NB = 135, 4 chains of 27) on 1,536 bins over 3
    blocks: within 1e-6 of float64 (rel-L2), a tenth of chip_smoke.py's
    1e-5; the unsplit TF32 product misses 1e-5."""
    r = np.random.RandomState(0)
    T, NB, CN = 1536, 135, 108
    x = torch.as_tensor(0.1 * r.randn(T, NB), dtype=torch.float32)
    d = torch.as_tensor(r.poisson(0.02, (T, CN)) - 0.05 * np.exp(r.randn(T, CN) - 3.0), dtype=torch.float32)
    want = x.double().T @ d.double()

    def split(a):
        big = _tf32(a)
        return big.double(), _tf32(a - big).double()

    xb, xs = split(x)
    db, ds = split(d)
    blocks = []
    for b0 in range(0, T, 512):
        acc = torch.zeros(NB, CN)
        for t0 in range(b0, b0 + 512, 64):
            tile = torch.zeros(NB, CN)
            for k in range(t0, t0 + 64, 8):
                ks = slice(k, k + 8)
                for a, bb in ((xs, db), (xb, ds), (xb, db)):
                    tile = (tile.double() + a[ks].T @ bb[ks]).float()
            acc = acc + tile
        blocks.append(acc)
    got = sum(blocks[1:], blocks[0]).double()
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    assert rel <= 1e-6, rel
    plain = (xb.T @ db).float().double()
    assert float(torch.linalg.norm(plain - want) / torch.linalg.norm(want)) > 1e-5


@pytest.mark.parametrize("NB,N,C", [(300, 60, 4), (15, 3, 9), (500, 100, 3), (135, 27, 1)])
def test_chain_wrappers_launch_each_group(monkeypatch, NB, N, C):
    """The card's route of the chain wrappers, with the launches replaced by
    their plain versions: one K3 launch for each group of chain_groups, K1/K2
    for a chain alone, and the groups' results joined in chain order equal
    the plain version of all C chains (value, dU, dI_rest)."""
    launched = []

    def k3(with_grad, x, u, ir, s, dt):
        launched.append(("K3", u.shape[0]))
        assert u.is_contiguous() and ir.is_contiguous()
        ref = fused_poisson_ll_chains_reference if with_grad else fused_poisson_ll_chains_value_reference
        return ref(x, u, ir, s, dt)

    def k12(with_grad, x, u, ir, s, dt):
        launched.append(("K1/K2", 1))
        assert u.ndim == 2 and u.is_contiguous() and ir.is_contiguous()
        ref = kernels.fused_poisson_ll_reference if with_grad else kernels.fused_poisson_ll_value_reference
        return ref(x, u, ir, s, dt)

    monkeypatch.setattr(kernels, "_on_card", lambda *a: True)
    monkeypatch.setattr(kernels, "_launch_k3", k3)
    monkeypatch.setattr(kernels, "_launch", k12)
    ops = _torch(*_inputs(24, NB, N, C, seed=2))
    want_launches = [("K1/K2", 1) if c == 1 else ("K3", c) for c in kernels.chain_groups(NB, N, C)]
    ll_r, du_r, dir_r = fused_poisson_ll_chains_reference(*ops, DT)
    ll, du, dir_ = fused_ll_value_and_grad_chains(*ops, DT)
    assert launched == want_launches
    launched.clear()
    v = fused_ll_value_chains(*ops, DT)
    assert launched == want_launches
    assert ll.shape == v.shape == (C,) and du.shape == (C, NB, N) and dir_.shape == (C, 24, N)
    for got, ref in ((ll, ll_r), (v, ll_r), (du, du_r), (dir_, dir_r)):
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


# --- CPU: the model over a leading chain axis --------------------------------


@pytest.mark.parametrize("name", ["distance_weighted_model", "sparse_weighted_model", "sbm_weighted_model"])
def test_batched_log_joint_matches_jax_vmap(name):
    """C = 3 chains of JAX-drawn parameters carried across by
    params_from_numpy: the (C,) log-joint and its gradient over the
    continuous block against ``jax.vmap`` of JAX's log-joint, float64, 1e-6
    relative."""
    import jax
    import jax.numpy as jnp

    import theano_pyglm_tpu as tpu
    from theano_pyglm_tpu.inference.map import split_params as split_j
    from torch_parity import build_pair_light, to_np

    pop_j, pop_t, _, _, d_j, d_t = build_pair_light(tpu.make_model(name, 4), T=200)
    draws = jax.vmap(pop_j.sample)(jax.random.split(jax.random.PRNGKey(3), 3))
    p_t = params_from_numpy({k: np.asarray(v) for k, v in draws.items()}, device="cpu", dtype=torch.float64)
    p_j = {k: jnp.asarray(to_np(v)) for k, v in p_t.items()}

    def lj_j(p):
        return pop_j.log_joint(p, d_j)

    want = np.asarray(jax.vmap(lj_j)(p_j))
    opt_t, fr_t = split_params(p_t)
    opt_t = {k: v.clone().requires_grad_(True) for k, v in opt_t.items()}
    got = pop_t.log_joint({**fr_t, **opt_t}, d_t)
    assert got.shape == (3,)
    np.testing.assert_allclose(to_np(got), want, rtol=1e-6)
    got.sum().backward()
    opt_j, fr_j = split_j(p_j)
    g_j = jax.vmap(jax.grad(lambda o, f: pop_j.log_joint({**f, **o}, d_j)))(opt_j, fr_j)
    for k in g_j:
        g, w = to_np(opt_t[k].grad), np.asarray(g_j[k])
        assert np.linalg.norm(g - w) <= 1e-6 * np.linalg.norm(w), k


@pytest.mark.parametrize("mode", ["resident", "chunked", "streamed"])
def test_fused_batched_likelihood_equals_each_chain(mode):
    """float32, the fused path (K3's plain version on the CPU): C = 3 chains'
    log-likelihoods and gradients at once equal each chain alone through
    K1/K2's, resident, in time blocks (one K3 call per block) and on the
    streamed design; 1e-5 relative."""
    spec = pt.make_model("sparse_weighted_model", 4)
    pop = pt.Population(spec, device="cpu", time_chunk=None if mode == "resident" else 96)
    r = np.random.RandomState(0)
    S = r.poisson(0.05, (300, 4)).astype(np.float32)
    stim = r.randn(300, 1).astype(np.float32)
    data = pop.prepare_data(S, stim=stim, materialize_design=mode != "streamed")
    ps = [pop.sample(torch.Generator().manual_seed(c)) for c in range(3)]
    batched = {k: v.clone().requires_grad_(v.is_floating_point()) for k, v in stack_states(ps).items()}
    got = pop.log_likelihood(batched, data)
    got.sum().backward()
    for c, p in enumerate(ps):
        q = {k: v.clone().requires_grad_(v.is_floating_point()) for k, v in p.items()}
        want = pop.log_likelihood(q, data)
        want.backward()
        assert abs(float(got[c].detach()) - float(want.detach())) <= 1e-5 * abs(float(want.detach()))
        for k in ("w_ir", "W", "bias", "w_stim"):
            g, w = batched[k].grad[c], q[k].grad
            assert float(torch.linalg.norm(g - w)) <= 1e-5 * float(torch.linalg.norm(w)), k


def test_chain_views_and_stacking():
    """stack_states and chain_state are inverses on states and params."""
    pop = pt.Population(pt.make_model("distance_weighted_model", 3), device="cpu", dtype=torch.float64)
    states = [init_mcmc_state(pop, pop.sample(torch.Generator().manual_seed(c)), step_size=0.01 * (c + 1))
              for c in range(2)]
    batched = stack_states(states)
    assert isinstance(batched["imp"], HMCState) and batched["imp"].step_size.shape == (2,)
    assert batched["params"]["A"].shape == (2, 3, 3)
    for c in range(2):
        view = chain_state(batched, c)
        assert torch.equal(view["params"]["locs"], states[c]["params"]["locs"])
        assert torch.equal(view["imp"].scale["w_ir"], states[c]["imp"].scale["w_ir"])
        assert float(view["glm"].step_size) == pytest.approx(0.01 * (c + 1))


# --- CPU: the batched sweep, draw for draw ------------------------------------


def _tensor_leaves(x, where="state"):
    if isinstance(x, torch.Tensor):
        yield where, x
    elif isinstance(x, HMCState):
        for k, v in x._asdict().items():
            if v is not None:
                yield from _tensor_leaves(v, f"{where}.{k}")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _tensor_leaves(v, f"{where}.{k}")


#: the shared stimulus of tests/test_torch_variants.py (DB = 3)
SHARED_BKGD = {
    "type": "shared", "D_stim": 1, "dt_max": 0.3, "mu": 0.0, "sigma": 0.5,
    "basis": {"type": "cosine", "n_bas": 3, "a": 1.0, "b": 1.0, "norm": True},
}

#: the sweep cases: (template, the sweep's keywords)
SWEEP_CASES = {
    "distance_weighted_model": ("distance_weighted_model", {}),
    "sparse_weighted_model": ("sparse_weighted_model", {}),
    "sbm_weighted_model": ("sbm_weighted_model", {}),
    "spatiotemporal_glm": ("spatiotemporal_glm", {}),
    "shared_stimulus": ("standard_glm", {}),
    "glm_hmc": ("distance_weighted_model", {"glm_update": "hmc"}),
}


def _sweep_problem(case):
    name, sweep_kw = SWEEP_CASES[case]
    spec = pt.make_model(name, 5)
    if name == "sparse_weighted_model":  # the ER density and the weight hypers, inferred
        spec["network"]["graph"]["infer_rho"] = True
        spec["network"]["weight"]["infer_hypers"] = True
    if name == "spatiotemporal_glm":
        spec["bkgd"]["D_stim"] = 4
    if case == "shared_stimulus":
        spec["bkgd"] = dict(SHARED_BKGD)
    pop = pt.Population(spec, device="cpu", dtype=torch.float64)
    r = np.random.RandomState(0)
    S = r.poisson(0.1, (300, 5)).astype(float)
    data = pop.prepare_data(S, stim=r.randn(300, pop.D_stim))
    return pop, data, [pop.sample(torch.Generator().manual_seed(10 + c)) for c in range(3)], sweep_kw


@pytest.mark.parametrize("name", list(SWEEP_CASES))
def test_batched_sweep_equals_one_chain_runs(name, monkeypatch):
    """CPU, float64, N=5, T=300: 5 sweeps (adapting) of 3 chains in one
    batched sweep equal, chain by chain, 5 sweeps of the batched sweep at
    C = 1 and of the one-chain sweep, each with a generator seeded as that
    chain's. Every tensor of the state matches to 1e-9 of the leaf's largest
    magnitude; A and the SBM types y exactly. The sparse model's
    birth-death runs on a time subsample (each chain draws its own
    offsets). The stimulus variants: the spatiotemporal and the shared glm
    blocks (D_stim=4; DB=3) and the glm block by whitened HMC, which from a
    prior draw rejects its first 3 transitions while its step size adapts
    (its variance sums then hold only the rounding of the whitening)."""
    if name == "sparse_weighted_model":
        monkeypatch.setattr(gibbs, "SUBSAMPLE_T", 128)
        monkeypatch.setattr(gibbs, "SUBSAMPLE_BLK", 32)
    pop, data, inits, sweep_kw = _sweep_problem(name)
    sweep = make_sweep(pop, data, n_leapfrog=3, fisher_params=inits[0], **sweep_kw)

    def run(gens, state):
        for _ in range(5):
            state = sweep(gens, state, True, 1.0)
        return state

    batched = run([torch.Generator().manual_seed(100 + c) for c in range(3)],
                  init_mcmc_state(pop, stack_states(inits)))
    for c in range(3):
        got = dict(_tensor_leaves(chain_state(batched, c)))
        one_c1 = chain_state(run([torch.Generator().manual_seed(100 + c)],
                                 init_mcmc_state(pop, stack_states([inits[c]]))), 0)
        one = run(torch.Generator().manual_seed(100 + c), init_mcmc_state(pop, inits[c]))
        for want_state in (one_c1, one):
            want = dict(_tensor_leaves(want_state))
            assert set(got) == set(want)
            for k, w in want.items():
                g = got[k]
                assert g.shape == w.shape and g.dtype == w.dtype, k
                if k.endswith((".A", ".y")):
                    assert torch.equal(g, w), k
                else:
                    assert float((g - w).abs().max()) <= 1e-9 * max(float(w.abs().max()), 1e-300), k


@pytest.mark.parametrize("name,update", [("spatiotemporal_glm", "update_glm_laplace_st"),
                                         ("shared_stimulus", "update_glm_laplace_shared")])
def test_batched_sweep_calls_the_glm_update_once(name, update, monkeypatch):
    """With 3 chains the sweep calls the variant's glm Laplace update once a
    sweep, on all chains' params at once (a chain axis of 3), not once a
    chain."""
    pop, data, inits, _ = _sweep_problem(name)
    bk_type = pop.spec["bkgd"]["type"]
    fn = mcmc._GLM_LAPLACE[bk_type]
    assert fn is getattr(gibbs, update)
    calls = []

    def counted(generator, pop_, params, *args, **kw):
        calls.append((len(generator), tuple(params["bias"].shape)))
        return fn(generator, pop_, params, *args, **kw)

    monkeypatch.setitem(mcmc._GLM_LAPLACE, bk_type, counted)
    sweep = make_sweep(pop, data, n_leapfrog=3, fisher_params=inits[0])
    state = init_mcmc_state(pop, stack_states(inits))
    for _ in range(2):
        state = sweep([torch.Generator().manual_seed(100 + c) for c in range(3)], state, True, 1.0)
    assert calls == [(3, (3, 5))] * 2
    assert state["glm"].accept_rate.shape == (3,)


# --- CUDA: K3 against its plain version and against K1/K2 ----------------------


def _check_chains_on_card(x, u, ir, s):
    """float32 sums in another order: each value 1e-5 relative, dU 1e-5
    relative L2, dI_rest rtol=1e-5 / atol=1e-6 (K1/K2's limits); each
    chain's value and gradient against K2 on that chain alone, 1e-5."""
    ll_r, du_r, dir_r = fused_poisson_ll_chains_reference(x, u, ir, s, DT)
    ll, du, dir_ = fused_ll_value_and_grad_chains(x, u, ir, s, DT)
    v = fused_ll_value_chains(x, u, ir, s, DT)
    torch.cuda.synchronize()
    for got in (ll, v):
        torch.testing.assert_close(got, ll_r, rtol=1e-5, atol=0.0)
    assert float(torch.linalg.norm(du - du_r) / torch.linalg.norm(du_r)) <= 1e-5
    torch.testing.assert_close(dir_, dir_r, rtol=1e-5, atol=1e-6)
    for c in range(u.shape[0]):
        ll_c, du_c, dir_c = fused_ll_value_and_grad(x, u[c].contiguous(), ir[c].contiguous(), s, DT)
        assert abs(float(ll_c) - float(ll[c])) <= 1e-5 * abs(float(ll_c))
        assert float(torch.linalg.norm(du[c] - du_c) / torch.linalg.norm(du_c)) <= 1e-5
        torch.testing.assert_close(dir_[c], dir_c, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "T,NB,N,C,clip_bins",
    [
        (60_000, 135, 27, 4, 200),  # the flagship's 4 chains
        (30_000, 50, 10, 4, 0),  # config 3
        (60_000, 80, 16, 4, 0),  # config 4
        (240_000, 50, 10, 2, 0),  # config 2's support sampler
        (700, 15, 3, 3, 40),
        (3, 135, 27, 4, 0),  # less than one tile
        (1001, 5, 1, 8, 0),  # N=1, the most chains
        (2001, 25, 5, 3, 20),  # N=5: a 7-column micro-tile past each chain's end
        (999, 77, 9, 2, 0),  # odd NB; T·N odd, so chain 1's I_rest span is not 16-byte aligned
        (1000, 300, 60, 2, 0),  # dU over three grid_y slices
    ],
)
def test_chain_kernels_match_reference_on_card(cuda, T, NB, N, C, clip_bins):
    torch.backends.cuda.matmul.allow_tf32 = False
    arrays = _inputs(T, NB, N, C, i_shift=-3.0 if T > 1000 else 1.0, clip_bins=clip_bins)
    before = dict(kernels.LAUNCHES)
    _check_chains_on_card(*_torch(*arrays, device=cuda))
    assert kernels.LAUNCHES["vg_chains"] == before["vg_chains"] + 1
    assert kernels.LAUNCHES["fwd_chains"] == before["fwd_chains"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize(
    "T,NB,N,C",
    [
        (30_000, 300, 60, 4),  # two K3 launches of 2 chains
        (20_000, 135, 27, 9),  # past MAX_CHAINS: 5 and 4 chains
        (20_000, 500, 100, 2),  # no two chains fit: K2 (two column groups) per chain
    ],
)
def test_chain_groups_on_card(cuda, T, NB, N, C):
    """A call K3 does not take whole, in chain_groups' groups: each chain's
    value, dU and dI_rest against the plain version and against K1/K2 on
    that chain alone, at _check_chains_on_card's limits; one launch per
    group (K1/K2 per chain where a group is one chain); and the 4-chain
    log-likelihood at N = 60 through the autograd op, value and gradient."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = _torch(*_inputs(T, NB, N, C, i_shift=-3.0), device=cuda)
    groups = kernels.chain_groups(NB, N, C)
    assert len(groups) > 1
    k3, alone = sum(c > 1 for c in groups), sum(c == 1 for c in groups)
    before = dict(kernels.LAUNCHES)
    _check_chains_on_card(*ops)
    after = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    # besides the wrappers' launches, _check_chains_on_card runs K2 on each chain
    want = {**dict.fromkeys(before, 0), "fwd": alone, "vg": alone + C, "fwd_chains": k3, "vg_chains": k3}
    assert after == want, after
    x, u, ir, s = ops
    u = u.clone().requires_grad_(True)
    ll = fused_poisson_ll_chains(x, u, ir, s, DT)
    w = torch.arange(1.0, C + 1.0, device=cuda)
    (w * ll).sum().backward()
    ll_r, du_r, _ = fused_poisson_ll_chains_reference(x, u.detach(), ir, s, DT)
    torch.testing.assert_close(ll.detach(), ll_r, rtol=1e-5, atol=0.0)
    want = w[:, None, None] * du_r
    assert float(torch.linalg.norm(u.grad - want) / torch.linalg.norm(want)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize(
    "T,NB,N,C",
    [
        (60_000, 135, 27, 4),  # the flagship's 4 chains
        (240_000, 50, 10, 2),  # config 2: 12 dU tiles, all 8 warps in k-slices
        (30_000, 300, 60, 4),  # N = 60: two groups of 2 chains, dU over 3 grid_y slices
        (60_000, 135, 27, 1),  # a chain axis of 1: K4-chains (float32: K1/K2)
        (20_000, 135, 27, 9),  # past MAX_CHAINS: groups of 5 and 4 chains
    ],
)
def test_vg_chains_kernels_match_reference_on_card(cuda, T, NB, N, C, bf16):
    """The four chain kernels of csrc/fused_ll_chains.cu, K3-vg and K3-fwd
    (float32 X_f), K4-vg-chains and K4-fwd-chains (bf16 X_f), against the
    plain versions: each value 1e-5 relative, dU 1e-5 relative L2, dI_rest
    rtol=1e-5 / atol=1e-6, bit for bit repeated, one launch per group of
    chain_groups (K1/K2 for a float32 chain alone)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, u, ir, s = _torch(*_inputs(T, NB, N, C, i_shift=-3.0, clip_bins=100), device=cuda)
    if bf16:
        x = x.to(torch.bfloat16)
    tag = "_bf16" if bf16 else ""
    groups = kernels.chain_groups(NB, N, C)
    before = dict(kernels.LAUNCHES)
    ll, du, dir_ = fused_ll_value_and_grad_chains(x, u, ir, s, DT)
    again = fused_ll_value_and_grad_chains(x, u, ir, s, DT)
    v, v_again = fused_ll_value_chains(x, u, ir, s, DT), fused_ll_value_chains(x, u, ir, s, DT)
    ll_r, du_r, dir_r = fused_poisson_ll_chains_reference(x, u, ir, s, DT)
    v_r = fused_poisson_ll_chains_value_reference(x, u, ir, s, DT)
    torch.cuda.synchronize()
    launched = 2 * sum(1 for c in groups if bf16 or c > 1)
    assert kernels.LAUNCHES["vg_chains" + tag] - before["vg_chains" + tag] == launched
    assert kernels.LAUNCHES["fwd_chains" + tag] - before["fwd_chains" + tag] == launched
    torch.testing.assert_close(ll, ll_r, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(v, v_r, rtol=1e-5, atol=0.0)
    assert float(torch.linalg.norm(du - du_r) / torch.linalg.norm(du_r)) <= 1e-5
    torch.testing.assert_close(dir_, dir_r, rtol=1e-5, atol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip((ll, du, dir_), again))
    assert torch.equal(v, v_again)


@pytest.mark.cuda
def test_chain_kernels_repeat_bit_for_bit_on_card(cuda):
    ops = _torch(*_inputs(60_000, 135, 27, 4, i_shift=-3.0), device=cuda)
    before = dict(kernels.LAUNCHES)
    a, b = fused_ll_value_and_grad_chains(*ops, DT), fused_ll_value_and_grad_chains(*ops, DT)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(fused_ll_value_chains(*ops, DT), fused_ll_value_chains(*ops, DT))
    assert kernels.LAUNCHES["vg_chains"] == before["vg_chains"] + 2
    assert kernels.LAUNCHES["fwd_chains"] == before["fwd_chains"] + 2
