"""The bf16 spike design of the PyTorch port (``design_dtype=torch.bfloat16``).

On the CPU, against the JAX package's ``design_dtype=jnp.bfloat16`` path in
float32 (x64 off, its Pallas op in interpret mode as tests/test_pallas.py
runs it): the bf16 cast's bits; K4's plain versions against the fused op
without a chain axis (U in float32) and under ``vmap`` (its chain rules
round U and dI to bf16), the split between the two semantics and a chain
axis of one; the coupling current, ψ and the log-joint with its gradient,
for one chain, a chain axis, time-chunked and streamed; the float64 path;
one batched sweep; K4's launch plans. On a CUDA device (tests marked
``cuda``, skipped elsewhere): the four K4 kernels against their plain
versions.

JAX is imported inside the tests that compare with it, so the ``cuda`` tests
also run where JAX is absent: ``python -m pytest --noconftest -o addopts=""
-m cuda tests/test_torch_bf16.py``.
"""

import numpy as np
import pytest
import torch

import theano_pyglm_torch as pt
from theano_pyglm_torch.inference import gibbs
from theano_pyglm_torch.inference.map import split_params
from theano_pyglm_torch.ops import kernels
from theano_pyglm_torch.ops.kernels import (
    fused_ll_value,
    fused_ll_value_and_grad,
    fused_ll_value_and_grad_chains,
    fused_ll_value_chains,
    fused_poisson_ll,
    fused_poisson_ll_chains,
    fused_poisson_ll_chains_reference,
    fused_poisson_ll_chains_value_reference,
    fused_poisson_ll_reference,
    fused_poisson_ll_value_reference,
)

DT = 1e-3
H100_SMS = 132
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def f32_jax():
    """The bf16 path is float32 around the design: x64 off for the test, as
    in test_pallas.py."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", False)
    yield jax
    jax.config.update("jax_enable_x64", True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc to build and launch the kernels")
    return torch.device("cuda")


def _inputs(T, NB, N, C, seed=0, i_shift=1.0, clip_bins=0):
    """float32 numpy operands: X_f (T, NB) (to be cast to bf16), U (C, NB, N),
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


def _torch(x, u, ir, s, device="cpu"):
    """The operands as the port takes them: X_f in bf16, the rest float32."""
    x_t = torch.as_tensor(x, device=device).to(BF16)
    return [x_t] + [torch.as_tensor(a, device=device) for a in (u, ir, s)]


def _rel(got, want) -> float:
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want.detach().cpu() if isinstance(want, torch.Tensor) else want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


# --- CPU: the bf16 cast and the design ----------------------------------------


def test_bf16_rounding_matches_jax_bits(f32_jax):
    """torch's and JAX's float32 → bf16 casts give the same bits: round to
    nearest, ties to even, on random values, exact ties, subnormals and
    values past bf16's largest finite."""
    import jax.numpy as jnp

    r = np.random.RandomState(0)
    # finite float32 values halfway between two bf16 values (upper halves
    # below 0x7f80, the first with an all-ones exponent)
    ties = (r.randint(0, 0x7F80, 500).astype(np.uint32) << 16 | 0x8000).view(np.float32)
    x = np.concatenate([
        r.randn(5000).astype(np.float32) * np.float32(10.0) ** r.randint(-30, 30, 5000),
        ties, -ties, np.float32([1e-40, -3e-39, 3.39e38, -3.4e38, 0.0, -0.0]),
    ]).astype(np.float32)
    got = _bf16_bits(torch.as_tensor(x).to(BF16))
    want = _bf16_bits(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(got, want)


def test_prepare_data_bf16_design_bits(f32_jax):
    """The resident X_imp (centred in float32, then cast) and a streamed
    block's design are the bf16 cast of the float32 design the port builds,
    bit for bit as JAX casts it (astype, as its prepare_data and its
    streamed blocks do); the column means stay float32."""
    import jax.numpy as jnp

    spec = pt.make_model("distance_weighted_model", 4, bias={"mu": 3.0, "sigma": 0.4})
    r = np.random.RandomState(0)
    S, stim = r.poisson(0.05, (1000, 4)).astype(np.float32), r.randn(1000, 1).astype(np.float32)
    f32 = pt.Population(spec, device="cpu", dtype=torch.float32)
    bf = pt.Population(spec, device="cpu", dtype=torch.float32, design_dtype=BF16)
    d32, d16 = f32.prepare_data(S, stim=stim), bf.prepare_data(S, stim=stim)
    assert d16["X_imp"].dtype == BF16 and d16["_X_imp_mean"].dtype == torch.float32
    torch.testing.assert_close(d16["_X_imp_mean"], d32["_X_imp_mean"], rtol=0, atol=0)
    want = _bf16_bits(jnp.asarray(d32["X_imp"].numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(_bf16_bits(d16["X_imp"]), want)

    chunked32 = pt.Population(spec, device="cpu", time_chunk=300)
    chunked16 = pt.Population(spec, device="cpu", time_chunk=300, design_dtype=BF16)
    s32 = chunked32.prepare_data(S, stim=stim, materialize_design=False)
    s16 = chunked16.prepare_data(S, stim=stim, materialize_design=False)
    for t0 in (0, 300, 900):
        b32, b16 = chunked32._block(s32, t0)["X_imp"], chunked16._block(s16, t0)["X_imp"]
        assert b16.dtype == BF16
        np.testing.assert_array_equal(_bf16_bits(b16), _bf16_bits(jnp.asarray(b32.numpy()).astype(jnp.bfloat16)))


# --- CPU: K4's plain versions against the JAX op -------------------------------


def _jax_one(jax, x, u, ir, s):
    """The JAX op without a chain axis on a bf16 X_f: value and gradients."""
    import jax.numpy as jnp
    from theano_pyglm_tpu.ops.pallas_kernels import fused_poisson_ll as jax_fused

    xj = jnp.asarray(x).astype(jnp.bfloat16)
    val, (gu, gir) = jax.value_and_grad(lambda u_, ir_: jax_fused(xj, u_, ir_, s, DT, True), argnums=(0, 1))(u, ir)
    return float(val), np.asarray(gu), np.asarray(gir)


def _jax_chains(jax, x, u, ir, s):
    """The JAX op vmapped over the chains of u and ir (X_f and S shared), a
    bf16 X_f: the (C,) values and each chain's unit-cotangent gradients."""
    import jax.numpy as jnp
    from theano_pyglm_tpu.ops.pallas_kernels import fused_poisson_ll as jax_fused

    xj = jnp.asarray(x).astype(jnp.bfloat16)
    per_chain = jax.vmap(lambda u_, ir_: jax_fused(xj, u_, ir_, s, DT, True))
    gu, gir = jax.grad(lambda u_, ir_: jnp.sum(per_chain(u_, ir_)), argnums=(0, 1))(u, ir)
    return np.asarray(per_chain(u, ir)), np.asarray(gu), np.asarray(gir)


@pytest.mark.parametrize("clip_bins", [0, 40])
def test_one_chain_reference_matches_jax(f32_jax, clip_bins):
    """K4-fwd's and K4-vg's plain versions: value 1e-5 relative, dU 1e-5
    relative L2, dI_rest 1e-5 (rtol, atol 1e-6): float32 sums in another
    order (measured: 1e-7, 4e-7, 6e-8)."""
    x, u, ir, s = _inputs(1500, 20, 4, 1, clip_bins=clip_bins)
    want, gu, gir = _jax_one(f32_jax, x, u[0], ir[0], s)
    xt, ut, irt, st = _torch(x, u[0], ir[0], s)
    ll, du, dir_ = fused_poisson_ll_reference(xt, ut, irt, st, DT)
    assert abs(float(ll) - want) <= 1e-5 * abs(want)
    assert abs(float(fused_poisson_ll_value_reference(xt, ut, irt, st, DT)) - want) <= 1e-5 * abs(want)
    assert _rel(du, gu) <= 1e-5
    np.testing.assert_allclose(dir_.numpy(), gir, rtol=1e-5, atol=1e-6)
    if clip_bins:
        assert (dir_.numpy() == 0).sum() >= clip_bins


@pytest.mark.parametrize("clip_bins", [0, 40])
def test_chain_reference_matches_jax_chain_rules(f32_jax, clip_bins):
    """K4-fwd-chains' and K4-vg-chains' plain versions on C = 3 chains:
    each value 1e-5 relative, dI_rest 1e-5, dU 1e-5 relative L2 (tighter
    than the 1e-3 a bf16(dI) that rounds to a neighbour in a few entries
    could need: measured 8e-7)."""
    x, u, ir, s = _inputs(1500, 20, 4, 3, clip_bins=clip_bins)
    want, gu, gir = _jax_chains(f32_jax, x, u, ir, s)
    ops = _torch(x, u, ir, s)
    ll, du, dir_ = fused_poisson_ll_chains_reference(*ops, DT)
    np.testing.assert_allclose(ll.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(fused_poisson_ll_chains_value_reference(*ops, DT).numpy(), want, rtol=1e-5)
    assert _rel(du, gu) <= 1e-5
    np.testing.assert_allclose(dir_.numpy(), gir, rtol=1e-5, atol=1e-6)
    if clip_bins:
        assert (dir_.numpy() == 0).sum() >= clip_bins


def test_chain_axis_of_one_keeps_the_chain_semantics(f32_jax):
    """A bf16 X_f splits the semantics: a chain axis of 1 (JAX's vmap of
    size 1) rounds U and dI, no chain axis does not. dU differs between
    the two by ~1e-3 relative L2 (bf16's half-ulp), 1,000 times what the
    port and JAX differ by within one semantics, and each value of the port
    lies ten times nearer JAX's of the same semantics than the other's. A
    float32 X_f has one semantics: the two agree to 1e-6."""
    x, u, ir, s = _inputs(1500, 20, 4, 1)
    one_j, gu_one, _ = _jax_one(f32_jax, x, u[0], ir[0], s)
    ch_j, gu_ch, _ = _jax_chains(f32_jax, x, u, ir, s)
    xt, ut, irt, st = _torch(x, u, ir, s)
    one_t, du_one, _ = fused_ll_value_and_grad(xt, ut[0], irt[0], st, DT)
    ch_t, du_ch, _ = fused_ll_value_and_grad_chains(xt, ut, irt, st, DT)
    assert _rel(gu_ch[0], gu_one) > 1e-4 and _rel(du_ch[0], du_one) > 1e-4
    assert _rel(du_one, gu_one) < 1e-5 and _rel(du_ch, gu_ch) < 1e-5
    split = abs(float(ch_j[0]) - one_j)
    assert abs(float(one_t) - one_j) < split / 10 and abs(float(ch_t[0]) - float(ch_j[0])) < split / 10
    x32 = torch.as_tensor(x)
    v1, d1, _ = fused_ll_value_and_grad(x32, ut[0], irt[0], st, DT)
    vc, dc, _ = fused_ll_value_and_grad_chains(x32, ut, irt, st, DT)
    assert abs(float(vc[0]) - float(v1)) <= 1e-6 * abs(float(v1)) and _rel(dc[0], d1) <= 1e-6


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_chain_groups_route_a_group_of_one(monkeypatch, dtype):
    """On the card every group of a bf16 call is a K4-chains launch, a
    chain alone included (N = 100 at NB = 500: K3 takes no two chains, so
    the groups are one chain each); with a float32 X_f a chain alone is
    K1/K2's. The wrappers are spied on, the launches replaced by the plain
    version."""
    calls = []

    def k3(with_grad, x_f, u, *rest):
        calls.append(("chains", u.shape[0]))
        ref = fused_poisson_ll_chains_reference if with_grad else fused_poisson_ll_chains_value_reference
        return ref(x_f, u, *rest)

    def k1k2(with_grad, x_f, *rest):
        calls.append(("one", 1))
        return (fused_poisson_ll_reference if with_grad else fused_poisson_ll_value_reference)(x_f, *rest)

    monkeypatch.setattr(kernels, "_check_chains", lambda *a: True)
    monkeypatch.setattr(kernels, "_launch_k3", k3)
    monkeypatch.setattr(kernels, "_launch", k1k2)
    assert kernels.chain_groups(500, 100, 2) == (1, 1)
    x, u, ir, s = _inputs(40, 500, 100, 2)
    ops = _torch(x, u, ir, s)
    ops[0] = ops[0].to(dtype)
    fused_ll_value_and_grad_chains(*ops, DT)
    fused_ll_value_chains(*ops, DT)
    want = ("chains", 1) if dtype == BF16 else ("one", 1)
    assert calls == [want] * 4


def test_autograd_ops_take_a_bf16_design():
    """The autograd ops carry the bf16 X_f as data (no gradient) and scale
    the residuals of the plain versions by the cotangent."""
    x, u, ir, s = _inputs(300, 10, 2, 3, seed=2)
    xt, ut, irt, st = _torch(x, u, ir, s)
    u1 = ut[0].clone().requires_grad_(True)
    (2.5 * fused_poisson_ll(xt, u1, irt[0], st, DT)).backward()
    torch.testing.assert_close(u1.grad, 2.5 * fused_poisson_ll_reference(xt, ut[0], irt[0], st, DT)[1])
    uc = ut.clone().requires_grad_(True)
    w = torch.tensor([1.0, 2.0, 3.0])
    (w * fused_poisson_ll_chains(xt, uc, irt, st, DT)).sum().backward()
    torch.testing.assert_close(uc.grad, w[:, None, None] * fused_poisson_ll_chains_reference(xt, ut, irt, st, DT)[1])
    assert xt.grad is None


# --- CPU: the model's bf16 branches against JAX's ------------------------------


def _pair(N=4, T=1200, chains=None, seed=0, **pop_kw):
    """(pop_j, pop_t, params_j, params_t, data_j, data_t) in float32 with a
    bf16 design: the port's parameters (a CPU generator; ``chains`` of them
    stacked on a leading axis) and design (cast to bf16 by each package from
    the port's float32 one), carried into JAX (use_pallas=True)."""
    import jax.numpy as jnp

    import theano_pyglm_tpu as tpu

    spec = pt.make_model("distance_weighted_model", N, bias={"mu": 3.0, "sigma": 0.4})
    pop_t = pt.Population(spec, device="cpu", design_dtype=BF16, **pop_kw)
    pop_j = tpu.Population(spec, use_pallas=True, design_dtype=jnp.bfloat16, **pop_kw)
    g = torch.Generator().manual_seed(seed)
    draws = [pop_t.sample(g) for _ in range(chains or 1)]
    params_t = draws[0] if chains is None else {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
    r = np.random.RandomState(seed)
    S, stim = r.poisson(0.05, (T, N)).astype(np.float32), r.randn(T, 1).astype(np.float32)
    data_t = pop_t.prepare_data(S, stim=stim)
    data_j = {k: jnp.asarray(v.numpy()) for k, v in pt.Population(spec, device="cpu").prepare_data(S, stim=stim).items()}
    data_j["X_imp"] = data_j["X_imp"].astype(jnp.bfloat16)
    params_j = {k: jnp.asarray(v.numpy()) for k, v in params_t.items()}
    return pop_j, pop_t, params_j, params_t, data_j, data_t


def _value_and_grad_t(pop, params, data):
    opt, frozen = split_params(params)
    opt = {k: v.clone().requires_grad_(True) for k, v in opt.items()}
    val = pop.log_joint({**frozen, **opt}, data)
    val.sum().backward()
    return val.detach().numpy(), {k: v.grad.numpy() for k, v in opt.items()}


def _value_and_grad_j(jax, pop, params, data, chains=False):
    from theano_pyglm_tpu.inference.map import split_params as split_j

    opt, frozen = split_j(params)

    def lj(o, f):
        return pop.log_joint({**f, **o}, data)

    if chains:
        val = jax.vmap(lj)(opt, frozen)
        g = jax.vmap(jax.grad(lj))(opt, frozen)
    else:
        val, g = jax.value_and_grad(lj)(opt, frozen)
    return np.asarray(val), {k: np.asarray(v) for k, v in g.items()}


def test_coupling_current_and_psi_match_jax(f32_jax):
    """The coupling current (w_eff and G rounded to bf16 apart, the mean
    term in float32), ψ in float32 (compute_psi) and the adjacency stage's
    bf16 ψ rows (_psi_from_X, the mean term added before the rounding)
    against JAX's, one chain and three chains (JAX vmapped): float32
    currents 1e-6 relative L2 (sums in another order); ψ rows in bf16 equal
    but where the float32 sums, taken in another order, round to
    neighbouring bf16 values: one bf16 ulp at most, in at most 1 % of the
    entries (measured 0.27 %: a presynaptic neuron silent over many bins
    repeats one value of ψ, and so one straddled rounding, many times)."""
    import jax
    import jax.numpy as jnp
    from theano_pyglm_tpu.inference import gibbs as gibbs_j

    pop_j, pop_t, p_j, p_t, d_j, d_t = _pair(chains=3)

    def current_j(p):
        return pop_j.impulse.current(p, {**d_j, "_G": pop_j.coupling(p)})

    want = np.asarray(jax.vmap(current_j)(p_j))
    got = pop_t.impulse.current(p_t, {**d_t, "_G": pop_t.coupling(p_t)})
    assert got.dtype == torch.float32 and got.shape == (3, 1200, 4)
    assert _rel(got, want) <= 1e-6
    for c in range(3):
        p1_t = {k: v[c] for k, v in p_t.items()}
        p1_j = {k: v[c] for k, v in p_j.items()}
        assert _rel(pop_t.impulse.current(p1_t, {**d_t, "_G": pop_t.coupling(p1_t)}), want[c]) <= 1e-6
        psi_t, psi_j = gibbs.compute_psi(pop_t, p1_t, d_t), gibbs_j.compute_psi(pop_j, p1_j, d_j)
        assert psi_t.dtype == torch.float32 and _rel(psi_t, psi_j) <= 1e-6
        w_eff = pop_t.impulse.effective(p1_t)
        rows = gibbs._psi_from_X(d_t["X_imp"], d_t["_X_imp_mean"], w_eff)  # (M, R, T)
        assert rows.dtype == BF16
        w_eff_j = jnp.asarray(w_eff.numpy())
        for n in range(4):
            want_n = gibbs_j._psi_from_X(d_j["X_imp"], d_j["_X_imp_mean"], w_eff_j[n])  # (T, M)
            assert want_n.dtype == jnp.bfloat16
            got_n, want_n = rows[:, n].T.float().numpy(), np.asarray(want_n.astype(jnp.float32))
            off = got_n != want_n
            assert off.mean() <= 1e-2
            assert np.all(np.abs(got_n - want_n)[off] <= 2.0**-7 * np.abs(want_n)[off])


def test_log_joint_and_gradient_match_jax(f32_jax):
    """One chain: the log-joint 1e-5 relative and each leaf's gradient 1e-5
    relative L2 against JAX's bf16 design with its Pallas op (U in
    float32)."""
    pop_j, pop_t, p_j, p_t, d_j, d_t = _pair()
    v_t, g_t = _value_and_grad_t(pop_t, p_t, d_t)
    v_j, g_j = _value_and_grad_j(f32_jax, pop_j, p_j, d_j)
    assert abs(float(v_t) - float(v_j)) <= 1e-5 * abs(float(v_j))
    assert set(g_t) == set(g_j)
    for k in g_j:
        assert _rel(g_t[k], g_j[k]) <= 1e-5, k


def test_batched_log_joint_matches_jax_vmap(f32_jax):
    """Three chains on a leading axis against JAX's vmapped log-joint (its
    chain rules: U and dI rounded to bf16): each value 1e-5 relative, each
    leaf's gradient 1e-3 relative L2 (the chain dU's limit: a few float32
    dI may round to neighbouring bf16 values)."""
    pop_j, pop_t, p_j, p_t, d_j, d_t = _pair(chains=3)
    v_t, g_t = _value_and_grad_t(pop_t, p_t, d_t)
    v_j, g_j = _value_and_grad_j(f32_jax, pop_j, p_j, d_j, chains=True)
    assert v_t.shape == (3,)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-5)
    for k in g_j:
        assert _rel(g_t[k], g_j[k]) <= 1e-3, k


@pytest.mark.parametrize("batch", [32, 3, 1])
def test_bf16_predictive_log_likelihood_takes_the_chain_semantics(f32_jax, batch):
    """The held-out predictive log-likelihood of 7 draws with a bf16
    design against JAX's predictive_log_likelihood at the same batch: JAX
    vmaps every block of draws (lax.map with batch_size, the remainder
    included), so its fused op takes the chain rules (U rounded to bf16).
    The port, each block one evaluation with a chain axis, lies within a
    tenth of the gap between the two semantics (that gap: each draw
    evaluated without a chain axis, U in float32), so evaluating draw by
    draw fails it; and within 1e-6 relative."""
    import math

    from theano_pyglm_torch.inference import predictive as pred_t
    from theano_pyglm_tpu.inference import predictive as pred_j

    pop_j, pop_t, _, p_t, d_j, d_t = _pair(chains=7)
    stack = {k: v.numpy() for k, v in p_t.items()}
    want = float(pred_j.predictive_log_likelihood(pop_j, stack, d_j, batch=batch))
    with torch.no_grad():
        one = torch.stack([pop_t.log_likelihood({k: v[i] for k, v in p_t.items()}, d_t) for i in range(7)])
    gap = abs(float(torch.logsumexp(one, 0)) - math.log(7) - want)
    got = float(pred_t.predictive_log_likelihood(pop_t, stack, d_t, batch=batch))
    assert gap > 0 and abs(got - want) < gap / 10
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("streamed", [False, True])
def test_time_chunked_log_joint_matches_jax(f32_jax, streamed):
    """Blocks of 500 bins over T=1200 (the last ragged). The port's fused
    path launches one K4 per block, f32(X)·U as JAX's unchunked Pallas op
    (JAX skips its fused op under chunking): value 1e-5 relative, gradient
    1e-5 relative L2 against JAX's unchunked. Its plain path
    (use_fused=False) takes the coupling current's bf16 branch as JAX's
    chunked path does: the same limits against JAX with time_chunk=500.
    Streamed: no X_imp, each block's design rebuilt from the spikes
    (uncentred) and cast; the fused path against JAX's Pallas op on the
    same uncentred design cast whole, the plain path against JAX's streamed
    chunks."""
    import jax.numpy as jnp

    import theano_pyglm_tpu as tpu

    pop_j, _, p_j, p_t, d_j, d_t = _pair()
    spec = pop_j.spec
    fused = pt.Population(spec, device="cpu", design_dtype=BF16, time_chunk=500)
    plain = pt.Population(spec, device="cpu", design_dtype=BF16, time_chunk=500, use_fused=False)
    chunked_j = tpu.Population(spec, use_pallas=True, design_dtype=jnp.bfloat16, time_chunk=500)
    if streamed:
        from theano_pyglm_torch.ops.convolve import convolve_with_basis

        r = np.random.RandomState(0)
        S, stim = r.poisson(0.05, (1200, 4)).astype(np.float32), r.randn(1200, 1).astype(np.float32)
        d_t = fused.prepare_data(S, stim=stim, materialize_design=False)
        d_cj = chunked_j.prepare_data(S, stim=stim, materialize_design=False)
        assert "X_imp" not in d_t
        X = convolve_with_basis(torch.as_tensor(S), torch.as_tensor(fused.basis_imp, dtype=torch.float32))
        d_j = {k: v for k, v in d_j.items() if k != "_X_imp_mean"}
        d_j["X_imp"] = jnp.asarray(X.numpy()).astype(jnp.bfloat16)
    else:
        d_cj = d_j
    v_u, g_u = _value_and_grad_j(f32_jax, pop_j, p_j, d_j)
    v_c, g_c = _value_and_grad_j(f32_jax, chunked_j, p_j, d_cj)
    for pop, v_want, g_want in ((fused, v_u, g_u), (plain, v_c, g_c)):
        v, g = _value_and_grad_t(pop, p_t, d_t)
        assert abs(float(v) - float(v_want)) <= 1e-5 * abs(float(v_want)), pop.use_fused
        for k in g_want:
            assert _rel(g[k], g_want[k]) <= 1e-5, (k, pop.use_fused)


def test_float64_with_bf16_design_matches_jax_x64():
    """Float64 (CPU verification) with a bf16 design runs the per-neuron
    path, as JAX does under x64 (its Pallas op off): the log-joint 1e-6
    relative and its gradient 1e-6 relative L2 against JAX's, whose bf16
    einsum accumulates in float32 (the port's in float64)."""
    import jax
    import jax.numpy as jnp

    import theano_pyglm_tpu as tpu

    spec = pt.make_model("distance_weighted_model", 4, bias={"mu": 3.0, "sigma": 0.4})
    pop_t = pt.Population(spec, device="cpu", dtype=torch.float64, design_dtype=BF16)
    pop_j = tpu.Population(spec, use_pallas=True, design_dtype=jnp.bfloat16)
    p_t = pop_t.sample(torch.Generator().manual_seed(0))
    r = np.random.RandomState(0)
    S, stim = r.poisson(0.05, (800, 4)).astype(float), r.randn(800, 1)
    d_t = pop_t.prepare_data(S, stim=stim)
    assert d_t["X_imp"].dtype == BF16 and not pop_t._fused_active(d_t)
    d_j = {k: jnp.asarray(v.numpy()) for k, v in pt.Population(spec, device="cpu", dtype=torch.float64)
           .prepare_data(S, stim=stim).items()}
    d_j["X_imp"] = jnp.asarray(d_t["X_imp"].float().numpy()).astype(jnp.bfloat16)
    p_j = {k: jnp.asarray(v.numpy()) for k, v in p_t.items()}
    v_t, g_t = _value_and_grad_t(pop_t, p_t, d_t)
    v_j, g_j = _value_and_grad_j(jax, pop_j, p_j, d_j)
    assert abs(float(v_t) - float(v_j)) <= 1e-6 * abs(float(v_j))
    for k in g_j:
        assert _rel(g_t[k], g_j[k]) <= 1e-6, k


def test_batched_bf16_sweep_runs(monkeypatch):
    """One batched sweep of 3 chains with a bf16 design, N=4, T=600: every
    leaf finite, A binary, the adjacency stage's ψ rows bf16, and the
    sampler's likelihood through the chain semantics (a spy on the plain
    chain versions sees the bf16 X_f)."""
    from theano_pyglm_torch.inference.mcmc import init_mcmc_state, make_sweep, stack_states

    spec = pt.make_model("distance_weighted_model", 4, bias={"mu": 3.0, "sigma": 0.4})
    pop = pt.Population(spec, device="cpu", design_dtype=BF16)
    g = torch.Generator().manual_seed(0)
    true = pop.sample(g)
    stim = np.random.RandomState(1).randn(600, 1).astype(np.float32)
    S, _ = pop.simulate(g, true, 600, stim=stim)
    data = pop.prepare_data(S, stim=stim)
    psi_dtypes, x_dtypes = set(), set()
    psi_from_x, chains_ref = gibbs._psi_from_X, kernels.fused_poisson_ll_chains_reference
    monkeypatch.setattr(gibbs, "_psi_from_X", lambda *a: psi_dtypes.add(psi_from_x(*a).dtype) or psi_from_x(*a))
    monkeypatch.setattr(kernels, "fused_poisson_ll_chains_reference",
                        lambda x_f, *a: x_dtypes.add(x_f.dtype) or chains_ref(x_f, *a))
    inits = [pop.sample(torch.Generator().manual_seed(10 + c)) for c in range(3)]
    sweep = make_sweep(pop, data, n_leapfrog=3, fisher_params=inits[0])
    state = sweep([torch.Generator().manual_seed(20 + c) for c in range(3)],
                  init_mcmc_state(pop, stack_states(inits)), True, 1.0)
    for k, v in state["params"].items():
        assert v.shape[0] == 3 and bool(torch.isfinite(v).all()), k
    assert bool(((state["params"]["A"] == 0) | (state["params"]["A"] == 1)).all())
    assert psi_dtypes == {BF16} and x_dtypes == {BF16}


# --- CPU: K4's launch plans -------------------------------------------------------


def _block_tiles(plan, T):
    return [
        [(i * plan.tile_t, min(T, (i + 1) * plan.tile_t)) for i in range(b, plan.n_tiles, plan.grid_x)]
        for b in range(plan.grid_x)
    ]


@pytest.mark.parametrize("chains", [None, 1, 4, 8])
@pytest.mark.parametrize("T", [1, 63, 700, 60_000, kernels.TILE_MAX * H100_SMS * 2 + 1])
def test_bf16_launch_plan_tiles_cover_time_once(T, chains):
    """K4 (no chain axis) and K4-chains at NB=135, N=27: every bin in one
    tile, tiles of 8s (a tile's bf16 X_f span, 16·NB bytes a step, starts on
    16 bytes at odd NB) up to TILE_MAX (K4-chains: the unit cap, which for
    the value kernel's 32-bin units may pass it), no block more than one
    tile above another, the shared memory within the limit and the
    mirror's."""
    for grad in (False, True):
        plan = kernels.launch_plan(T, 135, 27, H100_SMS, grad, chains=chains, x_bytes=2)
        most = kernels._unit_rows_cap(27, chains, grad) if chains else kernels.TILE_MAX
        assert plan.tile_t % 8 == 0 and 8 <= plan.tile_t <= most
        assert all((t0 * 135 * 2) % 16 == 0 for t0 in range(0, T, plan.tile_t))
        per_block = _block_tiles(plan, T)
        spans = sorted(span for tiles in per_block for span in tiles)
        assert spans[0][0] == 0 and spans[-1][1] == T
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        counts = [len(tiles) for tiles in per_block]
        assert min(counts) >= 1 and max(counts) - min(counts) <= 1
        assert plan.smem_bytes <= kernels.SMEM_LIMIT and plan.groups == 1
        want = (kernels._smem_bytes_bf16(135, 27, plan.tile_t) if chains is None
                else kernels._smem_bytes_chains(135, 27, chains, plan.tile_t, True, grad))
        assert plan.smem_bytes == want
        want_y = (-(-kernels.mma_tiles(135, 27, chains) // (kernels.WARPS * kernels.WARP_TILES))
                  if chains else kernels.k4_du_slices(135, 27))
        assert plan.grid_y == (want_y if grad else 1)


def test_bf16_launch_plan_flagship_and_limits():
    """The flagship plans at C = 4 in one dU slice (126 mma tiles); the bf16
    X_f frees shared memory, so the chain kernel holds every chain count
    that K3 holds, and a group of one chain where K3 takes none (N = 100).
    K4 takes column groups of its own (N = 100 at NB = 500: four, of at
    most 32 columns); the chain kernel none, and past MAX_CHAINS or in
    column groups it raises."""
    for grad in (False, True):
        plan = kernels.launch_plan(60_000, 135, 27, H100_SMS, grad, chains=4, x_bytes=2)
        assert plan.grid_y == 1 and plan.grid_x == H100_SMS and plan.tile_t >= 60
    for N, C in ((27, 8), (46, 4), (64, 2), (10, 4), (16, 4)):
        assert kernels._k3_fits(5 * N, N, C)
        for grad in (False, True):
            bf16, f32 = (kernels._smem_bytes_chains(5 * N, N, C, 8, b, grad) for b in (True, False))
            assert bf16 < f32
    assert kernels.launch_plan(600_000, 500, 100, H100_SMS, True, chains=1, x_bytes=2).groups == 1
    plan = kernels.launch_plan(600_000, 500, 100, H100_SMS, True, x_bytes=2)
    assert (plan.groups, plan.group_cols, plan.tile_t) == (4, 32, 32)
    with pytest.raises(ValueError, match="K4-chains takes"):
        kernels.launch_plan(1000, 15, 3, H100_SMS, True, chains=kernels.MAX_CHAINS + 1, x_bytes=2)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.launch_plan(1000, 1500, 300, H100_SMS, True, chains=1, x_bytes=2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernels.launch_plan(1000, 15, 3, H100_SMS, True, x_bytes=8)


def test_bf16_value_chains_plans():
    """K4-fwd-chains, the value-only instance of the chain source on a bf16
    X_f: at the flagship and configs 2-4 one slice, tiles of 8s up to the
    unit cap (units of 32 bins × up to VALUE_TILES n-tiles, one a warp: the
    flagship's 64 bins in four n-groups, config 2's 256 in one, configs 3
    and 4's 128 in two), the shared memory the mirror's, K4-vg-chains' less
    its bf16 dI copy; and every group that chain_groups gives at NB = 5N up
    to N = 64 plans."""
    cases = {(60_000, 135, 27, 4): 64, (240_000, 50, 10, 2): 256, (30_000, 50, 10, 4): 128,
             (60_000, 80, 16, 4): 128}
    for (T, NB, N, C), cap in cases.items():
        plan = kernels.launch_plan(T, NB, N, H100_SMS, False, chains=C, x_bytes=2)
        assert plan.grid_y == 1 and plan.groups == 1 and plan.tile_t % 8 == 0
        assert kernels._unit_rows_cap(N, C, grad=False) == cap and plan.tile_t <= cap
        vg = kernels._smem_bytes_chains(NB, N, C, plan.tile_t, True, grad=True)
        dI = 4 * -(-(C * N) // 8) * 8 * kernels._odd4(-(-plan.tile_t // 16) * 8)
        assert plan.smem_bytes == vg - dI <= kernels.SMEM_LIMIT
    for n in range(1, 65):
        for c in set(kernels.chain_groups(5 * n, n, 8)):
            plan = kernels.launch_plan(1000, 5 * n, n, H100_SMS, False, chains=c, x_bytes=2)
            assert plan.smem_bytes <= kernels.SMEM_LIMIT


# K4-fwd's and K4-vg's shapes on chip_smoke.py's paths: the flagship,
# configs 1-4 and the long recording's three (N = 100, in column groups)
K4_SHAPES = [(60_000, 135, 27), (60_000, 5, 1), (240_000, 50, 10), (30_000, 50, 10), (60_000, 80, 16),
             (600_000, 500, 100), (65_536, 500, 100), (10_176, 500, 100)]


def _k4_groups_of(N, W):
    """The column groups' n-tile counts (group q: n-tiles q·NT/G up to
    (q + 1)·NT/G)."""
    nt = -(-N // 8)
    G = -(-nt // -(-W // 8))
    return [(q + 1) * nt // G - q * nt // G for q in range(G)]


@pytest.mark.parametrize("T,NB,N", K4_SHAPES)
def test_k4_smem_mirror_is_the_layout(T, NB, N):
    """The plan's shared memory is the layout's, counted here from its
    parts: U split into TF32 big and small parts (a uint4 a lane, k-step of
    8 and n-tile of the widest group), two stages of X_f (ceil16(tile) rows
    and 16 values more, in bf16) with the I_rest and S spans (8 words past
    their rows), and the forward's join slots where units split their
    k-steps; within the limit, the groups at most K4_GROUP_TILES n-tiles, the
    tile at least K4_MIN_TILE bins where T allows."""
    for grad in (False, True):
        plan = kernels.launch_plan(T, NB, N, H100_SMS, grad, x_bytes=2)
        sizes = _k4_groups_of(N, plan.group_cols)
        assert len(sizes) == plan.groups and max(sizes) - min(sizes) <= 1
        assert max(sizes) <= kernels.K4_GROUP_TILES and plan.group_cols == (N if plan.groups == 1 else 8 * max(sizes))
        rt, ks = -(-plan.tile_t // 16) * 16, -(-NB // 8)
        u_words = ks * max(sizes) * 32 * 4
        x_words = -(-(rt * NB + 16) // 8) * 8 // 2
        span = -(-(plan.tile_t * plan.group_cols) // 4) * 4 + 8
        join = 0
        for ntg in set(sizes):
            ngf, units, kf, width = kernels._k4_fwd_split(rt, ntg, ks)
            join = max(join, units * kf * 32 * 8 * width if kf > 1 else 0)
        assert plan.smem_bytes == 4 * (u_words + 2 * (x_words + 2 * span) + join) <= kernels.SMEM_LIMIT
        assert plan.tile_t >= min(kernels.K4_MIN_TILE, -(-T // 8) * 8)
    if N == 100:
        assert (plan.groups, plan.group_cols, plan.tile_t, plan.grid_x) == (4, 32, 32, H100_SMS // 4)


@pytest.mark.parametrize("T,NB,N", K4_SHAPES + [(3, 135, 27), (999, 77, 9), (1000, 1500, 300)])
def test_k4_vg_items_cover_every_item_once(T, NB, N):
    """K4-vg's dU tiles (16 × 8 items): in each column group and k-slice
    every item in one warp's rows exactly once, at most WARP_TILES a warp,
    whole m-rows a warp; the k-slices' joined rows fit in the shared
    memory."""
    plan = kernels.launch_plan(T, NB, N, H100_SMS, True, x_bytes=2)
    runs = kernels.k4_vg_items(NB, N, plan.group_cols, plan.grid_y)
    ksl = 1 + max(kk for _, kk, _ in runs)
    rows_a_slice = min(16 * -(-(-(-NB // 16)) // plan.grid_y), NB)
    assert kernels.WARPS % ksl == 0 and 4 * ksl * rows_a_slice * plan.group_cols <= plan.smem_bytes
    mt = -(-NB // 16)
    assert len(runs) == plan.groups * plan.grid_y * kernels.WARPS
    for q, ntg in enumerate(_k4_groups_of(N, plan.group_cols)):
        want = sorted((m, n) for m in range(mt) for n in range(ntg))
        for k in range(ksl):
            got = sorted(it for grp, kk, items in runs if grp == q and kk == k for it in items)
            assert got == want, (q, k)
    for _, kk, items in runs:
        assert 0 <= kk < ksl and len(items) <= kernels.WARP_TILES
        rows = {m for m, _ in items}
        assert len(items) == len(rows) * max((n for _, n in items), default=-1) + len(rows)


@pytest.mark.parametrize("T,NB,N", K4_SHAPES + [(3, 135, 27), (999, 77, 9)])
def test_k4_forward_units_cover_the_tile_once(T, NB, N):
    """K4's forward: the units (32 bins × up to K4_UNIT_TILES n-tiles) and
    their k-slices cover each (row pair, n-tile, k-step) of a tile once, on
    at most 8 warps where the k-steps are split, and as many warps a unit as
    a power of 2 allows, a k-step a warp at least."""
    plan = kernels.launch_plan(T, NB, N, H100_SMS, False, x_bytes=2)
    rt, ks = -(-plan.tile_t // 16) * 16, -(-NB // 8)
    for ntg in set(_k4_groups_of(N, plan.group_cols)):
        ngf, units, kf, width = kernels._k4_fwd_split(rt, ntg, ks)
        assert width <= kernels.K4_UNIT_TILES and units == -(-rt // 32) * ngf
        assert kf == 1 or units * kf <= kernels.WARPS
        cover = [0] * (-(-rt // 32) * ntg * ks)
        for u in range(units):
            rp, ng = divmod(u, ngf)
            for nt in range(ng * ntg // ngf, (ng + 1) * ntg // ngf):
                for part in range(kf):
                    for k in range(part * ks // kf, (part + 1) * ks // kf):
                        cover[(rp * ntg + nt) * ks + k] += 1
        assert cover == [1] * len(cover)
        # a power of 2 that would not fit twice: 8 warps, a k-step a warp at least
        assert units >= kernels.WARPS or 2 * kf * units > kernels.WARPS or 2 * kf > ks


# --- CUDA: the four K4 kernels against their plain versions ---------------------


def _check_on_card(x, u, ir, s):
    """K4 on the chains of u (K4-chains) and on chain 0 alone without a
    chain axis (K4) against the plain versions: float32 sums in another
    order, each value 1e-5 relative, dU 1e-5 relative L2, dI_rest rtol=1e-5
    / atol=1e-6."""
    ref = fused_poisson_ll_chains_reference(x, u, ir, s, DT)
    got = fused_ll_value_and_grad_chains(x, u, ir, s, DT)
    v = fused_ll_value_chains(x, u, ir, s, DT)
    ref1 = fused_poisson_ll_reference(x, u[0].contiguous(), ir[0].contiguous(), s, DT)
    got1 = fused_ll_value_and_grad(x, u[0].contiguous(), ir[0].contiguous(), s, DT)
    v1 = fused_ll_value(x, u[0].contiguous(), ir[0].contiguous(), s, DT)
    torch.cuda.synchronize()
    for (ll, du, dir_), val, (ll_r, du_r, dir_r) in ((got, v, ref), (got1, v1, ref1)):
        for g in (ll, val):
            torch.testing.assert_close(g, ll_r, rtol=1e-5, atol=0.0)
        assert float(torch.linalg.norm(du - du_r) / torch.linalg.norm(du_r)) <= 1e-5
        torch.testing.assert_close(dir_, dir_r, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "T,NB,N,C,clip_bins",
    [
        (60_000, 135, 27, 4, 200),  # the flagship's 4 chains
        (30_000, 50, 10, 4, 0),  # config 3
        (60_000, 80, 16, 4, 0),  # config 4
        (240_000, 50, 10, 2, 0),  # config 2's support sampler
        (700, 15, 3, 3, 40),
        (3, 135, 27, 1, 0),  # less than one tile, a chain axis of 1
        (1001, 5, 1, 8, 0),  # N=1, the most chains
        (999, 77, 9, 2, 0),  # odd NB and T·N: spans that do not start on 16 bytes
        (1000, 135, 27, 8, 0),  # dU mma tiles over two grid_y slices
        (2001, 500, 100, 1, 20),  # K4 in two column groups; K4-chains on one chain
    ],
)
def test_k4_kernels_match_reference_on_card(cuda, T, NB, N, C, clip_bins):
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = _torch(*_inputs(T, NB, N, C, i_shift=-3.0 if T > 1000 else 1.0, clip_bins=clip_bins), device=cuda)
    before = dict(kernels.LAUNCHES)
    _check_on_card(*ops)
    after = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    groups = len(kernels.chain_groups(NB, N, C))
    assert after == {**dict.fromkeys(before, 0), "fwd_bf16": 1, "vg_bf16": 1,
                     "fwd_chains_bf16": groups, "vg_chains_bf16": groups}, after


@pytest.mark.cuda
def test_k4_kernels_repeat_bit_for_bit_on_card(cuda):
    ops = _torch(*_inputs(60_000, 135, 27, 4, i_shift=-3.0), device=cuda)
    one = [ops[0], ops[1][0].contiguous(), ops[2][0].contiguous(), ops[3]]
    for fn, args in ((fused_ll_value_and_grad_chains, ops), (fused_ll_value_chains, ops),
                     (fused_ll_value_and_grad, one), (fused_ll_value, one)):
        a, b = fn(*args, DT), fn(*args, DT)
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y), fn.__name__


def _check_k4_on_card(x, u, ir, s):
    """K4-fwd and K4-vg (no chain axis) against their plain versions: the
    value 1e-5 relative, dU 1e-5 relative L2, dI_rest rtol=1e-5 /
    atol=1e-6 (float32 sums in another order); one launch a call."""
    before = dict(kernels.LAUNCHES)
    ll, du, dir_ = fused_ll_value_and_grad(x, u, ir, s, DT)
    v = fused_ll_value(x, u, ir, s, DT)
    torch.cuda.synchronize()
    after = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    assert after == {**dict.fromkeys(before, 0), "fwd_bf16": 1, "vg_bf16": 1}, after
    ll_r, du_r, dir_r = fused_poisson_ll_reference(x, u, ir, s, DT)
    for got in (ll, v):
        torch.testing.assert_close(got, ll_r, rtol=1e-5, atol=0.0)
    assert float(torch.linalg.norm(du - du_r) / torch.linalg.norm(du_r)) <= 1e-5
    torch.testing.assert_close(dir_, dir_r, rtol=1e-5, atol=1e-6)
    return dir_


@pytest.mark.cuda
@pytest.mark.parametrize(
    "T,NB,N,clip_bins",
    [
        (3001, 500, 100, 40),  # N=100 in its four column groups, clipped bins
        (999, 77, 9, 0),  # NB not a multiple of 16 (nor of 8), odd T·N
        (2001, 9, 1, 0),  # NB = 9: one dU m-tile, its k-steps over the 8 warps
        (3, 135, 27, 0),  # T shorter than one tile: the forward's k-steps split
        (5, 500, 100, 0),  # the same in column groups
        (240_000, 50, 10, 0),  # config 2: dU in one warp's rows, its k-steps over the 8 warps
        (60_000, 135, 27, 200),  # the flagship, clipped bins
    ],
)
def test_k4_alone_matches_reference_on_card(cuda, T, NB, N, clip_bins):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, u, ir, s = _torch(*_inputs(T, NB, N, 1, seed=3, i_shift=-3.0 if T > 1000 else 1.0, clip_bins=clip_bins),
                         device=cuda)
    dir_ = _check_k4_on_card(x, u[0].contiguous(), ir[0].contiguous(), s)
    if clip_bins:
        assert int((dir_ == 0).sum()) >= clip_bins


@pytest.mark.cuda
def test_k4_repeats_bit_for_bit_at_n100_on_card(cuda):
    """K4 in four column groups and, for K4-vg, k-sliced partial rows: two
    calls give the same bits."""
    x, u, ir, s = _torch(*_inputs(20_000, 500, 100, 1, i_shift=-3.0), device=cuda)
    u, ir = u[0].contiguous(), ir[0].contiguous()
    for fn in (fused_ll_value_and_grad, fused_ll_value):
        a, b = fn(x, u, ir, s, DT), fn(x, u, ir, s, DT)
        for p, q in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(p, q), fn.__name__
