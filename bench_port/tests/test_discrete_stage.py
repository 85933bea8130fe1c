"""CPU tests of a configuration with a stochastic block model graph: its
recipe, the reference's replay of the sweep's discrete stage against the
port in float64, a tiny cell end to end, and the faults of the discrete
stage that its two readings have to catch. The reference's block model
prior is held to the port's in ``test_bench_port.py``."""

from __future__ import annotations

import types

import pytest
import torch

from bench_port import harness
from bench_port.inputs import make_inputs
from bench_port.reference import discrete as ref_discrete
from bench_port.tests import tiny


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_recipe_draws_the_block_model_and_takes_a_planted_b():
    cfg = tiny.sbm_cell(N=6)["config"]
    p = make_inputs(cfg, 2**33 + 5, "cpu")["params"]
    assert p["y"].dtype == torch.int64 and p["y"].shape == (6,)
    assert p["pi"].shape == (2,) and abs(float(p["pi"].sum()) - 1.0) < 1e-6
    assert p["Bm"].shape == (2, 2) and bool(((p["Bm"] > 0) & (p["Bm"] < 1)).all())
    planted = [[0.999, 0.001], [0.001, 0.999]]
    q = make_inputs({**cfg, "planted": {"B": planted}}, 2**33 + 5, "cpu")["params"]
    assert torch.equal(q["Bm"], torch.tensor(planted))
    same = (q["y"][:, None] == q["y"][None, :]).float()
    assert float((q["A"] != same).float().mean()) < 0.2


def _port_population(cfg):
    from theano_pyglm_torch import Population

    return Population(cfg["spec"], device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("N", [6, 12])
def test_the_discrete_replay_matches_the_port_in_float64(N):
    """The reference's replay of the discrete stage against the port's own
    stage in float64, from the same state and generators: the same types,
    π and B to rounding; and following the port, nothing counted."""
    from theano_pyglm_torch.inference.mcmc import init_mcmc_state, make_sweep

    cfg = tiny.sbm_cell(N=N)["config"]
    model = cfg["spec"]
    inp = make_inputs(cfg, 9, "cpu")
    pop = _port_population(cfg)
    data = pop.prepare_data(inp["S"].double(), stim=inp["stim"].double())
    C = 3
    g0 = torch.Generator().manual_seed(5)
    params = {k: v.expand(C, *v.shape).clone() for k, v in inp["params"].items()}
    params = {k: v.double() if v.is_floating_point() else v for k, v in params.items()}
    params["y"] = torch.randint(0, 2, (C, N), generator=g0)  # each chain from other types
    state = init_mcmc_state(pop, params)
    gens = [torch.Generator().manual_seed(100 + c) for c in range(C)]
    before = [g.get_state() for g in gens]
    out = make_sweep(pop, data, stages=("discrete",), diagnostic=True,
                     fisher_params=inp["params"])(gens, state, False, 1.0)["params"]
    moved = 0
    for c in range(C):
        judged = {k: out[k][c] for k in ("y", "pi", "Bm")}
        own = ref_discrete.discrete_replay(model, params["A"][c], params["y"][c], before[c], dtype=torch.float64)
        assert torch.equal(own["y"], judged["y"]), c
        assert torch.allclose(own["pi"], judged["pi"], rtol=1e-12, atol=0) and \
            torch.allclose(own["Bm"], judged["Bm"], rtol=1e-12, atol=0), c
        r = ref_discrete.discrete_replay(model, params["A"][c], params["y"][c], before[c], follow=judged,
                                         dtype=torch.float64)
        assert r["type_gap"] == 0 and r["hyper_gap"] <= 1e-12, (c, r["type_gap"], r["hyper_gap"])
        moved += int((judged["y"] != params["y"][c]).sum())
    assert moved > 0


def test_a_block_model_cell_is_correct_end_to_end():
    """The tiny flagship cell with a block model graph at N=4, K=2, through
    the sampler driver as a run drives it: every number within its limit,
    the discrete stage's two among them."""
    torch.manual_seed(0)
    out = harness.run_cell(tiny.sbm_cell(), 3, 0.3, False, torch.device("cpu"))
    assert {"type_gap", "hyper_gap"} <= set(out["checks"])
    assert all(c["value"] <= c["limit"] for c in out["checks"].values()), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_a_traced_run_times_the_discrete_stage_only_with_a_block_model_graph(monkeypatch):
    """The discrete stage is timed alone where the configuration's graph is a
    block model, so its metric is one new reader; the distance graph's cell
    times the two stages it timed before."""
    from bench_port.traffic import sampler

    ctx = {"config": tiny.cell("flagship-c16")["config"]}
    assert list(sampler._alone(ctx)) == ["adjacency", "hmc"]
    ctx = {"config": tiny.sbm_cell()["config"]}
    assert list(sampler._alone(ctx)) == ["adjacency", "hmc", "discrete"]
    discrete_ms = types.SimpleNamespace(UNIT="ms", read=lambda c: c.get("stage_ms", {}).get("discrete"))
    own = harness.reader
    monkeypatch.setattr(harness, "reader", lambda m: discrete_ms if m == "discrete_ms" else own(m))
    torch.manual_seed(0)
    out = harness.run_cell(tiny.sbm_cell(), 3, 0.3, True, torch.device("cpu"),
                           metrics=["adjacency_ms", "hmc_ms", "discrete_ms"])
    assert set(out["metrics"]) == {"adjacency_ms", "hmc_ms", "discrete_ms"}
    assert out["metrics"]["discrete_ms"][0] > 0
    assert all(c["value"] <= c["limit"] for c in out["checks"].values()), out["checks"]


def _type_logits(transposed: bool = False, self_pair: bool = True):
    """The port's collapsed type logits (``gibbs._collapsed_type_logits``)
    with the block edge counts over the transposed blocks, or without the
    neuron's self-pair: a fault of the counting. Neither switch set, the
    port's own function."""
    from theano_pyglm_torch.inference import gibbs

    def logits(A, y, n, K, alpha0, b0, b1):
        N, f = A.shape[-1], A.dtype
        mask = (torch.arange(N, device=A.device) != n).to(f)
        onehot = gibbs._onehot(y, K, f) * mask[:, None]
        cnt = onehot.sum(-2)
        E = onehot.transpose(-1, -2) @ A @ onehot
        E = (E.transpose(-1, -2) if transposed else E).unsqueeze(-3)
        P = (cnt[..., :, None] * cnt[..., None, :]).unsqueeze(-3)
        eo = torch.einsum("...m,...mk->...k", A[..., n, :] * mask, onehot)
        ei = torch.einsum("...m,...mk->...k", A[..., :, n] * mask, onehot)
        eye = torch.eye(K, dtype=f, device=A.device)
        same = eye[:, :, None] * eye[:, None, :] * float(self_pair)
        dE = (eye[:, :, None] * eo[..., None, None, :] + eye[:, None, :] * ei[..., None, :, None]
              + same * A[..., n, n, None, None, None])
        dP = eye[:, :, None] * cnt[..., None, None, :] + eye[:, None, :] * cnt[..., None, :, None] + same
        base = gibbs._betaln(b0 + E, b1 + (P - E))
        new = gibbs._betaln(b0 + E + dE, b1 + (P + dP) - (E + dE))
        return torch.log(alpha0 + cnt) + (new - base).sum((-2, -1))

    return logits


def _hypers_before_types():
    """The discrete stage's π and B drawn from the counts of the types as
    they were before its type stage."""
    from theano_pyglm_torch.inference import mcmc

    types, hypers = mcmc.update_sbm_types_collapsed, mcmc.update_sbm_hypers
    held = {}

    def types_kept(generator, pop, params):
        held["y"] = params["y"]
        return types(generator, pop, params)

    def hypers_stale(generator, pop, params):
        return {**hypers(generator, pop, {**params, "y": held["y"]}), "y": params["y"]}

    return [(mcmc, "update_sbm_types_collapsed", types_kept), (mcmc, "update_sbm_hypers", hypers_stale)]


def _types_skipped(cell):
    """The type stage skipped, the chains started with neuron 0 put in the
    other class than the one its edges were drawn with."""
    from theano_pyglm_torch.inference import mcmc

    make = cell["driver"].make_inputs

    def misassigned(cfg, seed, device):
        inp = make(cfg, seed, device)
        inp["params"]["y"][0] = 1 - inp["params"]["y"][0]
        return inp

    return [(mcmc, "update_sbm_types_collapsed", lambda generator, pop, params: params),
            (cell["driver"], "make_inputs", misassigned)]


def _gibbs():
    from theano_pyglm_torch.inference import gibbs

    return gibbs


FAULTS = {
    "type stage skipped": ("type_gap", _types_skipped),
    "transposed blocks": ("type_gap", lambda cell: [(_gibbs(), "_collapsed_type_logits", _type_logits(True))]),
    "self-pair dropped": ("type_gap", lambda cell: [(_gibbs(), "_collapsed_type_logits",
                                                      _type_logits(self_pair=False))]),
    "hypers before types": ("hyper_gap", lambda cell: _hypers_before_types()),
    "none (the port's logits, copied)": (None, lambda cell: [(_gibbs(), "_collapsed_type_logits", _type_logits())]),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_of_the_discrete_stage_fails_by_its_reading(fault, monkeypatch):
    """Each fault of the discrete stage fails the run by the reading named
    for it. A run checks one replayed stage, a decision a neuron and chain,
    and a fault of the counting moves few of them: the cell runs N=6 at 16
    chains, 96 decisions, where each of these faults showed on 6 of 6 seeds
    tried. The copy of the port's own logits passes."""
    number, patches = FAULTS[fault]
    cell = tiny.sbm_cell(N=6, chains=16)
    for target, name, value in patches(cell):
        monkeypatch.setattr(target, name, value)
    torch.manual_seed(0)
    out = harness.run_cell(cell, 4, 0.3, False, torch.device("cpu"))
    if number is None:
        assert all(c["value"] <= c["limit"] for c in out["checks"].values()), out["checks"]
    else:
        assert out["checks"][number]["value"] > out["checks"][number]["limit"], out["checks"]
