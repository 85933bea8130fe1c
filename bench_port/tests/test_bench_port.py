"""CPU tests of the port's benchmark (``bench_port``), at sizes a test run
holds. The test marked ``cuda`` runs the control on the card:

    python -m pytest --noconftest -o addopts="" -m cuda bench_port/tests
"""

from __future__ import annotations

import ast
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import harness, yardstick
from bench_port.reference import glm as ref
from bench_port.tests import tiny

CHECKOUT = harness.HERE.parent
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
#: the one-card cells; the four-card cell runs its ranks in processes of their own (below)
CELLS = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cells_configurations_and_metrics_are_found_by_name():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        cell = harness.resolve(w["name"])
        assert cell["workload"]["config"] == w["config"]
        assert cell["workload"]["traffic"] == w["traffic"]
        assert cell["workload"]["chips"] == w["chips"]
        assert cell["config"]["name"] == w["config"]
        assert configs[w["config"]]["file"] == f"bench_port/configs/{w['config']}.json"
        assert sorted(configs[w["config"]]["reduced"]) == sorted(cell["config"]["reduced"])
        for fn in ("setup", "window", "traced", "outputs", "check", "readings", "control_outputs"):
            assert callable(getattr(cell["driver"], fn))
    for m in BENCH["per_layer"]:
        mod = harness.reader(m["name"])
        assert mod.UNIT == m["unit"] and callable(mod.read), m["name"]
    for name in harness.metric_names():
        mod = harness.load_module("metrics", name)
        assert isinstance(mod.UNIT, str) and callable(mod.read)
    with pytest.raises(FileNotFoundError):
        harness.resolve("no-such-cell")
    with pytest.raises(ValueError):
        harness.resolve("../configs/flagship")


def test_a_traced_run_reads_the_per_layer_metrics_benchmark_json_lists_for_it():
    e2e = {w["name"]: {m["name"] for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])}
           for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        names = harness.per_layer_metrics(w["name"])
        assert names, w["name"]
        for m in BENCH["per_layer"]:
            listed = w["name"] in m["workloads"] if "workloads" in m else m["moves"] in e2e[w["name"]]
            assert (m["name"] in names) == listed, (w["name"], m["name"])
            if listed:
                assert m["moves"] in e2e[w["name"]], (w["name"], m["name"])
    assert harness.per_layer_metrics("no-such-cell") == []
    assert harness.reader("mfu_pct.sampler") is not None and harness.reader("device_idle_pct.evals") is not None


@pytest.mark.parametrize("workload", CELLS)
def test_a_run_prints_the_end_to_end_metrics_benchmark_json_lists_for_it(workload, monkeypatch, capsys):
    """``run.py --trace 0`` prints the cell's end-to-end metrics and no
    other, whatever more its driver times (that goes to standard error);
    ``setup_s`` and one more in every cell."""
    spec = importlib.util.spec_from_file_location("bench_port_run", harness.HERE / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    monkeypatch.setattr(run, "_caches", lambda: None)
    monkeypatch.setattr(sys, "path", list(sys.path))
    want = [m["name"] for m in BENCH["end_to_end"] if workload in m.get("workloads", [workload])]
    assert harness.end_to_end_metrics(workload) == want
    assert "setup_s" in want and len(want) >= 2
    timed = {name: (1.0, "u") for name in ("chain_sweeps_per_s", "evals_per_s", "setup_s", "peak_mem_gib")}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "card")
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {"metrics": dict(timed), "peak": 1, "attempted": 1,
                                                              "failed": 0, "checks": {}})
    assert run.main(["--workload", workload, "--seed", "1", "--seconds", "1", "--trace", "0"]) == 0
    printed = capsys.readouterr()
    line = json.loads(printed.out.strip().splitlines()[-1])
    assert list(line["metrics"]) == [k for k in timed if k in want]
    for k in timed:
        assert (f"timed, not reported in this cell: {k} " in printed.err) == (k not in want), k


def test_configurations_are_the_port_models_named():
    from theano_pyglm_torch.models.zoo import make_model

    flag = harness.load_json("configs", "flagship")["spec"]
    assert flag == make_model("distance_weighted_model", 27, bias={"mu": 3.0, "sigma": 0.4})
    want = make_model("sparse_weighted_model", 100)
    want["bias"] = {"mu": 2.3, "sigma": 0.3}
    assert harness.load_json("configs", "long-recording")["spec"] == want


@pytest.mark.parametrize("config", ["flagship", "long-recording", "sbm"])
def test_reference_matches_the_port_in_float64(config):
    """Value and gradient of the log-joint, the reference against the port's
    plain float64 path, on inputs the benchmark made; "sbm" is the flagship
    with a block model graph (its types, π and B among the parameters)."""
    from theano_pyglm_torch import Population
    from theano_pyglm_torch.inference.map import split_params, value_and_grad

    cells = {"flagship": "flagship-c16", "long-recording": "long-resident-evals"}
    cfg = tiny.cell(cells[config])["config"] if config in cells else tiny.sbm_cell(N=6)["config"]
    inp = __import__("bench_port.inputs", fromlist=["make_inputs"]).make_inputs(cfg, 5, "cpu")
    p64 = {k: v.double() if v.is_floating_point() else v for k, v in inp["params"].items()}
    pop = Population(cfg["spec"], device="cpu", dtype=torch.float64)
    data = pop.prepare_data(inp["S"].double(), stim=inp["stim"].double())
    q, frozen = split_params(p64)
    val, grads = value_and_grad(lambda p: pop.log_joint({**frozen, **p}, data), q)
    rv, rg, _, _ = ref.log_joint_and_grad(cfg["spec"], p64, inp["S"], inp["stim"], block=500)
    assert abs(float(val) - rv) <= 1e-10 * abs(rv)
    assert set(rg) == set(grads)
    for k, g in grads.items():
        assert torch.allclose(rg[k], g, rtol=1e-9, atol=1e-9 * float(g.abs().max())), k


def test_reference_blocks_do_not_change_the_answer():
    cfg = tiny.cell("long-resident-evals")["config"]
    inp = __import__("bench_port.inputs", fromlist=["make_inputs"]).make_inputs(cfg, 6, "cpu")
    a = ref.log_likelihood_and_grad(cfg["spec"], inp["params"], inp["S"], inp["stim"], block=10_000)
    b = ref.log_likelihood_and_grad(cfg["spec"], inp["params"], inp["S"], inp["stim"], block=333)
    assert abs(a[0] - b[0]) <= 1e-12 * abs(a[0])
    for k in a[1]:
        assert torch.allclose(a[1][k], b[1][k], rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("T", [1_500, 20_000])
def test_stage_replays_match_the_port_in_float64(T):
    """The reference's replays of the adjacency stage (with its time
    subsample where T > 16,384) and of the two HMC stages against the port's
    own stages in float64, from the same state and generators."""
    from theano_pyglm_torch import Population
    from theano_pyglm_torch.inference.mcmc import init_mcmc_state, make_sweep

    from bench_port.inputs import make_inputs
    from bench_port.reference import sweep as ref_sweep

    cell = tiny.cell("flagship-c16")
    cfg = {**cell["config"], "T": T}
    model = cfg["spec"]
    inp = make_inputs(cfg, 9, "cpu")
    S, stim = inp["S"], inp["stim"]
    pop = Population(model, device="cpu", dtype=torch.float64)
    data = pop.prepare_data(S.double(), stim=stim.double())
    C, N = 2, model["N"]
    g0 = torch.Generator().manual_seed(5)
    params = {k: (v.double().expand(C, *v.shape) + 0.3 * torch.randn((C,) + v.shape, generator=g0,
                                                                      dtype=torch.float64)
                  * (k in ("w_ir", "W", "locs"))).clone() for k, v in inp["params"].items()}
    state = init_mcmc_state(pop, params, step_size=0.05)
    gens = [torch.Generator().manual_seed(100 + c) for c in range(C)]
    kw = dict(stages=("adjacency",), diagnostic=True, fisher_params=inp["params"])
    before = [g.get_state() for g in gens]
    adj = make_sweep(pop, data, **kw)(gens, state, False, 1.0)["params"]
    gaps = []
    for c in range(C):
        p = {k: v[c] for k, v in params.items()}
        draws = ref_sweep.adjacency_draws(before[c], N, T, "cpu", torch.float64)
        assert (draws["offs"] is not None) == (T > ref_sweep.SUBSAMPLE_T)
        own = ref_sweep.adjacency_replay(model, p, S, stim, draws)
        assert torch.equal(own["A"], adj["A"][c])
        assert torch.allclose(own["W"], adj["W"][c], rtol=1e-10, atol=1e-10)
        gaps.append(float(ref_sweep.adjacency_replay(model, p, S, stim, draws,
                                                     follow={"A": adj["A"][c], "W": adj["W"][c]})["gap"].max()))
    assert max(gaps) <= 1e-10, gaps
    assert not torch.equal(adj["A"], params["A"]) or not torch.equal(adj["W"], params["W"])

    before = [g.get_state() for g in gens]
    hmc = make_sweep(pop, data, n_leapfrog=cfg["n_leapfrog"], stages=("imp", "latent"), diagnostic=True,
                     fisher_params=inp["params"])(gens, state, False, 1.0)["params"]
    blocks = ref.design_blocks(model, S, stim)
    for c in range(C):
        p = {k: v[c] for k, v in params.items()}
        moves = ref_sweep.hmc_draws(before[c], [tuple(p["w_ir"].shape), tuple(p["locs"].shape)], "cpu",
                                     torch.float64)
        targets = [("w_ir", ref_sweep.impulse_target(model, p, S, stim, blocks), T * N),
                   ("locs", ref_sweep.latent_target(model, p), N * N + p["locs"].numel())]
        for (k, target, n_terms), (p0, u) in zip(targets, moves):
            r = ref_sweep.hmc_replay(target, p[k], 0.05, torch.ones_like(p[k]), p0, float(u), cfg["n_leapfrog"],
                                     n_terms, follow=hmc[k][c])
            assert r["gap"] <= 1e-9, (k, r["gap"])
            assert torch.allclose(r["q"], hmc[k][c], rtol=1e-9, atol=1e-9), k


def test_frozen_bound_gives_the_kernel_table():
    """PERF.md's kernel table, Bound column: K3-vg at the flagship, C = 4;
    K2's wide-U instance at (600,000, 500, 100)."""
    assert round(yardstick.bound_ms(True, 60_000, 135, 27, C=4), 4) == 0.0271
    assert round(yardstick.bound_ms(True, 600_000, 500, 100), 4) == 0.7273
    assert round(yardstick.bound_ms(False, 60_000, 135, 27), 4) == 0.0135  # K1 at the flagship
    assert round(yardstick.bound_ms(False, 60_000, 135, 27, C=4), 4) == 0.0194  # K3-fwd


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(harness.HERE.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not (_imports(path) & set(harness.FORBIDDEN)), path
    for path in sorted((harness.HERE / "reference").rglob("*.py")):
        assert "theano_pyglm_torch" not in _imports(path), path


def test_forbidden_modules_are_compared_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_loaded() == ["jax"]


def test_the_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the machine without one")
    r = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "flagship-c16", "--seed", "1",
                        "--seconds", "1"], cwd=CHECKOUT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_seeds_take_any_whole_number():
    from bench_port.inputs import seeds

    big = 2**31 + 12345
    assert seeds(big, 4) == seeds(big, 6)[:4]
    assert seeds(big, 2) != seeds(big + 1, 2)
    assert all(0 <= s < 2**62 for s in seeds(2**40, 5))


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct_and_repeats_its_inputs(workload):
    from bench_port.inputs import make_inputs

    out = tiny.run(workload)
    assert all(c["value"] <= c["limit"] for c in out["checks"].values()), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    cfg = tiny.cell(workload)["config"]
    a, b = make_inputs(cfg, 2**33 + 1, "cpu"), make_inputs(cfg, 2**33 + 1, "cpu")
    assert torch.equal(a["S"], b["S"]) and torch.equal(a["stim"], b["stim"])
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])


def _scaled_ll(factor):
    from theano_pyglm_torch.models import population

    fused = population.fused_poisson_ll

    def altered(x_f, u, i_rest, s, dt):
        return fused(x_f, u, i_rest, s, dt) * factor

    return altered


def _half_the_bins():
    from theano_pyglm_torch.models import population

    fused = population.fused_poisson_ll

    def half(x_f, u, i_rest, s, dt):
        h = s.shape[0] // 2
        return 2.0 * fused(x_f[:h], u, i_rest[..., :h, :], s[:h], dt)

    return half


def _half_the_chains():
    from theano_pyglm_torch.models.population import Population

    ll = Population.log_likelihood

    def half(self, params, data):
        out = ll(self, params, data)
        if out.ndim == 0:
            return out
        h = out.shape[0] // 2
        return torch.cat([out[:h], out[:h].mean().expand(out.shape[0] - h)])

    return half


def _adjacency_tempered(factor):
    """The birth–death stage with every ΔLL scaled by ``factor`` (its
    tempering β), the rest of the sweep as it is."""
    from theano_pyglm_torch.inference import mcmc

    update = mcmc.update_adjacency_collapsed

    def altered(*args, beta=1.0, **kw):
        return update(*args, beta=beta * factor, **kw)

    return altered


def _leapfrog_step_dropped():
    """Every HMC transition of the sweep one leapfrog step short."""
    from theano_pyglm_torch.inference import mcmc

    step = mcmc.hmc_adaptive_step

    def altered(generator, logp_fn, state, n_steps=10, **kw):
        return step(generator, logp_fn, state, n_steps=n_steps - 1, **kw)

    return altered


def _mcmc():
    from theano_pyglm_torch.inference import mcmc

    return mcmc


def _unchanged(make_sweep):
    def make(*args, **kw):
        make_sweep(*args, **kw)
        return lambda gens, state, adapt, beta=1.0: state

    return make


FAULTS = {
    "state unchanged": ("sampler", lambda cell: (cell["driver"], "make_sweep", _unchanged(cell["driver"].make_sweep))),
    "half the chains": ("sampler", lambda cell: (__import__("theano_pyglm_torch.models.population",
                                                            fromlist=["Population"]).Population,
                                                 "log_likelihood", _half_the_chains())),
    "half the bins": (None, lambda cell: (__import__("theano_pyglm_torch.models.population",
                                                     fromlist=["population"]), "fused_poisson_ll", _half_the_bins())),
    "answer altered": (None, lambda cell: (__import__("theano_pyglm_torch.models.population",
                                                      fromlist=["population"]), "fused_poisson_ll", _scaled_ll(1.001))),
    # faults of one sweep stage alone, which the shared likelihood does not see
    "adjacency answer altered": ("sampler", lambda cell: (_mcmc(), "update_adjacency_collapsed",
                                                          _adjacency_tempered(0.99))),
    "hmc answer altered": ("sampler", lambda cell: (_mcmc(), "hmc_adaptive_step", _leapfrog_step_dropped())),
}
#: the number that has to catch a fault of one stage
STAGE_NUMBER = {"adjacency answer altered": "adj_gap", "hmc answer altered": "hmc_gap"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    """The run with its timed path broken underneath, the chip's look
    skipped: ``correct`` comes out false for each fault the cell can have."""
    cell = tiny.cell(workload)
    driver, patch = FAULTS[fault]
    if driver is not None and cell["traffic"]["driver"] != driver:
        pytest.skip(f"a {cell['traffic']['driver']} cell cannot have this fault")
    monkeypatch.setattr(*patch(cell))
    torch.manual_seed(0)
    out = harness.run_cell(cell, 4, 0.3, False, torch.device("cpu"))
    assert not all(c["value"] <= c["limit"] for c in out["checks"].values()), out["checks"]
    if fault in STAGE_NUMBER:
        c = out["checks"][STAGE_NUMBER[fault]]
        assert c["value"] > c["limit"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_tf32_control_is_not_correct(workload):
    """The reference in TF32, put in the program's place, fails a limit."""
    from bench_port.control import readings

    r = readings(tiny.cell(workload), 7, 0.2, torch.device("cpu"), control=True)
    limits = harness.resolve(workload)["workload"]["limits"]
    assert all(r["program"][k] <= lim for k, lim in limits.items()), r
    assert any(r["control"][k] > lim for k, lim in limits.items()), r


def test_traced_run_reads_the_trace():
    """On the CPU the device readers find nothing and return nothing; the
    host-clock stage timings and rate are there."""
    out = tiny.run("flagship-c16", trace=True)
    assert set(out["metrics"]) == {"adjacency_ms", "hmc_ms", "timed_chain_sweeps_per_s"}
    assert out["metrics"]["timed_chain_sweeps_per_s"][0] > 0
    bd = out["trace_summary"]["breakdown"]
    assert set(bd) == {"device_ops", "idle_gaps"}


def test_trace_union_and_breakdown():
    from bench_port.trace import SPAN, Trace

    ops = [("k1", 10.0, 20.0), ("k2", 15.0, 30.0), ("k1", 50.0, 60.0), ("copy", 85.0, 101.0), ("k3", 130.0, 131.0)]
    spans = [(SPAN + "window", 0.0, 80.0), (SPAN + "sweep", 0.0, 40.0), (SPAN + "sweep", 40.0, 80.0),
             (SPAN + "stage.adjacency", 90.0, 110.0)]
    tr = Trace(ops, spans)
    assert Trace.union(ops) == [[10.0, 30.0], [50.0, 60.0], [85.0, 101.0], [130.0, 131.0]]
    assert tr.busy_s() == pytest.approx(30e-6)
    assert tr.window_s == pytest.approx(80e-6)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert bd["idle_gaps"] == [["sweep", pytest.approx(45e-6)], ["stage.adjacency", pytest.approx(29e-6)]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_on_the_card_at_the_cell_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bench_port.control import readings

    cell = harness.resolve(workload)
    r = readings(cell, 7, 3.0, torch.device("cuda", 0), control=True)
    limits = cell["workload"]["limits"]
    assert all(np.isfinite(r["program"][k]) and r["program"][k] <= lim for k, lim in limits.items()), r
    assert any(r["control"][k] > lim for k, lim in limits.items()), r


#: built and run, not yet in BENCHMARK.json (its second set waits for a four-card machine)
MESH = "flagship-c64-4gpu"
MESH_FAULTS = {
    "exchange left out": [("driver", "gather_chains", "bench_port.tests.tiny:local_gather")],
    "state unchanged": [("bench_port.traffic.sampler", "make_sweep", "bench_port.tests.tiny:unchanged_make_sweep")],
}


#: the per-layer metrics the four-card cell would list in BENCHMARK.json
MESH_METRICS = ("adjacency_ms", "hmc_ms", "rank_imbalance_pct", "device_idle_pct.sampler", "mfu_pct.sampler")


@pytest.mark.parametrize("fault, trace", [(None, False), (None, True)] + [(f, False) for f in sorted(MESH_FAULTS)])
def test_the_four_rank_cell_on_gloo(fault, trace):
    """The four-card cell's ranks on the CPU (gloo), at the tiny sizes: a
    sound run is correct, traced or not, and each fault of the exchange or
    the step is not."""
    out = harness.run_ranks(MESH, 8, 0.5, trace, 4, device_type="cpu", cell_of="bench_port.tests.tiny:cell",
                            patches=MESH_FAULTS.get(fault, ()), timeout=240, metrics=MESH_METRICS)
    assert out["forbidden"] == []
    ok = all(c["value"] <= c["limit"] for c in out["checks"].values())
    assert ok == (fault is None), out["checks"]
    assert out["attempted"] > 0
    if trace:
        assert {"adjacency_ms", "hmc_ms", "rank_imbalance_pct"} <= set(out["metrics"])
        assert set(out["trace_summary"]["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert out["metrics"]["chain_sweeps_per_s"][0] > 0


def test_a_rank_that_loads_jax_fails_the_run():
    """A rank of a multi-card cell that has the JAX package loaded is seen
    by the parent process, which prints no result."""
    out = harness.run_ranks(MESH, 8, 0.3, False, 2, device_type="cpu", cell_of="bench_port.tests.tiny:cell",
                            patches=[("driver", "setup", "bench_port.tests.tiny:setup_loading_jax_on_rank_1")],
                            timeout=240)
    assert out["forbidden"] == ["jax"]
    assert harness.forbidden_loaded() == []
