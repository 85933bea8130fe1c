"""The port's harness against the JAX package's: metrics (tests/test_utils.py:76),
the spike binner, native and numpy, bit for bit with JAX's
(tests/test_utils.py:144,161), the Pillow-format .mat fixture written by
one package and read by the other (tests/test_fit_rgc.py:27), and the
command-line flow generate → map → mcmc (tests/test_cli.py) and fit_rgc
(tests/test_fit_rgc.py:48) at tiny sizes with ``--device cpu``."""

import json
import os

import numpy as np
import pytest
import torch

from theano_pyglm_torch.utils import binning
from theano_pyglm_torch.utils.io import load_results, parse_cmd_line_args


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_metrics_writer_and_timer_match_jax(tmp_path):
    """The same records, line for line, apart from the wall clock."""
    from theano_pyglm_tpu.utils.metrics import MetricsWriter as MetricsWriterJ
    from theano_pyglm_torch.utils.metrics import MetricsWriter, timer

    lines = []
    for name, cls in (("torch", MetricsWriter), ("jax", MetricsWriterJ)):
        path = os.path.join(tmp_path, name, "m.jsonl")
        w = cls(path)
        w.log(1, logp=-10.5)
        w.log(2, logp=-9.0, accept=0.9)
        w.close()
        recs = [json.loads(line) for line in open(path).read().strip().split("\n")]
        for r in recs:
            assert r.pop("wall_s") >= 0.0
        lines.append(recs)
    assert lines[0] == lines[1] == [{"step": 1, "logp": -10.5}, {"step": 2, "logp": -9.0, "accept": 0.9}]
    with timer("t") as t:
        sum(range(1000))
    assert t.elapsed > 0.0


def _events(kind, rng):
    T, N, dt = 1000, 7, 1e-3
    if kind == "random":
        times = rng.rand(5000) * T * dt * 1.1  # some events past the end
        neurons = rng.randint(-1, N + 1, 5000)  # some unknown ids
    else:  # every bin edge, and the next float on either side
        edges = np.arange(T) * dt
        times = np.concatenate([edges, np.nextafter(edges, -1.0), np.nextafter(edges, 2.0)])
        neurons = np.arange(times.shape[0]) % N
    return times, neurons, T, dt, N


@pytest.mark.parametrize("kind", ["random", "boundary"])
def test_bin_spikes_native_numpy_and_jax_bit_for_bit(kind, rng):
    from theano_pyglm_tpu.utils.binning import bin_spikes as bin_spikes_j

    assert binning.native_available(), "no C compiler: the native binner is untested"
    times, neurons, T, dt, N = _events(kind, rng)
    fast = binning.bin_spikes(times, neurons, T, dt, N)
    slow = binning.bin_spikes(times, neurons, T, dt, N, use_native=False)
    ref = bin_spikes_j(times, neurons, T, dt, N, use_native=False)
    assert fast.dtype == np.float32 and 0 < fast.sum() <= len(times)
    np.testing.assert_array_equal(fast, slow)
    np.testing.assert_array_equal(fast, ref)


def test_native_binner_is_built_from_the_ports_own_source():
    assert binning.SOURCE.is_file() and binning.SOURCE.parent.name == "native"
    assert "theano_pyglm_torch" in str(binning.SOURCE) and "_build" in str(binning.BUILD_DIR)
    lib = binning._load()
    assert lib is not None and "theano_pyglm_torch/_build/fastbin_" in lib._name


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_rgc_mat_fixture_between_packages(tmp_path, writer):
    """A fixture written by one package, read and binned by the other,
    equals the writer's spike matrix (spikes sit mid-bin)."""
    from theano_pyglm_tpu.utils import rgc as rgc_j
    from theano_pyglm_torch.utils import rgc as rgc_t

    path = os.path.join(tmp_path, "fix.mat")
    N, T_sec, dt = 3, 2.0, 1e-3
    if writer == "torch":
        out = rgc_t.save_rgc_fixture_mat(path, N=N, T_sec=T_sec, seed=1, device="cpu")
        per_neuron = rgc_t.make_synthetic_rgc(N=N, T_sec=T_sec, seed=1, device="cpu")[0]
        rec = rgc_j.load_rgc_mat(path)
        assert out["true"]["W"].device.type == "cpu"
    else:
        rgc_j.save_rgc_fixture_mat(path, N=N, T_sec=T_sec, seed=1)
        per_neuron = rgc_j.make_synthetic_rgc(N=N, T_sec=T_sec, seed=1)[0]
        rec = rgc_t.load_rgc_mat(path)
    assert rec["N"] == N and rec["stim"].shape[1] == 1 and rec["stim_dt"] == 0.01
    T = int(round(rec["T_sec"] / dt))
    S = binning.bin_spikes(rec["times"], rec["neurons"], T, dt, N)
    want = np.zeros((T, N), np.float32)
    for n, ts in enumerate(per_neuron):
        np.add.at(want, ((ts / dt).astype(int), n), 1.0)
    assert want.sum() > 0
    np.testing.assert_array_equal(S, want)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from theano_pyglm_torch.cli import generate_synth_data

    d = str(tmp_path_factory.mktemp("harness"))
    generate_synth_data(parse_cmd_line_args(
        ["--model", "sparse_weighted_model", "-N", "3", "-T", "8", "-r", d, "--seed", "5", "--device", "cpu"]
    ))
    return d


def test_cli_generate(workdir):
    data = load_results(os.path.join(workdir, "synth_data.npz"))
    assert data["S"].shape == (8000, 3) and data["S"].sum() > 0
    assert "stim" in data and data["true_params"]["W"].shape == (3, 3)


@pytest.mark.parametrize("flags", [[], ["--lam", "5.0"]])
def test_cli_map(workdir, flags):
    from theano_pyglm_torch.cli import main

    out = main(["map", "-d", os.path.join(workdir, "synth_data.npz"), "--model", "sparse_weighted_model",
                "-r", workdir, "--device", "cpu", *flags])
    res = load_results(out)
    assert np.isfinite(res["log_joint"]) and res["params"]["bias"].shape == (3,)
    try:
        import matplotlib  # noqa: F401
    except ImportError:  # cli map skips the figure without matplotlib
        return
    assert os.path.exists(os.path.join(workdir, "map_results.png"))


@pytest.mark.parametrize("flags", [[], ["--lam", "5.0"]])
def test_cli_map_against_jax(workdir, flags):
    """Both packages' ``map`` on the same synth_data.npz, each in its own
    default float32 from its smart initialization. In float64, the port's
    log-joint at the JAX MAP point equals the JAX package's (1e-9 rel.: the
    two harnesses build the same problem from the file); the plain MAP
    points have the same log-joint to 1e-5 rel., and the port's sparse fit
    has a penalized log-posterior at least as high as JAX's, less 1e-5 rel.
    (the smoothed-L1 fits stop at different points)."""
    import jax
    import jax.numpy as jnp

    from theano_pyglm_tpu import cli as cli_j
    from theano_pyglm_tpu.utils.io import parse_cmd_line_args as parse_j
    from theano_pyglm_torch import Population
    from theano_pyglm_torch.cli import main
    from theano_pyglm_torch.inference.map import _l1_penalty
    from theano_pyglm_torch.utils.io import load_data

    npz = os.path.join(workdir, "synth_data.npz")
    tag = "".join(flags)
    d_j, d_t = os.path.join(workdir, "jax" + tag), os.path.join(workdir, "torch" + tag)
    os.makedirs(d_j, exist_ok=True)
    common = ["-d", npz, "--model", "sparse_weighted_model"]
    with jax.enable_x64(False):
        fit_j = load_results(cli_j.fit_map(parse_j([*common, "-r", d_j, *flags])))["params"]
    fit_t = load_results(main(["map", *common, "-r", d_t, "--device", "cpu", *flags]))["params"]

    pop_j, data_j, raw = cli_j._load_problem(parse_j([*common, "-r", d_j]))
    data_j = {k: jnp.asarray(v, jnp.float64) for k, v in data_j.items()}
    lj_j = float(pop_j.log_joint({k: jnp.asarray(v, jnp.float64) for k, v in fit_j.items()}, data_j))
    pop = Population(pop_j.spec, device="cpu", dtype=torch.float64)
    raw_t = load_data(npz)
    data = pop.prepare_data(raw_t["S"], stim=raw_t.get("stim"))

    def lj(params, lam=0.0):
        p = {k: torch.as_tensor(np.asarray(v, np.float64)) for k, v in params.items()}
        with torch.no_grad():
            return float(pop.log_joint(p, data) - (_l1_penalty(p["W"], lam, 1e-6) if lam else 0.0))

    at_j = lj(fit_j)
    assert abs(at_j - lj_j) <= 1e-9 * abs(lj_j), (at_j, lj_j)
    if flags:
        lam = float(flags[1])
        pen_j, pen_t = lj(fit_j, lam), lj(fit_t, lam)
        assert pen_t >= pen_j - 1e-5 * abs(pen_j), (pen_t, pen_j)
    else:
        at_t = lj(fit_t)
        assert abs(at_t - at_j) <= 1e-5 * abs(at_j), (at_t, at_j)


def test_cli_mcmc(workdir):
    from theano_pyglm_torch.cli import main

    out = main(["mcmc", "-d", os.path.join(workdir, "synth_data.npz"), "--model", "sparse_weighted_model",
                "-r", workdir, "--n_samples", "10", "--n_warmup", "10", "--device", "cpu"])
    res = load_results(out)
    assert res["samples"]["W"].shape == (10, 3, 3) and np.all(np.isfinite(res["samples"]["W"]))
    metrics = open(os.path.join(workdir, "mcmc_metrics.jsonl")).read().strip().split("\n")
    assert metrics and all(0.0 <= json.loads(m)["accept"] <= 1.0 for m in metrics)
    assert main([]) == 2  # usage


def test_fit_rgc_end_to_end(tmp_path):
    """Fixture → bin → MAP → MCMC → report, as tests/test_fit_rgc.py:48 holds
    the JAX script: finite held-out values, KS in [0, 1], the fit beats a
    homogeneous rate."""
    from theano_pyglm_torch.scripts import fit_rgc

    fixture = os.path.join(tmp_path, "rgc_fixture.mat")
    results = os.path.join(tmp_path, "results")
    assert fit_rgc.main(["--make-fixture", fixture, "--fixture-N", "4", "--fixture-T", "6.0",
                         "--seed", "0", "--device", "cpu"]) is None
    report = fit_rgc.main(["--dataFile", fixture, "--resultsDir", results, "--map_iters", "200",
                           "--n_samples", "15", "--n_warmup", "15", "--device", "cpu"])
    with open(os.path.join(results, "rgc_fit_report.json")) as f:
        assert json.load(f) == json.loads(json.dumps(report))
    assert report["N"] == 4 and report["n_spikes"] > 0 and report["native_binner"]
    m = report["map"]
    assert np.isfinite(m["heldout_loglik"]) and 0.0 <= m["ks_mean"] <= 1.0
    assert m["ks_beats_null"], (m["ks_mean"], m["ks_null_mean"])
    assert np.isfinite(report["mcmc"]["heldout_predictive_loglik"])
    assert os.path.exists(os.path.join(results, "rgc_fit_params.npz"))


def test_flagship_figures_from_a_small_flagship_run(tmp_path):
    """rgc_flagship at N=4, 2 s, 2 chains × (10 + 10) on the CPU, then
    flagship_figures on its draws: both figures written."""
    pytest.importorskip("matplotlib")
    from theano_pyglm_torch.scripts import flagship_figures, rgc_flagship

    results = str(tmp_path)
    rgc_flagship.main(["--device", "cpu", "--N", "4", "--T_sec", "2", "--n_iters", "10", "--n_warmup", "10",
                       "--thin", "1", "--n_chains", "2", "-r", results])
    with np.load(os.path.join(results, "flagship_samples.npz")) as z:
        assert z["samples/locs"].shape[:2] == (10, 2)
    written = flagship_figures.main(["-r", results, "--n_loc_draws", "8"])
    assert [os.path.basename(w) for w in written] == ["network_posterior.png", "latent_locations.png"]
    for w in written:
        assert os.path.getsize(w) > 0


def test_sbm_seed_robustness_writes_the_jax_scripts_keys(tmp_path):
    """One key at T=300 and 10 + 10 sweeps of 2 chains: the runs of the JAX
    script (the key annealed, then the same key with annealing off) under
    its JSON keys."""
    from theano_pyglm_torch.scripts import sbm_seed_robustness

    report = sbm_seed_robustness.main(["--device", "cpu", "--keys", "5", "--T", "300", "--n_warmup", "10",
                                       "--n_samples", "10", "--n_chains", "2", "-r", str(tmp_path)])
    with open(os.path.join(tmp_path, "sbm_seed_robustness.json")) as f:
        assert json.load(f) == json.loads(json.dumps(report))
    assert set(report) == {"n_warmup", "n_samples", "n_chains", "runs", "min_ari_over_all_chains"}
    assert (report["n_warmup"], report["n_samples"], report["n_chains"]) == (10, 10, 2)
    assert [(r["master_key"], r["anneal_frac"]) for r in report["runs"]] == [(5, 0.5), (5, 0.0)]
    for r in report["runs"]:
        assert set(r) == {"master_key", "anneal_frac", "per_chain_ari_tail_half", "min_chain_ari",
                          "per_chain_ari_windows", "wall_s"}
        assert len(r["per_chain_ari_tail_half"]) == 2 and len(r["per_chain_ari_windows"]) == 2
        assert all(-1.0 <= a <= 1.0 for a in r["per_chain_ari_tail_half"])
        assert r["min_chain_ari"] == min(r["per_chain_ari_tail_half"])
    assert report["min_ari_over_all_chains"] == min(r["min_chain_ari"] for r in report["runs"])


def test_rgc_flagship_on_two_ranks(tmp_path):
    """``torchrun --nproc_per_node 2 -m theano_pyglm_torch.scripts.rgc_flagship``
    with gloo ranks on the CPU (N=4, 1 s, 4 chains × (10 + 10)): the chains
    split over the ranks, rank 0 alone simulates, fits, prints and writes,
    and every chain's draws equal those of the one-process run."""
    import subprocess
    import sys

    from theano_pyglm_torch.entry import _free_port

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1"}
    flags = ["-m", "theano_pyglm_torch.scripts.rgc_flagship", "--device", "cpu", "--N", "4", "--T_sec", "1",
             "--n_iters", "10", "--n_warmup", "10", "--thin", "1", "-r"]
    runs = {
        "two": [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--master_port",
                str(_free_port()), *flags, str(tmp_path / "two")],
        "one": [sys.executable, *flags, str(tmp_path / "one")],
    }
    outs = {name: subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=120)
            for name, cmd in runs.items()}
    for out in outs.values():
        assert out.returncode == 0, out.stderr[-3000:]
    assert outs["two"].stdout.count("MAP init") == 1  # rank 0 alone fits and prints
    with open(os.path.join(tmp_path / "two", "flagship_summary.json")) as f:
        summary = json.load(f)
    assert summary["ranks"] == 2 and summary["n_chains"] == 4
    with np.load(tmp_path / "two" / "flagship_samples.npz") as z, \
            np.load(tmp_path / "one" / "flagship_samples.npz") as one:
        assert z["samples/W"].shape[:2] == (10, 4) and np.all(np.isfinite(z["samples/W"]))
        assert sorted(z.files) == sorted(one.files)
        for k in one.files:
            np.testing.assert_array_equal(z[k], one[k], err_msg=k)
