"""The port's spans (``utils/metrics.timer``): what a profiled sweep and a
profiled evaluation of the log-joint record, where the spans show in the
profiler's events, and that without a profiler a span records nothing.

On the CPU: the spans of a tiny chain-batched sweep and of resident and
streamed evaluations under ``torch.profiler``. On a CUDA device (the test
marked ``cuda``, skipped elsewhere; no JAX needed): a flagship-size sweep
profiled with the spans on and off launches the same device operations,
none of them named as a span:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_tracing.py
"""

import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import theano_pyglm_torch as pt
from theano_pyglm_torch.inference.map import split_params, value_and_grad
from theano_pyglm_torch.inference.mcmc import SWEEP_STAGES, init_mcmc_state, make_sweep, stack_states
from theano_pyglm_torch.utils import metrics
from theano_pyglm_torch.utils.metrics import spans, timer

SPAN_NAMES = {"sweep", "value_and_grad", "value_and_grad.backward", "loglik.design"} | {
    "sweep." + s for s in SWEEP_STAGES}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sweep_problem(C=2, N=4, T=300, device="cpu", dtype=torch.float64):
    pop = pt.Population(pt.make_model("distance_weighted_model", N), device=device, dtype=dtype)
    r = np.random.RandomState(0)
    data = pop.prepare_data(r.poisson(0.1, (T, N)).astype(float), stim=r.randn(T, pop.D_stim))
    inits = [pop.sample(torch.Generator(device=device).manual_seed(10 + c)) for c in range(C)]
    sweep = make_sweep(pop, data, n_leapfrog=3, fisher_params=inits[0])
    gens = [torch.Generator(device=device).manual_seed(100 + c) for c in range(C)]
    return sweep, gens, init_mcmc_state(pop, stack_states(inits))


def _evals_problem(streamed, T=1_000, N=4, chunk=300):
    pop = pt.Population(pt.make_model("sparse_weighted_model", N), device="cpu",
                        time_chunk=chunk if streamed else None)
    r = np.random.RandomState(1)
    data = pop.prepare_data(r.poisson(0.05, (T, N)).astype(np.float32), stim=r.randn(T, pop.D_stim),
                            materialize_design=not streamed)
    q, frozen = split_params(pop.sample(torch.Generator().manual_seed(3)))
    return lambda: value_and_grad(lambda p: pop.log_joint({**frozen, **p}, data), q)


def _profiled(fn):
    """(the profiler, the spans) of ``fn`` in a session of its own: the span
    before it finds the profiler off, so the session's first span clears
    the store."""
    with timer("between sessions"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof, spans()


def _children(parent, recorded):
    name, a, b, depth = parent
    return sorted((s for s in recorded if s[3] == depth + 1 and a <= s[1] and s[2] <= b), key=lambda s: s[1])


def test_no_span_is_recorded_without_a_profiler():
    _profiled(lambda: timer("sweep").__enter__().__exit__(None, None, None))
    before = spans()
    sweep, gens, state = _sweep_problem()
    sweep(gens, state, False, 1.0)
    _evals_problem(streamed=True)()
    with timer("value_and_grad"):
        pass
    assert spans() == before


def test_a_profiled_sweep_records_each_stage_in_order():
    sweep, gens, state = _sweep_problem()
    ran = [s for s in ("glm", "imp", "latent") if s in state] + ["hypers", "adjacency", "discrete", "rotation"]
    _, recorded = _profiled(lambda: sweep(gens, state, False, 1.0))
    tops = [s for s in recorded if s[3] == 0]
    assert [s[0] for s in tops] == ["sweep"]
    kids = _children(tops[0], recorded)
    assert [s[0] for s in kids] == ["sweep." + s for s in ran]
    assert len(recorded) == 1 + len(ran)
    for (_, _, b, _), (_, a, _, _) in zip(kids, kids[1:]):
        assert b <= a
    assert all(s[1] <= s[2] for s in recorded)


@pytest.mark.parametrize("streamed", [False, True])
def test_a_profiled_evaluation_records_the_design_of_each_streamed_block(streamed):
    _, recorded = _profiled(_evals_problem(streamed))
    names = sorted(s[0] for s in recorded)
    blocks = 4 if streamed else 0  # 1,000 bins in blocks of 300
    assert names == sorted(["value_and_grad", "value_and_grad.backward"] + ["loglik.design"] * blocks)
    top = [s for s in recorded if s[3] == 0]
    assert [s[0] for s in top] == ["value_and_grad"]
    assert all(top[0][1] <= s[1] and s[2] <= top[0][2] for s in recorded)
    backward = [s for s in recorded if s[0] == "value_and_grad.backward"][0]
    assert all(s[2] <= backward[1] for s in recorded if s[0] == "loglik.design")


def test_span_names_are_host_ranges_and_never_user_annotations():
    sweep, gens, state = _sweep_problem()
    evals = _evals_problem(streamed=True)

    def both():
        sweep(gens, state, False, 1.0)
        evals()

    prof, recorded = _profiled(both)
    named = [e for e in prof.events() if e.name in SPAN_NAMES]
    assert {e.name for e in named} == {s[0] for s in recorded}
    assert len(named) == len(recorded)
    for e in named:
        assert not e.is_user_annotation, e.name
        assert e.device_type != torch.autograd.DeviceType.CUDA, e.name


def test_a_second_profiling_session_starts_with_an_empty_store():
    _, first = _profiled(_evals_problem(streamed=False))
    assert len(first) == 2
    with timer("outside a session"):
        pass
    _, second = _profiled(lambda: timer("alone").__enter__().__exit__(None, None, None))
    assert [s[0] for s in second] == ["alone"]


def test_timer_elapsed_and_echo_are_unchanged(capsys):
    with timer("t") as t:
        time.sleep(0.02)
    assert 0.02 <= t.elapsed < 1.0
    assert capsys.readouterr().out == ""
    with timer("phase", echo=True) as t:
        pass
    assert capsys.readouterr().out == f"[phase] {t.elapsed:.3f}s\n"
    with profile(activities=[ProfilerActivity.CPU]):
        with timer("phase", echo=True) as t:
            time.sleep(0.01)
    assert t.elapsed >= 0.01
    assert capsys.readouterr().out == f"[phase] {t.elapsed:.3f}s\n"


def test_a_span_raises_through_and_closes():
    with timer("between sessions"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with timer("sweep"):
                raise ValueError("inside")
        with timer("sweep.glm"):
            pass
    assert [(s[0], s[3]) for s in spans()] == [("sweep", 0), ("sweep.glm", 0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc to build and launch the kernels")
    return torch.device("cuda")


@pytest.mark.cuda
def test_program_spans_are_not_device_operations_on_the_card(cuda, monkeypatch):
    """The flagship sweep (N=27, T=60,000, 16 chains) profiled on the card
    with its spans recorded and with them switched off, three times each
    in turns after two profiled sweeps that are not counted: no device
    operation named as a span, and the same median count of operations.
    The median, as a profiled sweep now and then counts a fill or a copy
    more or fewer than the others, with the spans on or off alike."""
    sweep, gens, state = _sweep_problem(C=16, N=27, T=60_000, device=cuda, dtype=torch.float32)
    state = sweep(gens, state, False, 1.0)
    torch.cuda.synchronize()
    start = [g.get_state() for g in gens]
    recording = metrics._profiler_enabled

    def device_ops(record):
        monkeypatch.setattr(metrics, "_profiler_enabled", recording if record else lambda: False)
        for g, s in zip(gens, start):
            g.set_state(s)
        with timer("between sessions"):
            pass
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sweep(gens, state, False, 1.0)
            torch.cuda.synchronize()
        return Counter(e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA), spans()

    device_ops(True)
    device_ops(False)
    runs = {True: [], False: []}
    for record in (True, False) * 3:
        ops, recorded = device_ops(record)
        runs[record].append(ops)
        if record:
            on_spans = recorded
        else:
            assert recorded == on_spans  # switched off, the store is left as it was
    ran = [s for s in ("glm", "imp", "latent") if s in state] + ["hypers", "adjacency", "discrete", "rotation"]
    assert sorted(s[0] for s in on_spans) == sorted(["sweep"] + ["sweep." + s for s in ran])
    names = set().union(*runs[True], *runs[False])
    assert names and not names & SPAN_NAMES
    counts = {side: sorted(sum(c.values()) for c in ops) for side, ops in runs.items()}
    assert counts[True][1] == counts[False][1], counts
