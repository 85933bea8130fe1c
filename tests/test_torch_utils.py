"""The port's spike-triggered average (theano_pyglm_torch/utils/sta.py) and
IO utilities (utils/io.py) against the JAX package's, on the CPU."""

import os

import numpy as np
import pytest
import torch

from theano_pyglm_torch.utils import io as io_t
from theano_pyglm_torch.utils.sta import sta
from theano_pyglm_tpu.utils import io as io_j
from theano_pyglm_tpu.utils.binning import bin_spikes
from theano_pyglm_tpu.utils.sta import sta as sta_j


@pytest.mark.parametrize("T,D,N,L", [(60, 2, 3, 4), (200, 1, 2, 30), (5, 3, 2, 8)])
def test_sta_matches_jax(T, D, N, L):
    """Strictly causal lags 1..L (L beyond T included), a silent neuron's
    zero average, 1-D stimulus: JAX's values to 1e-12."""
    r = np.random.RandomState(T)
    stim = r.randn(T, D)
    S = r.poisson(0.3, (T, N)).astype(float)
    S[:, -1] = 0.0
    got = sta(stim, S, L, device="cpu")
    assert got.shape == (N, L, D) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(sta_j(stim, S, L)), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(sta(torch.tensor(stim[:, 0]), torch.tensor(S), L).numpy(),
                               np.asarray(sta_j(stim[:, 0], S, L)), rtol=1e-12, atol=1e-15)


def test_segment_data_matches_jax():
    r = np.random.RandomState(0)
    S, stim = r.poisson(1.0, (103, 3)), r.randn(103, 2)
    for frac in (0.8, 0.5, 0.71):
        for args in ((S, stim), (S, None)):
            got, want = io_t.segment_data(*args, train_frac=frac), io_j.segment_data(*args, train_frac=frac)
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    assert (a is None and b is None) or np.array_equal(a, b)


def test_results_roundtrip_and_cross_read(tmp_path):
    """Each package reads what the other wrote, .npz (one nested level) and
    .pkl."""
    results = {"a": np.arange(3.0), "nested": {"b": np.eye(2), "c": np.ones(4)}}
    for ext in (".npz", ".pkl"):
        for save, load in ((io_t.save_results, io_j.load_results), (io_j.save_results, io_t.load_results)):
            path = os.path.join(tmp_path, "sub", f"r{ext}")
            save(path, results)
            back = load(path)
            np.testing.assert_array_equal(back["a"], results["a"])
            for k in ("b", "c"):
                np.testing.assert_array_equal(back["nested"][k], results["nested"][k])


def test_load_data_matches_jax(tmp_path):
    """Dense and event-format .npz: the same dict; events are binned to the
    JAX package's counts bit for bit (boundary times, out-of-range events
    and neurons dropped)."""
    r = np.random.RandomState(1)
    dense = os.path.join(tmp_path, "d.npz")
    np.savez(dense, S=r.poisson(0.1, (50, 3)), dt=1e-3, stim=r.randn(50, 1))
    times = np.concatenate([r.uniform(0, 2.0, 500), np.arange(0, 2.0, 1e-3)[:300], [-0.1, 2.5, 0.3]])
    neurons = np.concatenate([r.randint(0, 4, 500), r.randint(0, 4, 300), [0, 1, 7]])
    events = os.path.join(tmp_path, "e.npz")
    np.savez(events, spike_times=times, spike_neurons=neurons, dt=1e-3, T_sec=2.0, N=4)
    for path in (dense, events):
        got, want = io_t.load_data(path), io_j.load_data(path)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert np.array_equal(io_t.load_data(events)["S"], bin_spikes(times, neurons, 2000, 1e-3, 4, use_native=False))
    with pytest.raises(ValueError, match="unknown data format"):
        io_t.load_data(os.path.join(tmp_path, "x.csv"))


def test_cli_flags_match_jax():
    """The reference's flags as JAX parses them, plus the port's --device
    (default cuda)."""
    argv = ["--dataFile", "x.npz", "-N", "5", "--T", "2.5", "--resume", "--checkpoint_every", "10", "--xv"]
    for args in (argv, []):
        got, want = vars(io_t.parse_cmd_line_args(args)), vars(io_j.parse_cmd_line_args(args))
        assert got.pop("device") == "cuda" and got == want
    assert io_t.parse_cmd_line_args(["--device", "cpu"]).device == "cpu"
