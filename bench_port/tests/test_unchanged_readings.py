"""The accepted cells read what they read before the harness took block model
graphs: the same draws, and the same readings under the same keys, value for
value. The readings are taken on a fixed state, built from the tiny cell's
inputs and seeded generators and not from the program's sweeps, so they pin
the harness and the reference and nothing of the program's rounding: the
"program" outputs are the float64 reference's own, each moved by a seeded
relative step of at most 1e-6. The golden values were recorded from the
harness as it stood before (tiny cells on the CPU, one thread, seed 11)."""

from __future__ import annotations

import hashlib

import pytest
import torch

from bench_port.inputs import _prior_draw, make_inputs
from bench_port.reference import glm as ref
from bench_port.tests import tiny

GOLDEN = {
    "flagship-c16": {
        "program": {
            "adj_gap": 2.872417142363304e-06,
            "hmc_gap": 5.9047840606120634e-06,
            "imp_logp_gap": 7.978430083068897e-07,
            "logjoint_gap": 2.2596402619383546e-07,
            "grad_gap": 6.936144639164358e-07,
            "stuck_chains": 1.0,
        },
        "control": {
            "adj_gap": 0.00042701032664882455,
            "hmc_gap": 2.396887464504619e-06,
            "imp_logp_gap": 8.386544178263618e-07,
            "logjoint_gap": 3.1770933428439707e-06,
            "grad_gap": 0.000239183969740633,
            "stuck_chains": 1.0,
        },
    },
    "long-resident-evals": {
        "program": {
            "logjoint_gap": 5.496313901132404e-07,
            "grad_gap": 6.563062162509982e-07,
        },
        "control": {
            "logjoint_gap": 6.455797860460586e-08,
            "grad_gap": 8.898973698429183e-05,
        },
    },
    "long-streamed-evals": {
        "program": {
            "logjoint_gap": 5.496313901132404e-07,
            "grad_gap": 6.563062162509982e-07,
        },
        "control": {
            "logjoint_gap": 6.455797860460586e-08,
            "grad_gap": 8.898973698429183e-05,
        },
    },
}
#: the readings' relative tolerance: float64 gaps of a 1e-6 step (1e-10 of
#: another CPU's summation order), and the control's float32 sums
REL = {"program": 1e-8, "control": 1e-4}
#: sha256 of each leaf's name and float32 bytes, in sorted order, of the tiny recipe's draw
DRAWS = {
    "flagship-c16": (["A", "W", "bias", "locs", "w_ir", "w_stim"],
                     "acc2ad4dbdfc1858291c0e79d09d6d70e147737d35f400e569f246d830367235"),
    "long-resident-evals": (["A", "W", "bias", "w_ir", "w_stim"],
                            "243b42d84c9e7fc1d8f4af8911e52a8b9186acbe3f0223c212a180bacb9c9a79"),
}
#: the continuous leaves that the fixed state moves from the recipe's draw
MOVED = ("bias", "w_stim", "w_ir", "locs", "W")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moved(d: dict, g: torch.Generator, scale: float) -> dict:
    return {k: v + scale * torch.randn(v.shape, generator=g, dtype=v.dtype) if k in MOVED else v.clone()
            for k, v in d.items()}


def _stepped(d: dict, g: torch.Generator) -> dict:
    """``d``'s tensors in float64, each value moved by a relative step drawn
    from (−1e-6, 1e-6)."""
    return {k: v.double() * (1 + 1e-6 * (2 * torch.rand(v.shape, generator=g, dtype=torch.float64) - 1))
            for k, v in d.items()}


def _sampler_state(ctx, inp, g) -> dict:
    """A sampler cell's judged outputs at a fixed state: C chains at the
    recipe's draw, moved thrice (start, previous, final sweep; chain 1 ends
    where it started), with seeded generators and step sizes."""
    drv = ctx["cell"]["driver"]
    C = ctx["traffic"]["chains"]
    params = {k: v.expand(C, *v.shape).clone() for k, v in inp["params"].items()}
    start = _moved(params, g, 0.05)
    prev = _moved(start, g, 0.02)
    final = _moved(prev, g, 0.02)
    for k in MOVED:
        if k in final:
            final[k][1] = start[k][1]
    leaves = [k for _, k in drv._HMC_LEAVES if k in final]
    fixed = {"final": final, "prev": prev, "start": start, "S": inp["S"], "stim": inp["stim"],
             "value": torch.zeros(C), "grads": {k: final[k] for k in ref.CONTINUOUS if k in final},
             "adj_gens": [torch.Generator().manual_seed(1000 + c).get_state() for c in range(C)],
             "hmc_gens": [torch.Generator().manual_seed(2000 + c).get_state() for c in range(C)],
             "hmc_step": {k: torch.full((C,), 0.02) for k in leaves},
             "hmc_scale": {k: 1 + 0.1 * torch.rand(final[k].shape, generator=g) for k in leaves},
             "hmc_out": {k: final[k] for k in leaves}}
    want = drv._values(ctx, fixed, "float64")
    stages = drv._stages(ctx, fixed, "float64", follow=False)
    return {**fixed, "value": _stepped({"v": want["value"]}, g)["v"],
            "imp_logp": _stepped({"v": want["imp_logp"]}, g)["v"], "grads": _stepped(want["grads"], g),
            "adj_out": {"A": stages["adj_out"]["A"], "W": _stepped({"W": stages["adj_out"]["W"]}, g)["W"]},
            "hmc_out": _stepped(stages["hmc_out"], g)}


def _evals_state(ctx, inp, g) -> dict:
    """An evals cell's judged outputs at the recipe's draw, moved once."""
    drv = ctx["cell"]["driver"]
    params = _moved(inp["params"], g, 0.05)
    fixed = {"params": params, "S": inp["S"], "stim": inp["stim"],
             "grads": {k: params[k] for k in ref.CONTINUOUS if k in params}}
    want = drv._values(ctx, fixed, "float64")
    return {**fixed, "value": _stepped({"v": want["value"]}, g)["v"], "grads": _stepped(want["grads"], g)}


def _fixed_readings(workload: str, seed: int = 11) -> dict:
    """The harness's readings, and the control's, of a tiny cell's outputs
    at a fixed state."""
    cell = tiny.cell(workload)
    drv = cell["driver"]
    ctx = {"cell": cell, "config": cell["config"], "traffic": cell["traffic"], "seed": seed,
           "device": torch.device("cpu"), "seconds": 0.0, "mesh": None, "host_group": None}
    inp = make_inputs(cell["config"], seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    judged = (_sampler_state if cell["traffic"]["driver"] == "sampler" else _evals_state)(ctx, inp, g)
    return {"program": drv.readings(ctx, judged),
            "control": drv.readings(ctx, {**judged, **drv.control_outputs(ctx, judged)})}


@pytest.mark.parametrize("workload", ["flagship-c16", "long-resident-evals", "long-streamed-evals"])
def test_accepted_cells_read_what_they_read_before(workload):
    got = _fixed_readings(workload)
    for side in ("program", "control"):
        assert got[side] == pytest.approx(GOLDEN[workload][side], rel=REL[side], abs=0), side


@pytest.mark.parametrize("workload", sorted(DRAWS))
def test_distance_and_erdos_renyi_draws_are_bit_for_bit_as_before(workload):
    p = _prior_draw(tiny.cell(workload)["config"], torch.Generator().manual_seed(12345), "cpu")
    h = hashlib.sha256()
    for k in sorted(p):
        h.update(k.encode())
        h.update(p[k].numpy().tobytes())
    assert (sorted(p), h.hexdigest()) == DRAWS[workload]
