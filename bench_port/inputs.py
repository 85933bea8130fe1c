"""The benchmark's inputs, made from ``--seed`` alone: the generating
parameters, the stimulus and the spikes. The program under test receives
them as they are; the reference reads the same tensors.

Recipes, rewritten here in torch and numpy (the originals stay where they
are): the flagship's prior draw of a ``distance_weighted_model`` with a
white-noise stimulus and spikes from the model's own generative process
(``theano_pyglm_torch/scripts/rgc_flagship.py``); the long recording's
planted network, an Erdős–Rényi draw with weights ±1.5 and self-coupling
−2 (``theano_pyglm_torch/scripts/stretch_streaming.py``), with spikes drawn
independently at each neuron's bias rate (``bench.py``'s recipe: only the
likelihood's throughput is timed there); and the stochastic block model's
law (``models/network.py``, the 'sbm' graph) for a configuration whose
graph is one.

Parameters and stimulus are drawn on the device with a ``torch.Generator``
seeded from the seed, in float32, the dtype the program runs in; the
reference widens the same values. The flagship's spikes come from a
simulation on the host (numpy, float64): the process is sequential in
time, and each spike adds its neuron's L-bin impulse response to the
currents ahead of it, so a bin costs a few vector operations.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port.reference.glm import EXP_CLIP, causal_filter, cosine_basis

__all__ = ["make_inputs", "seeds"]

RATE_MAX = 1e4  # spikes/s: the generative process clips runaway rates here


def seeds(seed: int, n: int) -> list:
    """``n`` 62-bit seeds drawn from ``seed`` (any size of whole number)."""
    ss = np.random.SeedSequence(int(seed))
    return [int(x) >> 2 for x in ss.generate_state(n, dtype=np.uint64)]


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _basis(spec: dict, dt: float, device) -> torch.Tensor:
    b = spec["basis"]
    L = int(round(spec["dt_max"] / dt))
    return torch.as_tensor(cosine_basis(L, int(b["n_bas"]), float(b["a"]), float(b["b"])), device=device)


def _prior_draw(cfg: dict, g: torch.Generator, device) -> dict:
    """The parameters of the configuration's recipe, float32 on ``device``."""
    spec = cfg["spec"]
    N = spec["N"]
    B = int(spec["impulse"]["basis"]["n_bas"])
    DB = int(spec["bkgd"]["D_stim"]) * int(spec["bkgd"]["basis"]["n_bas"])
    f = torch.float32

    def normal(shape, mu, sd):
        return mu + sd * torch.randn(shape, generator=g, dtype=f, device=device)

    bias, bkgd, imp = spec["bias"], spec["bkgd"], spec["impulse"]
    wt, graph = spec["network"]["weight"], spec["network"]["graph"]
    p = {
        "bias": normal((N,), bias["mu"], bias["sigma"]),
        "w_stim": normal((N, DB), bkgd["mu"], bkgd["sigma"]),
        "w_ir": normal((N, N, B), torch.as_tensor(imp["mu"], dtype=f, device=device), imp["sigma"]),
    }
    eye = torch.eye(N, dtype=f, device=device)
    if graph["type"] == "distance":
        locs = normal((N, graph["D"]), 0.0, graph["sigma_l"])
        d2 = ((locs[:, None, :] - locs[None, :, :]) ** 2).sum(-1)
        prob = torch.sigmoid(graph["eta0"] - d2 / graph["tau"] ** 2)
        p["locs"] = locs
    elif graph["type"] == "erdos_renyi":
        prob = torch.full((N, N), graph["rho"], dtype=f, device=device)
    elif graph["type"] == "sbm":
        prob = _sbm_draw(graph, cfg.get("planted", {}), N, p, g, device)
    else:
        raise ValueError(f"no recipe for the {graph['type']!r} graph")
    p["A"] = (torch.rand((N, N), generator=g, dtype=f, device=device) < prob).to(f)
    planted = cfg.get("planted", {})
    if "W_abs" not in planted:
        mu = wt["mu"] * (1 - eye) + wt["mu_self"] * eye
        sd = wt["sigma"] * (1 - eye) + wt["sigma_self"] * eye
        p["W"] = mu + sd * torch.randn((N, N), generator=g, dtype=f, device=device)
    else:
        sign = torch.where(torch.rand((N, N), generator=g, dtype=f, device=device) < 0.5, 1.0, -1.0)
        W = planted["W_abs"] * sign * (1 - eye) + planted["W_self"] * eye
        p["W"] = W * p["A"]
    return p


def _gamma(alpha: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """Gamma(alpha, 1) draws, one an entry of ``alpha``."""
    return torch._standard_gamma(alpha.contiguous(), generator=g)


def _sbm_draw(graph: dict, planted: dict, N: int, p: dict, g: torch.Generator, device) -> torch.Tensor:
    """The stochastic block model's latents, put into ``p`` (π, the types y
    (int64) and the block probabilities "Bm"), and each edge's probability
    B[y_n, y_m]: π ~ Dir(α0·1_K), y_n ~ Cat(π), B[k, k'] ~ Beta(b0, b1), or
    the planted (K, K) "B" where the configuration gives one."""
    K, f = int(graph["K"]), torch.float32
    b0, b1 = (float(v) for v in graph["B_prior"])
    gam = _gamma(torch.full((K,), float(graph["alpha0"]), dtype=f, device=device), g)
    pi = gam / gam.sum()
    y = torch.multinomial(pi, N, replacement=True, generator=g)
    if "B" in planted:
        Bm = torch.as_tensor(planted["B"], dtype=f, device=device)
    else:
        ga = _gamma(torch.full((K, K), b0, dtype=f, device=device), g)
        gb = _gamma(torch.full((K, K), b1, dtype=f, device=device), g)
        Bm = ga / (ga + gb)
    p.update(pi=pi, y=y, Bm=Bm)
    return Bm[y[:, None], y[None, :]]


def _stimulus_current(cfg: dict, p: dict, stim: torch.Tensor) -> torch.Tensor:
    """bias + the stimulus current, (T, N) float64."""
    spec = cfg["spec"]
    basis = _basis(spec["bkgd"], spec["dt"], stim.device)
    s = stim.double()
    hist = torch.cat([s.new_zeros((basis.shape[0], s.shape[1])), s])
    Xs = causal_filter(hist, basis).reshape(s.shape[0], -1)
    return p["bias"].double() + Xs @ p["w_stim"].double().T


def simulate(cfg: dict, p: dict, stim: torch.Tensor, rng: np.random.Generator) -> np.ndarray:
    """(T, N) float32 spike counts from the model's generative process:
    S[t] ~ Poisson(min(exp(clip(I[t])), RATE_MAX)·dt), where each spike of
    neuron p at t adds A[n, p] W[n, p] Σ_b softmax(w_ir[n, p])_b basis[l, b]
    to I[t + 1 + l, n]."""
    spec = cfg["spec"]
    dt, N, T = spec["dt"], spec["N"], stim.shape[0]
    I0 = _stimulus_current(cfg, p, stim).cpu().numpy()
    basis = _basis(spec["impulse"], dt, "cpu").numpy()
    L = basis.shape[0]
    w_eff = torch.softmax(p["w_ir"].double(), -1).cpu().numpy()
    G = (p["A"] * p["W"]).double().cpu().numpy()
    H = np.einsum("npb,lb->pln", w_eff * G[:, :, None], basis)  # (pre, lag, post)
    I_net = np.zeros((T + L + 1, N))
    S = np.zeros((T, N), dtype=np.float32)
    for t in range(T):
        lam = np.minimum(np.exp(np.clip(I0[t] + I_net[t], -EXP_CLIP, EXP_CLIP)), RATE_MAX)
        s = rng.poisson(lam * dt)
        if s.any():
            S[t] = s
            nz = np.flatnonzero(s)
            I_net[t + 1:t + 1 + L] += np.tensordot(s[nz], H[nz], 1)
    return S


def make_inputs(cfg: dict, seed: int, device) -> dict:
    """{"params": generating parameters (float32), "stim": (T, 1) float32,
    "S": (T, N) float32 spike counts}, on ``device``; the same seed gives
    the same inputs on the same kind of device.

    With ``cfg["spikes"] == "simulate"`` a draw whose spikes run above
    ``max_rate_hz`` on average (a network past criticality) is set aside
    for the next draw of the same seed, at most ``max_draws`` times."""
    spec = cfg["spec"]
    T, N, dt = cfg["T"], spec["N"], spec["dt"]
    s_par, s_stim, s_spk = seeds(seed, 3)
    g = _gen(s_par, device)
    stim = torch.randn((T, 1), generator=_gen(s_stim, device), dtype=torch.float32, device=device)
    rule = cfg["spikes"]
    if rule["type"] == "simulate":
        rng = np.random.Generator(np.random.PCG64(np.random.SeedSequence(s_spk)))
        for _ in range(rule["max_draws"]):
            p = _prior_draw(cfg, g, device)
            S = simulate(cfg, p, stim, rng)
            if S.mean() / dt <= rule["max_rate_hz"]:
                break
        else:
            raise RuntimeError(f"seed {seed}: no draw in {rule['max_draws']} stayed under {rule['max_rate_hz']} Hz")
        S = torch.as_tensor(S, device=device)
    elif rule["type"] == "poisson_at_bias":
        p = _prior_draw(cfg, g, device)
        lam = (torch.exp(p["bias"]) * dt).expand(T, N).contiguous()
        S = torch.poisson(lam, generator=_gen(s_spk, device))
    else:
        raise ValueError(f"unknown spike rule {rule['type']!r}")
    return {"params": p, "stim": stim, "S": S}
