"""Plain reference of the network GLM's log-joint and its gradient.

Written from the model's equations, not from the program: it imports
nothing of the package under test and rebuilds every table it needs (the
raised-cosine bases, the causal designs) from the configuration and the raw
inputs (spikes, stimulus, parameters) that the benchmark made itself.

The model (one chain), for postsynaptic neuron n at bin t:

    I[t, n]  = bias[n] + Σ_d Xs[t, d] w_stim[n, d]
               + Σ_p Σ_b X[t, p, b] · A[n, p] W[n, p] softmax(w_ir[n, p])_b
    LL       = Σ_t,n S·(clip(I) + log dt) − exp(clip(I))·dt − log S!

with X[t, p, b] = Σ_l basis_imp[l, b] S[t−1−l, p] (strictly causal, zeros
before t = 0), Xs the stimulus filtered the same way by the stimulus
basis, and clip at ±40 (λ and log λ clipped at the same point). Priors:
bias, w_stim, w_ir (per-column means) and W (its own diagonal mean and
scale) Gaussian; the graph either Erdős–Rényi, A ~ Bern(ρ), or
distance-dependent, locs ~ N(0, σ_l²), A ~ Bern(σ(η0 − ‖ℓ_n − ℓ_p‖²/τ²)),
with probabilities clamped to [1e-12, 1 − 1e-12].

The likelihood and its gradient are summed over time blocks, each with
its own design rebuilt from the spikes (the exact L-bin history), so a
long recording needs one block's design at a time. Its gradient is
written out (dLL/dI = S − λ·dt where the clip is inactive); the softmax
and the priors, which are small, go through autograd.

``precision="float64"`` is the reference. ``precision="tf32"`` is the
control: float32 arithmetic with every product's operands rounded to TF32
(10 mantissa bits), the precision a float32 matrix product takes on the
card's tensor cores when TF32 is allowed.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["cosine_basis", "causal_filter", "design_blocks", "log_likelihood_and_grad", "log_prior_and_grad",
           "log_joint_and_grad", "weight_prior", "edge_logits", "CONTINUOUS"]

EXP_CLIP = 40.0
_LOG2PI = math.log(2.0 * math.pi)
#: the continuous leaves whose gradient is compared
CONTINUOUS = ("bias", "w_stim", "w_ir", "W", "locs")


def cosine_basis(L: int, n_bas: int, a: float = 1.0, b: float = 1.0) -> np.ndarray:
    """(L, n_bas) raised cosines equally spaced in u = log(a·l + b) over the
    lags l = 1..L, each column scaled to unit sum (Pillow et al. 2008)."""
    u = np.log(a * (np.arange(L, dtype=np.float64) + 1.0) + b)
    centers = np.linspace(u[0], u[-1], n_bas)
    width = centers[1] - centers[0]
    arg = np.clip((u[:, None] - centers[None, :]) * np.pi / (2.0 * width), -np.pi, np.pi)
    phi = 0.5 * (np.cos(arg) + 1.0)
    return phi / phi.sum(0)


def _basis(spec: dict, dt: float) -> np.ndarray:
    b = spec["basis"]
    if b["type"] != "cosine" or not b.get("norm", True):
        raise ValueError(f"the reference knows unit-sum cosine bases, not {b}")
    return cosine_basis(int(round(spec["dt_max"] / dt)), int(b["n_bas"]), float(b["a"]), float(b["b"]))


def causal_filter(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """out[t, n, b] = Σ_l basis[l, b] · x[t − 1 − l, n] for x (T + L, N)
    whose first L rows are the history before the block: (T, N, B). One
    cross-correlation (``conv1d``) of each column with the reversed basis."""
    L = basis.shape[0]
    T = x.shape[0] - L
    w = torch.flip(basis, (0,)).T[:, None, :]  # (B, 1, L)
    out = F.conv1d(x.T[:, None, :], w)  # (N, B, T + 1)
    return out[:, :, :T].permute(2, 0, 1)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    return _tf32(a) @ _tf32(b) if tf32 else a @ b


def coupling_weights(w_ir, A, W) -> torch.Tensor:
    """U[p·B + b, n] = A[n, p] W[n, p] softmax(w_ir[n, p])_b: (N·B, N)."""
    N, _, B = w_ir.shape
    u = torch.softmax(w_ir, -1) * (A * W)[:, :, None]  # (n, p, b)
    return u.permute(1, 2, 0).reshape(N * B, N)


def _float(precision: str):
    if precision not in ("float64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    return torch.float32 if precision == "tf32" else torch.float64


def design_blocks(model: dict, S: torch.Tensor, stim: torch.Tensor, block: int = 65_536,
                  precision: str = "float64") -> list:
    """[(t0, t1, X (Tb, N·B), Xs (Tb, D·Bs))]: the impulse and stimulus
    designs of the recording in time blocks of ``block`` bins, each rebuilt
    from the raw spikes and stimulus (with the L bins before it)."""
    f = _float(precision)
    dev, dt = S.device, float(model["dt"])
    basis_imp = torch.as_tensor(_basis(model["impulse"], dt), dtype=f, device=dev)
    basis_stim = torch.as_tensor(_basis(model["bkgd"], dt), dtype=f, device=dev)
    L, Ls = basis_imp.shape[0], basis_stim.shape[0]
    T, N = S.shape
    S = S.to(f)
    stim = stim.to(f).reshape(T, -1)
    out = []
    for t0 in range(0, T, block):
        t1 = min(t0 + block, T)
        hist = S[max(t0 - L, 0):t1]
        hist = torch.cat([hist.new_zeros((L - (t0 - max(t0 - L, 0)), N)), hist])
        X = causal_filter(hist, basis_imp).reshape(t1 - t0, -1)  # (Tb, N·B)
        sh = stim[max(t0 - Ls, 0):t1]
        sh = torch.cat([sh.new_zeros((Ls - (t0 - max(t0 - Ls, 0)), sh.shape[1])), sh])
        Xs = causal_filter(sh, basis_stim).reshape(t1 - t0, -1)  # (Tb, D·Bs)
        out.append((t0, t1, X, Xs))
    return out


def log_likelihood_and_grad(model: dict, params: dict, S: torch.Tensor, stim: torch.Tensor,
                            block: int = 65_536, precision: str = "float64", blocks=None,
                            with_abs: bool = False):
    """(LL, {bias, w_stim, w_ir, W: dLL/d leaf}) of one chain's ``params``
    on spikes S (T, N) and stimulus (T, 1), in time blocks of ``block``
    bins, on S's device. ``blocks``: the :func:`design_blocks` of the same
    recording and precision, made once for many calls. ``with_abs`` adds a
    third element, Σ |each summand of LL|, the scale of LL's rounding."""
    tf32 = precision == "tf32"
    f = _float(precision)
    dev = S.device
    dt = float(model["dt"])
    p = {k: params[k].to(dev, f) for k in ("bias", "w_stim", "w_ir", "A", "W")}
    T, N = S.shape
    w_ir = p["w_ir"].detach().requires_grad_(True)
    W = p["W"].detach().requires_grad_(True)
    U = coupling_weights(w_ir, p["A"], W)
    Ud = U.detach()
    S = S.to(f)
    ll = torch.zeros((), dtype=torch.float64, device=dev)
    size = torch.zeros((), dtype=torch.float64, device=dev)
    g_bias = torch.zeros(N, dtype=f, device=dev)
    g_stim = torch.zeros_like(p["w_stim"])
    g_U = torch.zeros_like(Ud)
    for t0, t1, X, Xs in blocks if blocks is not None else design_blocks(model, S, stim, block, precision):
        Sb = S[t0:t1]
        I = p["bias"] + _mm(Xs, p["w_stim"].T, tf32) + _mm(X, Ud, tf32)
        Ic = torch.clamp(I, -EXP_CLIP, EXP_CLIP)
        lam_dt = torch.exp(Ic) * dt
        terms = Sb * (Ic + math.log(dt)) - lam_dt - torch.lgamma(Sb + 1.0)
        # the control sums each block in float32, as a float32 program would
        ll = ll + (terms.sum().double() if tf32 else terms.sum())
        if with_abs:
            size = size + (Sb * (Ic + math.log(dt))).abs().sum().double() + (lam_dt + torch.lgamma(Sb + 1.0)).sum()
        dI = (Sb - lam_dt) * (I.abs() < EXP_CLIP)
        g_bias += dI.sum(0)
        g_stim += _mm(dI.T, Xs, tf32)
        g_U += _mm(X.T, dI, tf32)
    g_wir, g_W = torch.autograd.grad(U, (w_ir, W), grad_outputs=g_U)
    grads = {"bias": g_bias, "w_stim": g_stim, "w_ir": g_wir, "W": g_W}
    return (float(ll), grads, float(size)) if with_abs else (float(ll), grads)


def _gauss(x, mu, sigma):
    z = (x - mu) / sigma
    return -0.5 * (z * z + _LOG2PI) - torch.log(torch.as_tensor(sigma, dtype=x.dtype, device=x.device))


def _bernoulli(a, prob):
    prob = torch.clamp(prob, 1e-12, 1.0 - 1e-12)
    return torch.special.xlogy(a, prob) + torch.special.xlogy(1.0 - a, 1.0 - prob)


def log_prior_and_grad(model: dict, params: dict, precision: str = "float64"):
    """(log-prior, {component: its log-prior}, {leaf: d log-prior / d leaf})
    of one chain's ``params``, for the Gaussian weights and either graph."""
    f = torch.float32 if precision == "tf32" else torch.float64
    x = {k: params[k].to(f).detach().requires_grad_(k != "A") for k in ("bias", "w_stim", "w_ir", "A", "W")}
    if "locs" in params:
        x["locs"] = params["locs"].to(f).detach().requires_grad_(True)
    N = x["A"].shape[0]
    eye = torch.eye(N, dtype=f, device=x["A"].device)
    bias, bkgd, imp = model["bias"], model["bkgd"], model["impulse"]
    graph = model["network"]["graph"]
    mu_b = torch.as_tensor(imp["mu"], dtype=f, device=eye.device)
    parts = {
        "bias": _gauss(x["bias"], bias["mu"], bias["sigma"]).sum(),
        "bkgd": _gauss(x["w_stim"], bkgd["mu"], bkgd["sigma"]).sum(),
        "impulse": _gauss(x["w_ir"], mu_b, imp["sigma"]).sum(),
    }
    mu_w, sd_w = weight_prior(model, N, f, eye.device)
    parts["weights"] = (-0.5 * (((x["W"] - mu_w) / sd_w) ** 2 + _LOG2PI) - torch.log(sd_w)).sum()
    logits = edge_logits(model, x)
    parts["graph"] = _bernoulli(x["A"], torch.sigmoid(logits)).sum()
    if graph["type"] == "distance":
        parts["graph"] = parts["graph"] + _gauss(x["locs"], 0.0, graph["sigma_l"]).sum()
    total = sum(parts.values())
    leaves = [k for k in CONTINUOUS if k in x]
    grads = torch.autograd.grad(total, [x[k] for k in leaves])
    return float(total.detach()), {k: float(v.detach()) for k, v in parts.items()}, dict(zip(leaves, grads))


def weight_prior(model: dict, N: int, dtype, device) -> tuple:
    """(μ, σ) of each weight W[n, p]: (N, N), the self-coupling's on the
    diagonal."""
    wt = model["network"]["weight"]
    eye = torch.eye(N, dtype=dtype, device=device)
    return wt["mu"] * (1 - eye) + wt["mu_self"] * eye, wt["sigma"] * (1 - eye) + wt["sigma_self"] * eye


def edge_logits(model: dict, params: dict) -> torch.Tensor:
    """(N, N) logit of each edge's prior probability: log ρ/(1 − ρ) for
    Erdős–Rényi, η0 − ‖ℓ_n − ℓ_p‖²/τ² for the distance graph (the
    probability clamped to [1e-12, 1 − 1e-12] where it is used)."""
    graph = model["network"]["graph"]
    A = params["A"]
    if graph["type"] == "erdos_renyi":
        rho = graph["rho"]
        return torch.full_like(A, math.log(rho) - math.log1p(-rho))
    if graph["type"] == "distance":
        locs = params["locs"]
        d2 = ((locs[:, None, :] - locs[None, :, :]) ** 2).sum(-1)
        return graph["eta0"] - d2 / graph["tau"] ** 2
    raise ValueError(f"the reference knows the erdos_renyi and distance graphs, not {graph['type']!r}")


def log_joint_and_grad(model: dict, params: dict, S: torch.Tensor, stim: torch.Tensor,
                       block: int = 65_536, precision: str = "float64", blocks=None):
    """(log-joint, {leaf: gradient}, LL, {component: log-prior}) of one
    chain's ``params``; the gradient over :data:`CONTINUOUS` (locs with the
    distance graph). ``blocks`` as :func:`log_likelihood_and_grad` has it."""
    ll, g_ll = log_likelihood_and_grad(model, params, S, stim, block, precision, blocks)
    lp, parts, g_lp = log_prior_and_grad(model, {k: v.to(S.device) for k, v in params.items()}, precision)
    grads = {k: g_lp[k] + g_ll.get(k, 0.0) for k in g_lp}
    return ll + lp, grads, ll, parts
