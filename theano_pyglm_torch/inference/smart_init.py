"""Smart initialization for MAP/MCMC — port of
:mod:`theano_pyglm_tpu.inference.smart_init`.

- bias: log of the empirical firing rate (exact MAP for a bias-only exp-GLM);
- stimulus filters: ridge-regularized least squares of the centered spikes on
  the stimulus design (a whitened spike-triggered average);
- coupling: short-lag excess cross-correlation between neuron pairs seeds W
  (and the adjacency, for graph models that infer it);
- SBM types: spectral clustering of the adjacency guess (numpy).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["smart_initialize"]


def _xcorr_coupling(S: torch.Tensor, L: int) -> torch.Tensor:
    """(N_post, N_pre) short-lag excess cross-correlation: mean of
    (centered) S_post[t] · S_pre[t-1-l] over l < L, normalized per pair."""
    Sc = S - S.mean(0, keepdim=True)
    T, N = S.shape
    acc = S.new_zeros((N, N))
    for lag in range(1, L + 1):
        acc = acc + Sc[lag:].T @ Sc[:-lag]  # (N_post, N_pre)
    var = Sc.var(0, correction=0)
    denom = torch.sqrt(torch.outer(var, var)) * (T - L) * L
    return acc / torch.clamp(denom, min=1e-12)


def _kmeans_labels(emb, K, n_iter: int = 50, seed: int = 0):
    """Tiny deterministic Lloyd's k-means on the spectral embedding (numpy)."""
    rng = np.random.RandomState(seed)
    centers = [emb[rng.randint(len(emb))]]
    for _ in range(K - 1):
        d2 = np.min([np.sum((emb - c) ** 2, axis=1) for c in centers], axis=0)
        p = d2 / max(d2.sum(), 1e-12)
        centers.append(emb[rng.choice(len(emb), p=p)])
    centers = np.stack(centers)
    labels = np.zeros(len(emb), dtype=np.int64)
    for _ in range(n_iter):
        d = ((emb[:, None, :] - centers[None]) ** 2).sum(-1)
        new = d.argmin(1)
        if np.array_equal(new, labels):
            break
        labels = new
        for k in range(K):
            if np.any(labels == k):
                centers[k] = emb[labels == k].mean(0)
    return labels


@torch.no_grad()
def smart_initialize(pop, data, generator: torch.Generator | None = None) -> dict:
    """Data-driven initial parameter dict for ``pop`` given ``data``.

    Leaves the data says nothing about come from ``pop.sample(generator)``
    (a CPU generator seeded with 0 by default).
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = pop.sample(generator)
    S = data["S"]
    T = S.shape[0]

    # --- bias: log mean rate (floor at 0.1 Hz to avoid -inf for silent cells)
    params["bias"] = torch.log(torch.clamp(S.mean(0) / pop.dt, min=0.1))

    # --- stimulus weights: ridge least squares of centered spikes on the design
    if "w_stim" in params and "X_stim" in data:
        X = data["X_stim"]  # (T, D·B)
        Sc = S - S.mean(0, keepdim=True)
        eye = torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
        w = torch.linalg.solve(X.T @ X + 1e-3 * T * eye, X.T @ Sc)  # (D·B, N)
        # scale into log-rate units: match a modest modulation depth
        params["w_stim"] = (w / torch.clamp(w.abs().max(), min=1e-6)).T

    # --- normalized impulses start at the prior-mean logits: W carries the
    # magnitude and a random per-pair shape would dilute every edge's evidence
    if "w_ir" in params and pop.spec.get("impulse", {}).get("type") == "normalized":
        mu_ir = torch.as_tensor(pop.spec["impulse"].get("mu", 0.0), dtype=pop.dtype, device=pop.device)
        params["w_ir"] = mu_ir.expand_as(params["w_ir"]).clone()

    # --- coupling from cross-correlograms
    xc = _xcorr_coupling(S, min(pop.L_imp, 20))
    if "W" in params:
        params["W"] = xc / torch.clamp(xc.abs().max(), min=1e-6)
        if not pop.graph.fixed_A:
            # Only for graph models that infer A: a fixed (complete) graph
            # never updates A, so thresholding would sever edges for good.
            thresh = torch.quantile(xc.abs().flatten(), 0.75)
            params["A"] = (xc.abs() >= thresh).to(params["A"].dtype)
        if pop.graph.name == "sbm" and "y" in params:
            # Seed the latent types by spectral clustering of the adjacency
            # guess, and the block matrix / mixing weights from the counts.
            K = int(pop.spec["network"]["graph"].get("K", 2))
            A_g = params["A"].cpu().numpy().astype(np.float64)
            M = A_g + A_g.T
            M = M - M.mean()
            _, vecs = np.linalg.eigh(M)
            y = _kmeans_labels(vecs[:, -K:], K)
            onehot = np.eye(K)[y]
            counts = onehot.sum(0)
            pi = (counts + 1.0) / (counts.sum() + K)
            Bm = np.clip((onehot.T @ A_g @ onehot + 1.0) / (np.outer(counts, counts) + 2.0), 1e-3, 1 - 1e-3)
            params["y"] = torch.as_tensor(y, dtype=params["y"].dtype, device=pop.device)
            params["pi"] = torch.as_tensor(pi, dtype=params["pi"].dtype, device=pop.device)
            params["Bm"] = torch.as_tensor(Bm, dtype=params["Bm"].dtype, device=pop.device)
    elif "w_ir" in params:
        # constant-weight models: the correlation structure goes into the
        # impulse weights' overall scale (first basis column).
        w_ir = torch.zeros_like(params["w_ir"])
        w_ir[:, :, 0] = xc
        params["w_ir"] = w_ir

    return params
