"""Plain reference of the Gibbs sweep's discrete stage for a stochastic block
model graph, replayed from the draws the program's stage took: the collapsed
update of each neuron's type y_n, then the conjugate draws of the block
model's π and B.

Written from the model, not from the program: it imports nothing of the
package under test, and keeps its own counts of the types and the blocks
from the adjacency matrix and the types it is given. The stage's random
numbers are drawn again from the chain's generator, restored to its state
before the stage, with the calls the stage makes in the order it makes them:
uniforms (N, K) for the types' Gumbel noise, then Gamma(α0 + c_k) (K,) for
π, then Gamma(b0 + E) and Gamma(b1 + P − E) (K, K) for B, each in the
program's dtype.

The types, neuron by neuron: with (π, B) integrated out,

    log p(y_n = k | y_−n, A) = log(α0 + c_k)
        + Σ_blocks [betaln(b0 + E', b1 + P' − E') − betaln(b0 + E, b1 + P − E)] + const,

c, E and P the class counts, the block edge counts and the block pair
counts (ordered pairs, self-pairs included) over the other neurons, and
(E', P') the same with neuron n put in class k: its row adds to the blocks
of row k, its column to those of column k, its self-pair to block (k, k).
The new type is the argmax of these logits plus Gumbel noise
−log(−log u). Then π ~ Dir(α0 + c) and B[k, k'] ~ Beta(b0 + E, b1 + P − E)
from the counts of all neurons, B clipped to [1e-6, 1 − 1e-6].

Judged, the replay follows the judged types (``follow``): neuron n sees the
judged types of the neurons before it, so one judged type that differs does
not spread, and the hypers are drawn from the counts of the judged types. A
type whose score lies within the float32 rounding bound of the logit sums
(``sweep._band``, over the magnitudes of the lgamma terms that do not cancel,
the class count's log and the noise) of the best score may be the judged
one; any other judged type counts.
"""

from __future__ import annotations

import torch

from bench_port.reference.glm import sbm_hypers
from bench_port.reference.sweep import _band, _gen

__all__ = ["discrete_replay"]

B_CLIP = 1e-6


def _counts(A: torch.Tensor, y: torch.Tensor, K: int) -> tuple:
    """(c (K,), E (K, K), P (K, K)): class counts, block edges
    E[k, k'] = Σ_{y_n = k, y_m = k'} A[n, m], and block pairs c_k c_k'."""
    Z = torch.zeros((y.shape[0], K), dtype=A.dtype, device=A.device)
    Z[torch.arange(y.shape[0], device=A.device), y] = 1.0
    c = Z.sum(0)
    return c, Z.T @ A @ Z, torch.outer(c, c)


def _block_terms(E: torch.Tensor, P: torch.Tensor, b0: float, b1: float) -> tuple:
    """(betaln(b0 + E, b1 + P − E), the sum of its three lgammas' magnitudes)."""
    a, b = b0 + E, b1 + P - E
    la, lb, lab = torch.lgamma(a), torch.lgamma(b), torch.lgamma(a + b)
    return la + lb - lab, la.abs() + lb.abs() + lab.abs()


def _type_scores(A, y, n: int, K: int, alpha0: float, b0: float, b1: float, gumbel) -> tuple:
    """(scores (K,), rounding bounds (K,)) of neuron n's types: the
    collapsed log-marginal logits plus the noise, each with the float32
    rounding bound of the sums it is made of."""
    others = torch.ones(A.shape[0], dtype=torch.bool, device=A.device)
    others[n] = False
    An, yn = A[others][:, others], y[others]
    c, E, P = _counts(An, yn, K)
    Zo = torch.zeros((yn.shape[0], K), dtype=A.dtype, device=A.device)
    Zo[torch.arange(yn.shape[0], device=A.device), yn] = 1.0
    row = A[n, others] @ Zo  # n's edges to each class
    col = A[others, n] @ Zo  # each class's edges to n
    base, base_size = _block_terms(E, P, b0, b1)
    scores, bounds = [], []
    for k in range(K):
        E1, P1 = E.clone(), P.clone()
        E1[k, :] += row
        E1[:, k] += col
        E1[k, k] += A[n, n]
        P1[k, :] += c
        P1[:, k] += c
        P1[k, k] += 1.0
        new, new_size = _block_terms(E1, P1, b0, b1)
        changed = (E1 != E) | (P1 != P)
        log_c = torch.log(alpha0 + c[k])
        g = gumbel[k]
        scores.append(log_c + (new - base)[changed].sum() + g)
        size = (new_size + base_size)[changed].sum() + log_c.abs() + g.abs() + 2.0
        bounds.append(_band(6 * int(changed.sum()) + 2, size))
    return torch.stack(scores), torch.stack(bounds)


def discrete_replay(model: dict, A: torch.Tensor, y: torch.Tensor, gen_state: torch.Tensor,
                    follow: dict | None = None, dtype=torch.float32) -> dict:
    """The discrete stage on one chain from the adjacency ``A`` (N, N) and
    the types ``y`` (N,) it found, its draws regenerated from ``gen_state``
    in ``dtype`` (the program's). Returns {"y", "pi", "Bm"}, the replay's
    own outcome (with ``follow``, each type drawn after the judged types of
    the neurons before it, and π and B from the judged types' counts), and
    with ``follow`` ({"y", "pi", "Bm"} judged) also "type_gap", the judged
    types that the replay does not allow, and "hyper_gap", the worst
    relative difference of the judged π and B from the replay's."""
    K, alpha0, b0, b1 = sbm_hypers(model)
    dev = A.device  # the draws' device; the counting, small, runs on the host
    A = A.to("cpu", torch.float64)
    y = y.to("cpu").long().clone()
    N = y.shape[0]
    g = _gen(gen_state, dev)
    u = torch.rand((N, K), generator=g, dtype=dtype, device=dev).cpu()
    gumbel = -torch.log(-torch.log(torch.clamp(u.double(), min=torch.finfo(dtype).tiny)))
    own = torch.empty_like(y)
    missed = 0
    for n in range(N):
        scores, bounds = _type_scores(A, y, n, K, alpha0, b0, b1, gumbel[n])
        best = int(torch.argmax(scores))
        own[n] = best
        y[n] = best
        if follow is not None:
            j = int(follow["y"][n])
            if j != best and scores[best] - scores[j] >= bounds[best] + bounds[j]:
                missed += 1
            y[n] = j
    c, E, P = _counts(A, y, K)

    def gamma(alpha):
        return torch._standard_gamma(alpha.to(dev, dtype).contiguous(), generator=g).to("cpu", torch.float64)

    g_pi = gamma(alpha0 + c)
    g_a, g_b = gamma(b0 + E), gamma(b1 + (P - E))
    pi = g_pi / g_pi.sum()
    Bm = torch.clamp(g_a / (g_a + g_b), B_CLIP, 1.0 - B_CLIP)
    out = {"y": own, "pi": pi, "Bm": Bm}
    if follow is not None:
        gaps = [((follow[k].to("cpu", torch.float64) - v).abs() / v.abs()).max() for k, v in (("pi", pi), ("Bm", Bm))]
        out.update(type_gap=float(missed), hyper_gap=float(max(gaps)))
    return out
