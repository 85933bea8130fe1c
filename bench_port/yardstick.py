"""The card's published peaks, each fused kernel's least time, and the
model's operations: the arithmetic that the roofline and mfu metrics
divide by. Frozen here so that a change to the program cannot move it.

``bound_ms`` is ``bound()`` of ``chip_smoke.py``, written on shapes
instead of tensors: the larger of the bytes (each input read once, each
output written once) over the HBM rate and the products at their accuracy
(float32-accurate products as 3xTF32 on the tensor cores, bf16 × float32 as
two TF32 products, bf16 × bf16 at the bf16 rate). It gives the Bound column
of the kernel table in ``PERF.md``.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "TF32_FLOP_PER_S", "BF16_FLOP_PER_S", "F32_ACCURATE_FLOP_PER_S",
           "bound_ms", "ll_flops", "sweep_flops", "eval_flops"]

# NVIDIA H100 SXM, published dense rates at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
#: float32-accurate products as 3xTF32: the peak the mfu metrics hold the model's operations to
F32_ACCURATE_FLOP_PER_S = TF32_FLOP_PER_S / 3


def bound_ms(grad: bool, T: int, NB: int, N: int, C: int = 1, x_bytes: int = 4, chains: bool = False) -> float:
    """The least milliseconds of one fused call over (T, NB) X_f, C chains
    of (NB, N) U and (T, N) I_rest, and (T, N) S: value and gradient
    (``grad``: K2, K3-vg, K4-vg[-chains]) or value only. ``x_bytes`` 2 is a
    bfloat16 X_f; ``chains`` with it, U and dI rounded to bf16 (K4-chains)."""
    nbytes = T * NB * x_bytes + 4 * (C * NB * N + C * T * N + T * N)
    flops = 2 * T * NB * N * C
    if grad:
        nbytes += 4 * C * (T * N + NB * N + 1)  # dI_rest, dU, ll
        flops *= 2  # X_fᵀ @ dI_rest
    else:
        nbytes += 4 * C
    if x_bytes == 4:
        t_ops = 3 * flops / TF32_FLOP_PER_S
    elif chains:
        t_ops = flops / BF16_FLOP_PER_S
    else:
        t_ops = 2 * flops / TF32_FLOP_PER_S
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, t_ops)


def ll_flops(grad: bool, T: int, NB: int, N: int) -> float:
    """The fused likelihood's products for one chain: X_f @ U, and with the
    gradient X_fᵀ @ dI as well (the count the kernel bounds use)."""
    return (4 if grad else 2) * T * NB * N


#: operations a bin of a 1-D Newton step of the birth–death proposal takes
#: (current ± w·ψ, its exponential, and the two weighted sums of the
#: gradient and curvature), counted as multiply-adds
ADJ_FLOPS_PER_BIN = 6


def sweep_flops(T: int, N: int, B: int, DB: int, n_leapfrog: int, glm_newton: int = 6,
                adj_newton: int = 8) -> dict:
    """The model's operations in one sweep of one chain, by term (the work
    the algorithm needs, not what the program happens to launch):

    - ``imp_leapfrog``: n_leapfrog + 1 value-and-gradient evaluations of
      the likelihood (each step's end gradient starts the next);
    - ``glm_current``: the coupling current the glm block holds fixed;
    - ``glm_newton``: N neurons × the Newton steps, each a gradient and a
      Hessian over (T, D) with D = 1 + DB, then the MH test's two values;
    - ``adjacency_psi``: the unit coupling currents ψ (T, N, N) from the
      (T, N, B) design;
    - ``adjacency_entries``: every (n, p) entry's Newton steps and its exact
      ΔLL over all T bins.
    """
    NB = N * B
    D = 1 + DB
    return {
        "imp_leapfrog": (n_leapfrog + 1) * ll_flops(True, T, NB, N),
        "glm_current": ll_flops(False, T, NB, N),
        "glm_newton": N * (glm_newton * (2 * T * D * D + 4 * T * D) + 2 * 2 * T * D),
        "adjacency_psi": 2 * T * N * N * B,
        "adjacency_entries": N * N * T * ADJ_FLOPS_PER_BIN * (adj_newton + 1),
    }


def eval_flops(T: int, N: int, B: int, DB: int) -> dict:
    """The model's operations in one value-and-gradient evaluation of the
    log-joint, by term: the fused likelihood's products and the stimulus
    current with its gradient."""
    return {"likelihood": ll_flops(True, T, N * B, N), "stimulus": 4 * T * DB * N}
