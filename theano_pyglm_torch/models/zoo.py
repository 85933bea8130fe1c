"""Model zoo — named nested-dict templates (≅ pyglm/models/model_factory.py).

``make_model(name, N)`` deep-copies a template and sets the population size,
exactly the reference's factory pattern (SURVEY.md §2 "Model zoo / config").
Template names follow the reference's [M]-confidence names; extra keyword
overrides are merged shallowly per section.

Templates:
  standard_glm            complete graph, constant weights; coupling magnitude
                          lives in the Gaussian basis-impulse weights; cosine
                          stimulus filter. (Acceptance config 1 with N=1.)
  spatiotemporal_glm      standard_glm with a separable low-rank
                          spatiotemporal stimulus filter.
  simple_weighted_model   complete graph + Gaussian W + normalized impulses.
  sparse_weighted_model   Erdős–Rényi graph + Gaussian W + normalized
                          impulses. (Acceptance configs 2–3.)
  sbm_weighted_model      SBM latent-type graph + Gaussian W. (Config 4.)
  distance_weighted_model latent-location distance graph + Gaussian W.
                          (Config 5, the N=27 RGC-scale flagship.)
"""

from __future__ import annotations

import copy

__all__ = ["make_model", "TEMPLATES"]

_COSINE_IMP = {"type": "cosine", "n_bas": 5, "a": 1.0, "b": 1.0, "norm": True}
_COSINE_STIM = {"type": "cosine", "n_bas": 5, "a": 1.0, "b": 1.0, "norm": True}


def _base(N):
    return {
        "N": N,
        "dt": 1e-3,
        "bias": {"mu": 2.0, "sigma": 0.5},
        "bkgd": {
            "type": "basis",
            "D_stim": 1,
            "dt_max": 0.3,
            "mu": 0.0,
            "sigma": 0.5,
            "basis": dict(_COSINE_STIM),
        },
        # Basis columns sum to one, so an impulse weight w_b is the total
        # log-rate contribution of that column; σ=0.3 keeps prior draws
        # subcritical at ~7 Hz baseline rates.
        "impulse": {
            "type": "basis",
            "dt_max": 0.1,
            "mu": 0.0,
            "sigma": 0.3,
            "basis": dict(_COSINE_IMP),
        },
        "nlin": {"type": "exp"},
        "observation": {"type": "poisson"},
        "network": {"graph": {"type": "complete"}, "weight": {"type": "constant", "value": 1.0}},
    }


def _weighted(N, graph):
    m = _base(N)
    # Normalized (unit-area) impulses so W carries the coupling magnitude —
    # identifiability convention for weighted networks (SURVEY.md §7).
    m["impulse"] = {
        "type": "normalized",
        "dt_max": 0.1,
        # Per-column logit means favor the early (fast) cosine bumps, so
        # prior-drawn coupling filters are peaked like real PSPs (~5–20 ms)
        # rather than spread over the whole 100 ms window — this is what
        # makes synthetic networks statistically identifiable (the per-edge
        # Fisher information scales with the filter's Σφ²).
        "mu": [1.5, 0.5, -0.5, -1.5, -2.5],
        "sigma": 1.0,
        "basis": dict(_COSINE_IMP),
    }
    m["bias"] = {"mu": 1.5, "sigma": 0.5}
    m["network"] = {
        "graph": graph,
        "weight": {
            "type": "gaussian",
            # W scales a unit-sum filter (normalized impulses), i.e. W is the
            # total log-rate kick per presynaptic spike. σ=2 makes edges
            # statistically identifiable from ~30 s of data (per-edge Fisher
            # info ≈ rate·dt·Σφ²·W²·n_spikes) while staying subcritical
            # (branching ≈ rate·dt·W ≈ 0.1 at 20 Hz).
            "mu": 0.0,
            "sigma": 2.0,
            # self-coupling (refractory) edges pushed negative by default
            "mu_self": -2.0,
            "sigma_self": 1.0,
        },
    }
    return m


def standard_glm(N):
    return _base(N)


def spatiotemporal_glm(N):
    m = _base(N)
    m["bkgd"] = {
        "type": "spatiotemporal",
        "D_stim": 25,
        "dt_max": 0.3,
        "mu": 0.0,
        "sigma": 0.5,
        "basis": dict(_COSINE_STIM),
    }
    return m


def simple_weighted_model(N):
    return _weighted(N, {"type": "complete"})


def sparse_weighted_model(N):
    return _weighted(N, {"type": "erdos_renyi", "rho": 0.2})


def sbm_weighted_model(N):
    return _weighted(
        N, {"type": "sbm", "K": 2, "alpha0": 1.0, "B_prior": (1.0, 1.0)}
    )


def distance_weighted_model(N):
    return _weighted(
        N, {"type": "distance", "D": 2, "sigma_l": 1.0, "tau": 1.0, "eta0": 1.0}
    )


TEMPLATES = {
    "standard_glm": standard_glm,
    "spatiotemporal_glm": spatiotemporal_glm,
    "simple_weighted_model": simple_weighted_model,
    "sparse_weighted_model": sparse_weighted_model,
    "sbm_weighted_model": sbm_weighted_model,
    "distance_weighted_model": distance_weighted_model,
}


def make_model(name: str, N: int, **overrides) -> dict:
    """Build a model spec dict by template name (≅ make_model in the
    reference). ``overrides`` replace top-level sections, e.g.
    ``make_model('standard_glm', 2, bkgd={'type': 'none'})``."""
    if name not in TEMPLATES:
        raise ValueError(f"unknown model {name!r}; available: {sorted(TEMPLATES)}")
    spec = copy.deepcopy(TEMPLATES[name](N))
    for k, v in overrides.items():
        spec[k] = copy.deepcopy(v)
    return spec
