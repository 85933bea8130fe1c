"""Model-spec validation — early, specific errors for malformed specs.

The reference silently KeyErrors deep inside component constructors when a
model dict is malformed; here the nested-dict spec (the user-facing API,
SURVEY.md §5 "Config") is checked up front with messages that name the bad
section/key/choice.
"""

from __future__ import annotations

__all__ = ["validate_spec"]

_CHOICES = {
    ("bkgd", "type"): {"none", "basis", "spatiotemporal", "shared"},
    ("impulse", "type"): {"basis", "normalized"},
    ("nlin", "type"): {"exp", "softplus", "explinear"},
    ("observation", "type"): {"poisson", "bernoulli"},
    ("network.graph", "type"): {"complete", "erdos_renyi", "sbm", "distance"},
    ("network.weight", "type"): {"constant", "gaussian"},
}

_KNOWN_TOP = {
    "N", "dt", "description", "bias", "bkgd", "impulse", "nlin",
    "observation", "network",
}


def _check_choice(section: str, d: dict, default: str):
    typ = d.get("type", default)
    allowed = _CHOICES.get((section, "type"))
    if allowed and typ not in allowed:
        raise ValueError(
            f"model spec: {section}.type={typ!r} is not one of {sorted(allowed)}"
        )


def validate_spec(spec: dict) -> None:
    if "N" not in spec:
        raise ValueError("model spec must set 'N' (number of neurons)")
    N = spec["N"]
    if not isinstance(N, int) or N < 1:
        raise ValueError(f"model spec: N must be a positive int, got {N!r}")
    dt = spec.get("dt", 1e-3)
    if not (0 < float(dt) < 1.0):
        raise ValueError(f"model spec: dt must be in (0, 1) seconds, got {dt!r}")

    unknown = set(spec) - _KNOWN_TOP
    if unknown:
        raise ValueError(
            f"model spec: unknown top-level section(s) {sorted(unknown)}; "
            f"known: {sorted(_KNOWN_TOP)}"
        )

    _check_choice("bkgd", dict(spec.get("bkgd", {})), "none")
    _check_choice("impulse", dict(spec.get("impulse", {})), "basis")
    _check_choice("nlin", dict(spec.get("nlin", {})), "exp")
    _check_choice("observation", dict(spec.get("observation", {})), "poisson")
    net = dict(spec.get("network", {}))
    _check_choice("network.graph", dict(net.get("graph", {})), "complete")
    _check_choice("network.weight", dict(net.get("weight", {})), "constant")

    g = dict(net.get("graph", {}))
    if g.get("type") == "sbm" and int(g.get("K", 2)) < 1:
        raise ValueError("model spec: network.graph.K must be >= 1")
    if g.get("type") == "erdos_renyi":
        rho = float(g.get("rho", 0.2))
        if not (0.0 <= rho <= 1.0):
            raise ValueError(f"model spec: network.graph.rho must be in [0,1], got {rho}")
