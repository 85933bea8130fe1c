"""The two HMC stages alone (impulse weights and latent locations), timed
as ``adjacency_ms`` is."""

UNIT = "ms"


def read(ctx):
    return ctx.get("stage_ms", {}).get("hmc")
