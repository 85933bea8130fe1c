"""MAP (L-BFGS), smart initialization and HMC. The Gibbs sweep and the
MCMC sampling loop are not ported yet (ROADMAP.md, queue 1 items 6-7)."""

from theano_pyglm_torch.inference.hmc import HMCState, hmc  # noqa: F401
from theano_pyglm_torch.inference.map import map_fit  # noqa: F401
