"""MAP (L-BFGS), smart initialization, HMC, the Gibbs sweep stages and the
MCMC sampling loop."""

from theano_pyglm_torch.inference.hmc import HMCState, hmc  # noqa: F401
from theano_pyglm_torch.inference.map import map_fit  # noqa: F401
from theano_pyglm_torch.inference.mcmc import gibbs_sample  # noqa: F401
