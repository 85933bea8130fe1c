"""MAP (L-BFGS, sparse MAP with cross-validated λ), smart initialization,
HMC, the Gibbs sweep stages and the MCMC sampling loop."""

from theano_pyglm_torch.inference.hmc import HMCState, hmc  # noqa: F401
from theano_pyglm_torch.inference.map import cross_validate_lambda, map_fit, sparse_map_fit  # noqa: F401
from theano_pyglm_torch.inference.mcmc import gibbs_sample  # noqa: F401
