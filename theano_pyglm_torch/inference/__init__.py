"""MAP (L-BFGS, sparse MAP with cross-validated λ), smart initialization,
HMC, the Gibbs sweep stages and the MCMC sampling loop, adaptive rejection
sampling of the bias, and the held-out predictive log-likelihood."""

from theano_pyglm_torch.inference.ars import adaptive_rejection_sample, update_bias_ars  # noqa: F401
from theano_pyglm_torch.inference.hmc import HMCState, hmc  # noqa: F401
from theano_pyglm_torch.inference.map import cross_validate_lambda, map_fit, sparse_map_fit  # noqa: F401
from theano_pyglm_torch.inference.mcmc import gibbs_sample  # noqa: F401
from theano_pyglm_torch.inference.predictive import predictive_log_likelihood  # noqa: F401
from theano_pyglm_torch.utils.dtypes import default_float  # noqa: F401
