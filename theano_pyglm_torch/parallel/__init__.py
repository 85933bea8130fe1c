"""Multi-chain MCMC: independent chains of the Gibbs sweep on one device."""

from theano_pyglm_torch.parallel.chains import gibbs_sample_chains  # noqa: F401
