"""theano_pyglm_torch — the network-GLM framework on PyTorch and CUDA.

The PyTorch port of :mod:`theano_pyglm_tpu`, laid out the same way so each
module's counterpart sits at the same path:

  ops/        bases, causal basis convolution, log-densities, clipped-exp
              spec, and the fused Poisson log-likelihood kernels (CUDA C++
              in ``csrc/``, built with nvcc at first use)
  models/     components, graph + weight priors, Population, zoo
  inference/  MAP (L-BFGS), smart initialization, HMC, the Gibbs sweep
              stages and the MCMC sampling loop
  parallel/   independent chains of the sampler
  utils/      precision policy, numpy <-> torch parameter conversion,
              convergence diagnostics, time-rescaling KS
  scripts/    entry points (the flagship run)

Parameters are a plain ``dict[str, torch.Tensor]``; every random draw takes
a ``torch.Generator``. The package imports torch and never JAX, and imports
in place from the repository root.
"""

__version__ = "0.1.0"

from theano_pyglm_torch.models.zoo import make_model  # noqa: F401
from theano_pyglm_torch.models.population import Population  # noqa: F401
