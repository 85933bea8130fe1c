"""Tensor-level building blocks: bases, convolution, densities, the clipped-exp
spec and the fused Poisson log-likelihood kernels."""
