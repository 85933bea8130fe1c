"""Multi-chain MCMC and the multi-GPU layer: chains batched on one device
and split over the ranks of a process group, the log-joint and MAP split
over neurons (one process a GPU, :mod:`.distributed`)."""

from theano_pyglm_torch.parallel.mesh import chain_mesh, replicate, shard_chains  # noqa: F401
from theano_pyglm_torch.parallel.chains import gibbs_sample_chains  # noqa: F401
from theano_pyglm_torch.parallel.neurons import make_sharded_value_and_grad  # noqa: F401
from theano_pyglm_torch.parallel.map import parallel_map_fit  # noqa: F401
