#!/usr/bin/env python
"""Full Bayesian MCMC on a data file (the reference's test/synth_mcmc.py);
--n_chains > 1 runs independent chains, on --device.

  python -m theano_pyglm_torch.scripts.synth_mcmc -d results/synth_data.npz --model sparse_weighted_model \
      --n_samples 1000 --n_chains 4 -r results/
"""
from theano_pyglm_torch.cli import fit_mcmc
from theano_pyglm_torch.utils.io import parse_cmd_line_args

if __name__ == "__main__":
    fit_mcmc(parse_cmd_line_args(description=__doc__))
