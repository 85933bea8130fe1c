#!/usr/bin/env python
"""MAP-fit a model to a data file (the reference's test/synth_map.py), with
sparse coupling (--lam) or a cross-validated penalty (--xv), on --device.

  python -m theano_pyglm_torch.scripts.synth_map -d results/synth_data.npz --model sparse_weighted_model -r results/
"""
from theano_pyglm_torch.cli import fit_map
from theano_pyglm_torch.utils.io import parse_cmd_line_args

if __name__ == "__main__":
    fit_map(parse_cmd_line_args(description=__doc__))
