#!/usr/bin/env python
"""Sample a model from its prior and simulate spikes (the reference's
test/generate_synth_data.py), on --device (default cuda).

  python -m theano_pyglm_torch.scripts.generate_synth_data --model sparse_weighted_model -N 10 -T 60 -r results/
"""
from theano_pyglm_torch.cli import generate_synth_data
from theano_pyglm_torch.utils.io import parse_cmd_line_args

if __name__ == "__main__":
    generate_synth_data(parse_cmd_line_args(description=__doc__))
