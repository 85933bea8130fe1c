"""Entry points of the port (python3 -m theano_pyglm_torch.scripts.<name>)."""
