"""Model components, network priors, the Population and the model zoo."""
