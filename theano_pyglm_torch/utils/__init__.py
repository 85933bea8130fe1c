"""Precision policy, numpy <-> torch parameter conversion, checkpoints,
spike-triggered averages, data and results IO, and copies of the numpy
convergence diagnostics and time-rescaling KS test."""
