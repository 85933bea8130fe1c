"""Precision policy, numpy <-> torch parameter conversion, and copies of
the numpy convergence diagnostics and time-rescaling KS test."""
