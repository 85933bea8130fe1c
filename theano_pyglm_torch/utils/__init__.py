"""Precision policy and numpy <-> torch parameter conversion."""
