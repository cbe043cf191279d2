"""Vectorized game worlds."""
