"""Utilities of the port: pytree vector-space helpers (tree.py) and the
env-gated finite-value guards (finite.py)."""
