"""Utilities of the port: pytree vector-space helpers (tree.py)."""
