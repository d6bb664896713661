"""Deterministic synthetic data (the port of ``src/repro/data``)."""
