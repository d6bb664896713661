"""Compatibility shim: the flat engine lives in the core/engines/ family.

The reference keeps ``core/engine.py`` for callers of the original flat
LEAD engine (``benchmarks/bench_compression.py`` imports it); the port
keeps the same names here.  Import from ``repro_torch.core.engines`` in new
code.
"""
from repro_torch.core.engines import engine_for, flat_twin
from repro_torch.core.engines.base import FlatEngineBase, fast_uniform
from repro_torch.core.engines.lead import FlatLEADEngine, FlatLEADState

__all__ = ["FlatEngineBase", "FlatLEADEngine", "FlatLEADState",
           "engine_for", "fast_uniform", "flat_twin"]
