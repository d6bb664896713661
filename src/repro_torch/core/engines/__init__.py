"""Flat engine family: the codes-on-the-wire substrate.

    base.py       shared substrate (block layout, payload and decode stage,
                  dense|neighbor gossip, payload-bit accounting, dither)
    lead.py       FlatLEADEngine - the fused-kernel LEAD hot path
    baselines.py  FlatDGDEngine (exact, no encode stage)

``engine_for`` is the registry front door: it dispatches
``(algorithm, compressor, topology)`` to the matching engine.  Only
``lead`` and ``dgd`` are registered so far; the other engines of
``src/repro/core/engines`` are not ported yet.
"""
from __future__ import annotations

from repro_torch.core.compression import Identity
from repro_torch.core.engines.base import FlatEngineBase, fast_uniform
from repro_torch.core.engines.baselines import FlatDGDEngine, SimpleState
from repro_torch.core.engines.lead import FlatLEADEngine, FlatLEADState
from repro_torch.device import DeviceLike
from repro_torch.kernels.ops import DEFAULT_BLOCK

# registry: algorithm name -> engine class
ENGINES = {
    "lead": FlatLEADEngine,
    "dgd": FlatDGDEngine,
}

# exact baselines take no compressor (their payload is the raw buffer)
_EXACT = (FlatDGDEngine,)

_CANONICAL = {cls: name for name, cls in ENGINES.items()}


def _lookup(algorithm: str):
    key = algorithm.lower().replace("_", "-")
    if key not in ENGINES:
        raise KeyError(f"unknown algorithm {algorithm!r}; registry has "
                       f"{sorted(ENGINES)}")
    return ENGINES[key]


def is_exact(algorithm: str) -> bool:
    """True when the registered algorithm transmits raw 32-bit values."""
    return issubclass(_lookup(algorithm), _EXACT)


def algorithm_name(engine) -> str:
    """Canonical registry key of an engine instance."""
    return _CANONICAL[type(engine)]


def describe(engine) -> str:
    """One-line `(algorithm, compressor, gossip, topology)` description of a
    resolved engine - the registry path a run actually took."""
    comp = engine.compressor
    comp_s = "none (exact, 32-bit)" if comp is None else repr(comp)
    return (f"algorithm={algorithm_name(engine)} compressor={comp_s} "
            f"gossip={engine.gossip} topology={engine.topology!r}")


def engine_for(topology, compressor, dim: int, dither: str = "fast",
               gossip: str = "dense", algorithm: str = "lead", faults=None,
               device: DeviceLike = None, **hyper) -> FlatEngineBase:
    """Registry dispatch: (algorithm, compressor, topology) -> flat engine
    on `device` ("cuda" when None).

    `topology` is a core/topology.Topology or a raw mixing matrix; `gossip`
    selects "dense" (W @ q) or "neighbor" (sparse gather over the
    topology's table).  Identity normalizes to None (the raw 32-bit wire);
    `hyper` forwards the algorithm's hyper-parameters (eta/gamma/alpha for
    LEAD, eta for DGD), each a Schedule.  Fault injection is not ported
    yet."""
    if faults is not None:
        raise NotImplementedError("fault injection is not ported yet "
                                  "(ROADMAP.md, 'Modules still to port')")
    cls = _lookup(algorithm)
    if isinstance(compressor, Identity):
        compressor = None
    if issubclass(cls, _EXACT) and compressor is not None:
        raise ValueError(f"{cls.__name__} is an exact baseline; it does not "
                         "take a compressor")
    block = getattr(compressor, "block", DEFAULT_BLOCK)
    return cls(topology=topology, dim=dim, compressor=compressor, block=block,
               gossip=gossip, dither=dither, device=device, **hyper)


__all__ = ["ENGINES", "FlatDGDEngine", "FlatEngineBase", "FlatLEADEngine",
           "FlatLEADState", "SimpleState", "algorithm_name", "describe",
           "engine_for", "fast_uniform", "is_exact"]
