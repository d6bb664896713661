"""Flat engine family: the codes-on-the-wire substrate.

    base.py       shared substrate (block layout, encode/decode wire stage,
                  dense|neighbor gossip, payload-bit accounting, dither)
    lead.py       FlatLEADEngine - the fused-kernel LEAD hot path
    baselines.py  the paper's baselines: CHOCO-SGD, DeepSqueeze, QDGD,
                  DCD-SGD (compressed) and DGD, NIDS, EXTRA, D2 (exact, no
                  encode stage)

``engine_for`` is the registry front door: it dispatches
``(algorithm, compressor, topology)`` to the matching engine.  Every name
and alias of the reference's registry is registered except CEDAS and C-GT
(``cedas``, ``cgt``, ``c-gt``), which are not ported yet, nor is
``flat_twin`` (the tree baselines are not ported).
"""
from __future__ import annotations

from repro_torch.core.compression import Identity
from repro_torch.core.engines.base import FlatEngineBase, fast_uniform
from repro_torch.core.engines.baselines import (
    ExtraState, FlatCHOCOEngine, FlatD2Engine, FlatDCDEngine, FlatDGDEngine,
    FlatDeepSqueezeEngine, FlatEXTRAEngine, FlatNIDSEngine, FlatQDGDEngine,
    SimpleState,
)
from repro_torch.core.engines.lead import FlatLEADEngine, FlatLEADState
from repro_torch.device import DeviceLike
from repro_torch.kernels.ops import DEFAULT_BLOCK

# registry: algorithm name -> engine class (aliases share one class)
ENGINES = {
    "lead": FlatLEADEngine,
    "choco": FlatCHOCOEngine,
    "choco-sgd": FlatCHOCOEngine,
    "deepsqueeze": FlatDeepSqueezeEngine,
    "qdgd": FlatQDGDEngine,
    "dcd": FlatDCDEngine,
    "dcd-sgd": FlatDCDEngine,
    "dgd": FlatDGDEngine,
    "nids": FlatNIDSEngine,
    "extra": FlatEXTRAEngine,
    "d2": FlatD2Engine,
}

# exact baselines take no compressor (their payload is the raw buffer)
_EXACT = (FlatDGDEngine, FlatNIDSEngine, FlatEXTRAEngine, FlatD2Engine)

# canonical name per engine class (the first registry entry wins over
# its aliases)
_CANONICAL = {}
for _name, _cls in ENGINES.items():
    _CANONICAL.setdefault(_cls, _name)
del _name, _cls


def _lookup(algorithm: str):
    key = algorithm.lower().replace("_", "-")
    if key not in ENGINES:
        raise KeyError(f"unknown algorithm {algorithm!r}; registry has "
                       f"{sorted(set(ENGINES))}")
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
    every other compressor runs on every compressed algorithm: the p=inf
    QuantizePNorm through the fused kernels, RandK, TopK and p != inf
    quantizers through their encode_blocks wire.  An object without that
    protocol is rejected.  `hyper` forwards the algorithm's
    hyper-parameters (eta/gamma/alpha for LEAD, eta/gamma for the
    baselines), each a Schedule.  Fault injection is not ported yet."""
    if faults is not None:
        raise NotImplementedError("fault injection is not ported yet "
                                  "(ROADMAP.md, 'Modules still to port')")
    cls = _lookup(algorithm)
    if isinstance(compressor, Identity):
        compressor = None
    if issubclass(cls, _EXACT) and compressor is not None:
        raise ValueError(f"{cls.__name__} is an exact baseline; it does not "
                         "take a compressor")
    if compressor is not None and not hasattr(compressor, "encode_blocks"):
        raise NotImplementedError(
            f"{type(compressor).__name__} lacks the encode_blocks/"
            "decode_blocks flat wire protocol")
    block = getattr(compressor, "block", DEFAULT_BLOCK)
    return cls(topology=topology, dim=dim, compressor=compressor, block=block,
               gossip=gossip, dither=dither, device=device, **hyper)


__all__ = ["ENGINES", "ExtraState", "FlatCHOCOEngine", "FlatD2Engine",
           "FlatDCDEngine", "FlatDGDEngine", "FlatDeepSqueezeEngine",
           "FlatEXTRAEngine", "FlatEngineBase", "FlatLEADEngine",
           "FlatLEADState", "FlatNIDSEngine", "FlatQDGDEngine", "SimpleState",
           "algorithm_name", "describe", "engine_for", "fast_uniform",
           "is_exact"]
