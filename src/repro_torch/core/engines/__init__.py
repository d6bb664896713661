"""Flat engine family: the codes-on-the-wire substrate.

    base.py       shared substrate (block layout, encode/decode wire stage,
                  dense|neighbor gossip, payload-bit accounting, dither)
    lead.py       FlatLEADEngine - the fused-kernel LEAD hot path
    baselines.py  the paper's baselines: CHOCO-SGD, DeepSqueeze, QDGD,
                  DCD-SGD (compressed) and DGD, NIDS, EXTRA, D2 (exact, no
                  encode stage)
    cedas.py      FlatCEDASEngine - compressed exact diffusion
    cgt.py        FlatCGTEngine - compressed gradient tracking, the
                  multi-wire engine (two payloads per step)

``engine_for`` is the registry front door: it dispatches
``(algorithm, compressor, topology)`` to the matching engine.  Every name
and alias of the reference's registry is registered.  ``flat_twin``
builds the flat engine that mirrors a tree algorithm (core/baselines.py,
or LEADSim).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.compression import Identity
from repro_torch.core.engines.base import FlatEngineBase, fast_uniform
from repro_torch.core.engines.baselines import (
    ExtraState, FlatCHOCOEngine, FlatD2Engine, FlatDCDEngine, FlatDGDEngine,
    FlatDeepSqueezeEngine, FlatEXTRAEngine, FlatNIDSEngine, FlatQDGDEngine,
    SimpleState,
)
from repro_torch.core.engines.cedas import FlatCEDASEngine
from repro_torch.core.engines.cgt import FlatCGTEngine
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
    "cedas": FlatCEDASEngine,
    "cgt": FlatCGTEngine,
    "c-gt": FlatCGTEngine,
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

    `topology` is a core/topology.Topology or a raw mixing matrix, a
    TopologyBank (or a sequence of round graphs, or a periodic schedule:
    time-varying gossip), a ``hierarchical`` graph, or any of them with a
    communication interval (``with_interval``; not on a bank); `gossip`
    selects "dense" (W @ q) or "neighbor" (sparse gather over the
    topology's table; "ring" is the same gather, for the static uniform
    ring only; "hier" the two-level wire of a hierarchical graph).  Identity normalizes to None (the raw 32-bit wire);
    every other compressor runs on every compressed algorithm: the p=inf
    QuantizePNorm through the fused kernels, RandK, TopK and p != inf
    quantizers through their encode_blocks wire.  An object without that
    protocol is rejected.  `hyper` forwards the algorithm's
    hyper-parameters (eta/gamma/alpha for LEAD, eta/gamma for the
    baselines), each a Schedule.  `faults` attaches a
    core/faults.FaultModel: run() then takes the engine's faulted wire
    (step_with_wire_faulted); None leaves the clean path untouched."""
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
               gossip=gossip, dither=dither, faults=faults, device=device,
               **hyper)


# tree algorithm class name -> registry key of its flat twin
_TREE_TWINS = {
    "CHOCO_SGD": "choco",
    "DeepSqueeze": "deepsqueeze",
    "QDGD": "qdgd",
    "DCD_SGD": "dcd",
    "DGD": "dgd",
    "NIDS": "nids",
    "EXTRA": "extra",
    "D2": "d2",
    "CEDAS": "cedas",
    "CGT": "cgt",
    "LEADSim": "lead",
}


def flat_twin(algo, dim: int, *, gossip: str = "dense",
              device: DeviceLike = None) -> FlatEngineBase:
    """Flat engine mirroring a tree algorithm instance (a baseline of
    core/baselines.py, or LEADSim): same mixing matrix, compressor and
    hyper-parameters, ready to hand to core/simulator.py run() in its
    place.  It lives on `device`, by default the algorithm's own (its
    DenseGossip's, or LEADSim's device)."""
    name = type(algo).__name__
    if name not in _TREE_TWINS:
        raise KeyError(f"no flat twin registered for {name}; registry has "
                       f"{sorted(_TREE_TWINS)}")
    cls = ENGINES[_TREE_TWINS[name]]
    fields = {f.name for f in dataclasses.fields(cls)}
    hyper = {k: getattr(algo, k) for k in ("eta", "gamma", "alpha")
             if k in fields and hasattr(algo, k)}
    dense = getattr(algo, "gossip", None)
    if getattr(algo, "topology", None) is not None:
        topo = algo.topology
    else:
        topo = dense.W.cpu().numpy()
    if device is None:
        device = (dense.W.device if dense is not None
                  else getattr(algo, "device", None))
    return engine_for(topo, getattr(algo, "compressor", None), dim,
                      gossip=gossip, algorithm=_TREE_TWINS[name],
                      device=device, **hyper)


__all__ = ["ENGINES", "ExtraState", "FlatCEDASEngine", "FlatCGTEngine",
           "FlatCHOCOEngine", "FlatD2Engine", "FlatDCDEngine",
           "FlatDGDEngine", "FlatDeepSqueezeEngine",
           "FlatEXTRAEngine", "FlatEngineBase", "FlatLEADEngine",
           "FlatLEADState", "FlatNIDSEngine", "FlatQDGDEngine", "SimpleState",
           "algorithm_name", "describe", "engine_for", "fast_uniform",
           "flat_twin", "is_exact"]
