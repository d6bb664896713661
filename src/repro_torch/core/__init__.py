"""Core of the port: LEAD, compression, gossip, topology, objectives, the
baselines (tree and flat), the engines and the simulator."""
from repro_torch.core.compression import (
    Identity, QuantizePNorm, RandK, TopK, compress_pytree, estimate_C,
)
from repro_torch.core.gossip import DenseGossip, EncodedRingGossip
from repro_torch.core.lead import (LEADHyper, LEADState, init as lead_init,
                                   step as lead_step)
from repro_torch.core import baselines, convex, topology
from repro_torch.core.simulator import LEADSim, run as simulate

__all__ = [
    "Identity", "QuantizePNorm", "RandK", "TopK", "compress_pytree",
    "estimate_C", "DenseGossip", "EncodedRingGossip", "LEADHyper",
    "LEADState", "lead_init", "lead_step", "baselines", "convex", "topology",
    "LEADSim", "simulate",
]
