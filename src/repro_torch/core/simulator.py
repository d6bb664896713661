"""Single-device decentralized-training simulator.

Runs an algorithm (LEAD via LEADSim, or any flat engine from core/engines:
the baselines are driven directly) on an objective from core/convex.py,
recording the paper's metrics per iteration:

    dist:      (1/n) sum ||x_i - x*||^2          (Fig. 1a, 2a, 3a)
    consensus: (1/n) sum ||x_i - xbar||^2        (Fig. 1c)
    comp_err:  ||Q(m) - m|| / ||Y||              (Fig. 1d)
    loss:      average local loss
    bits:      cumulative transmitted bits per agent (Fig. 1b, x-axis)

The reference's ``lax.scan`` becomes a Python loop over device work: every
metric is written into a preallocated device tensor and the trace crosses
to the host once, at the end - no per-step host sync.  The stochastic and
noisy gradient oracles, fault injection and the tree engine are not ported
yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import topology as topology_mod
from repro_torch.core.convex import consensus_error, distance_to_opt
from repro_torch.core.engines import FlatLEADState, engine_for
from repro_torch.core.engines.base import FlatEngineBase
from repro_torch.core.lead import LEADHyper
from repro_torch.core.stage_timer import mark
from repro_torch.device import DeviceLike

_MASK32 = 0xFFFFFFFF
_LATER = "is not ported yet (ROADMAP.md, 'Modules still to port')"


@dataclasses.dataclass(frozen=True)
class LEADSim:
    """init/step adapter making LEAD interface-compatible with the flat
    baselines.

    ``topology`` is the communication graph: a core/topology.Topology or a
    raw mixing matrix.  engine="flat" drives the fused flat-buffer engine
    (core/engines/lead.py); the reference's pytree path (engine="tree") and
    its legacy ``gossip=`` form are not ported yet.  engine_gossip selects
    the flat engine's communication stage: "dense" or "neighbor".  dim and
    device are bound by run() from the problem when left None.
    """
    topology: Any
    compressor: Any = None
    eta: Any = 0.1
    gamma: Any = 1.0
    alpha: Any = 0.5
    engine: str = "flat"
    dither: str = "fast"
    engine_gossip: str = "dense"
    dim: Optional[int] = None
    faults: Any = None
    device: DeviceLike = None

    def __post_init__(self):
        if self.engine == "tree":
            raise NotImplementedError(f"LEADSim(engine='tree') {_LATER}")
        if self.engine != "flat":
            raise ValueError(f"engine must be 'flat', got {self.engine!r}")
        if self.faults is not None:
            raise NotImplementedError(f"fault injection {_LATER}")
        object.__setattr__(self, "_engines", {})

    def _flat_engine(self, dim: int):
        """The engine for `dim`, built once (its graph tables are copied to
        the device at construction)."""
        if dim not in self._engines:
            self._engines[dim] = engine_for(
                self.topology, self.compressor, dim, dither=self.dither,
                gossip=self.engine_gossip, device=self.device, eta=self.eta,
                gamma=self.gamma, alpha=self.alpha)
        return self._engines[dim]

    @property
    def hyper(self):
        return LEADHyper(eta=self.eta, gamma=self.gamma, alpha=self.alpha)

    def _dim_of(self, g) -> int:
        if self.dim is not None:
            return self.dim
        if g.ndim != 2:
            raise ValueError("gradients in the native (n, nb, block) layout "
                             "need LEADSim(dim=...)")
        return g.shape[1]

    def init(self, x0, g0, key=None):
        return self._flat_engine(self._dim_of(x0)).init(x0, g0, self.hyper)

    def step_with_wire(self, state, g, seed: int):
        """(new_state, comp_err, wire_bits) of one LEAD iteration; wire_bits
        is the per-agent bits this step put on the wire."""
        return self._flat_engine(self._dim_of(g)).step_wire(state, g, seed,
                                                            self.hyper)

    def step(self, state, g, seed: int):
        return self.step_with_wire(state, g, seed)[0]

    def x_of(self, state):
        """Current iterates as (n, d)."""
        if isinstance(state, FlatLEADState):
            if self.dim is None:
                raise ValueError("LEADSim needs dim=<per-agent d> to "
                                 "unblockify states; run() binds it")
            return self._flat_engine(self.dim).unblockify(state.x)
        return state.x


def with_topology(algo, topology):
    """`algo` rebound to a new (static) communication graph."""
    topo = topology_mod.materialize(topology)
    if isinstance(algo, LEADSim):
        return dataclasses.replace(algo, topology=topo)
    if isinstance(algo, FlatEngineBase):
        return dataclasses.replace(algo, topology=topo)
    raise TypeError(f"cannot rebind topology on {type(algo).__name__}")


class Trace(NamedTuple):
    """Host-side metric traces, one entry per recorded iteration.

    comp_err is ``||Q(m) - m|| / ||Y||`` where ``m`` is the message the
    algorithm transmitted this iteration (LEAD: the difference Y - H) and
    ``Y`` the pre-communication iterate that carries it.  bits_per_agent is
    the cumulative bits each agent has put on the wire up to and including
    the iteration, accumulated from the actual per-step payloads.
    """
    dist: np.ndarray
    consensus: np.ndarray
    loss: np.ndarray
    bits_per_agent: np.ndarray
    comp_err: np.ndarray


def _mix32(z: int) -> int:
    """murmur3's 32-bit finalizer, on the host."""
    z &= _MASK32
    z ^= z >> 16
    z = (z * 0x85EBCA6B) & _MASK32
    z ^= z >> 13
    z = (z * 0xC2B2AE35) & _MASK32
    return z ^ (z >> 16)


def step_seed(seed: int, it: int) -> int:
    """The uint32 dither seed of iteration `it` of a run seeded `seed`."""
    return _mix32(_mix32(seed) * 0x9E3779B9 + it)


def run(algo, problem, x_star, *, iters=300, seed: int = 0, stochastic=False,
        noise_std=0.0, record_every=1, topology=None) -> Trace:
    """Run `algo` on `problem` from x0 = 0; returns metric traces (host
    numpy).  The run lives on x_star's device.

    topology= swaps the algorithm's communication graph before running.
    Each iteration's dither seed is derived from `seed` and the iteration
    (step_seed), so a quantized trace matches the reference's in
    distribution, not bit for bit: the reference draws its seeds from its
    jax.random key stream.  An uncompressed trace matches it to rounding.

    Metrics are written into a preallocated device tensor and cross to the
    host once, at the end.  With record_every > 1 the metric reductions of
    skipped iterations are not computed (their rows are sliced out).
    Each step marks the ends of its stages for core/stage_timer.py, which
    times them when a StageTimer is active."""
    if stochastic or noise_std > 0:
        raise NotImplementedError(f"the stochastic gradient oracle {_LATER}")
    dev = x_star.device
    n, d = problem.n, problem.d
    x0 = torch.zeros((n, d), dtype=torch.float32, device=dev)

    if topology is not None:
        algo = with_topology(algo, topology)
    if isinstance(algo, LEADSim) and (algo.dim is None or algo.device is None):
        algo = dataclasses.replace(algo, dim=d, device=dev)

    state = algo.init(x0, problem.full_grad(x0))
    x_of = getattr(algo, "x_of", lambda s: s.x)

    ms = torch.zeros((5, iters), dtype=torch.float32, device=dev)
    bits_acc = torch.zeros((), dtype=torch.float32, device=dev)
    for it in range(iters):
        g = problem.full_grad(x_of(state))
        mark("gradient")
        new, cerr, bits = algo.step_with_wire(state, g, step_seed(seed, it))
        bits_acc = bits_acc + bits
        if it % record_every == 0:
            X = x_of(new)
            ms[0, it] = distance_to_opt(X, x_star)
            ms[1, it] = consensus_error(X)
            ms[2, it] = problem.loss(X)
            ms[3, it] = cerr
        ms[4, it] = bits_acc
        mark("metrics")
        state = new

    # single device->host transfer for the whole trace
    dist, cons, loss, cerr, bits = ms.cpu().numpy().astype(np.float64)
    sel = slice(0, iters, record_every)
    return Trace(dist=dist[sel], consensus=cons[sel], loss=loss[sel],
                 bits_per_agent=bits[sel], comp_err=cerr[sel])
