"""Single-device decentralized-training simulator.

Runs an algorithm (LEAD via LEADSim, any flat engine from core/engines, or
a tree algorithm from core/baselines.py) on an objective from
core/convex.py, recording the paper's metrics per iteration:

    dist:      (1/n) sum ||x_i - x*||^2          (Fig. 1a, 2a, 3a)
    consensus: (1/n) sum ||x_i - xbar||^2        (Fig. 1c)
    comp_err:  ||Q(m) - m|| / ||Y||              (Fig. 1d)
    loss:      average local loss
    bits:      cumulative transmitted bits per agent (Fig. 1b, x-axis)

The reference's ``lax.scan`` becomes a Python loop over device work: every
metric is written into a preallocated device tensor and the trace crosses
to the host once, at the end - no per-step host sync.

LEADSim runs LEAD on one of two paths: engine="tree", the reference's
pytree path (core/lead.py over a DenseGossip and the per-agent compress
``vmap_compress``: the difference in plain torch, then the compressor's
own compress), or engine="flat", the fused flat-buffer engine
(core/engines/lead.py).  The stochastic and noisy gradient oracles and
fault injection are not ported yet.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import lead as lead_mod
from repro_torch.core import topology as topology_mod
from repro_torch.core.compression import compress_each, sub_seed
from repro_torch.core.convex import consensus_error, distance_to_opt
from repro_torch.core.engines import FlatLEADState, engine_for
from repro_torch.core.engines.base import FlatEngineBase
from repro_torch.core.gossip import DenseGossip
from repro_torch.core.lead import LEADHyper
from repro_torch.core.stage_timer import mark
from repro_torch.device import DeviceLike

_LATER = "is not ported yet (ROADMAP.md, 'Modules still to port')"


def vmap_compress(compressor) -> Callable:
    """Per-agent compression: row i of an (n, ...) tensor is agent i's
    array; fn(seed, X) compresses every row with the step's draws
    (core/compression.compress_each)."""
    def fn(seed, X):
        return compress_each(compressor, seed, X)
    return fn


@functools.lru_cache(maxsize=None)
def static_bits(compressor, d: int, device: torch.device) -> torch.Tensor:
    """The per-agent bits of one step on a path that forms no payload: the
    compressor's static wire_bits(d) (32 per element uncompressed), a 0-d
    f32 tensor on `device`, built once per (compressor, d, device)."""
    bits = compressor.wire_bits(d) if compressor is not None else d * 32
    return torch.full((), float(bits), dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class LEADSim:
    """init/step adapter making LEAD interface-compatible with the
    baselines.

    The communication graph comes from either ``topology`` (a
    core/topology.Topology or a raw mixing matrix) or the legacy ``gossip``
    (a DenseGossip); give exactly one.  engine="flat" drives the fused
    flat-buffer engine (core/engines/lead.py); engine="tree" the
    reference's pytree path (core/lead.py), which needs a compressor
    (Identity for an uncompressed wire).  engine_gossip selects the flat
    engine's communication stage: "dense", "neighbor" or "ring".  dim and
    device are bound by run() from the problem when left None; with
    ``gossip=`` the device defaults to its W's.
    """
    topology: Any = None
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
    gossip: Optional[DenseGossip] = None

    def __post_init__(self):
        if self.engine not in ("tree", "flat"):
            raise ValueError(f"engine must be 'tree' or 'flat', got "
                             f"{self.engine!r}")
        if self.faults is not None:
            raise NotImplementedError(f"fault injection {_LATER}")
        if (self.gossip is None) == (self.topology is None):
            raise ValueError("give exactly one of gossip= (DenseGossip) or "
                             "topology=")
        # fail at construction, not inside a step: the tree path
        # dereferences the compressor (vmap_compress / wire_bits)
        if self.engine == "tree" and self.compressor is None:
            raise ValueError("LEADSim(engine='tree') needs a compressor; pass "
                             "compression.Identity() for an uncompressed "
                             "wire")
        if self.gossip is not None and self.device is None:
            object.__setattr__(self, "device", self.gossip.W.device)
        object.__setattr__(self, "_engines", {})

    @property
    def _topology(self):
        """The static Topology (a sequence of round graphs, a time-varying
        bank, raises: banks are not ported)."""
        if self.topology is not None:
            return topology_mod.materialize(self.topology)
        return topology_mod.as_topology(self.gossip.W.cpu().numpy())

    @functools.cached_property
    def _gossip(self) -> DenseGossip:
        """The tree path's dense mixing backend: the given DenseGossip, or
        one built once off the topology on the device."""
        if self.gossip is not None:
            return self.gossip
        return DenseGossip.from_topology(self._topology, self.device)

    def _flat_engine(self, dim: int):
        """The engine for `dim`, built once (its graph tables are copied to
        the device at construction)."""
        if dim not in self._engines:
            self._engines[dim] = engine_for(
                self._topology, self.compressor, dim, dither=self.dither,
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

    def init(self, x0, g0, seed=None):
        if self.engine == "tree":
            return lead_mod.init(x0, g0, self.hyper, self._gossip.mix, h0=x0)
        return self._flat_engine(self._dim_of(x0)).init(x0, g0, self.hyper)

    def step_with_wire(self, state, g, seed: int):
        """(new_state, comp_err, wire_bits) of one LEAD iteration; wire_bits
        is the per-agent bits this step put on the wire: from the actual
        payload on the flat engine, the compressor's static wire_bits(d) on
        the tree path (which never forms a payload)."""
        if self.engine == "tree":
            new, cerr = lead_mod.step_with_metrics(
                state, g, seed, self.hyper, self._gossip.mix,
                vmap_compress(self.compressor))
            return new, cerr, static_bits(self.compressor, g.shape[1],
                                          g.device)
        return self._flat_engine(self._dim_of(g)).step_wire(state, g, seed,
                                                            self.hyper)

    def step_with_metrics(self, state, g, seed: int):
        """(new_state, comp_err) with comp_err = ||Qh-(Y-H)||/||Y||, the
        error this iteration incurred."""
        return self.step_with_wire(state, g, seed)[:2]

    def step(self, state, g, seed: int):
        return self.step_with_wire(state, g, seed)[0]

    def x_of(self, state):
        """Current iterates as (n, d) on either path."""
        if isinstance(state, FlatLEADState):
            if self.dim is None:
                raise ValueError("LEADSim needs dim=<per-agent d> to "
                                 "unblockify states; run() binds it")
            return self._flat_engine(self.dim).unblockify(state.x)
        return state.x


def with_topology(algo, topology):
    """`algo` rebound to a new (static) communication graph: flat engines
    and LEADSim get the Topology itself, tree baselines a DenseGossip over
    its W on their device."""
    topo = topology_mod.materialize(topology)
    if isinstance(algo, LEADSim):
        return dataclasses.replace(algo, gossip=None, topology=topo)
    if isinstance(algo, FlatEngineBase):
        return dataclasses.replace(algo, topology=topo)
    if isinstance(getattr(algo, "gossip", None), DenseGossip):
        return dataclasses.replace(algo, gossip=DenseGossip.from_topology(
            topo, algo.gossip.W.device))
    raise TypeError(f"cannot rebind topology on {type(algo).__name__}")


class Trace(NamedTuple):
    """Host-side metric traces, one entry per recorded iteration.

    comp_err is ``||Q(m) - m|| / ||Y||`` where ``m`` is the message the
    algorithm transmitted this iteration (LEAD: the difference Y - H;
    CHOCO: x_half - xhat; DeepSqueeze: the error-compensated
    v = x - eta g + e; QDGD: x; DCD: the post-gossip x - xhat) and ``Y``
    the pre-communication iterate that carries it.  Every LEAD path, flat
    engine and compressed tree baseline records it from inside the step;
    only algorithms without step metrics fall back to the
    ``_compression_error`` re-compression estimate.

    bits_per_agent is the cumulative bits each agent has put on the wire
    up to and including the iteration: the actual per-step payloads on
    the flat engines, the compressor's static ``wire_bits(d)`` per
    iteration on the tree paths.
    """
    dist: np.ndarray
    consensus: np.ndarray
    loss: np.ndarray
    bits_per_agent: np.ndarray
    comp_err: np.ndarray


def run(algo, problem, x_star, *, iters=300, seed: int = 0, stochastic=False,
        noise_std=0.0, record_every=1, topology=None) -> Trace:
    """Run `algo` on `problem` from x0 = 0; returns metric traces (host
    numpy).  The run lives on x_star's device.

    topology= swaps the algorithm's communication graph before running.
    Iteration `it` draws with sub_seed(seed, it), so a compressed trace matches the reference's in
    distribution, not bit for bit: the reference draws its keys from its
    jax.random key stream.  An uncompressed trace matches it to rounding.

    The algorithm's own protocol decides what a step reports, as in the
    reference: step_with_wire gives the actual wire bits; step_with_metrics
    the in-step comp_err, with the compressor's static wire_bits(d) per
    step; a bare step the ``_compression_error`` estimate.

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
        algo = dataclasses.replace(algo, dim=d, device=algo.device or dev)

    state = algo.init(x0, problem.full_grad(x0))
    x_of = getattr(algo, "x_of", lambda s: s.x)
    comp = getattr(algo, "compressor", None)
    bits_per_step = static_bits(comp, d, dev)
    step_with_wire = getattr(algo, "step_with_wire", None)
    step_with_metrics = getattr(algo, "step_with_metrics", None)

    ms = torch.zeros((5, iters), dtype=torch.float32, device=dev)
    bits_acc = torch.zeros((), dtype=torch.float32, device=dev)
    for it in range(iters):
        g = problem.full_grad(x_of(state))
        mark("gradient")
        s = sub_seed(seed, it)
        if step_with_wire is not None:
            new, cerr, bits = step_with_wire(state, g, s)
        elif step_with_metrics is not None:
            new, cerr = step_with_metrics(state, g, s)
            bits = bits_per_step
        else:
            new = algo.step(state, g, s)
            cerr = _compression_error(algo, state, problem, s)
            bits = bits_per_step
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


def _compression_error(algo, state, problem, seed: int) -> torch.Tensor:
    """Fallback estimate of the Trace comp_err for algorithms without step
    metrics: re-compress the transmitted message of the pre-step state with
    the step's seed.

    The target is the quantity the algorithm puts on the wire:
    error-compensated algorithms (an ``e`` field) transmit
    v = x - eta g + e; hat-tracking algorithms (an ``xhat`` field) a
    difference against their public copies; direct-compression algorithms
    x."""
    comp = getattr(algo, "compressor", None)
    if comp is None:
        return torch.zeros((), dtype=torch.float32, device=state.x.device)
    if hasattr(state, "e"):
        eta = lead_mod._at(getattr(algo, "eta", 0.0), state.k)
        target = state.x - eta * problem.full_grad(state.x) + state.e
        ref = target
    elif hasattr(state, "xhat"):
        target = state.x - state.xhat
        ref = state.x
    else:
        target = state.x
        ref = state.x
    q = compress_each(comp, seed, target)
    return (torch.linalg.vector_norm((q - target).reshape(-1))
            / (torch.linalg.vector_norm(ref.reshape(-1)) + 1e-12))
