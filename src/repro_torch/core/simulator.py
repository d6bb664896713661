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

LEADSim runs LEAD on one of two paths: engine="tree" (the default, as in
the reference), the reference's pytree path (core/lead.py over a
DenseGossip and the per-agent compress ``vmap_compress``: the difference in
plain torch, then the compressor's own compress), or engine="flat", the
fused flat-buffer engine (core/engines/lead.py).

Gradient oracles: the full gradient, minibatch gradients
(``stochastic=True``) or the full gradient plus Gaussian noise
(``noise_std > 0``, which wins over ``stochastic``).  Their random input,
batch indices or the noise plane, comes from one replaceable function,
``oracle_draws``: the counter hash, seeded per step.  The parity tests
replace it to hand the port the reference's threefry draws.

Fault injection: an algorithm carrying an active core/faults.FaultModel
(``LEADSim(engine="flat", faults=...)`` or ``engine_for(..., faults=...)``)
is driven through the engine's faulted wire, and the Trace's four fault
fields get the per-step fault metrics.  An inactive model (every rate 0)
takes the clean path, bit for bit.

Time-varying (TopologyBank), two-level (``gossip="hier"``) and interval
(``with_interval(tau)``) graphs run on the flat engines: run() hands each
step its host counter, from which the engine picks the bank's round and
gates the interval's wire without reading the card.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core import lead as lead_mod
from repro_torch.core import topology as topology_mod
from repro_torch.core.compression import compress_each, fast_normal, sub_seed
from repro_torch.core.convex import (batch_indices, consensus_error,
                                     distance_to_opt)
from repro_torch.core.engines import FlatLEADState, engine_for
from repro_torch.core.engines.base import FlatEngineBase
from repro_torch.core.gossip import DenseGossip
from repro_torch.core.lead import LEADHyper
from repro_torch.core.stage_timer import mark
from repro_torch.device import DeviceLike
from repro_torch.utils.finite import assert_finite_tree, finite_checks_enabled

_MASK32 = 0xFFFFFFFF
_ORACLE = 1                 # substream of a step's seed for the oracle


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
    reference's pytree path (core/lead.py; the default, as in the
    reference), which needs a compressor (Identity for an uncompressed
    wire).  engine_gossip selects the flat engine's communication stage:
    "dense", "neighbor" or "ring".  faults attaches a core/faults.FaultModel
    to the flat engine (the tree path has no faulted wire).  dim and device
    are bound by run() from the problem when left None; with ``gossip=``
    the device defaults to its W's.  The fields come in the reference's
    order (``LEADSim(gossip, compressor, eta, ...)`` positionally), with
    the port's device last.
    """
    gossip: Optional[DenseGossip] = None
    compressor: Any = None
    eta: Any = 0.1
    gamma: Any = 1.0
    alpha: Any = 0.5
    engine: str = "tree"
    dither: str = "fast"
    engine_gossip: str = "dense"
    dim: Optional[int] = None
    topology: Any = None
    faults: Any = None
    device: DeviceLike = None

    def __post_init__(self):
        if self.engine not in ("tree", "flat"):
            raise ValueError(f"engine must be 'tree' or 'flat', got "
                             f"{self.engine!r}")
        if self.faults is not None:
            if not isinstance(self.faults, faults_mod.FaultModel):
                raise TypeError(f"faults must be a core/faults.FaultModel, "
                                f"got {self.faults!r}")
            if self.engine != "flat":
                raise ValueError("fault injection runs on the flat engine's "
                                 "faulted wire; pass engine='flat'")
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
        """Topology or TopologyBank (a periodic schedule or a sequence of
        round graphs materializes into a bank; a live periodless schedule
        raises, see topology.materialize)."""
        if self.topology is not None:
            return topology_mod.materialize(self.topology)
        return topology_mod.as_topology(self.gossip.W.cpu().numpy())

    @functools.cached_property
    def _gossip(self) -> DenseGossip:
        """The tree path's dense mixing backend: the given DenseGossip, or
        one built once off the topology on the device.  The tree path
        mixes one static graph: a bank raises ValueError."""
        if self.gossip is not None:
            return self.gossip
        topo = self._topology
        if isinstance(topo, topology_mod.TopologyBank):
            raise ValueError(
                "LEADSim(engine='tree') mixes one static graph; a "
                "TopologyBank (time-varying gossip) needs engine='flat'")
        return DenseGossip.from_topology(topo, self.device)

    def _flat_engine(self, dim: int):
        """The engine for `dim`, built once (its graph tables are copied to
        the device at construction)."""
        if dim not in self._engines:
            self._engines[dim] = engine_for(
                self._topology, self.compressor, dim, dither=self.dither,
                gossip=self.engine_gossip, faults=self.faults,
                device=self.device, eta=self.eta, gamma=self.gamma,
                alpha=self.alpha)
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

    def step_with_wire(self, state, g, seed: int, step: int = None):
        """(new_state, comp_err, wire_bits) of one LEAD iteration; wire_bits
        is the per-agent bits this step put on the wire: from the actual
        payload on the flat engine, the compressor's static wire_bits(d) on
        the tree path (which never forms a payload).  step is the host
        step counter the flat engine picks a bank's round and gates an
        interval with (the tree path mixes one static graph)."""
        if self.engine == "tree":
            new, cerr = lead_mod.step_with_metrics(
                state, g, seed, self.hyper, self._gossip.mix,
                vmap_compress(self.compressor))
            return new, cerr, static_bits(self.compressor, g.shape[1],
                                          g.device)
        return self._flat_engine(self._dim_of(g)).step_wire(
            state, g, seed, self.hyper, step)

    def step_with_metrics(self, state, g, seed: int):
        """(new_state, comp_err) with comp_err = ||Qh-(Y-H)||/||Y||, the
        error this iteration incurred."""
        return self.step_with_wire(state, g, seed)[:2]

    def step(self, state, g, seed: int):
        return self.step_with_wire(state, g, seed)[0]

    # -- the faulted driver protocol (delegates to the flat engine) ----------
    def init_fault_state(self, state):
        return self._flat_engine(self.dim).init_fault_state(state)

    def step_with_wire_faulted(self, state, fstate, g, seed: int,
                               step: int = None):
        return self._flat_engine(self._dim_of(g)).step_with_wire_faulted(
            state, fstate, g, seed, step)

    def x_of(self, state):
        """Current iterates as (n, d) on either path."""
        if isinstance(state, FlatLEADState):
            if self.dim is None:
                raise ValueError("LEADSim needs dim=<per-agent d> to "
                                 "unblockify states; run() binds it")
            return self._flat_engine(self.dim).unblockify(state.x)
        return state.x


def with_topology(algo, topology):
    """`algo` rebound to a new communication graph: flat engines and
    LEADSim get the Topology or TopologyBank itself, tree baselines a
    DenseGossip over its W on their device.  A periodic schedule
    materializes into a bank; a live periodless schedule raises
    (topology.materialize), and so does a bank for a tree baseline."""
    topo = topology_mod.materialize(topology)
    if isinstance(algo, LEADSim):
        return dataclasses.replace(algo, gossip=None, topology=topo)
    if isinstance(algo, FlatEngineBase):
        return dataclasses.replace(algo, topology=topo)
    if isinstance(getattr(algo, "gossip", None), DenseGossip):
        if isinstance(topo, topology_mod.TopologyBank):
            raise TypeError(
                f"{type(algo).__name__} is a tree baseline with a static "
                "DenseGossip; a TopologyBank (time-varying gossip) needs a "
                "flat engine (engine_for)")
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

    The last four rows are the fault metrics (core/faults.py), per
    recorded iteration: dropped_links counts the directed real edges that
    did not deliver, realized_gap is 1 - sigma_2 of the renormalized
    realized mixing matrix, staleness_mean/max summarize the FaultState's
    ages.  run() always fills them; on a fault-free run all four are 0.

    Hierarchical and interval wires: with ``gossip="hier"`` the link
    metrics are computed over the inter-node graph, the only level with
    wire links (intra-node averaging is local arithmetic and cannot drop).
    With ``comm_interval`` tau > 1, bits_per_agent grows only on
    communication steps (a skipped step ships zero bits), dropped_links
    and realized_gap are 0 on skipped steps, and staleness ages freeze
    there (no wire fired, so nothing aged).
    """
    dist: np.ndarray
    consensus: np.ndarray
    loss: np.ndarray
    bits_per_agent: np.ndarray
    comp_err: np.ndarray
    dropped_links: np.ndarray = None
    realized_gap: np.ndarray = None
    staleness_mean: np.ndarray = None
    staleness_max: np.ndarray = None


def oracle_draws(problem, X: torch.Tensor, seed: int, *, stochastic: bool,
                 batch: int, noise_std: float) -> dict:
    """The random input of one gradient-oracle call at the iterates X:
    ``noise``, a standard normal plane of X's shape (noise_std > 0), or
    ``idx``, the (n, batch) sample indices (stochastic), from the counter
    hash seeded `seed`, on X's device; nothing for the full gradient.  The
    one place the oracles draw: the parity tests replace it to hand the
    port the reference's draws."""
    if noise_std > 0:
        return {"noise": fast_normal(X.shape, seed, device=X.device)}
    if stochastic:
        return {"idx": batch_indices(problem.n, batch, problem.m, seed,
                                     X.device)}
    return {}


def oracle_grad(problem, X: torch.Tensor, seed: int, *, stochastic=False,
                batch=64, noise_std=0.0) -> torch.Tensor:
    """One call of run()'s gradient oracle at the iterates X: the full
    gradient plus noise_std times ``oracle_draws``' Gaussian plane
    (noise_std > 0 wins), the minibatch gradient over its batch indices
    (stochastic), else the full gradient."""
    if noise_std <= 0 and not stochastic:
        return problem.full_grad(X)
    draws = oracle_draws(problem, X, seed, stochastic=stochastic,
                         batch=batch, noise_std=noise_std)
    if noise_std > 0:
        return problem.full_grad(X) + noise_std * draws["noise"]
    return problem.minibatch_grad(X, draws["idx"])


def run(algo, problem, x_star, *, iters=300, seed: int = 0, stochastic=False,
        batch=64, noise_std=0.0, record_every=1, topology=None) -> Trace:
    """Run `algo` on `problem` from x0 = 0; returns metric traces (host
    numpy).  The run lives on x_star's device.

    stochastic=True takes minibatch gradients of `batch` samples per
    agent; noise_std > 0 instead adds Gaussian noise of that scale to the
    full gradient (the bounded-variance oracle of Assumption 3).  The
    initial gradient comes from the same oracle.

    topology= swaps the algorithm's communication graph before running: a
    Topology, a TopologyBank, a sequence of round graphs or a periodic
    schedule (time-varying gossip: step k mixes with round k % P).
    Iteration `it` draws with sub_seed(seed, it) (its oracle with that
    seed's substream 1, the initial gradient with sub_seed(seed,
    2^32 - 1)'s), so a compressed or stochastic trace matches the
    reference's in distribution, not bit for bit: the reference draws
    from its jax.random key stream.  An uncompressed full-gradient trace
    matches it to rounding.

    The algorithm's own protocol decides what a step reports, as in the
    reference: step_with_wire gives the actual wire bits; step_with_metrics
    the in-step comp_err, with the compressor's static wire_bits(d) per
    step; a bare step the ``_compression_error`` estimate.  An algorithm
    with an active FaultModel steps through step_with_wire_faulted with a
    FaultState beside its state.

    Metrics are written into a preallocated device tensor and cross to the
    host once, at the end.  A faulted run's dropped links and realized
    gap depend only on (fault seed, step, topology): they are realized on
    the host after the loop (the gap's SVD would synchronise the card).
    With record_every > 1 the metric reductions of skipped iterations are
    not computed (their rows are sliced out).  With REPRO_ASSERT_FINITE set
    every recorded step checks its iterates and comp_err (utils/finite.py).
    Each step marks the ends of its stages for core/stage_timer.py, which
    times them when a StageTimer is active."""
    dev = x_star.device
    n, d = problem.n, problem.d
    x0 = torch.zeros((n, d), dtype=torch.float32, device=dev)

    if topology is not None:
        algo = with_topology(algo, topology)
    if isinstance(algo, LEADSim) and (algo.dim is None or algo.device is None):
        algo = dataclasses.replace(algo, dim=d, device=algo.device or dev)

    grad_at = functools.partial(oracle_grad, problem, stochastic=stochastic,
                                batch=batch, noise_std=noise_std)
    state = algo.init(x0, grad_at(x0, sub_seed(sub_seed(seed, _MASK32),
                                               _ORACLE)))
    x_of = getattr(algo, "x_of", lambda s: s.x)
    comp = getattr(algo, "compressor", None)
    bits_per_step = static_bits(comp, d, dev)
    step_with_wire = getattr(algo, "step_with_wire", None)
    step_with_metrics = getattr(algo, "step_with_metrics", None)
    finite_on = finite_checks_enabled()

    # an active FaultModel reroutes the step through the faulted wire; an
    # inactive one takes this exact clean path (bit-identical traces)
    fm = getattr(algo, "faults", None)
    faulted = fm is not None and fm.is_active
    fstate = algo.init_fault_state(state) if faulted else None

    # rows: dist, consensus, loss, comp_err, bits (+ staleness mean, max)
    ms = torch.zeros((7 if faulted else 5, iters), dtype=torch.float32,
                     device=dev)
    bits_acc = torch.zeros((), dtype=torch.float32, device=dev)
    for it in range(iters):
        s = sub_seed(seed, it)
        g = grad_at(x_of(state), sub_seed(s, _ORACLE))
        mark("gradient")
        if faulted:
            new, fstate, cerr, bits = algo.step_with_wire_faulted(
                state, fstate, g, s, step=it)
        elif step_with_wire is not None:
            new, cerr, bits = step_with_wire(state, g, s, step=it)
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
            if finite_on:
                assert_finite_tree({"x": X, "comp_err": cerr},
                                   where="simulator recorded step")
            ms[0, it] = distance_to_opt(X, x_star)
            ms[1, it] = consensus_error(X)
            ms[2, it] = problem.loss(X)
            ms[3, it] = cerr
            if faulted:
                age = fstate.age.to(torch.float32)
                ms[5, it] = torch.mean(age)
                ms[6, it] = torch.max(age)
        ms[4, it] = bits_acc
        mark("metrics")
        state = new

    # single device->host transfer for the whole trace
    rows = ms.cpu().numpy().astype(np.float64)
    sel = slice(0, iters, record_every)
    dist, cons, loss, cerr, bits = rows[:5]
    zeros = np.zeros(len(dist[sel]), np.float64)
    faults = dict(dropped_links=zeros, realized_gap=zeros,
                  staleness_mean=zeros, staleness_max=zeros)
    if faulted:
        # the masks of the recorded steps (state.k = it, the pre-step
        # counter the wire used), realized on the host, at the wire's
        # granularity: on a hier wire only the inter graph has links; an
        # interval run fires no wire on its skipped steps (0 there)
        topo = algo._topology if isinstance(algo, LEADSim) else algo.topology
        gmode = (algo.engine_gossip if isinstance(algo, LEADSim)
                 else getattr(algo, "gossip", "dense"))
        tau = int(getattr(topo, "comm_interval", 1))
        if gmode == "hier" and int(getattr(topo, "node_size", 1)) > 1:
            topo = topo.inter
        ks = torch.arange(0, iters, record_every)
        dropped, gap = faults_mod.link_metrics(fm, topo, ks)
        if tau > 1:
            comm = ks % tau == 0
            dropped, gap = dropped * comm, gap * comm
        faults = dict(dropped_links=dropped.numpy().astype(np.float64),
                      realized_gap=gap.numpy().astype(np.float64),
                      staleness_mean=rows[5][sel], staleness_max=rows[6][sel])
    return Trace(dist=dist[sel], consensus=cons[sel], loss=loss[sel],
                 bits_per_agent=bits[sel], comp_err=cerr[sel], **faults)


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
