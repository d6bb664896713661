"""Shared substrate of the flat engine family.

Every flat engine keeps its per-agent state as contiguous
``(n_agents, nb, block)`` f32 tensors in the kernels' block layout and runs
its iteration as a handful of fused passes over them.  This module holds
what the family shares:

  * layout  - blockify/unblockify between the logical (n, d) view and the
              padded (n, nb, block) buffers.  nb is padded to the
              reference's tile multiple so state shapes compare directly;
              zero rows are a fixed point of every kernel, so the padding
              never leaks.
  * wire    - ``encode_payload``: the pre-communication stage, three routes
              as in the reference.  Identity/None ships the raw buffer (d *
              32 bits); the paper's p=inf quantizer encodes the message with
              K4 (kernels/quantize.encode) fed by the engine's dither plane,
              and ``quant_payload`` gives the payload, the receiver decode
              (K2) and the wire bits; every other compressor goes through its
              ``encode_blocks``/``decode_blocks`` (core/compression.py), fed
              by the engine's own draws.
  * gossip  - ``mix_payload``: the payload is decoded ONCE, then mixed
              densely (``gossip="dense"``, W @ q) or by the sparse
              neighbor gather (``gossip="neighbor"``) over the engine's
              Topology; ``gossip="ring"`` is the reference's alias for the
              neighbor gather that also requires the uniform ring.
              ``gossip="hier"`` (topology.hierarchical graphs) runs the
              two-level wire: exact intra-node averaging (free), one
              encode per node, the neighbor gather over the inter graph
              only, so the wire bits are inter-node bytes per agent.  On a
              TopologyBank step k mixes with round ``k % P``.  Separately,
              ``topo.with_interval(tau)`` gates the whole wire at
              ``k % tau == 0``; the other steps run the engine's
              ``local_stage`` (zero bits, no gossip).
  * dither  - the U[0, 1) planes from ``fast_uniform`` (defined in
              core/compression.py), the reference's counter hash
              reproduced bit for bit.

Every engine's iteration is the same three-beat bar (``_step_core``, for
the clean and the faulted wire alike):

    message(s, gb, hy)                 -> (msg, ctx)  pre-communication math
    encode_payload / mix_payload                       the wire
    apply_stage(s, gb, q, wq, hy, ctx) -> new         post-communication math

plus ``comp_err(s, gb, q, hy, ctx)``, the step's compression error, which
``_step_core`` computes after ``apply_stage`` for the simulator's trace (a
driver that records no trace, as the trainer, never pays for it).

A multi-wire engine (C-GT ships an iterate wire and a tracker wire)
declares one name per wire in ``wire_fields``; its ``message`` returns a
tuple of that many buffers, each wire j is encoded under its own seed
(``compression.wire_seed(seed, j)``), the payloads and decodes travel as
tuples through one exchange (a faulted exchange realizes one link mask,
shared by all its wires), ``apply_stage`` receives tuples (q, wq), and the
wire bits are the sum over the wires.

Hyper-parameters are ``Schedule`` values (core/lead.py) resolved once per
step at ``state.k``, a 0-d tensor on the engine's device, so nothing in a
step waits for the host.  The step functions take the dither seed as an
explicit uint32 value; every random draw of step k is seeded with
``seed ^ k``, the reference's ``dither="fast"`` rule for a key whose last
word is seed.  The reference draws the random input of RandK, TopK's
approximate mode and the p != inf quantizer from threefry keys; the port
draws it from the same counter-hash stream, so those wires match the
reference in distribution, and draw for draw when the reference's draws
are injected (the parity tests do).

Fault injection (``faults=``, a core/faults.FaultModel) reroutes the wire
through ``mix_payload_faulted``: the same encode, then a degraded mix under
the step's link mask (renormalized weights or the stale cache), with a
FaultState carried from step to step (``step_with_wire_faulted``).  The
mask is a counter hash of (seed, step, edge) computed on the state's
device, so a faulted step makes no host sync either.

The reference picks a bank's round and gates an interval with the traced
counter ``state.k``.  The port decides both on the host, from run()'s
step counter: the step functions take ``step``, the host int equal to
``state.k``, which run() passes, so neither decision reads the card.  A
caller that gives no ``step`` on a bank or an interval run has it read off
``state.k``, one synchronisation per step.

Not ported (raises NotImplementedError): ``dither="match"``, the
reference's threefry stream, which torch cannot reproduce.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict

import numpy as np
import torch

from repro_torch.core import compression as compression_mod
from repro_torch.core import faults as faults_mod
from repro_torch.core import topology as topology_mod
from repro_torch.core.compression import (Identity, QuantizePNorm, TopK,
                                          _flat_to_rows, _is_inf,
                                          _rows_to_flat, fast_uniform)
from repro_torch.core.gossip import (DenseGossip, EncodedNeighborGossip,
                                     HierarchicalGossip)
from repro_torch.core.lead import _at
from repro_torch.core.stage_timer import mark
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import quantize as _q
from repro_torch.kernels.ops import DEFAULT_BLOCK, _pick_tile

_MASK32 = 0xFFFFFFFF


def _is_fused_quantizer(comp) -> bool:
    """True when the compressor is exactly what the fused kernels
    implement: the blockwise p=inf b-bit quantizer."""
    return isinstance(comp, QuantizePNorm) and _is_inf(comp.p)


@dataclasses.dataclass(frozen=True)
class FlatEngineBase:
    """Layout + wire + gossip substrate shared by every flat engine.

    topology is a core/topology.Topology (a raw mixing matrix is accepted
    and normalized).  compressor=None (or Identity) means no encode stage:
    the raw message buffer is the payload (d * 32 bits on the wire).  The
    payload is decoded once per step; gossip="dense" mixes W @ q,
    gossip="neighbor" runs the sparse neighbor gather, gossip="ring" is the
    same gather on the static uniform ring only (any other topology raises
    ValueError), and gossip="hier" the two-level wire of a
    topology.hierarchical graph.  The topology may be a TopologyBank (or a
    periodic schedule, which becomes one): step k then mixes with round
    k % P.  device is where the state lives ("cuda" when None); the
    topology's tables are copied there once, here.

    Subclasses add their hyper-parameter fields (eta/gamma/...), each a
    ``Schedule``, and implement ``init``, ``message`` and ``apply_stage``,
    plus the class metadata ``state_cls`` (the state NamedTuple) and
    ``consensus_init`` (how each non-x state field starts from a consensus
    point: "copy" of x0 or "zeros"), ported as data.
    """
    topology: Any                      # Topology (or (n, n) matrix)
    dim: int                           # logical per-agent dimension d
    compressor: Any = None             # None -> Identity (no encode stage)
    block: int = DEFAULT_BLOCK
    gossip: str = "dense"              # "dense" | "neighbor" | "ring" alias
    dither: str = "fast"               # the counter-hash dither stream
    faults: Any = None                 # core/faults.FaultModel (None = clean)
    device: DeviceLike = None          # None -> "cuda"

    state_cls: ClassVar[type] = None
    consensus_init: ClassVar[Dict[str, str]] = {}
    # one name per buffer the algorithm transmits each communication step;
    # a multi-wire engine overrides it, returns a same-length tuple from
    # ``message`` and receives same-length tuples (q, wq) in apply_stage
    wire_fields: ClassVar[tuple] = ("msg",)

    def __post_init__(self):
        # materialize: a TopologyBank passes through, a periodic schedule
        # becomes a bank, a live (periodless) schedule raises
        object.__setattr__(self, "topology",
                           topology_mod.materialize(self.topology))
        object.__setattr__(self, "device", resolve_device(self.device))
        if self.gossip not in ("dense", "neighbor", "ring", "hier"):
            raise ValueError(f"gossip must be 'dense', 'neighbor', 'ring' or "
                             f"'hier', got {self.gossip!r}")
        if self.dither == "match":
            raise NotImplementedError(
                "dither='match' reproduces the reference's per-agent threefry "
                "draws, which torch cannot generate; the port runs "
                "dither='fast', the reference's counter-hash stream")
        if self.dither != "fast":
            raise ValueError(f"dither must be 'fast', got {self.dither!r}")
        if self.faults is not None and not isinstance(self.faults,
                                                      faults_mod.FaultModel):
            raise TypeError(f"faults must be a core/faults.FaultModel, got "
                            f"{self.faults!r}")
        if (self.faults is not None and self.n_wires > 1
                and self.faults.policy != "renormalize"):
            raise ValueError(
                "multi-wire engines support only the 'renormalize' fault "
                "policy: the stale cache holds one payload per agent but "
                f"{type(self).__name__} ships {self.n_wires} wires per "
                "exchange")
        if self._bank and self.comm_interval > 1:
            raise ValueError(
                "comm_interval > 1 is not supported on a TopologyBank: "
                "skipping rounds changes which round graph fires at which "
                "step, and the bank recomputations (CHOCO/DCD xhat_w, "
                "LEAD hw) assume every round fires")
        if self.gossip == "hier":
            if not isinstance(self.topology,
                              topology_mod.HierarchicalTopology):
                raise ValueError(
                    "gossip='hier' needs a topology.hierarchical(...) graph "
                    "(use gossip='neighbor' for flat topologies)")
            if (self._hier and self.faults is not None
                    and self.faults.policy != "renormalize"):
                raise ValueError(
                    "hier gossip supports only the 'renormalize' fault "
                    "policy: the stale cache is agent-granular but the hier "
                    "wire is node-granular")
        if self.gossip == "ring":
            if self._bank:
                raise ValueError(
                    "gossip='ring' is the static uniform-ring alias and does "
                    "not support a TopologyBank (use gossip='neighbor')")
            if not np.allclose(self.topology.W, topology_mod.ring(self.n).W,
                               atol=1e-6):
                raise ValueError(
                    "gossip='ring' requires the uniform ring mixing matrix "
                    "(use gossip='neighbor' for arbitrary topologies)")
        # the dense W (a bank's stacked rounds) serves gossip="dense", the
        # bank's reference mixes and the init-time mix (H_w = W H, round 0)
        object.__setattr__(self, "_dense", DenseGossip.from_topology(
            self.topology, self.device))
        object.__setattr__(self, "_neighbor", (
            EncodedNeighborGossip.from_topology(self.topology, self.device)
            if self.gossip != "dense" and not self._hier else None))
        object.__setattr__(self, "_hg", (
            HierarchicalGossip.from_topology(self.topology, self.device)
            if self._hier else None))

    @property
    def _bank(self) -> bool:
        """True when the engine mixes over a round-indexed TopologyBank."""
        return isinstance(self.topology, topology_mod.TopologyBank)

    @property
    def n_wires(self) -> int:
        """Number of buffers this engine ships per communication step."""
        return len(self.wire_fields)

    @property
    def comm_interval(self) -> int:
        """tau: the topology's communication interval (1 = every step)."""
        return int(getattr(self.topology, "comm_interval", 1))

    @property
    def node_size(self) -> int:
        """Agents per node of a hierarchical topology (1 otherwise)."""
        return int(getattr(self.topology, "node_size", 1))

    @property
    def _hier(self) -> bool:
        """True when the engine runs the two-level wire: exact intra-node
        averaging (free) and the encoded inter-node exchange.  node_size 1
        stays False: the composite graph then is the inter graph, and the
        neighbor gather runs as on the flat path."""
        return self.gossip == "hier" and self.node_size > 1

    @property
    def W(self) -> np.ndarray:
        """The dense (n, n) mixing matrix of the engine's topology (on a
        bank, round 0's: TopologyBank.W)."""
        return self.topology.W

    @property
    def n(self) -> int:
        return self.topology.n

    @property
    def nb_logical(self) -> int:
        """Blocks of the logical vector: ceil(d / block)."""
        return -(-self.dim // self.block)

    @property
    def tile_b(self) -> int:
        return _pick_tile(self.dim, self.block, _q.DEFAULT_TILE_B)

    @property
    def nb(self) -> int:
        """nb_logical rounded up to a tile multiple (the reference's
        padding, kept so that state shapes compare directly)."""
        return -(-self.nb_logical // self.tile_b) * self.tile_b

    # -- layout ------------------------------------------------------------
    def blockify(self, arr: torch.Tensor) -> torch.Tensor:
        """(n, d) -> (n, nb, block), zero-padded past d (a view when there
        is nothing to pad)."""
        return _rows_to_flat(arr, self.nb, self.block)

    def unblockify(self, buf: torch.Tensor) -> torch.Tensor:
        """(n, nb, block) -> (n, d)."""
        return _flat_to_rows(buf, self.dim)

    def _blockify_g(self, g: torch.Tensor) -> torch.Tensor:
        """Gradients arrive either (n, d) or already in the native
        (n, nb, block) layout."""
        return g if g.ndim == 3 else self.blockify(g)

    def _mix(self, buf: torch.Tensor) -> torch.Tensor:
        """W @ buf along the agent axis (pads are zero -> stay zero).  On a
        bank, round 0: the init-time convention (at a consensus start every
        round's W x equals x)."""
        return self._dense.for_round(0).mix(buf)

    def mix_round(self, buf: torch.Tensor, step: int) -> torch.Tensor:
        """W_k @ buf through the engine's gossip backend, with the round of
        step k (a host int) on a bank, the fixed W otherwise.  For engine
        state that is not wire traffic (reference buffers such as LEAD's
        H, which receivers track as replicas), so no fault mask applies."""
        if not self._bank:
            return self._mix(buf)
        if self.gossip == "dense":
            out = self._dense.for_round(step).mix(buf)
        else:
            out = self._neighbor.for_round(step).mix(buf)
        mark("round_mix")
        return out

    def _host_step(self, s, step):
        """The step counter as a host int where the step needs it (a bank
        picks its round, an interval gates its wire): the caller's `step`,
        else state.k read off its device (one synchronisation)."""
        if step is not None:
            return int(step)
        if self._bank or self.comm_interval > 1:
            return int(s.k)
        return None

    def _rows(self, buf: torch.Tensor) -> torch.Tensor:
        """(n, nb, block) -> (n*nb, block): one kernel call for all agents."""
        return buf.reshape(-1, buf.shape[-1])

    # -- hyper-parameters ----------------------------------------------------
    @property
    def hyper_fields(self):
        """Names of this engine's algorithm hypers (dataclass fields beyond
        the layout substrate), each a Schedule (float or callable of k)."""
        return tuple(f.name for f in dataclasses.fields(self)
                     if f.name not in _LAYOUT_FIELDS)

    def hypers_at(self, k: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Resolve every hyper Schedule at iteration k (0-d f32 tensors)."""
        return {f: _at(getattr(self, f), k) for f in self.hyper_fields}

    # -- dither ------------------------------------------------------------
    @staticmethod
    def _step_seed(seed: int, k: torch.Tensor) -> torch.Tensor:
        """seed ^ k, the uint32 seed of step k's draws, on k's device."""
        return torch.bitwise_xor(k.to(torch.int64), int(seed) & _MASK32)

    def _dither_plane(self, seed: int, k: torch.Tensor,
                      rows: int = None) -> torch.Tensor:
        """U[0,1) dither (rows, nb, block), seeded with seed ^ k on the
        device; rows defaults to the agent count (the hier wire draws
        node-level planes)."""
        rows = self.n if rows is None else rows
        return fast_uniform((rows, self.nb, self.block),
                            self._step_seed(seed, k))

    def _draws(self, comp, seed: int, k: torch.Tensor,
               rows: int) -> Dict[str, Any]:
        """The random input of `comp`'s encode_blocks at step k for a
        message of `rows` rows, from the counter-hash stream seeded seed ^
        k: no input for exact TopK, the (rows, m) sample indices for
        approximate TopK, else the (rows, dim) uniforms of the logical
        elements (the dither plane's)."""
        if isinstance(comp, TopK):
            if not comp.approx_threshold:
                return {}
            u = fast_uniform((rows, comp.sample_size(self.dim)),
                             self._step_seed(seed, k))
            mark("dither")
            return {"idx": TopK.indices_from_uniform(u, self.dim)}
        u = self.unblockify(self._dither_plane(seed, k, rows))
        mark("dither")
        return {"u": u}

    # -- wire --------------------------------------------------------------
    def encode_payload(self, buf: torch.Tensor, seed: int, k: torch.Tensor):
        """Pre-communication stage: (payload, decode, wire_bits) for the
        message `buf` (n, nb, block) at step k with dither seed `seed`.

        payload is everything that may cross agents; decode maps it back to
        the (n, nb, block) estimate; wire_bits is the per-agent bits of the
        actual payload.  Identity/None ships the raw buffer (d * 32 bits).
        The paper's p=inf quantizer encodes with K4 fed by the engine's
        dither plane; every other compressor goes through its
        encode_blocks wire path with the engine's draws."""
        comp = self.compressor
        if comp is None or isinstance(comp, Identity):
            bits = torch.full((), float(self.dim * 32), dtype=torch.float32,
                              device=buf.device)
            return {"values": buf}, (lambda pl: pl["values"]), bits
        if not hasattr(comp, "encode_blocks"):
            raise NotImplementedError(
                f"{type(comp).__name__} does not implement the flat "
                "encode_blocks/decode_blocks wire protocol")
        if _is_fused_quantizer(comp):
            u = self._dither_plane(seed, k, buf.shape[0])
            mark("dither")
            code, scale = _q.encode(self._rows(buf), self._rows(u),
                                    bits=comp.bits)
            mark("encode")
            return self.quant_payload(code, scale, comp.bits)
        payload, bits = comp.encode_blocks(
            buf, self.dim, **self._draws(comp, seed, k, buf.shape[0]))
        mark("encode")
        return payload, comp.decode_blocks, bits

    def quant_payload(self, code: torch.Tensor, scale: torch.Tensor,
                      bits: int):
        """(payload, decode, wire_bits) for fused-quantizer outputs: code
        int8 / scale f32 in row layout (rows*nb, ...), rows the agents or,
        on the hier wire, the nodes.  The receiver decode is the K2
        kernel; the wire carries (b+1)-bit codes for the d logical elements
        and one f32 scale per logical block."""
        shape3 = (-1, self.nb, self.block)
        payload = {"code": code.reshape(shape3),
                   "scale": scale.reshape(-1, self.nb, 1)}

        def decode(pl):
            rows = _q.decode(pl["code"].reshape(-1, self.block),
                             pl["scale"].reshape(-1, 1), bits=bits)
            return rows.reshape(shape3)

        wire = torch.full((), float(self.dim * (bits + 1)
                                    + self.nb_logical * 32),
                          dtype=torch.float32, device=code.device)
        return payload, decode, wire

    def mix_payload(self, payload, decode, step: int = None):
        """Communication stage: (q, W q) with q = decode(payload), decoded
        exactly ONCE; the one decoded copy serves the receiver-own view and
        the mix.  On a bank, step (the host step counter) picks the round
        graph; on the hier wire q is block-constant (the decode broadcasts
        each node's payload), so its node view is exact and only node-level
        buffers travel the inter graph.  A multi-wire engine hands tuples
        of payloads and decodes: each wire is decoded and mixed in turn, and
        q, wq come back as tuples."""
        if isinstance(decode, tuple):
            outs = [self.mix_payload(pl, dec, step)
                    for pl, dec in zip(payload, decode)]
            return tuple(o[0] for o in outs), tuple(o[1] for o in outs)
        q = decode(payload)
        mark("decode")
        if self._hier:
            hg = self._hg
            wq = hg.broadcast(hg.inter.mix(hg.node_view(q)))
        elif self.gossip == "dense":
            wq = self._dense.for_round(step or 0).mix(q)
        else:
            wq = self._neighbor.for_round(step or 0).mix(q)
        mark("mix")
        return q, wq

    # -- fault injection -----------------------------------------------------
    def init_fault_state(self, state) -> faults_mod.FaultState:
        """Fresh FaultState (stale cache and staleness ages) for a run of
        this engine, carried beside the engine state by run()."""
        if self.faults is None:
            raise ValueError("the engine has no FaultModel attached")
        return faults_mod.init_fault_state(self.faults, state.x)

    def mix_payload_faulted(self, payload, decode, k: torch.Tensor,
                            fstate: faults_mod.FaultState, step: int = None):
        """The communication stage under the engine's FaultModel:
        (q, wq, new_fstate).  q is the clean own decode (an agent needs no
        wire to read its own payload); wq the degraded mix, where a link
        that did not deliver at step k is renormalized away
        (policy="renormalize") or served from the sender's last good
        broadcast (policy="stale").  Undetected corruption hits the wire
        copy only, never q or the self column.  The masks hash the device
        counter k; on a bank they compose with the round graph of `step`
        (the host counter), so only links that exist this round drop.  On
        the hier wire faults hit node -> node inter links and node
        broadcasts (intra-node averaging is local arithmetic): a lost
        inter link stalls every agent of the receiving node, so the
        staleness age repeats node-wise over agents.

        A multi-wire engine's tuple of payloads crosses one exchange: the
        link realization is drawn once and every wire sees it (a dropped
        link loses all the wires at once, as one lost packet would); q and
        wq come back as tuples, and the FaultState advances once (the
        construction check allows only the renormalize policy there, so
        there is no per-wire cache)."""
        if not isinstance(decode, tuple):
            q, wq, fs, _ = self._mix_one_faulted(payload, decode, k, fstate,
                                                 step)
            return q, wq, fs
        qs, wqs, fs, link = [], [], fstate, None
        for pl, dec in zip(payload, decode):
            q, wq, fs, link = self._mix_one_faulted(pl, dec, k, fstate,
                                                    step, link)
            qs.append(q)
            wqs.append(wq)
        return tuple(qs), tuple(wqs), fs

    def _link_realization(self, k: torch.Tensor, step: int = None):
        """(backend, mask, ok) of the exchange at step k: the gossip backend
        of the step's graph, its link-survival mask and the agents whose
        broadcast went out (repeated node-wise on the hier wire)."""
        fm = self.faults
        if self._hier:
            hg = self._hg
            return (hg.inter, fm.table_mask(k, hg.inter.neighbors),
                    torch.repeat_interleave(fm.broadcast_ok(k, hg.m),
                                            self.node_size))
        if self.gossip == "dense":
            return (self._dense.for_round(step or 0),
                    fm.dense_mask(k, self.n), fm.broadcast_ok(k, self.n))
        nbr = self._neighbor.for_round(step or 0)
        return (nbr, fm.table_mask(k, nbr.neighbors),
                fm.broadcast_ok(k, self.n))

    def _mix_one_faulted(self, payload, decode, k, fstate, step=None,
                         link=None):
        """One wire of mix_payload_faulted: (q, wq, new_fstate, link), with
        `link` the exchange's realization (drawn here when None)."""
        fm = self.faults
        q = decode(payload)
        mark("decode")
        backend, mask, ok = (self._link_realization(k, step)
                             if link is None else link)
        age = torch.where(ok, torch.zeros_like(fstate.age), fstate.age + 1)
        if self._hier:
            hg = self._hg
            qn = hg.node_view(q)
            wq = hg.broadcast(backend.mix_masked(
                qn, mask, x_tx=fm.corrupt_values(qn, k)))
            mark("mix")
            return (q, wq, faults_mod.FaultState(cache=fstate.cache, age=age),
                    (backend, mask, ok))
        q_tx = fm.corrupt_values(q, k)
        cache = fstate.cache if fm.policy == "stale" else None
        wq = backend.mix_masked(q, mask, x_tx=q_tx, cache=cache)
        new_cache = fstate.cache
        if fm.policy == "stale":
            sel = ok.reshape((self.n,) + (1,) * (q.ndim - 1))
            new_cache = torch.where(sel, q_tx, fstate.cache)
        mark("mix")
        return (q, wq, faults_mod.FaultState(cache=new_cache, age=age),
                (backend, mask, ok))

    @staticmethod
    def rel_err(q: torch.Tensor, target: torch.Tensor,
                ref: torch.Tensor) -> torch.Tensor:
        """The in-step relative compression error of a transmitted message
        under the Trace convention (core/compression.rel_err)."""
        return compression_mod.rel_err(q, target, ref)

    # -- the algorithm stage protocol ---------------------------------------
    def message(self, s, gb, hy):
        """Pre-communication math: (msg, ctx)."""
        raise NotImplementedError

    def apply_stage(self, s, gb, q, wq, hy, ctx, step=None):
        """Post-communication math: the new state.  step is the host step
        counter, which the bank recomputations read."""
        raise NotImplementedError

    def comp_err(self, s, gb, q, hy, ctx):
        """The in-step relative compression error of the transmitted
        message (the Trace convention), from the state before the step and
        the receiver's own decode q: 0 for an exact engine."""
        return torch.zeros((), dtype=torch.float32, device=gb.device)

    def local_stage(self, s, gb, hy):
        """The no-communication step of a communication interval
        (``k % comm_interval != 0``): (new_state, comp_err) with zero wire
        traffic.  Default: self-delivery, the message as its own q and wq
        (the W = I step), right for engines that transmit (a surrogate of)
        their iterate and mix it in (DGD, NIDS, EXTRA, D2, QDGD,
        DeepSqueeze).  Engines whose apply_stage advances a communication
        tracking state (LEAD's h/hw/d, CHOCO's xhat, DCD's hats) override
        it to freeze that state."""
        msg, ctx = self.message(s, gb, hy)
        return (self.apply_stage(s, gb, msg, msg, hy, ctx),
                torch.zeros((), dtype=torch.float32, device=gb.device))

    def encode_stage(self, s, gb, seed: int, hy):
        """message + wire encode: (payload, decode, wire_bits, ctx).  A
        multi-wire engine's message is a tuple: wire j is encoded under
        ``compression.wire_seed(seed, j)``, payloads and decodes come back
        as tuples, and the bits are summed over the wires (every buffer
        crosses the wire each exchange)."""
        msg, ctx = self.message(s, gb, hy)
        mark("message")
        if self.n_wires == 1:
            return (*self._encode_one(msg, seed, s.k), ctx)
        if not (isinstance(msg, tuple) and len(msg) == self.n_wires):
            raise ValueError(
                f"{type(self).__name__}.message must return one buffer per "
                f"wire of {self.wire_fields}")
        payloads, decodes, bits = zip(*(
            self._encode_one(m, compression_mod.wire_seed(seed, j), s.k)
            for j, m in enumerate(msg)))
        return payloads, decodes, sum(bits), ctx

    def _encode_one(self, msg, seed: int, k: torch.Tensor):
        """One wire's encode: (payload, decode, wire_bits).  On the hier
        wire each node encodes the mean of its agents' messages once: the
        payload has m = n / node_size rows, the decode broadcasts the node
        estimate back to its agents, and the per-agent bits are the node
        payload's over node_size."""
        if self._hier:
            hg = self._hg
            payload, node_decode, bits = self.encode_payload(
                hg.intra_mean(msg), seed, k)
            return (payload, lambda pl: hg.broadcast(node_decode(pl)),
                    bits / self.node_size)
        return self.encode_payload(msg, seed, k)

    def _intra_project(self, state):
        """Block-average every agent-leading buffer of a hier engine's
        state (exact intra-node averaging: local arithmetic, no wire), after
        apply_stage on a communication step: each node then is one agent
        of the inter-graph algorithm seeing its block-mean gradient.  The
        counter k passes through."""
        hg = self._hg
        return type(state)(*(
            hg.broadcast(hg.intra_mean(v))
            if v.ndim >= 1 and v.shape[0] == self.n else v for v in state))

    def _local(self, s, gb, hy):
        """(new_state, comp_err 0, bits 0) of an interval's local step."""
        new, _ = self.local_stage(s, gb, hy)
        zero = torch.zeros((), dtype=torch.float32, device=gb.device)
        mark("local")
        return new, zero, zero

    def _step_core(self, s, g, seed: int, hy, step: int = None,
                   fstate=None):
        """The family's one iteration shape, clean or faulted: encode ->
        gossip -> apply (-> the hier intra-node projection).  With
        comm_interval tau > 1 the whole wire fires only at k % tau == 0,
        decided on the host; the other steps run local_stage (zero bits,
        comp_err 0) and leave the FaultState as it was: no wire fired, so
        nothing dropped and no age advanced.  With a FaultState the
        exchange goes through mix_payload_faulted.  Returns (new_state,
        comp_err, wire_bits, new_fstate)."""
        gb = self._blockify_g(g)
        step = self._host_step(s, step)
        if self.comm_interval > 1 and step % self.comm_interval:
            new, zero, _ = self._local(s, gb, hy)
            return new, zero, zero, fstate
        payload, decode, bits, ctx = self.encode_stage(s, gb, seed, hy)
        if fstate is None:
            q, wq = self.mix_payload(payload, decode, step)
        else:
            q, wq, fstate = self.mix_payload_faulted(payload, decode, s.k,
                                                     fstate, step)
        new = self.apply_stage(s, gb, q, wq, hy, ctx, step)
        comp_err = self.comp_err(s, gb, q, hy, ctx)
        mark("comp_err")
        if self._hier:
            new = self._intra_project(new)
            mark("intra_project")
        return new, comp_err, bits, fstate

    # -- driver protocol (engines driven directly by run()) -----------------
    def step_with_wire(self, state, g, seed: int, step: int = None):
        """(new_state, comp_err, wire_bits) with the engine's stored hypers
        resolved at state.k; step is the host step counter (== state.k),
        which run() passes."""
        return self._step_core(state, g, seed, self.hypers_at(state.k),
                               step)[:3]

    def step_with_wire_faulted(self, state, fstate, g, seed: int,
                               step: int = None):
        """The faulted twin of step_with_wire: the same iteration, with the
        communication stage through mix_payload_faulted and a FaultState
        riding along.  Returns (new_state, new_fstate, comp_err,
        wire_bits)."""
        new, comp_err, bits, fs = self._step_core(
            state, g, seed, self.hypers_at(state.k), step, fstate)
        return new, fs, comp_err, bits

    def step_with_metrics(self, state, g, seed: int, step: int = None):
        """(new_state, comp_err): the first two results of
        step_with_wire."""
        return self.step_with_wire(state, g, seed, step)[:2]

    def x_of(self, state):
        """Current iterates as (n, d) regardless of the blocked layout."""
        return self.unblockify(state.x)

    def step(self, state, g, seed: int, step: int = None):
        return self.step_with_wire(state, g, seed, step)[0]


# derived, not hand-maintained: a field added to the base is a layout knob,
# never a hyper
_LAYOUT_FIELDS = tuple(f.name for f in dataclasses.fields(FlatEngineBase))
