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
              Topology.
  * dither  - the U[0, 1) planes from ``fast_uniform``, the reference's
              counter hash reproduced bit for bit.

Every engine's iteration is the same three-beat bar (``_step_core``):

    message(s, gb, hy)            -> (msg, ctx)      pre-communication math
    encode_payload / mix_payload                      the wire
    apply_stage(s, gb, q, wq, hy, ctx) -> (new, err)  post-communication math

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

Not ported yet (each raises NotImplementedError): ``dither="match"`` (the
reference's threefry stream cannot be reproduced in torch), fault
injection, time-varying banks, ``gossip="hier"``, communication intervals
and, with them, the baselines' ``local_stage``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict

import torch
import torch.nn.functional as F

from repro_torch.core import topology as topology_mod
from repro_torch.core.compression import (Identity, QuantizePNorm, TopK,
                                          _is_inf)
from repro_torch.core.gossip import DenseGossip, EncodedNeighborGossip
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


def fast_uniform(shape, seed, device: DeviceLike = None) -> torch.Tensor:
    """Counter-based U[0,1) dither: the murmur3-style integer finalizer of
    ``src/repro/core/engines/base.py::fast_uniform`` over an iota, keyed by
    a uint32 seed (an int, or a 0-d integer tensor on the target device).
    Bit for bit the reference's stream: the uint32 arithmetic runs in int64
    masked to 32 bits (int64 products wrap modulo 2^64, so their low 32 bits
    are the uint32 product's).  Updates in place to hold the temporaries
    to two int64 planes."""
    m = 1
    for s in shape:
        m *= int(s)
    if isinstance(seed, torch.Tensor):
        s = seed.to(torch.int64)
        dev = seed.device
    else:
        dev = resolve_device(device)
        s = torch.full((), int(seed) & _MASK32, dtype=torch.int64, device=dev)
    z = torch.arange(m, dtype=torch.int64, device=dev)
    z += (s * 0x9E3779B9) & _MASK32
    z &= _MASK32
    z *= 0x85EBCA6B
    z &= _MASK32
    z ^= z >> 13
    z *= 0xC2B2AE35
    z &= _MASK32
    z ^= z >> 16
    z >>= 8
    # top 24 bits -> [0, 1) with full f32 mantissa coverage
    u = z.to(torch.float32)
    del z
    return u.mul_(1.0 / (1 << 24)).reshape(shape)


_LATER = ("not ported yet (ROADMAP.md, 'Modules still to port')")


@dataclasses.dataclass(frozen=True)
class FlatEngineBase:
    """Layout + wire + gossip substrate shared by every flat engine.

    topology is a core/topology.Topology (a raw mixing matrix is accepted
    and normalized).  compressor=None (or Identity) means no encode stage:
    the raw message buffer is the payload (d * 32 bits on the wire).  The
    payload is decoded once per step; gossip="dense" mixes W @ q,
    gossip="neighbor" runs the sparse neighbor gather.  device is where the
    state lives ("cuda" when None); the topology's tables are copied there
    once, here.

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
    gossip: str = "dense"              # "dense" | "neighbor"
    dither: str = "fast"               # the counter-hash dither stream
    device: DeviceLike = None          # None -> "cuda"

    state_cls: ClassVar[type] = None
    consensus_init: ClassVar[Dict[str, str]] = {}

    def __post_init__(self):
        object.__setattr__(self, "topology",
                           topology_mod.materialize(self.topology))
        object.__setattr__(self, "device", resolve_device(self.device))
        if self.gossip == "hier":
            raise NotImplementedError(f"gossip='hier' is {_LATER}")
        if self.gossip not in ("dense", "neighbor"):
            raise ValueError(f"gossip must be 'dense' or 'neighbor', got "
                             f"{self.gossip!r}")
        if self.dither == "match":
            raise NotImplementedError(
                "dither='match' reproduces the reference's per-agent threefry "
                "draws, which torch cannot generate; the port runs "
                "dither='fast', the reference's counter-hash stream")
        if self.dither != "fast":
            raise ValueError(f"dither must be 'fast', got {self.dither!r}")
        # the dense W serves gossip="dense" and the init-time mix (H_w = W H)
        object.__setattr__(self, "_dense", DenseGossip.from_topology(
            self.topology, self.device))
        object.__setattr__(self, "_neighbor", (
            EncodedNeighborGossip.from_topology(self.topology, self.device)
            if self.gossip == "neighbor" else None))

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
        n = arr.shape[0]
        pad = self.nb * self.block - self.dim
        flat = arr.to(torch.float32)
        if pad:
            flat = F.pad(flat, (0, pad))
        return flat.reshape(n, self.nb, self.block)

    def unblockify(self, buf: torch.Tensor) -> torch.Tensor:
        """(n, nb, block) -> (n, d)."""
        return buf.reshape(buf.shape[0], -1)[:, :self.dim]

    def _blockify_g(self, g: torch.Tensor) -> torch.Tensor:
        """Gradients arrive either (n, d) or already in the native
        (n, nb, block) layout."""
        return g if g.ndim == 3 else self.blockify(g)

    def _mix(self, buf: torch.Tensor) -> torch.Tensor:
        """W @ buf along the agent axis (pads are zero -> stay zero)."""
        return self._dense.mix(buf)

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

    def _dither_plane(self, seed: int, k: torch.Tensor) -> torch.Tensor:
        """U[0,1) dither (n, nb, block), seeded with seed ^ k on the
        device."""
        return fast_uniform((self.n, self.nb, self.block),
                            self._step_seed(seed, k))

    def _draws(self, comp, seed: int, k: torch.Tensor) -> Dict[str, Any]:
        """The random input of `comp`'s encode_blocks at step k, from the
        counter-hash stream seeded seed ^ k: no input for exact TopK, the
        (n, m) sample indices for approximate TopK, else the (n, dim)
        uniforms of the logical elements (the dither plane's)."""
        if isinstance(comp, TopK):
            if not comp.approx_threshold:
                return {}
            u = fast_uniform((self.n, comp.sample_size(self.dim)),
                             self._step_seed(seed, k))
            mark("dither")
            return {"idx": TopK.indices_from_uniform(u, self.dim)}
        u = self.unblockify(self._dither_plane(seed, k))
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
            u = self._dither_plane(seed, k)
            mark("dither")
            code, scale = _q.encode(self._rows(buf), self._rows(u),
                                    bits=comp.bits)
            mark("encode")
            return self.quant_payload(code, scale, comp.bits)
        payload, bits = comp.encode_blocks(buf, self.dim,
                                           **self._draws(comp, seed, k))
        mark("encode")
        return payload, comp.decode_blocks, bits

    def quant_payload(self, code: torch.Tensor, scale: torch.Tensor,
                      bits: int):
        """(payload, decode, wire_bits) for fused-quantizer outputs: code
        int8 / scale f32 in row layout (n*nb, ...).  The receiver decode is
        the K2 kernel; the wire carries (b+1)-bit codes for the d logical
        elements and one f32 scale per logical block."""
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

    def mix_payload(self, payload, decode):
        """Communication stage: (q, W q) with q = decode(payload), decoded
        exactly ONCE; the one decoded copy serves the receiver-own view and
        the mix."""
        q = decode(payload)
        mark("decode")
        wq = self._mix(q) if self.gossip == "dense" else self._neighbor.mix(q)
        mark("mix")
        return q, wq

    # -- the algorithm stage protocol ---------------------------------------
    def message(self, s, gb, hy):
        """Pre-communication math: (msg, ctx)."""
        raise NotImplementedError

    def apply_stage(self, s, gb, q, wq, hy, ctx):
        """Post-communication math: (new_state, comp_err)."""
        raise NotImplementedError

    def local_stage(self, s, gb, hy):
        """The no-communication step of a communication interval; the
        interval path is not ported, so only LEAD (which the reference's
        tests pin) has one."""
        raise NotImplementedError(
            f"{type(self).__name__}.local_stage (communication intervals) "
            f"is {_LATER}")

    def encode_stage(self, s, gb, seed: int, hy):
        """message + wire encode: (payload, decode, wire_bits, ctx)."""
        msg, ctx = self.message(s, gb, hy)
        mark("message")
        payload, decode, bits = self.encode_payload(msg, seed, s.k)
        return payload, decode, bits, ctx

    def _step_core(self, s, g, seed: int, hy):
        """The family's one iteration shape: encode -> gossip -> apply."""
        gb = self._blockify_g(g)
        payload, decode, bits, ctx = self.encode_stage(s, gb, seed, hy)
        q, wq = self.mix_payload(payload, decode)
        new, comp_err = self.apply_stage(s, gb, q, wq, hy, ctx)
        return new, comp_err, bits

    # -- driver protocol (engines driven directly by run()) -----------------
    def step_with_wire(self, state, g, seed: int):
        """(new_state, comp_err, wire_bits) with the engine's stored hypers
        resolved at state.k."""
        return self._step_core(state, g, seed, self.hypers_at(state.k))

    def x_of(self, state):
        """Current iterates as (n, d) regardless of the blocked layout."""
        return self.unblockify(state.x)

    def step(self, state, g, seed: int):
        return self.step_with_wire(state, g, seed)[0]


# derived, not hand-maintained: a field added to the base is a layout knob,
# never a hyper
_LAYOUT_FIELDS = tuple(f.name for f in dataclasses.fields(FlatEngineBase))
