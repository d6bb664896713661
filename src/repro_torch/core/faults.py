"""Fault injection and graceful degradation for the compressed gossip wire.

A port of the reference's ``core/faults.py``: the same fault process, the
same counter hash and the same degradation policies, so that for one
``(seed, step)`` both packages realize the same faults, bit for bit.

  * :class:`FaultModel` - a frozen description of the fault process:
    per-step Bernoulli link drops, windowed agent dropout and rejoin,
    straggler episodes of ``straggler_tau`` steps, and bit-flip corruption
    of a broadcast payload.  Every realization is a counter hash of
    ``(seed, step, edge-or-agent)``: deterministic, replayable, drawn on
    whatever device the step counter lives on, with no host random state.
  * the policies - ``policy="renormalize"``: a dropped link's weight moves
    to the receiver's own weight, so the realized mixing matrix stays
    row-stochastic (and, for symmetric masks, doubly stochastic: LEAD's
    dual invariant needs that); an isolated agent gets self-weight 1.0.
    ``policy="stale"``: a dropped link is served at full weight from the
    sender's last good broadcast (:class:`FaultState` carries that cache
    and each agent's staleness age).  The stale policy suits algorithms
    whose payload is close to an iterate (DGD, CHOCO); LEAD's payload is
    an increment, and replaying a stale one corrupts the receiver's H_w.
  * the realized graph - :func:`renormalize_dense` and
    :func:`renormalize_table` build the degraded weights for the dense and
    the neighbor-table mix; :func:`link_metrics` and :func:`step_metrics`
    give the Trace's fault metrics (dropped links, realized spectral gap,
    staleness mean and max) from ``(model, topology, step, age)`` alone.

All faults are communication faults: a down or straggling agent keeps
computing, it is only not heard.  A link drop fails both directions of an
undirected edge at once; a down agent neither sends nor receives; a
straggler's outgoing payload is late; a corrupted payload is discarded
when ``detect_corruption`` (a checksum) is on, and otherwise enters the
mix with a ``bitflip_frac`` fraction of its f32 elements hit by one random
bit flip each.

The hash is uint32 arithmetic.  torch has no uint32 ``arange`` on the CPU,
so it runs in int64 masked with 0xFFFFFFFF: an int64 product wraps modulo
2^64, and its low 32 bits are the uint32 product's (as ``fast_uniform``
does, core/compression.py).

On a time-varying topology bank the link metrics are taken over each
step's round graph (:func:`link_metrics`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

_MASK32 = 0xFFFFFFFF

# distinct hash salts per fault plane (independent Bernoulli streams even
# where seed, step and agent counters coincide)
_SALT_LINK = 0x1001
_SALT_DOWN = 0x2002
_SALT_STRAGGLER = 0x3003
_SALT_CORRUPT = 0x4004
_SALT_ELEM = 0x5005

_GOLD = 0x9E3779B9            # 2^32 / golden ratio (Weyl increment)


def _device_of(*xs, device: DeviceLike = None) -> torch.device:
    """The device of the first tensor among `xs`, else `device` ("cuda"
    when None)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(device)


def _u32(x):
    """An integer tensor as int64 holding its uint32 value; a Python int
    stays an int (a host int never becomes a device tensor: that copy would
    synchronise the card)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK32
    return int(x) & _MASK32


def _f32(p: float) -> float:
    """`p` rounded to f32: the reference compares f32 draws with an f32
    rate."""
    return float(np.float32(p))


def _mix32(x):
    """Murmur3-style 32-bit finalizer over int64 tensors holding uint32
    (or a Python int)."""
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _MASK32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _MASK32
    return x ^ (x >> 16)


def counter_hash(seed: int, k, a, b, salt: int,
                 device: DeviceLike = None) -> torch.Tensor:
    """uint32 hash (as int64) of the counters ``(seed, step k, ids a/b,
    salt)`` over broadcastable ints or integer tensors, on their device."""
    k, a, b = (_u32(v) for v in (k, a, b))
    h = (int(seed) & _MASK32) ^ _mix32(
        (k + ((salt * _GOLD) & _MASK32)) & _MASK32)
    h = _mix32(h ^ ((a * _GOLD + 0x85EBCA6B) & _MASK32))
    h = _mix32(h ^ ((b * 0xC2B2AE35 + _GOLD) & _MASK32))
    if isinstance(h, torch.Tensor):
        return h
    return torch.tensor(h, dtype=torch.int64,
                        device=_device_of(device=device))


def counter_u01(seed: int, k, a, b, salt: int,
                device: DeviceLike = None) -> torch.Tensor:
    """U[0, 1) f32 from the counter hash (its top 24 bits)."""
    h = counter_hash(seed, k, a, b, salt, device=device)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


class FaultState(NamedTuple):
    """Per-run fault bookkeeping carried from step to step.

    cache  (n, nb, block) f32: each agent's last successfully broadcast
           decoded payload, the stale policy's fallback (zeros at the
           start); the renormalize policy carries an empty (0,) tensor.
    age    (n,) int32: steps since each agent last broadcast successfully
           (0 = fresh this step).
    """
    cache: torch.Tensor
    age: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Deterministic fault process and degradation policy (frozen and
    hashable).

    Rates are probabilities in [0, 1].  A model whose rates are all 0 is
    inactive (``is_active`` False): drivers take the clean path, so a
    drop-rate-0 run is bit-identical to a fault-free one.
    """
    seed: int = 0
    link_drop: float = 0.0        # per step, per undirected edge
    agent_drop: float = 0.0       # per window, per agent outage
    dropout_window: int = 1       # steps an agent outage lasts
    straggler_rate: float = 0.0   # per episode, per agent late payload
    straggler_tau: int = 1        # steps a straggler episode lasts
    bitflip_rate: float = 0.0     # per step, per agent payload corruption
    bitflip_frac: float = 1.0 / 64.0  # fraction of elements hit when corrupted
    detect_corruption: bool = True    # checksum: corrupted -> dropped
    policy: str = "renormalize"   # "renormalize" | "stale"

    def __post_init__(self):
        if self.policy not in ("renormalize", "stale"):
            raise ValueError(f"policy must be 'renormalize' or 'stale', got "
                             f"{self.policy!r}")
        for f in ("link_drop", "agent_drop", "straggler_rate",
                  "bitflip_rate", "bitflip_frac"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f}={v} must be a probability")
        if self.dropout_window < 1 or self.straggler_tau < 1:
            raise ValueError("dropout_window and straggler_tau must be >= 1")

    @property
    def is_active(self) -> bool:
        """True when any fault can ever realize."""
        return (self.link_drop > 0 or self.agent_drop > 0
                or self.straggler_rate > 0 or self.bitflip_rate > 0)

    # -- per-agent fault planes (elementwise over broadcastable ids) ---------
    def agent_down(self, k, ids: torch.Tensor) -> torch.Tensor:
        """Agent outage at step k: the same agents stay down for
        ``dropout_window`` consecutive steps, then rejoin."""
        if self.agent_drop <= 0:
            return torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
        win = _u32(k) // self.dropout_window
        return counter_u01(self.seed, win, ids, 0, _SALT_DOWN) \
            < _f32(self.agent_drop)

    def straggler(self, k, ids: torch.Tensor) -> torch.Tensor:
        """The agent's outgoing payload is late for the whole
        ``straggler_tau`` episode holding step k."""
        if self.straggler_rate <= 0:
            return torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
        ep = _u32(k) // self.straggler_tau
        return counter_u01(self.seed, ep, ids, 0, _SALT_STRAGGLER) \
            < _f32(self.straggler_rate)

    def corrupted(self, k, ids: torch.Tensor) -> torch.Tensor:
        """The agent's step-k broadcast is corrupted."""
        if self.bitflip_rate <= 0:
            return torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
        return counter_u01(self.seed, k, ids, 0, _SALT_CORRUPT) \
            < _f32(self.bitflip_rate)

    def broadcast_ok(self, k, n: int, device: DeviceLike = None) -> torch.Tensor:
        """(n,) bool: did each agent's step-k broadcast reach the wire
        intact?  False for down agents, stragglers and (when detected)
        corrupted payloads; an undetected corrupted broadcast was
        delivered, poisoned, and counts as ok."""
        ids = torch.arange(n, device=_device_of(k, device=device))
        ok = ~self.agent_down(k, ids) & ~self.straggler(k, ids)
        if self.detect_corruption:
            ok = ok & ~self.corrupted(k, ids)
        return ok

    # -- link survival -------------------------------------------------------
    def link_ok(self, k, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """Does the directed link dst <- src deliver at step k?  Over
        broadcastable integer tensors (k may be a tensor too): the one
        primitive every mask derives from.  A link fails when its
        undirected edge drops (hashed on the sorted pair), when either end
        is down, or when the sender's broadcast failed."""
        shape = torch.broadcast_shapes(
            src.shape, dst.shape, k.shape if isinstance(k, torch.Tensor)
            else ())
        ok = torch.ones(shape, dtype=torch.bool, device=src.device)
        if self.link_drop > 0:
            lo, hi = torch.minimum(src, dst), torch.maximum(src, dst)
            ok = ok & (counter_u01(self.seed, k, lo, hi, _SALT_LINK)
                       >= _f32(self.link_drop))
        if self.agent_drop > 0:
            ok = ok & ~self.agent_down(k, src) & ~self.agent_down(k, dst)
        if self.straggler_rate > 0:
            ok = ok & ~self.straggler(k, src)
        if self.bitflip_rate > 0 and self.detect_corruption:
            ok = ok & ~self.corrupted(k, src)
        return ok

    def table_mask(self, k, neighbors: torch.Tensor) -> torch.Tensor:
        """(n, deg_max) survival over a padded neighbor table (row i =
        receiver, entries = senders).  Pads carry weight 0, so their value
        never matters."""
        dst = torch.arange(neighbors.shape[0], device=neighbors.device)[:, None]
        return self.link_ok(k, neighbors, dst)

    def dense_mask(self, k, n: int, device: DeviceLike = None) -> torch.Tensor:
        """(n, n) survival, [i, j] = link i <- j, the diagonal always True.
        A k of shape (K, 1, 1) gives the (K, n, n) masks of K steps."""
        dev = _device_of(k, device=device)
        ids = torch.arange(n, device=dev)
        m = self.link_ok(k, ids[None, :], ids[:, None])
        return m | torch.eye(n, dtype=torch.bool, device=dev)

    # -- payload corruption --------------------------------------------------
    def corrupt_values(self, buf: torch.Tensor, k) -> torch.Tensor:
        """The buffer as received over the wire: agents whose step-k
        broadcast is corrupted and undetected get a ``bitflip_frac``
        fraction of their f32 elements hit by one random bit flip each
        (sign, exponent or mantissa).  The identity with detection on or
        rate 0 (detected corruption is a link drop)."""
        if self.bitflip_rate <= 0 or self.detect_corruption:
            return buf
        n = buf.shape[0]
        bad = self.corrupted(k, torch.arange(n, device=buf.device))
        cnt = torch.arange(buf.numel(), device=buf.device).reshape(buf.shape)
        h = counter_hash(self.seed, k, cnt, 0, _SALT_ELEM)
        hit = (h >> 8).to(torch.float32) * (1.0 / (1 << 24)) \
            < _f32(self.bitflip_frac)
        flip = torch.where(hit, torch.ones_like(h) << (h & 31),
                           torch.zeros_like(h))
        # the uint32 flip word as int32: bit 31 (the sign) wraps negative
        flip = torch.where(flip >= 1 << 31, flip - (1 << 32), flip)
        bits = buf.to(torch.float32).contiguous().view(torch.int32) \
            ^ flip.to(torch.int32)
        corrupt = bits.view(torch.float32).to(buf.dtype)
        sel = bad.reshape((n,) + (1,) * (buf.ndim - 1))
        return torch.where(sel, corrupt, buf)


# -- realized (degraded) mixing weights --------------------------------------

def renormalize_dense(W: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The realized mixing matrix: surviving entries of W keep their
    weight, and each row's lost mass moves to the diagonal.  Rows stay
    stochastic and nonnegative with no division, an isolated agent gets
    the identity row, and a symmetric W under a symmetric mask stays
    symmetric, hence doubly stochastic (dividing by the surviving row sum
    would break the column sums LEAD's dual invariant needs).  A mask of
    shape (K, n, n) gives K realized matrices."""
    Wm = W * mask
    lost = W.sum(-1) - Wm.sum(-1)
    eye = torch.eye(W.shape[-1], dtype=Wm.dtype, device=Wm.device)
    return Wm + lost[..., None] * eye


def renormalize_table(weights: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The neighbor-table form of :func:`renormalize_dense`: `weights` is
    a Topology's padded (n, deg_max + 1) table (self weight in column 0),
    `mask` the (n, deg_max) link survival; dropped entries are zeroed and
    their mass added to the self column."""
    m = torch.cat([torch.ones_like(mask[:, :1]), mask], dim=1)
    wm = weights * m
    lost = weights.sum(1) - wm.sum(1)
    return torch.cat([wm[:, :1] + lost[:, None], wm[:, 1:]], dim=1)


# -- fault metrics ---------------------------------------------------------------

def link_metrics(model: FaultModel, topo, ks: torch.Tensor):
    """dropped_links and realized_gap at each step of `ks` (a 1-D integer
    tensor; the work runs on its device), in one batched pass.

    dropped_links counts directed real edges (``topo.edge_mask``) that did
    not deliver; realized_gap is 1 - sigma_2 of the renormalized realized
    matrix (``topo.spectral_gap`` for the fault-free symmetric W).  On a
    TopologyBank both are taken over each step's round graph (round
    k % P): only edges that exist that round count, and the fault-free
    gap of a degree-1 round is 0 (the contraction lives in the period
    product).  Both are (K,) f32.  ``torch.linalg.svdvals`` synchronises
    a card with the host, so ``simulator.run`` calls this once, on the
    host, after its loop: the masks depend only on (seed, step,
    topology)."""
    dev = ks.device
    n = topo.n
    if hasattr(topo, "period"):                  # TopologyBank: step's round
        r = ks.to(torch.int64) % topo.period
        W = torch.as_tensor(np.asarray(topo.Ws), dtype=torch.float32,
                            device=dev)[r]
        edges = torch.as_tensor(topo.edge_masks, device=dev)[r]
    else:
        W = torch.as_tensor(np.asarray(topo.W), dtype=torch.float32,
                            device=dev)
        edges = torch.as_tensor(topo.edge_mask, device=dev)
    m = model.dense_mask(ks.reshape(-1, 1, 1), n)
    dropped = (edges & ~m).sum((-2, -1)).to(torch.float32)
    if n == 1:
        return dropped, torch.ones_like(dropped)
    sv = torch.linalg.svdvals(renormalize_dense(W, m))
    return dropped, 1.0 - sv[:, 1]


def step_metrics(model: FaultModel, topo, k, age: torch.Tensor):
    """The Trace's four fault metrics for step k as 0-d f32 tensors on
    age's device: dropped_links, realized_gap (see :func:`link_metrics`;
    a bank's round graph of step k) and the mean and max of the staleness
    ages."""
    ks = torch.as_tensor(k, device=age.device).reshape(1)
    dropped, gap = link_metrics(model, topo, ks)
    agef = age.to(torch.float32)
    return dropped[0], gap[0], torch.mean(agef), torch.max(agef)


def init_fault_state(model: FaultModel, x_like: torch.Tensor) -> FaultState:
    """Fresh FaultState for a run over buffers shaped like `x_like` (the
    agent axis leading): the stale policy's zero payload cache, or an
    empty one, and zero ages."""
    n = x_like.shape[0]
    cache = (torch.zeros(x_like.shape, dtype=torch.float32,
                         device=x_like.device)
             if model.policy == "stale"
             else torch.zeros((0,), dtype=torch.float32,
                              device=x_like.device))
    return FaultState(cache=cache,
                      age=torch.zeros((n,), dtype=torch.int32,
                                      device=x_like.device))
