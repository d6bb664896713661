"""Gossip (decentralized mixing) backends over the leading agent axis.

* DenseGossip - explicit mixing-matrix multiply, W @ X, leaf-wise over a
  pytree (the tree path's ``mix`` and ``i_minus_w``).
* EncodedNeighborGossip - sparse neighbor exchange, built from a Topology's
  padded ``neighbors``/``weights`` table: each agent combines its own
  decoded payload with a gather of its neighbors' - O(n * deg * d) where the
  dense mix is O(n^2 * d), valid for any Assumption-1 graph.  The payload is
  decoded once: per-agent decode commutes with the gather, so the flat
  engine decodes before the (virtual) exchange and hands the one decoded
  copy to ``mix``.

* HierarchicalGossip - two-level mixing for ``topology.hierarchical``
  graphs: exact (free) intra-node block averaging, then an
  EncodedNeighborGossip over the inter-node graph, so only node-mean
  payloads pay wire bits.
* EncodedRingGossip - the uniform-ring special case of
  EncodedNeighborGossip, kept for its (w_self, w_neighbor) reading API:
  decode once, then roll the decoded buffer to the ring neighbours.

DenseGossip and EncodedNeighborGossip hold their tables as tensors on one
device, copied there once at construction.  Built from a
core/topology.TopologyBank they hold the bank's stacked tables (a leading
round axis of length P), and ``for_round(k)`` is the backend of step k: a
view of round ``k % P``, chosen with the host's step counter, so a
time-varying step copies nothing and waits for nothing.  Both also have
``mix_masked``, the degraded mix under a core/faults.py link-survival mask
(renormalized surviving weights, or the stale cache for dropped links),
which the engines' fault layer uses (engines/base.py
``mix_payload_faulted``).  ``RingGossip``, the reference's
collective-permute ring over a mesh axis, is not ported: it belongs with
the torch.distributed trainer.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.faults import renormalize_dense, renormalize_table
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.utils.tree import Pytree, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class DenseGossip:
    """mix(X) = W @ X along the leading agent axis.  W is (n, n), or the
    (P, n, n) stack of a bank's rounds, whose ``for_round(k)`` mixes."""
    W: torch.Tensor                      # (n, n) or (P, n, n) f32

    @staticmethod
    def from_topology(topo, device: DeviceLike = None) -> "DenseGossip":
        """`topo` is a Topology, a TopologyBank (its stacked ``Ws``) or any
        (n, n) array."""
        W = np.asarray(getattr(topo, "Ws", getattr(topo, "W", topo)),
                       np.float64)
        return DenseGossip(W=torch.as_tensor(W, dtype=torch.float32,
                                             device=resolve_device(device)))

    def for_round(self, k: int) -> "DenseGossip":
        """The backend of step k (a host int): round ``k % P`` of a bank's
        stack, a view; a static backend is its own every round."""
        if self.W.ndim == 2:
            return self
        return DenseGossip(W=self.W[k % self.W.shape[0]])

    @property
    def n(self) -> int:
        return self.W.shape[-1]

    def mix(self, tree: Pytree) -> Pytree:
        """W @ x for every leaf x, each flattened to one 2-D matmul over
        its trailing axes."""
        def one(x):
            n = x.shape[0]
            return (self.W.to(x.dtype) @ x.reshape(n, -1)).reshape(x.shape)

        return tree_map(one, tree)

    def i_minus_w(self, tree: Pytree) -> Pytree:
        """(I - W) x, leaf-wise."""
        return tree_map(torch.subtract, tree, self.mix(tree))

    def mix_masked(self, x: torch.Tensor, mask: torch.Tensor, *,
                   x_tx: torch.Tensor = None,
                   cache: torch.Tensor = None) -> torch.Tensor:
        """Degraded ``W @ x`` under a link-survival mask (core/faults.py):
        ``mask[i, j]`` says whether link i <- j delivered (the diagonal is
        True).  With ``cache=None`` the surviving weights are renormalized
        (a dropped link's weight moves to the self weight,
        faults.renormalize_dense); with a cache buffer a dropped link is
        served at full weight from the sender's last good broadcast (the
        stale policy).  ``x_tx`` is the buffer as transmitted (corruption
        hits the wire copy); the self column always reads the clean local
        ``x``.  One (n, ...) buffer, not a pytree."""
        W = self.W.to(x.dtype)
        n = W.shape[0]
        x_tx = x if x_tx is None else x_tx
        off_diag = 1.0 - torch.eye(n, dtype=x.dtype, device=x.device)
        shape = (-1,) + (1,) * (x.ndim - 1)

        def matmul(M, b):
            return (M @ b.reshape(n, -1)).reshape(b.shape)

        if cache is None:
            Wr = renormalize_dense(W, mask)
            own = torch.diagonal(Wr).reshape(shape) * x
            return own + matmul(Wr * off_diag, x_tx)
        off = W * off_diag
        own = torch.diagonal(W).reshape(shape) * x
        return (own + matmul(off * mask, x_tx)
                + matmul(off * ~mask, cache))


@dataclasses.dataclass(frozen=True)
class EncodedNeighborGossip:
    """Sparse neighbor-exchange mixing on the leading (agent) axis:

        out[i] = weights[i, 0] * x[i] + sum_j weights[i, 1+j] * x[nbr[i, j]]

    - exactly ``W @ x`` up to summation order.  Pads (self index, weight 0)
    contribute exactly 0.  Built from a TopologyBank the tables carry a
    leading round axis, and ``for_round(k)`` mixes."""
    neighbors: torch.Tensor              # ([P,] n, deg_max) int64
    weights: torch.Tensor                # ([P,] n, deg_max + 1) f32

    @staticmethod
    def from_topology(topo, device: DeviceLike = None) -> "EncodedNeighborGossip":
        """`topo` is a Topology or a TopologyBank (its shared-layout stacked
        tables, copied once)."""
        dev = resolve_device(device)
        return EncodedNeighborGossip(
            neighbors=torch.as_tensor(np.asarray(topo.neighbors),
                                      dtype=torch.int64, device=dev),
            weights=torch.as_tensor(np.asarray(topo.weights),
                                    dtype=torch.float32, device=dev))

    def for_round(self, k: int) -> "EncodedNeighborGossip":
        """The backend of step k (a host int): round ``k % P`` of a bank's
        stacked tables, views; the bank-wide table width keeps every round
        the same shape.  A static backend is its own every round."""
        if self.neighbors.ndim == 2:
            return self
        r = k % self.neighbors.shape[0]
        return EncodedNeighborGossip(neighbors=self.neighbors[r],
                                     weights=self.weights[r])

    def mix(self, x: torch.Tensor) -> torch.Tensor:
        """Weighted neighbor gather, accumulated one neighbor column at a
        time (deg_max row-gathers, no (n, deg, d) intermediate)."""
        w = self.weights.to(x.dtype)
        shape = (-1,) + (1,) * (x.ndim - 1)
        out = w[:, 0].reshape(shape) * x
        for j in range(self.neighbors.shape[1]):
            out = out + w[:, 1 + j].reshape(shape) * x[self.neighbors[:, j]]
        return out

    def mix_encoded(self, payload: Pytree, decode) -> Pytree:
        """W @ decode(payload), leaf-wise, with one decode: decode commutes
        with the per-agent gather, so the one decoded copy serves every
        receiver."""
        return tree_map(self.mix, decode(payload))

    def mix_masked(self, x: torch.Tensor, mask: torch.Tensor, *,
                   x_tx: torch.Tensor = None,
                   cache: torch.Tensor = None) -> torch.Tensor:
        """Degraded sparse mix under a (n, deg_max) link-survival mask
        (core/faults.py; mask[i, j]: did neighbors[i, j] deliver to i).
        ``cache=None`` renormalizes the surviving table weights
        (faults.renormalize_table); a cache buffer instead serves a dropped
        link at full weight from the sender's last good broadcast (the
        stale policy).  ``x_tx`` is the as-transmitted buffer; the self
        column reads the clean local ``x``.  The same column-at-a-time
        accumulation as ``mix``."""
        x_tx = x if x_tx is None else x_tx
        shape = (-1,) + (1,) * (x.ndim - 1)
        w = self.weights.to(x.dtype)
        if cache is None:
            w = renormalize_table(w, mask)
        out = w[:, 0].reshape(shape) * x
        for j in range(self.neighbors.shape[1]):
            src = self.neighbors[:, j]
            val = x_tx[src] if cache is None else torch.where(
                mask[:, j].reshape(shape), x_tx[src], cache[src])
            out = out + w[:, 1 + j].reshape(shape) * val
        return out


@dataclasses.dataclass(frozen=True)
class HierarchicalGossip:
    """Two-level mixing for topology.hierarchical graphs.

    Blocks of ``node_size`` consecutive agents form one node.  The intra
    level is exact averaging (``intra_mean``, no wire); only node-level
    buffers travel the ``inter`` graph (an EncodedNeighborGossip over
    ``topo.inter``'s table).  For any buffer x,

        mix(x) = broadcast(W_inter @ intra_mean(x)) = kron(W_inter, J/s) @ x

    at node granularity, O(m * deg * d) with m = n / s.  The engines'
    ``gossip="hier"`` path encodes each node's intra-mean once and ships
    that one payload over the inter table, so the wire carries inter-node
    bytes only (payload / node_size per agent).  ``node_view`` reads row 0
    of each block: exact for the block-constant buffers that path
    produces."""
    node_size: int
    inter: EncodedNeighborGossip

    @staticmethod
    def from_topology(topo, device: DeviceLike = None) -> "HierarchicalGossip":
        """Backend for a topology.HierarchicalTopology (its inter table is
        copied to the device once)."""
        return HierarchicalGossip(
            node_size=int(topo.node_size),
            inter=EncodedNeighborGossip.from_topology(topo.inter, device))

    @property
    def m(self) -> int:
        """Node count of the inter graph."""
        return int(self.inter.neighbors.shape[0])

    def intra_mean(self, x: torch.Tensor) -> torch.Tensor:
        """(n, ...) -> (m, ...) block means, the exact intra-node mix."""
        s = self.node_size
        return x.reshape((x.shape[0] // s, s) + tuple(x.shape[1:])).mean(1)

    def node_view(self, x: torch.Tensor) -> torch.Tensor:
        """(n, ...) -> (m, ...) row 0 of each block; equals ``intra_mean``
        on block-constant buffers, with no arithmetic."""
        return x[::self.node_size]

    def broadcast(self, xb: torch.Tensor) -> torch.Tensor:
        """(m, ...) node-level buffer -> (n, ...) block-constant buffer."""
        s, m = self.node_size, xb.shape[0]
        rest = tuple(xb.shape[1:])
        return xb[:, None].expand((m, s) + rest).reshape((m * s,) + rest)

    def mix(self, tree: Pytree) -> Pytree:
        """kron(W_inter, J/s) @ x leaf-wise (see the class docstring)."""
        return tree_map(
            lambda x: self.broadcast(self.inter.mix(self.intra_mean(x))),
            tree)


@dataclasses.dataclass(frozen=True)
class EncodedRingGossip:
    """Uniform-ring special case of EncodedNeighborGossip: the compact
    (w_self, w_neighbor) API for ring-only drivers and tests.

    ``mix_encoded`` decodes the payload once and rolls the decoded buffer
    to the two ring neighbours (one for n == 2, none for n == 1): rolling
    commutes with per-agent decode."""
    w_self: float = 1.0 / 3.0
    w_neighbor: float = 1.0 / 3.0

    @staticmethod
    def weights_from(W) -> "EncodedRingGossip":
        """Read (w_self, w_neighbor) off a uniform ring mixing matrix (a
        Topology, an array or a CPU tensor)."""
        Wn = np.asarray(getattr(W, "W", W))
        return EncodedRingGossip(w_self=float(Wn[0, 0]),
                                 w_neighbor=float(Wn[0, 1 % Wn.shape[0]]))

    def shift(self, tree: Pytree, direction: int) -> Pytree:
        """Roll every leaf by one agent along the ring."""
        return tree_map(lambda a: torch.roll(a, -direction, dims=0), tree)

    def mix_encoded(self, payload: Pytree, decode) -> Pytree:
        """w_self * own + w_neighbor * (right + left) on the decoded buffer.

        Degenerate rings (topology.ring): n == 2 has one neighbour (both
        shifts would deliver the same agent; summing them double-counts),
        n == 1 has none."""
        n = tree_leaves(payload)[0].shape[0]
        own = decode(payload)
        if n == 1:
            return own
        right = self.shift(own, +1)
        if n == 2:
            return tree_map(
                lambda o, r: self.w_self * o + self.w_neighbor * r,
                own, right)
        left = self.shift(own, -1)
        return tree_map(
            lambda o, r, l: self.w_self * o + self.w_neighbor * (r + l),
            own, right, left)
