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

* EncodedRingGossip - the uniform-ring special case of
  EncodedNeighborGossip, kept for its (w_self, w_neighbor) reading API:
  decode once, then roll the decoded buffer to the ring neighbours.

DenseGossip and EncodedNeighborGossip hold their tables as tensors on one
device, copied there once at construction.  The masked (fault) and
time-varying (bank) forms and the hierarchical backend are not ported yet,
nor is ``RingGossip``, the reference's collective-permute ring over a mesh
axis (it belongs with the torch.distributed trainer).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.utils.tree import Pytree, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class DenseGossip:
    """mix(X) = W @ X along the leading agent axis."""
    W: torch.Tensor                      # (n, n) f32

    @staticmethod
    def from_topology(topo, device: DeviceLike = None) -> "DenseGossip":
        """`topo` is a Topology or any (n, n) array."""
        W = np.asarray(getattr(topo, "W", topo), np.float64)
        return DenseGossip(W=torch.as_tensor(W, dtype=torch.float32,
                                             device=resolve_device(device)))

    @property
    def n(self) -> int:
        return self.W.shape[0]

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


@dataclasses.dataclass(frozen=True)
class EncodedNeighborGossip:
    """Sparse neighbor-exchange mixing on the leading (agent) axis:

        out[i] = weights[i, 0] * x[i] + sum_j weights[i, 1+j] * x[nbr[i, j]]

    - exactly ``W @ x`` up to summation order.  Pads (self index, weight 0)
    contribute exactly 0."""
    neighbors: torch.Tensor              # (n, deg_max) int64
    weights: torch.Tensor                # (n, deg_max + 1) f32

    @staticmethod
    def from_topology(topo, device: DeviceLike = None) -> "EncodedNeighborGossip":
        dev = resolve_device(device)
        return EncodedNeighborGossip(
            neighbors=torch.as_tensor(np.asarray(topo.neighbors),
                                      dtype=torch.int64, device=dev),
            weights=torch.as_tensor(np.asarray(topo.weights),
                                    dtype=torch.float32, device=dev))

    def mix(self, x: torch.Tensor) -> torch.Tensor:
        """Weighted neighbor gather, accumulated one neighbor column at a
        time (deg_max row-gathers, no (n, deg, d) intermediate)."""
        w = self.weights.to(x.dtype)
        shape = (-1,) + (1,) * (x.ndim - 1)
        out = w[:, 0].reshape(shape) * x
        for j in range(self.neighbors.shape[1]):
            out = out + w[:, 1 + j].reshape(shape) * x[self.neighbors[:, j]]
        return out


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
