"""Gossip (decentralized mixing) backends over the leading agent axis.

* DenseGossip - explicit mixing-matrix multiply, W @ X.
* EncodedNeighborGossip - sparse neighbor exchange, built from a Topology's
  padded ``neighbors``/``weights`` table: each agent combines its own
  decoded payload with a gather of its neighbors' - O(n * deg * d) where the
  dense mix is O(n^2 * d), valid for any Assumption-1 graph.  The payload is
  decoded once: per-agent decode commutes with the gather, so the flat
  engine decodes before the (virtual) exchange and hands the one decoded
  copy to ``mix``.

Both hold their tables as tensors on one device, copied there once at
construction.  The masked (fault) and time-varying (bank) forms and the
hierarchical backend are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


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

    def mix(self, x: torch.Tensor) -> torch.Tensor:
        """W @ x, flattened to one 2-D matmul over the trailing axes."""
        n = x.shape[0]
        return (self.W.to(x.dtype) @ x.reshape(n, -1)).reshape(x.shape)


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
