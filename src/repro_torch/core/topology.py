"""Communication topologies: first-class ``Topology`` objects (Assumption 1).

The port's copy of ``src/repro/core/topology.py`` for static graphs.  A
mixing matrix W must be symmetric, doubly stochastic, and primitive with
eigenvalues -1 < lambda_n <= ... <= lambda_2 < lambda_1 = 1.

Every builder (``ring``, ``chain``, ``star``, ``torus_2d``, ``erdos_renyi``,
``fully_connected``, ``from_matrix``, ``metropolis``) returns a frozen
:class:`Topology` carrying three views of the same graph:

  * ``W``          - the dense (n, n) mixing matrix (``gossip="dense"``);
  * ``neighbors`` / ``weights`` - the padded neighbor-exchange table:
                     ``neighbors[i, j]`` is agent i's j-th neighbor (padded
                     with i itself), ``weights[i, 0]`` its self weight and
                     ``weights[i, 1 + j]`` the weight on that neighbor
                     (padded with 0) (``gossip="neighbor"``);
  * ``permute_rounds()`` - the edge set as partial permutations grouped by
                     index shift, the form a point-to-point exchange takes.

Fields are host numpy: the engines copy what they need to their device once,
at construction.  The spectral quantities of Theorem 1 / Corollary 1 are
cached properties:

    beta    = lambda_max(I - W)
    kappa_g = lambda_max(I - W) / lambda_min^+(I - W)

The module-level ``spectral_gap``, ``beta``, ``lambda_min_plus``,
``kappa_g``, ``check_mixing`` and ``check_doubly_stochastic`` take a
Topology or a raw matrix (a raw matrix is not validated first).

Not ported yet (ROADMAP "Modules still to port", robustness and topology
layers): time-varying schedules and ``TopologyBank``, ``hierarchical``
graphs and the communication interval.  They raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, List, Tuple

import numpy as np

_EDGE_TOL = 1e-12           # |W_ij| above this is a graph edge
_LATER = ("not ported yet: time-varying banks, hierarchical graphs and "
          "communication intervals come with the robustness and topology "
          "layers (ROADMAP.md, 'Modules still to port')")


@dataclasses.dataclass(frozen=True, eq=False)
class Topology:
    """Frozen graph object: dense mixing matrix + sparse neighbor table +
    point-to-point round decomposition + Theorem-1 spectral metadata.

    ``weights[:, 0]`` is the self weight; column ``1 + j`` pairs with
    ``neighbors[:, j]`` (self-padded index, 0.0-padded weight), so a
    weighted gather over the table reproduces ``W @ x`` up to summation
    order."""
    name: str
    W: np.ndarray                        # (n, n) float64 mixing matrix
    neighbors: np.ndarray                # (n, deg_max) int32, self-padded
    weights: np.ndarray                  # (n, deg_max + 1) float64, 0-padded

    @property
    def n(self) -> int:
        return self.W.shape[0]

    @property
    def deg_max(self) -> int:
        return self.neighbors.shape[1]

    @property
    def shape(self) -> Tuple[int, int]:
        return self.W.shape

    def __array__(self, dtype=None, copy=None):
        """np.asarray(topo) yields the dense W."""
        return self.W if dtype is None else self.W.astype(dtype)

    def __repr__(self) -> str:
        return f"{self.name}(n={self.n}, deg_max={self.deg_max})"

    def with_schedule(self, fn, period=None):
        raise NotImplementedError(_LATER)

    def with_interval(self, tau: int):
        raise NotImplementedError(_LATER)

    # -- spectral quantities (Theorem 1 / Corollary 1) ----------------------
    @functools.cached_property
    def _eig_i_minus_w(self) -> np.ndarray:
        return np.linalg.eigvalsh(np.eye(self.n) - self.W)

    @property
    def beta(self) -> float:
        """lambda_max(I - W)."""
        return float(self._eig_i_minus_w[-1])

    @property
    def lambda_min_plus(self) -> float:
        """Smallest nonzero eigenvalue of I - W."""
        ev = self._eig_i_minus_w
        pos = ev[ev > 1e-10]
        return float(pos[0]) if len(pos) else 0.0

    @property
    def kappa_g(self) -> float:
        lm = self.lambda_min_plus
        return self.beta / lm if lm > 0 else float("inf")

    @functools.cached_property
    def spectral_gap(self) -> float:
        if self.n <= 1:
            return 1.0
        ev = np.sort(1.0 - self._eig_i_minus_w)      # eigenvalues of W
        return float(1.0 - max(abs(ev[0]), abs(ev[-2])))

    # -- point-to-point view --------------------------------------------------
    @functools.cached_property
    def _rounds(self) -> List[Tuple[Tuple[Tuple[int, int], ...], np.ndarray]]:
        # pairs are (src, dst): dst receives from src, so the edge for pair
        # (i, j) is W[j, i] > tol
        n = self.n
        by_shift = {}
        for i in range(n):
            for j in range(n):
                if i != j and self.W[j, i] > _EDGE_TOL:
                    by_shift.setdefault((j - i) % n, []).append((i, j))
        rounds = []
        for s in sorted(by_shift, key=lambda s: (min(s, n - s), s)):
            pairs = tuple(sorted(by_shift[s]))
            rw = np.zeros(n)
            for i, j in pairs:
                rw[j] = self.W[j, i]
            rounds.append((pairs, rw))
        return rounds

    def permute_rounds(self):
        """The directed edge set as a list of ``(pairs, recv_weight)``
        rounds, each a partial permutation (grouped by the index shift
        ``(j - i) mod n``, so sources and destinations within a round are
        unique).  ``recv_weight[j] = W[j, src]`` for the agent j receives
        from this round, 0.0 where it receives nothing.  Rounds are ordered
        by hop distance with the +1 shift first."""
        return self._rounds

    def validate(self, atol: float = 1e-8) -> "Topology":
        """check_mixing + neighbor-table/W consistency; returns self."""
        check_mixing(self.W, atol=atol)
        recon = np.zeros_like(self.W)
        recon[np.arange(self.n), np.arange(self.n)] = self.weights[:, 0]
        for j in range(self.deg_max):
            recon[np.arange(self.n), self.neighbors[:, j]] += \
                self.weights[:, 1 + j]
        if not np.allclose(recon, self.W, atol=atol):
            raise ValueError("neighbor table does not reconstruct W")
        return self


def _table_from_w(W: np.ndarray):
    """Padded (neighbors, weights) table off the dense matrix's sparsity."""
    n = W.shape[0]
    nbr_lists = [np.nonzero((W[i] > _EDGE_TOL)
                            & (np.arange(n) != i))[0] for i in range(n)]
    deg_max = max((len(l) for l in nbr_lists), default=0)
    neighbors = np.empty((n, deg_max), np.int32)
    weights = np.zeros((n, deg_max + 1))
    weights[:, 0] = np.diag(W)
    for i, nbrs in enumerate(nbr_lists):
        neighbors[i, :len(nbrs)] = nbrs
        neighbors[i, len(nbrs):] = i            # self-padding (weight 0)
        weights[i, 1:1 + len(nbrs)] = W[i, nbrs]
    return neighbors, weights


def _build(name: str, W: np.ndarray) -> Topology:
    W = np.asarray(W, np.float64)
    neighbors, weights = _table_from_w(W)
    return Topology(name=name, W=W, neighbors=neighbors, weights=weights)


def from_matrix(W, name: str = "matrix", validate: bool = True) -> Topology:
    """Topology from an explicit mixing matrix (Assumption 1 checked unless
    ``validate=False``); the neighbor table is derived from W's sparsity."""
    topo = _build(name, np.asarray(W, np.float64))
    return topo.validate() if validate else topo


def as_topology(obj: Any, name: str = "matrix") -> Topology:
    """Normalize Topology | array-like to a Topology."""
    if isinstance(obj, Topology):
        return obj
    return from_matrix(obj, name=name)


def materialize(obj: Any, name: str = "matrix") -> Topology:
    """The compiled form of a communication graph.  Only static graphs are
    ported: a Topology or a matrix goes through :func:`as_topology`; a
    sequence of round graphs (a bank) raises."""
    if isinstance(obj, (list, tuple)):
        raise NotImplementedError(_LATER)
    return as_topology(obj, name=name)


def hierarchical(inter_topo, node_size: int):
    raise NotImplementedError(_LATER)


# -- graph families ----------------------------------------------------------

def ring(n: int) -> Topology:
    """Ring with uniform 1/3 weights (paper §5 setup).  n=1,2 degenerate."""
    if n == 1:
        return _build("ring", np.ones((1, 1)))
    if n == 2:
        return _build("ring", np.full((2, 2), 0.5))
    W = np.zeros((n, n))
    for i in range(n):
        W[i, i] = 1.0 / 3.0
        W[i, (i + 1) % n] = 1.0 / 3.0
        W[i, (i - 1) % n] = 1.0 / 3.0
    return _build("ring", W)


def chain(n: int) -> Topology:
    """Path graph with Metropolis-Hastings weights."""
    A = np.zeros((n, n), dtype=bool)
    for i in range(n - 1):
        A[i, i + 1] = A[i + 1, i] = True
    return _build("chain", metropolis_matrix(A))


def fully_connected(n: int) -> Topology:
    return _build("full", np.full((n, n), 1.0 / n))


def star(n: int) -> Topology:
    A = np.zeros((n, n), dtype=bool)
    A[0, 1:] = A[1:, 0] = True
    return _build("star", metropolis_matrix(A))


def torus_2d(rows: int, cols: int) -> Topology:
    """2-D torus; uniform weight over the 4 neighbors + self (length-2
    sides collapse the two wrap-around edges onto one neighbor)."""
    n = rows * cols
    W = np.zeros((n, n))
    w = 1.0 / 5.0
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            W[i, i] = w
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                j = ((r + dr) % rows) * cols + (c + dc) % cols
                W[i, j] += w
    return _build(f"torus_{rows}x{cols}", W)


def erdos_renyi(n: int, p: float = 0.5, seed: int = 0) -> Topology:
    """G(n, p) with a ring backbone (guarantees connectivity) and
    Metropolis-Hastings weights.  The edge draw hashes (seed, edge index)
    through numpy's SeedSequence, a fixed-spec mixing function, so the same
    seed yields the same graph on every numpy version."""
    bits = np.random.SeedSequence(seed).generate_state(n * n, np.uint32)
    u = (bits >> 8).astype(np.float64) * (1.0 / (1 << 24))
    A = (u < p).reshape(n, n)
    A = np.triu(A, 1)
    A = A | A.T
    for i in range(n):
        A[i, (i + 1) % n] = A[(i + 1) % n, i] = True
    return _build(f"er_p{p:g}_s{seed}", metropolis_matrix(A))


def metropolis_matrix(adj: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings weight *matrix* for an adjacency (symmetric,
    doubly stochastic) - the raw-ndarray core of :func:`metropolis`."""
    adj = np.asarray(adj)
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    W = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j and adj[i, j]:
                W[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        W[i, i] = 1.0 - W[i].sum()
    return W


def metropolis(adj: np.ndarray) -> Topology:
    """Topology with Metropolis-Hastings weights for an adjacency matrix."""
    return _build("metropolis", metropolis_matrix(adj))


# -- spectral quantities on raw matrices or Topologies -----------------------
# thin wrappers over the cached Topology properties; a raw matrix is wrapped
# without Assumption-1 validation, as in the reference

def _topo_of(W) -> Topology:
    return W if isinstance(W, Topology) else _build("matrix", np.asarray(W))


def spectral_gap(W) -> float:
    return _topo_of(W).spectral_gap


def beta(W) -> float:
    """lambda_max(I - W)."""
    return _topo_of(W).beta


def lambda_min_plus(W) -> float:
    """Smallest nonzero eigenvalue of I - W."""
    return _topo_of(W).lambda_min_plus


def kappa_g(W) -> float:
    return _topo_of(W).kappa_g


def check_doubly_stochastic(W, atol: float = 1e-8) -> None:
    """Assumption 1 minus symmetry and connectivity: square, nonnegative,
    rows and columns sum to 1; raises ValueError on violation."""
    W = np.asarray(W)
    n = W.shape[0]
    checks = [
        (W.shape == (n, n), "W must be square"),
        (np.all(W >= -atol), "W must be nonnegative"),
        (np.allclose(W.sum(axis=1), 1.0, atol=atol), "rows must sum to 1"),
        (np.allclose(W.sum(axis=0), 1.0, atol=atol),
         "columns must sum to 1"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(msg)


def check_mixing(W, atol: float = 1e-8) -> None:
    """Validate Assumption 1; raises ValueError on violation."""
    W = np.asarray(W)
    n = W.shape[0]
    checks = [
        (W.shape == (n, n), "W must be square"),
        (np.allclose(W, W.T, atol=atol), "W must be symmetric"),
        (np.allclose(W.sum(axis=1), 1.0, atol=atol), "rows must sum to 1"),
        (np.all(W >= -atol), "W must be nonnegative"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(msg)
    if n > 1:
        ev = np.sort(np.linalg.eigvalsh(W))
        if not ev[0] > -1.0 + 1e-10:
            raise ValueError("lambda_n(W) must be > -1")
        if not ev[-2] < 1.0 - 1e-12:
            raise ValueError("graph must be connected (lambda_2 < 1)")
