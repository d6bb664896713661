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

Time-varying gossip: a Topology is a callable of the iteration counter,
``topo(k)`` the graph of step k (itself when static);
``topo.with_schedule(fn, period=P)`` attaches a hook ``fn(k) -> Topology``.
The engines do not call the hook per step: :func:`materialize` turns a
periodic schedule into a :class:`TopologyBank`, the P round graphs stacked
in one shared layout (``Ws (P, n, n)``, ``neighbors (P, n, max_deg)``,
``weights (P, n, max_deg + 1)``), and the engines copy its tables to the
device once and pick round ``k % P`` each step.  A schedule without a
period raises there.  Round graphs must be doubly stochastic but need not
be symmetric: ``exponential_onepeer`` builds directed degree-1 rounds,
``random_matching`` symmetric matchings drawn from the fault layer's
counter hash (core/faults.py), so both packages draw the same rounds.

Two-level gossip: :func:`hierarchical` builds a composite Topology,
``W = kron(W_inter, J_s / s)``: blocks of ``node_size`` consecutive agents
average exactly (no wire), only node means travel the ``inter`` graph.
``topo.with_interval(tau)`` sets the communication interval: the engines
gossip only at ``k % tau == 0`` and take a local step (zero wire bits)
otherwise.  Both knobs pass through :func:`materialize` unchanged.

The module-level ``spectral_gap``, ``beta``, ``lambda_min_plus``,
``kappa_g``, ``check_mixing`` and ``check_doubly_stochastic`` take a
Topology or a raw matrix (a raw matrix is not validated first).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

_EDGE_TOL = 1e-12           # |W_ij| above this is a graph edge


def _check_interval(tau) -> int:
    tau = int(tau)
    if tau < 1:
        raise ValueError(f"comm_interval must be >= 1, got {tau}")
    return tau


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
    schedule: Optional[Callable[[int], "Topology"]] = None
    schedule_period: Optional[int] = None   # P: schedule repeats mod P
    comm_interval: int = 1               # tau: gossip fires at k % tau == 0

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

    # -- time-varying hook --------------------------------------------------
    def __call__(self, k: int) -> "Topology":
        """The graph at iteration k: ``schedule(k)`` when a hook is
        attached, else this (static) topology."""
        return self if self.schedule is None else self.schedule(int(k))

    def with_schedule(self, fn: Callable[[int], "Topology"],
                      period: Optional[int] = None) -> "Topology":
        """A copy whose ``topo(k)`` resolves through ``fn``, which returns
        Topologies of the same n.  ``period=P`` declares the schedule
        periodic (``fn(k) == fn(k mod P)``), which lets :func:`materialize`
        turn it into a :class:`TopologyBank`; the engines reject a
        periodless schedule."""
        if period is not None and period < 1:
            raise ValueError(f"schedule period must be >= 1, got {period}")
        return dataclasses.replace(self, schedule=fn, schedule_period=period)

    def with_interval(self, tau: int) -> "Topology":
        """A copy with communication interval ``tau``: the engines run the
        encode and gossip stages only at ``k % tau == 0`` and a local step
        (zero wire bits) otherwise; ``tau=1`` gossips every step."""
        return dataclasses.replace(self, comm_interval=_check_interval(tau))

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

    @functools.cached_property
    def edge_mask(self) -> np.ndarray:
        """(n, n) bool: True where a real directed edge exists (W above the
        edge tolerance, off the diagonal).  The fault layer
        (core/faults.py) counts dropped links against this set."""
        return (self.W > _EDGE_TOL) & ~np.eye(self.n, dtype=bool)

    @functools.cached_property
    def uniform_weights(self) -> Optional[Tuple[float, float]]:
        """(w_self, w_neighbor) when every agent has the same self weight
        and every edge the same weight (ring, torus, fully_connected);
        None for weight-heterogeneous graphs (metropolis on an irregular
        adjacency).  :func:`bank` keeps one style per bank."""
        diag = np.diag(self.W)
        off = self.W[(self.W > _EDGE_TOL) & ~np.eye(self.n, dtype=bool)]
        if len(off) == 0:
            return (1.0, 0.0)
        if np.allclose(diag, diag[0]) and np.allclose(off, off[0]):
            return (float(diag[0]), float(off[0]))
        return None

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


# -- round-indexed topology banks (time-varying gossip) ----------------------

@dataclasses.dataclass(frozen=True, eq=False)
class TopologyBank:
    """A periodic sequence of P round graphs in stacked, shared-layout host
    arrays: the form the engines run time-varying gossip from.

    The engines copy the stacked tables to their device once and mix step
    k with round ``k % P``; core/faults.py composes its link masks with the
    step's round graph.  All rounds have the same n, and every round's
    padded neighbor table is re-padded to the bank-wide ``max_deg`` (self
    index, weight 0.0: the same convention as a single Topology's table).
    Round graphs must be doubly stochastic but need not be symmetric.

    Build one with :func:`bank` (a list of Topologies or matrices), a
    graph family (:func:`exponential_onepeer`, :func:`random_matching`),
    or by materializing a periodic schedule (:func:`materialize`).
    """
    name: str
    rounds: Tuple[Topology, ...]         # the P per-round graphs
    Ws: np.ndarray                       # (P, n, n) float64
    neighbors: np.ndarray                # (P, n, max_deg) int32, self-padded
    weights: np.ndarray                  # (P, n, max_deg + 1) f64, 0-padded
    comm_interval: int = 1               # tau: gossip fires at k % tau == 0

    @property
    def period(self) -> int:
        return len(self.rounds)

    @property
    def n(self) -> int:
        return self.Ws.shape[1]

    @property
    def deg_max(self) -> int:
        """The shared bank-wide table width."""
        return self.neighbors.shape[2]

    @property
    def W(self) -> np.ndarray:
        """The round-0 dense matrix, the init-time mixing convention: at a
        consensus start every round's W x equals x, so engines that mix
        once during init (LEAD's H_w, DCD's xhat_w) use round 0."""
        return self.Ws[0]

    @functools.cached_property
    def edge_masks(self) -> np.ndarray:
        """(P, n, n) bool: each round's directed real edges (the fault
        layer's dropped-link count, per step's graph)."""
        return np.stack([
            (W > _EDGE_TOL) & ~np.eye(self.n, dtype=bool) for W in self.Ws])

    @functools.cached_property
    def period_W(self) -> np.ndarray:
        """W_{P-1} ... W_1 W_0, the map one full period applies.  For
        one-peer exponential graphs at n = 2^m it is exactly the uniform
        1/n averaging matrix."""
        P = np.eye(self.n)
        for W in self.Ws:
            P = W @ P
        return P

    @property
    def beta(self) -> float:
        """lambda_max(I - period_W), of the period product's symmetric
        part."""
        return _topo_of(0.5 * (self.period_W + self.period_W.T)).beta

    @property
    def kappa_g(self) -> float:
        return _topo_of(0.5 * (self.period_W + self.period_W.T)).kappa_g

    @functools.cached_property
    def spectral_gap(self) -> float:
        """1 - sigma_2(period_W): the contraction of one full period
        (singular values, so directed round products are handled)."""
        if self.n <= 1:
            return 1.0
        sv = np.linalg.svd(self.period_W, compute_uv=False)
        return float(1.0 - sv[1])

    def __call__(self, k: int) -> Topology:
        """The round graph at iteration k: ``rounds[k % P]``."""
        return self.rounds[int(k) % self.period]

    def with_interval(self, tau: int) -> "TopologyBank":
        """A copy with communication interval ``tau`` (see
        :meth:`Topology.with_interval`).  The engines reject tau > 1 on a
        bank: skipping rounds changes which round graph fires at which
        step, and the bank recomputations (CHOCO's and DCD's xhat_w,
        LEAD's hw) assume every round fires."""
        return dataclasses.replace(self, comm_interval=_check_interval(tau))

    def __repr__(self) -> str:
        degs = [int(np.max((r.weights[:, 1:] > _EDGE_TOL).sum(axis=1)))
                for r in self.rounds]
        deg_s = str(degs[0]) if len(set(degs)) == 1 else f"<={max(degs)}"
        return (f"{self.name}(n={self.n}, period={self.period}, "
                f"deg={deg_s})")

    def validate(self, atol: float = 1e-8) -> "TopologyBank":
        """Every round doubly stochastic and every stacked table
        reconstructs its stacked W; returns self."""
        for r, W in enumerate(self.Ws):
            check_doubly_stochastic(W, atol=atol)
            recon = np.zeros_like(W)
            recon[np.arange(self.n), np.arange(self.n)] = \
                self.weights[r, :, 0]
            for j in range(self.deg_max):
                recon[np.arange(self.n), self.neighbors[r, :, j]] += \
                    self.weights[r, :, 1 + j]
            if not np.allclose(recon, W, atol=atol):
                raise ValueError(
                    f"bank round {r}: neighbor table does not "
                    f"reconstruct W")
        return self


def bank(topos, name: str = "bank") -> TopologyBank:
    """Stack a sequence of round graphs (Topologies or raw matrices) into a
    :class:`TopologyBank` with the shared (n, max_deg) layout.

    A round that disagrees with round 0 raises a ValueError naming it: a
    different agent count n, or a different weight style (uniform against
    non-uniform).  Tables narrower than the bank-wide max_deg are
    re-padded (self index, weight 0.0)."""
    topos = [t if isinstance(t, Topology)
             else _build(f"{name}[{r}]", np.asarray(t, np.float64))
             for r, t in enumerate(topos)]
    if not topos:
        raise ValueError("bank needs at least one round graph")
    n0 = topos[0].n
    style0 = topos[0].uniform_weights is not None
    for r, t in enumerate(topos):
        if t.n != n0:
            raise ValueError(
                f"bank round {r} ({t.name!r}) has n={t.n} agents but "
                f"round 0 ({topos[0].name!r}) has n={n0}; every round of "
                f"a TopologyBank must share the same agent count")
        if (t.uniform_weights is not None) != style0:
            kind = ("uniform" if t.uniform_weights is not None
                    else "non-uniform")
            kind0 = "uniform" if style0 else "non-uniform"
            raise ValueError(
                f"bank round {r} ({t.name!r}) has {kind} weights but "
                f"round 0 ({topos[0].name!r}) is {kind0}; a TopologyBank "
                f"must not mix uniform and non-uniform weight styles "
                f"(re-weight the odd round out, e.g. via metropolis)")
    deg = max(t.deg_max for t in topos)
    nbr = np.empty((len(topos), n0, deg), np.int32)
    wts = np.zeros((len(topos), n0, deg + 1))
    for r, t in enumerate(topos):
        d = t.deg_max
        nbr[r, :, :d] = t.neighbors
        nbr[r, :, d:] = np.arange(n0, dtype=np.int32)[:, None]  # self pad
        wts[r, :, :d + 1] = t.weights
    Ws = np.stack([t.W for t in topos])
    return TopologyBank(name=name, rounds=tuple(topos), Ws=Ws,
                        neighbors=nbr, weights=wts)


def materialize(obj: Any, name: str = "matrix"):
    """The form the engines run: Topology | TopologyBank | matrix |
    sequence of round graphs, with periodic schedules expanded.

    * a TopologyBank passes through;
    * a list or tuple of graphs becomes ``bank(...)``;
    * a scheduled Topology with ``schedule_period=P`` becomes the bank of
      ``fn(0), ..., fn(P-1)``, keeping its communication interval;
    * a scheduled Topology without a period raises ValueError (it would
      freeze at ``topo(0)``);
    * everything else goes through :func:`as_topology`.
    """
    if isinstance(obj, TopologyBank):
        return obj
    if isinstance(obj, (list, tuple)):
        return bank(obj, name=name)
    topo = as_topology(obj, name=name)
    if topo.schedule is None:
        return topo
    if topo.schedule_period is None:
        raise ValueError(
            f"topology {topo.name!r} carries a live (periodless) schedule "
            "callable, which the engines cannot run: it would freeze the "
            "graph at topo(0).  Either attach a period "
            "(topo.with_schedule(fn, period=P)) so it materializes into a "
            "TopologyBank, or resolve topo(k) yourself and re-run per "
            "phase.")
    P = topo.schedule_period
    b = bank([topo(k) for k in range(P)], name=f"{topo.name}@P{P}")
    if topo.comm_interval != 1:
        b = b.with_interval(topo.comm_interval)
    return b


# -- time-varying graph families ---------------------------------------------

def exponential_onepeer(n: int) -> TopologyBank:
    """One-peer exponential graphs: a period-ceil(log2 n) bank whose round
    r has each agent i average itself with agent ``(i - 2^r) mod n``::

        W_r[i, i] = 1/2,   W_r[i, (i - 2^r) mod n] = 1/2

    Each round is doubly stochastic and directed with degree 1.  At
    n = 2^m the P-round product is exactly the uniform 1/n averaging
    matrix; off powers of two it still contracts."""
    if n < 1:
        raise ValueError(f"exponential_onepeer needs n >= 1, got {n}")
    if n == 1:
        return bank([_build("exp_onepeer[0]", np.ones((1, 1)))],
                    name="exp_onepeer1")
    P = int(np.ceil(np.log2(n)))
    rounds = []
    idx = np.arange(n)
    for r in range(P):
        W = np.zeros((n, n))
        W[idx, idx] = 0.5
        W[idx, (idx - (1 << r)) % n] = 0.5
        rounds.append(_build(f"exp_onepeer[{r}]", W))
    return bank(rounds, name=f"exp_onepeer{n}")


_SALT_MATCH = 0x7007        # counter-hash domain for random_matching draws


def random_matching(n: int, seed: int = 0, rounds: int = 8) -> TopologyBank:
    """A bank of ``rounds`` random perfect matchings drawn from the counter
    hash of (seed, round, agent) (core/faults.py), so the rounds are the
    reference's bit for bit, and ``random_matching(n, seed, r1)`` is a
    prefix of ``random_matching(n, seed, r2)`` for r1 < r2.

    Round r sorts agents by their hashed key and pairs consecutive ones;
    each matched pair averages (W[i,i] = W[i,j] = 1/2), an unmatched agent
    (odd n) keeps self weight 1.  Every round is symmetric doubly
    stochastic with degree <= 1."""
    from repro_torch.core.faults import counter_hash
    if n < 1:
        raise ValueError(f"random_matching needs n >= 1, got {n}")
    if rounds < 1:
        raise ValueError(f"random_matching needs rounds >= 1, got {rounds}")
    topos = []
    idx = np.arange(n)
    for r in range(rounds):
        keys = counter_hash(seed, r, torch.from_numpy(idx), 0,
                            _SALT_MATCH).numpy()
        order = np.argsort(keys, kind="stable")
        W = np.eye(n)
        for a in range(0, n - 1, 2):
            i, j = int(order[a]), int(order[a + 1])
            W[i, i] = W[j, j] = 0.5
            W[i, j] = W[j, i] = 0.5
        topos.append(_build(f"matching_s{seed}[{r}]", W))
    return bank(topos, name=f"matching{n}_s{seed}")


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


# -- two-level (hierarchical) graphs ------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class HierarchicalTopology(Topology):
    """Two-level graph from :func:`hierarchical`: ``node_size``
    consecutive agents form one node (exact averaging inside the block, no
    wire) and the nodes talk over the ``inter`` graph.  The inherited
    fields describe the composite matrix ``kron(inter.W, J_s / s)``, so it
    serves any consumer as a plain n-agent Topology; ``gossip="hier"``
    engines read ``node_size`` and ``inter`` to run the two levels
    apart."""
    node_size: int = 1
    inter: Optional[Topology] = None


def hierarchical(inter_topo, node_size: int) -> HierarchicalTopology:
    """Two-level topology: uniform averaging inside each block of
    ``node_size`` consecutive agents, ``inter_topo`` between the blocks.

    ``W = kron(W_inter, J_s / s)``: its eigenvalues are those of
    ``W_inter`` plus 0, so Assumption 1 holds whenever it holds for
    ``W_inter``.  ``node_size=1`` reproduces ``inter_topo``'s W and table
    exactly.  The inter graph must be static (a Topology or a raw matrix),
    not a TopologyBank or a scheduled Topology."""
    if isinstance(inter_topo, TopologyBank):
        raise ValueError(
            "hierarchical() needs a static inter graph, not a TopologyBank "
            "(time-varying inter-node gossip is not supported)")
    inter = as_topology(inter_topo, name="inter")
    if inter.schedule is not None:
        raise ValueError(
            "hierarchical() needs a static inter graph, not a scheduled "
            "Topology: drop the schedule (topo(k)) before nesting")
    s = int(node_size)
    if s < 1:
        raise ValueError(f"node_size must be >= 1, got {s}")
    W = np.kron(inter.W, np.full((s, s), 1.0 / s))
    neighbors, weights = _table_from_w(W)
    return HierarchicalTopology(
        name=f"hier({inter.name}x{s})", W=W, neighbors=neighbors,
        weights=weights, comm_interval=inter.comm_interval,
        node_size=s, inter=inter)


def _near_square(n: int) -> Tuple[int, int]:
    """rows x cols = n with rows the largest divisor <= sqrt(n)."""
    r = int(np.sqrt(n))
    while n % r:
        r -= 1
    return r, n // r


TOPOLOGIES = {
    "ring": ring,
    "chain": chain,
    "full": fully_connected,
    "star": star,
    "torus": lambda n: torus_2d(*_near_square(n)),
    "erdos_renyi": erdos_renyi,
    "exp-onepeer": exponential_onepeer,        # -> TopologyBank, period log2 n
    "random-matching": random_matching,        # -> TopologyBank, period 8
}


def make_mixing(name: str, n: int):
    """Topology or TopologyBank by family name (time-varying families
    return banks)."""
    if name not in TOPOLOGIES:
        raise KeyError(f"unknown topology {name!r}; options: "
                       f"{sorted(TOPOLOGIES)}")
    return TOPOLOGIES[name](n)


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
