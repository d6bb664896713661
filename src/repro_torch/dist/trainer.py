"""Decentralized trainer: the engine family over stacked model pytrees, with
codes on the wire, the agents on one device or split over the ranks of a
torch.distributed group (the port of ``src/repro/dist/trainer.py``).

``DistConfig.algorithm`` resolves through the same ``engine_for`` registry
as the simulator (core/engines): LEAD and every paper baseline - CHOCO-SGD,
DeepSqueeze, QDGD, DCD-SGD compressed; DGD, NIDS, EXTRA, D2 exact - and
CEDAS and C-GT.  The trainer holds no per-algorithm algebra of its own:
each step it blocks every stacked train-state leaf into the kernels'
``(A, nb, block)`` layout, calls the engine's ``message`` stage, encodes
the message with the compressor's ``encode_blocks``, exchanges the payload
and calls the engine's ``apply_stage``.  ``allreduce`` is the one special
case: the centralized SGD reference (x -= eta * mean_agents(g)), kept for
A/B comparisons.

Agents over ranks.  The reference shards the leading agent axis A of every
leaf over a device mesh, one agent per device, and ships payloads with one
``ppermute`` per ``Topology.permute_rounds()`` entry.  Here a process
holds a contiguous block of agents as the leading tensor axis of each
stacked leaf: all A of them when the step is built without a mesh (one
device), or A / R on each of the R agent ranks of a ``launch/mesh.RankMesh``
over torch.distributed (``dist/sharding.AgentLayout``; R = A is the
reference's layout).  Either way the exchange follows the reference:
every rank posts one ``batch_isend_irecv`` per ``permute_rounds()`` entry
of the step's graph, carrying the payload of each edge whose ends lie on
two ranks - the int8 codes and f32 scales of ``encode_blocks`` (the
uint32 words of ``pack_codes`` when ``wire_pack``, sent as int32), the raw
rows of an exact algorithm - while an edge inside a block is a row gather.
The receiver decodes (K2: its own payload once, each round's remote rows
once) and mixes in the one-device step's neighbor-table order (see
``_RoundMix``), so a rank's agents come out bit-identical to the same
agents of a one-process run.
Without a mesh no round has a remote edge, so the one-device step is the
same code with no sends.  Ranks along the axes outside the profile's agent
axes (``model``) are replicas: they run the same agents on the same batch
rows and exchange within their own agent group, so they stay
bit-identical (the reference replicates the weights over ``model`` and
shards the batch over the agent axes only).  ``seq_parallel`` on a model
axis above 1 raises (ROADMAP.md).

Per leaf and per step: message -> [hier: intra-node mean] -> the draws of
``leaf_draws`` -> ``encode_blocks`` (K4 on the paper's p=inf quantizer) ->
the exchange and the receiver's decode (K2) -> the mix -> ``apply_stage``
(K3 for LEAD) -> [hier: projection].  The reference trainer computes Y - H
in ``message`` and encodes with ``encode_blocks``; it never calls the
fused ``encode_stage``, so K1 does not run on this path.  The leaves go
through the pipeline one at a time, so only one leaf's message, draws and
payload are alive at once (the reference builds every leaf's message
first; the numbers are the same).

Graph forms, all decided on the host from the step counter ``step`` (a host
int equal to ``state.step``, which drivers pass; without it the step reads
``state.step`` off the device once):

* a ``TopologyBank`` mixes with the round graph of ``step % P``;
* ``Topology.with_interval(tau)`` runs the comm stage only at ``step % tau
  == 0``; the other steps run the engine's ``local_stage``, zero bits;
* a ``hierarchical(inter, node_size)`` graph: node blocks are consecutive
  agents; the message is averaged exactly over its node before encode (an
  ``all_reduce`` over the node group where a node spans ranks), the lanes
  exchange over ``kron(W_inter, I_s)``, the new state is projected back
  to node-constant, and the bits are the node's over node_size;
* an active ``FaultModel`` (policy "renormalize", detected corruption):
  each rank hashes the survival of its receivers' links from (step,
  source, receiver); a receiver substitutes its own decode for an
  undelivered payload at the round's weight, the reference's mass-to-self
  degradation;
* on a bank, the engines' recompute of W_k h (LEAD's hw, CHOCO's and DCD's
  xhat_w, CEDAS's hw) mixes state, not wire traffic: the reference's GSPMD
  moves those f32 rows between devices, and here they take the same
  rounds, clean (``_with_round_mix``).

The dither: each leaf's and wire's random input comes from
``leaf_draws``, the counter hash of core/compression.py seeded from (run
seed, step, leaf, wire); a rank draws only its agents' rows of that
plane.  The reference draws threefry keys (one per leaf, ``fold_in`` per
wire), which torch cannot reproduce; the parity tests replace
``leaf_draws`` with the reference's draws.

``wire_pack=True`` ships the quantizer's codes as uint32 words
(kernels/ops.pack_codes), unpacked at the receiver; ``microbatches``
accumulates the gradient over batch chunks; ``compute_dtype`` and
``state_dtype`` select the forward's and the stored state's precision.
Metrics: grad_norm, bits_per_agent (the payload bits summed over leaves
and wires) and, under faults, dropped_links - 0-d tensors on the device,
read by nobody inside the step; on a mesh each is the whole run's (the
agent group's sums).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import faults as faults_mod
from repro_torch.core import topology
from repro_torch.core.compression import (QuantizePNorm, RandK, TopK,
                                          fast_uniform, sub_seed, wire_seed)
from repro_torch.core.engines import ENGINES, engine_for, is_exact
from repro_torch.core.engines.base import _LAYOUT_FIELDS
from repro_torch.core.lead import LEADHyper, _at
from repro_torch.core.stage_timer import mark
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.sharding import AgentLayout, agent_layout, make_profile
from repro_torch.launch.mesh import node_group as make_node_group
from repro_torch.kernels.ops import pack_codes, unpack_codes
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import SGD
from repro_torch.utils.finite import assert_finite_tree, finite_checks_enabled
from repro_torch.utils.tree import (tree_flatten, tree_leaves, tree_map,
                                    tree_unflatten, tree_zeros_like)

Pytree = Any


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Distributed-run configuration (algorithm + wire + schedule knobs).

    algorithm is any core/engines registry key (lead, choco, deepsqueeze,
    qdgd, dcd, dgd, nids, extra, d2, cedas, cgt + aliases) or "allreduce".
    compressor overrides the wire operator; None picks the paper default -
    the blockwise p=inf quantizer QuantizePNorm(bits, block) for compressed
    algorithms, nothing for exact ones.

    topology selects the graph the agents gossip over: None -> the uniform
    ring; a core/topology builder name ("ring", "torus", "erdos_renyi",
    ..., "exp-onepeer", "random-matching"); a Topology or TopologyBank (n
    must equal the agent count); a list of round graphs (validated into a
    bank); or a callable n_agents -> Topology | TopologyBank.  Periodic
    schedules materialize into banks; a live (periodless) schedule raises.
    A topology.hierarchical(inter, node_size) graph runs two-level gossip,
    and Topology.with_interval(tau) gossips only every tau-th step.

    hyper sets the algorithm hyper-parameters, each a Schedule (float or
    callable of the step counter): None - the engine's paper defaults with
    eta = 0.03; a dict of exactly the hypers the engine declares (unknown
    keys raise); or a LEADHyper for LEAD and allreduce.

    faults attaches a core/faults.FaultModel: each gossip round is masked
    with the model's deterministic link realization keyed on the step (the
    schedule replays identically across restarts), degraded by the
    mass-to-self renormalization.  policy="renormalize" with
    detect_corruption=True only; the stale policy and undetected bit flips
    are simulator modes.

    The reference's ``interpret`` (Pallas interpret mode) has no
    counterpart: the tensor's device picks the kernel or its plain version.
    """
    algorithm: str = "lead"
    bits: int = 2                        # default quantizer bit-width
    block: int = 512                     # quantization block (paper: 512)
    compressor: Any = None               # explicit Compressor override
    topology: Any = None                 # None -> ring | name | Topology |
                                         # callable n_agents -> Topology
    hyper: Any = None                    # None | dict | LEADHyper (see above)
    optimizer: Any = SGD()
    seq_parallel: bool = False           # raises on a model axis above 1
    wire_pack: bool = False              # ship codes as packed uint32 words
    microbatches: int = 1                # grad accumulation over batch chunks
    compute_dtype: str = "float32"
    state_dtype: str = "float32"
    faults: Any = None                   # core/faults.FaultModel

    def __post_init__(self):
        if self.algorithm != "allreduce":
            key = self.algorithm.lower().replace("_", "-")
            if key not in ENGINES:
                raise ValueError(
                    f"unknown algorithm {self.algorithm!r}; registry has "
                    f"{sorted(set(ENGINES))} + 'allreduce'")
        if self.faults is not None:
            if not isinstance(self.faults, faults_mod.FaultModel):
                raise TypeError(f"faults must be a core/faults.FaultModel, "
                                f"got {self.faults!r}")
            if self.faults.is_active:
                if self.algorithm == "allreduce":
                    raise ValueError(
                        "fault injection degrades the decentralized gossip "
                        "stage; the centralized allreduce reference has none")
                if self.faults.policy != "renormalize":
                    raise ValueError(
                        "the trainer supports policy='renormalize' only (the "
                        "stale policy needs a per-leaf payload cache - use "
                        "the simulator for it)")
                if not self.faults.detect_corruption:
                    raise ValueError(
                        "undetected bit-flip corruption is a simulator mode; "
                        "the trainer models detected corruption as "
                        "sender-side link drops")


_DEFAULT_ETA = 0.03                      # the trainer's LM-tuned stepsize


def _hyper_dict(dc: DistConfig) -> Dict[str, Any]:
    """DistConfig.hyper normalized to a plain {name: Schedule} dict."""
    h = dc.hyper
    if h is None:
        return {"eta": _DEFAULT_ETA}
    if isinstance(h, LEADHyper):
        return {f: getattr(h, f) for f in ("eta", "gamma", "alpha")}
    return dict(h)


def topology_of(dc: DistConfig, n_agents: int):
    """Resolve DistConfig.topology for n_agents to a Topology or
    TopologyBank, through core/topology.materialize (a bank or list of
    rounds is validated, a periodic schedule expands into its bank, a live
    schedule raises)."""
    t = dc.topology
    if t is None:
        return topology.ring(n_agents)
    if isinstance(t, str):
        topo = topology.make_mixing(t, n_agents)
    elif isinstance(t, (topology.Topology, topology.TopologyBank)):
        topo = t
    elif callable(t):
        topo = t(n_agents)
    else:
        topo = t
    topo = topology.materialize(topo, name="dist")
    if topo.n != n_agents:
        raise ValueError(
            f"DistConfig.topology has n={topo.n} agents but the run has "
            f"{n_agents}")
    return topo


def _hyper_fields_of(algorithm: str) -> set:
    """The algorithm hypers (Schedule fields) its engine class declares."""
    cls = ENGINES[algorithm.lower().replace("_", "-")]
    return {f.name for f in dataclasses.fields(cls)} - set(_LAYOUT_FIELDS)


def engine_of(dc: DistConfig, n_agents: int, device: DeviceLike = None):
    """Resolve DistConfig through the engine_for registry over the
    config's n_agents topology, on `device` (None for the centralized
    allreduce reference).  Hypers the engine does not declare raise."""
    hyp = _hyper_dict(dc)
    if dc.algorithm == "allreduce":
        extra = set(hyp) - {"eta"}
        if extra and not isinstance(dc.hyper, LEADHyper):
            raise ValueError(
                f"allreduce (centralized SGD reference) only takes 'eta'; "
                f"got {sorted(extra)}")
        return None
    declared = _hyper_fields_of(dc.algorithm)
    extra = set(hyp) - declared
    if extra:
        raise ValueError(
            f"algorithm {dc.algorithm!r} does not declare hyper(s) "
            f"{sorted(extra)} (it takes {sorted(declared)}); pass "
            f"DistConfig(hyper={{...}}) with exactly those fields")
    comp = dc.compressor
    if comp is None and not is_exact(dc.algorithm):
        comp = QuantizePNorm(bits=dc.bits, block=dc.block)
    return engine_for(topology_of(dc, n_agents), comp, dim=dc.block,
                      gossip="neighbor", algorithm=dc.algorithm,
                      faults=dc.faults, device=device, **hyp)


class TrainState(NamedTuple):
    """All leaves stacked (A, ...): one slice per agent.

    params is the engine state's iterate x; algo holds the engine's other
    state fields by name (each a pytree shaped like params) - {} for
    single-state algorithms (DGD, QDGD, allreduce); step a 0-d int64."""
    params: Pytree
    algo: Dict[str, Pytree]
    opt: Any
    step: torch.Tensor


def layout_of(cfg, mesh, n_agents: int) -> AgentLayout:
    """The agents this process holds: every one without a mesh, else its
    block on `mesh` (a launch/mesh.RankMesh; dist/sharding.agent_layout,
    collective on first use)."""
    if mesh is None:
        return AgentLayout(n_agents=int(n_agents))
    if not dist.is_initialized():
        raise RuntimeError("a rank mesh needs torch.distributed's default "
                           "process group: init_process_group first")
    return agent_layout(mesh, make_profile(cfg, mesh.axis_names),
                        int(n_agents))


def init_train_state(cfg, n_agents: int, dc: DistConfig,
                     generator: torch.Generator = None,
                     device: DeviceLike = None, mesh=None) -> TrainState:
    """Consensus start on `device`: every agent holds the same replica
    (init_params from `generator`), so W x = x exactly, and the engine's
    consensus_init spec makes each extra state field a copy of the params
    or zeros - no init communication or gradient.  With a rank `mesh`
    the leaves hold this rank's agents only (every rank draws the same
    replica from the same generator seed)."""
    dev = resolve_device(device)
    lay = layout_of(cfg, mesh, n_agents)
    p0 = tfm.init_params(cfg, generator, dev)
    sd = getattr(torch, dc.state_dtype)

    def stack(l):
        l = l.to(sd) if l.is_floating_point() else l
        return l[None].expand((lay.local,) + tuple(l.shape)).contiguous()

    params = tree_map(stack, p0)
    eng = engine_of(dc, n_agents, dev)
    algo = {} if eng is None else {
        f: (params if kind == "copy" else tree_zeros_like(params))
        for f, kind in eng.consensus_init.items()}
    return TrainState(params=params, algo=algo,
                      opt=dc.optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int64, device=dev))


def agent_losses(cfg, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Each agent's loss on its own batch (tokens, labels and, for vlm and
    audio, memory), (A,), without gradients (the reference CLI's vmapped
    ``loss_fn``)."""
    with torch.no_grad():
        return torch.stack([
            tfm.loss_fn(tree_map(lambda l, a=a: l[a], params), cfg,
                        {k: v[a] for k, v in batch.items()})[0]
            for a in range(batch["tokens"].shape[0])])


# -- leaf layout (the kernels' block layout, per stacked leaf) ------------------

def _leaf_blocks(l: torch.Tensor, block: int):
    """Stacked leaf (A, ...) -> ((A, nb, block) f32, d_leaf), zero-padded
    past d_leaf (a view when there is nothing to pad or cast)."""
    A = l.shape[0]
    flat = l.reshape(A, -1).to(torch.float32)
    d_leaf = flat.shape[1]
    nb = -(-d_leaf // block)
    pad = nb * block - d_leaf
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(A, nb, block), d_leaf


def _leaf_unblocks(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    A = like.shape[0]
    flat = buf.reshape(A, -1)[:, :like[0].numel()]
    return flat.reshape(like.shape).to(like.dtype)


# -- the dither ------------------------------------------------------------------

def leaf_draws(comp, seed: int, step: int, leaf: int, wire: Optional[int],
               n: int, dim: int, device, first: int = 0
               ) -> Dict[str, torch.Tensor]:
    """The random input of ``comp.encode_blocks`` for leaf `leaf` (flatten
    order) at `step`, wire `wire` (None for a single-wire engine), for a
    message of n agents x dim logical elements: U[0, 1) of shape (n, dim)
    for the quantizers and RandK, the sample indices of approximate TopK,
    nothing for exact TopK.  Drawn by fast_uniform from the host seed
    ``sub_seed(sub_seed(seed, step), leaf)`` (``wire_seed`` of it per wire),
    on `device`: the trainer's one source of randomness, which the parity
    tests replace with the reference's draws.  ``first`` is the global
    agent of row 0 (a rank's block): the rows are those of the whole run's
    plane, by the counter hash's offset (a rank on a mesh always passes
    it)."""
    s = sub_seed(sub_seed(seed, step), leaf)
    if wire is not None:
        s = wire_seed(s, wire)
    if isinstance(comp, TopK):
        if not comp.approx_threshold:
            return {}
        k = comp.sample_size(dim)
        u = fast_uniform((n, k), s, device, offset=first * k)
        return {"idx": TopK.indices_from_uniform(u, dim)}
    if isinstance(comp, (QuantizePNorm, RandK)):
        return {"u": fast_uniform((n, dim), s, device, offset=first * dim)}
    return {}


# -- the exchange ----------------------------------------------------------------

def _node_mean(x: torch.Tensor, node_size: int) -> torch.Tensor:
    """Exact mean over each block of node_size consecutive agents,
    broadcast back to every agent of the block."""
    A = x.shape[0]
    xn = x.reshape((A // node_size, node_size) + tuple(x.shape[1:]))
    return xn.mean(dim=1, keepdim=True).expand_as(xn).reshape(x.shape)


class _Round(NamedTuple):
    """One ``permute_rounds()`` entry as this rank takes part in it."""
    recv: tuple               # (pair index, peer rank) of each remote in-edge
    send: tuple               # (pair index, local row, peer rank): remote out


class _RoundMix:
    """The exchange and mix of one round graph on this rank: the reference's
    ``gossip_payloads`` (src/repro/dist/trainer.py:557-640) over the rank's
    block of agents.

    Each ``permute_rounds()`` entry posts one ``batch_isend_irecv`` of the
    wire tensors of its cross-rank edges (an edge inside the block needs
    no message), and the rows a round delivers are decoded once.  The mix
    then sums in the engines' neighbor-table order
    (core/gossip.EncodedNeighborGossip.mix: ``w0 * x`` plus one table
    column at a time; under faults ``mix_masked``'s renormalized weights),
    which is the one-device step's: a rank's rows come out bit-identical
    to the one-process run's, whatever the split.  The reference sums per
    round; the two orders agree to rounding (tests/test_torch_trainer.py's
    bounds)."""

    def __init__(self, graph, neighbors, weights, lay: AgentLayout, device):
        L, f0 = lay.local, lay.first
        nbr = np.asarray(neighbors)[f0:f0 + L]
        self.weights = torch.tensor(np.asarray(weights)[f0:f0 + L],
                                    dtype=torch.float32, device=device)
        self.neighbors = torch.tensor(nbr, dtype=torch.int64, device=device)
        self.dst = torch.arange(f0, f0 + L, device=device)
        self.edge = self.neighbors != self.dst[:, None]
        # the remote in-edges: slot of (src, dst) -> (k, i), row i of the
        # k-th round that delivers to this rank
        self.rounds: List[_Round] = []
        slot = {}
        for pairs, _ in graph.permute_rounds():
            recv, send = [], []
            for pi, (i, j) in enumerate(pairs):
                if lay.holds(j) and not lay.holds(i):
                    slot[(i, j)] = (sum(1 for r in self.rounds if r.recv),
                                    len(recv))
                    recv.append((pi, lay.owner(i)))
                elif lay.holds(i) and not lay.holds(j):
                    send.append((pi, i - f0, lay.owner(j)))
            self.rounds.append(_Round(recv=tuple(recv), send=tuple(send)))
        # per table column: each local receiver's source row in the rank's
        # block (itself where the source is remote) and the remote ones'
        # (rows, flat indices into the delivered rows); `view`: every row
        # delivered by one round, in order (a view of its decode, no copy)
        offsets = np.cumsum([0] + [len(r.recv) for r in self.rounds
                                   if r.recv])
        self.columns = []
        for c in range(nbr.shape[1]):
            local = np.arange(L)
            rows, where = [], []
            for r in range(L):
                src = int(nbr[r, c])
                if lay.holds(src):
                    local[r] = src - f0
                else:
                    rows.append(r)
                    where.append(slot[(src, f0 + r)])
            view = None
            if rows == list(range(L)) and len({k for k, _ in where}) == 1 \
                    and [i for _, i in where] == list(
                        range(where[0][1], where[0][1] + L)):
                view = where[0]
            self.columns.append((
                torch.tensor(local, dtype=torch.int64, device=device),
                torch.tensor(rows, dtype=torch.int64, device=device),
                torch.tensor([offsets[k] + i for k, i in where],
                             dtype=torch.int64, device=device), view))

    def masks(self, fm, k: int):
        """(L, deg_max) survival of the rank's receivers' table links at
        step k (faults.FaultModel.table_mask's rows), and the count of
        real edges that dropped (this rank's receivers)."""
        ok = fm.link_ok(k, self.neighbors, self.dst[:, None])
        return ok, torch.sum(self.edge & ~ok).to(torch.float32)

    def _remote(self, wire, to_payload, decode, lay: AgentLayout):
        """The rows the rounds deliver to this rank, one decoded tensor per
        round that delivers any: one batch_isend_irecv per round with a
        cross-rank edge, the received rows of a round decoded at once."""
        names = sorted(wire)
        out = []
        for rd in self.rounds:
            if not (rd.recv or rd.send):
                continue
            bufs = {k: torch.empty((len(rd.recv),) + tuple(wire[k].shape[1:]),
                                   dtype=wire[k].dtype,
                                   device=wire[k].device) for k in names}
            ops = []
            for n, (pi, peer) in enumerate(rd.recv):
                for t, k in enumerate(names):
                    ops.append(dist.P2POp(dist.irecv, bufs[k][n], peer,
                                          lay.group, pi * len(names) + t))
            for pi, row, peer in rd.send:
                for t, k in enumerate(names):
                    ops.append(dist.P2POp(dist.isend, wire[k][row], peer,
                                          lay.group, pi * len(names) + t))
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            if rd.recv:
                out.append(decode(to_payload(bufs)))
        return out

    def exchange(self, wire, to_payload, decode, lay: AgentLayout,
                 masks=None):
        """(q, W q) of one wire: `wire` the tensors that travel, (L, ...)
        each; to_payload(wire rows) the payload decode takes."""
        own = decode(to_payload(wire))
        mark("decode")
        delivered = self._remote(wire, to_payload, decode, lay)
        remote = None
        shape = (-1,) + (1,) * (own.ndim - 1)
        w = self.weights.to(own.dtype)
        if masks is not None:
            w = faults_mod.renormalize_table(w, masks)
        out = w[:, 0].reshape(shape) * own
        for c, (local, rows, flat, view) in enumerate(self.columns):
            if view is not None:
                col = delivered[view[0]].narrow(0, view[1], own.shape[0])
            else:
                col = own.index_select(0, local)
                if len(rows):
                    if remote is None:
                        remote = torch.cat(delivered)
                    col.index_copy_(0, rows, remote.index_select(0, flat))
            out = out + w[:, 1 + c].reshape(shape) * col
        mark("mix")
        return own, out


def _with_round_mix(eng, mix_round):
    """A shallow copy of `eng` whose ``mix_round(buf, step)`` is
    `mix_round`: the engines' bank recompute of W_k h over the trainer's
    exchange (an instance attribute shadows the method)."""
    out = copy.copy(eng)
    object.__setattr__(out, "mix_round", mix_round)
    return out


def _values(payload):
    return payload["values"]


# -- train step ------------------------------------------------------------------

def make_train_step(cfg, n_agents: int, dc: DistConfig,
                    device: DeviceLike = None, mesh=None):
    """Returns step(state, batch, seed, step=None) -> (state, metrics).

    batch: {tokens, labels[, memory]} with leading (A_local, B_local, ...)
    dims on the device - every agent without a mesh, else this rank's
    (dist/sharding.train_batch_rows) - (memory: the vlm's or audio model's
    (A, B_local, M, d) stub embeddings; every key follows its agent and
    microbatch); seed: the run's dither seed (a host int); step: the host
    step counter (== state.step; read off the device when None).  metrics:
    grad_norm and, for decentralized algorithms, bits_per_agent (the
    payload bits this step put on the wire, summed over leaves and wires;
    leader-lane bits on hierarchical graphs, 0.0 on an interval's skipped
    steps); faulted runs add dropped_links, the directed gossip edges that
    did not deliver this step.

    mesh: a launch/mesh.RankMesh over torch.distributed's default group
    (None: one process, every agent).  Every rank of it must build the
    step and call it with the same step counters."""
    tfm.check_supported(cfg)
    dev = resolve_device(device)
    A = int(n_agents)
    if mesh is not None and dc.seq_parallel:
        tp = make_profile(cfg, mesh.axis_names).tp_axis
        if tp is not None and mesh.dims[tp] > 1:
            raise NotImplementedError(
                "seq_parallel over a model axis above 1 is not ported to "
                "repro_torch yet (see ROADMAP.md, queue 1)")
    lay = layout_of(cfg, mesh, A)
    cdt = getattr(torch, dc.compute_dtype)
    eng = engine_of(dc, A, dev)
    comp = None if eng is None else eng.compressor
    topo = eng.topology if eng is not None else topology_of(dc, A)
    tau = int(getattr(topo, "comm_interval", 1))
    node_size = int(getattr(topo, "node_size", 1))
    hier = isinstance(topo, topology.HierarchicalTopology) and node_size > 1
    if tau > 1 and eng is None:
        raise ValueError(
            "comm_interval > 1 (Topology.with_interval) gates the "
            "decentralized gossip stage; the centralized allreduce "
            "reference has no gossip stage to skip")
    if hier and A % node_size:
        raise ValueError(f"hierarchical node_size={node_size} does not "
                         f"divide the {A} agents")
    fm = (dc.faults if dc.faults is not None and dc.faults.is_active
          else None)
    L = lay.local
    node_group = None
    if hier and L % node_size:
        # a node spans node_size / L ranks: its exact mean is an all_reduce
        if node_size % L:
            raise ValueError(
                f"hierarchical node_size={node_size} and {L} agents per "
                f"rank: a node must hold whole agent blocks or lie in one")
        node_group = make_node_group(
            mesh, make_profile(cfg, mesh.axis_names).agent_axes,
            node_size // L)
    if hier:
        # lanes: every inter edge (b -> c) carries node_size parallel
        # exchanges (b s + i -> c s + i); on the node-constant messages the
        # intra mean makes, lane-wise mixing equals kron(W_inter, J_s / s)
        lane_W = np.kron(topo.inter.W, np.eye(node_size))
        lanes = topology.from_matrix(lane_W, name=f"{topo.name}|lanes",
                                     validate=False)
        graphs = [(lanes, lanes.neighbors, lanes.weights)]
    elif isinstance(topo, topology.TopologyBank):
        # the bank's tables, padded to its widest round
        graphs = [(g, topo.neighbors[r], topo.weights[r])
                  for r, g in enumerate(topo.rounds)]
    else:
        graphs = [(topo, topo.neighbors, topo.weights)]
    # the exchange of each round graph, built on the host once
    mixes = [_RoundMix(g, n, w, lay, dev) for g, n, w in graphs]
    n_wires = 1 if eng is None else eng.n_wires
    draw_kw = {"first": lay.first} if lay.distributed else {}

    def node_mean(x):
        """The exact mean over each node of the rank's rows."""
        if node_group is None:
            return _node_mean(x, node_size)
        part = x.sum(0, keepdim=True)
        dist.all_reduce(part, group=node_group)
        return (part / node_size).expand_as(x).contiguous()

    def loss_of(p, b):
        if cdt != torch.float32:
            p = tree_map(lambda l: l.to(cdt) if l.is_floating_point()
                         else l, p)
        return tfm.loss_fn(p, cfg, b)[0]

    def grads(params, batch):
        """Per-agent gradients of the stacked params: the agents' losses
        summed (they share no parameter, so the sum's gradient is each
        agent's own), one backward per microbatch, accumulated in order
        and averaged as the reference's scan does.  Each agent's loss sees
        only its own tokens (an MoE's capacity is per agent, as under the
        reference's vmap)."""
        leaves, treedef = tree_flatten(params)
        xs = [l.detach().requires_grad_() for l in leaves]
        p = tree_unflatten(treedef, xs)
        mb = dc.microbatches
        acc = None
        for c in range(mb):
            total = 0.0
            for a in range(L):
                pa = tree_map(lambda l: l[a], p)
                ba = {k: v[a] for k, v in batch.items()}
                if mb > 1:
                    n = ba["tokens"].shape[0] // mb
                    ba = {k: v[c * n:(c + 1) * n] for k, v in ba.items()}
                total = total + loss_of(pa, ba)
            g = torch.autograd.grad(total, xs)
            acc = list(g) if acc is None else [x + y for x, y in zip(acc, g)]
        if mb > 1:
            acc = [l / mb for l in acc]
        return tree_unflatten(treedef, [l.to(torch.float32) for l in acc])

    def wire_of(payload):
        """(the tensors that travel, wire rows -> payload) of one wire: the
        payload itself, or the quantizer's codes as uint32 words per agent
        (sent as int32: NCCL has no uint32, and the words only travel)."""
        if not (dc.wire_pack and "code" in payload):
            return payload, lambda w: w
        code = payload["code"]
        n_codes = code[0].numel()
        wire = {"packed": torch.stack([
                    pack_codes(c, comp.bits).view(torch.int32)
                    for c in code]),
                "scale": payload["scale"]}

        def to_payload(w):
            rows = [unpack_codes(p.view(torch.uint32), n_codes, comp.bits)
                    for p in w["packed"]]
            return {"code": torch.stack(rows).reshape(
                        (-1,) + tuple(code.shape[1:])),
                    "scale": w["scale"]}
        return wire, to_payload

    def comm_leaf(i, s_leaf, gb, d_leaf, hy, seed, k_host, rm, masks, e):
        """One leaf's message, encode, exchange and apply: (new, bits)."""
        msg, ctx = e.message(s_leaf, gb, hy)
        wires = msg if n_wires > 1 else (msg,)
        if len(wires) != n_wires:
            raise ValueError(f"{type(e).__name__}.message must return one "
                             f"buffer per wire of {e.wire_fields}")
        mark("message")
        if hier:
            wires = tuple(node_mean(w) for w in wires)
            mark("intra_mean")
        qs, wqs = [], []
        bits = torch.zeros((), dtype=torch.float32, device=dev)
        wires = list(wires)
        for j in range(n_wires):
            # each message and its draws are dropped once encoded: only one
            # leaf's wire buffers are alive at a time
            m, wires[j] = wires[j], None
            if comp is not None:
                draws = leaf_draws(comp, seed, k_host, i,
                                   j if n_wires > 1 else None, L, d_leaf,
                                   dev, **draw_kw)
                mark("dither")
                payload, b = comp.encode_blocks(m, d_leaf, **draws)
                del draws, m
                mark("encode")
                decode = comp.decode_blocks
            else:
                payload = {"values": m}
                b = torch.full((), float(d_leaf * 32), dtype=torch.float32,
                               device=dev)
                decode = _values
            wire, to_payload = wire_of(payload)
            del payload
            q, wq = rm.exchange(wire, to_payload, decode, lay, masks)
            del wire
            qs.append(q)
            wqs.append(wq)
            bits = bits + b
        if n_wires == 1:
            q, wq = qs[0], wqs[0]
        else:
            q, wq = tuple(qs), tuple(wqs)
        new = e.apply_stage(s_leaf, gb, q, wq, hy, ctx, k_host)
        return new, bits

    def step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int,
             step: int = None):
        k_host = int(state.step) if step is None else int(step)
        g = grads(state.params, batch)
        mark("gradient")
        direction, opt_state = dc.optimizer.update(g, state.opt,
                                                   state.params)
        sq = sum(torch.sum(l.to(torch.float32) ** 2)
                 for l in tree_leaves(direction))
        metrics = {"grad_norm": torch.sqrt(lay.all_sum(sq.reshape(1))[0])}
        mark("optimizer")

        if eng is None:                  # centralized allreduce reference
            eta = _at(_hyper_dict(dc).get("eta", _DEFAULT_ETA), state.step)
            x_new = tree_map(
                lambda xl, gl: xl - eta * (
                    lay.all_sum(gl.sum(0, keepdim=True)) / A),
                state.params, direction)
            mark("update")
            return TrainState(params=x_new, algo=state.algo, opt=opt_state,
                              step=state.step + 1), metrics

        hy = eng.hypers_at(state.step)
        leaves_x, treedef = tree_flatten(state.params)
        leaves_g = tree_leaves(direction)
        leaves_algo = {f: tree_leaves(state.algo[f])
                       for f in eng.consensus_init}
        comm = tau == 1 or k_host % tau == 0
        rm = mixes[k_host % len(mixes)]
        e = eng
        if comm and isinstance(topo, topology.TopologyBank):
            # W_k h of the bank recompute: the step's rounds, clean
            e = _with_round_mix(eng, lambda buf, _step: rm.exchange(
                {"values": buf}, lambda w: w, _values, lay)[1])
        masks = None
        bits_total = torch.zeros((), dtype=torch.float32, device=dev)
        dropped = torch.zeros((), dtype=torch.float32, device=dev)
        if comm and fm is not None:
            masks, dropped = rm.masks(fm, k_host)
            dropped = lay.all_sum(dropped.reshape(1))[0]
            mark("fault_masks")

        new_x, new_algo = [], {f: [] for f in leaves_algo}
        for i, (lx, lg) in enumerate(zip(leaves_x, leaves_g)):
            xb, d_leaf = _leaf_blocks(lx, dc.block)
            gb, _ = _leaf_blocks(lg, dc.block)
            fields = {f: _leaf_blocks(leaves_algo[f][i], dc.block)[0]
                      for f in leaves_algo}
            s_leaf = eng.state_cls(x=xb, k=state.step, **fields)
            mark("block")
            if comm:
                ns, bits = comm_leaf(i, s_leaf, gb, d_leaf, hy, seed, k_host,
                                     rm, masks, e)
                bits_total = bits_total + bits
            else:
                ns = eng.local_stage(s_leaf, gb, hy)[0]
                mark("local")
            nx = _leaf_unblocks(ns.x, lx)
            na = {f: _leaf_unblocks(getattr(ns, f), lx) for f in leaves_algo}
            if comm and hier:
                # the full state back to node-constant: each node is one
                # logical agent
                nx = node_mean(nx)
                na = {f: node_mean(v) for f, v in na.items()}
            new_x.append(nx)
            for f, v in na.items():
                new_algo[f].append(v)
            mark("unblock")
        if comm and hier:
            bits_total = bits_total / node_size

        metrics["bits_per_agent"] = bits_total
        if fm is not None:
            metrics["dropped_links"] = dropped
        new = TrainState(
            params=tree_unflatten(treedef, new_x),
            algo={f: tree_unflatten(treedef, ls)
                  for f, ls in new_algo.items()},
            opt=opt_state, step=state.step + 1)
        if finite_checks_enabled():
            assert_finite_tree({"params": new.params, "metrics": metrics},
                               where="dist train step")
        return new, metrics

    return step
