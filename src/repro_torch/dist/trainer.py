"""Decentralized trainer: the engine family over stacked model pytrees, with
codes on the wire, all agents on one device (the port of
``src/repro/dist/trainer.py``).

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

One device, A agents.  The reference shards the leading agent axis A of
every leaf over a device mesh, one agent per device, and ships payloads
with one ``ppermute`` per ``Topology.permute_rounds()`` entry.  Here the
agent axis is an ordinary tensor axis on one device, and the exchange is
the engines' sparse neighbor gather (core/gossip.EncodedNeighborGossip)
of the decoded payload along that axis: the same step as the reference's
mesh with one agent per device, up to summation order.  So where the
reference's functions take ``mesh, prof`` the port's take ``n_agents`` and
``device`` ("cuda" when None).  With one agent per
agent slice and no model axis, ``seq_parallel`` is a no-op in the reference
too; tensor parallelism and the multi-card trainer on torch.distributed
come in a later slice (ROADMAP.md).

Per leaf and per step: message -> [hier: intra-node mean] -> the draws of
``leaf_draws`` -> ``encode_blocks`` (K4 on the paper's p=inf quantizer) ->
the receiver's decode (K2), once per agent -> the neighbor gather and the
mix -> ``apply_stage`` (K3 for LEAD) -> [hier: projection].  Decoding each
agent's payload once and gathering the decoded rows gives the same numbers
as gathering the payload and decoding at each receiver (the decode is
elementwise), with one K2 launch per leaf and wire instead of one per
round.  The reference trainer computes Y - H in ``message`` and encodes
with ``encode_blocks``; it never calls the fused ``encode_stage``, so K1
does not run on this path.  The leaves go through the pipeline one at a
time, so only one leaf's message, draws and payload are alive at once
(the reference builds every leaf's message first; the numbers are the
same).

Graph forms, all decided on the host from the step counter ``step`` (a host
int equal to ``state.step``, which drivers pass; without it the step reads
``state.step`` off the device once):

* a ``TopologyBank`` mixes with the round graph of ``step % P``;
* ``Topology.with_interval(tau)`` runs the comm stage only at ``step % tau
  == 0``; the other steps run the engine's ``local_stage``, zero bits;
* a ``hierarchical(inter, node_size)`` graph: node blocks are consecutive
  agents; the message is averaged exactly over its node before encode, the
  lanes exchange over ``kron(W_inter, I_s)``, the new state is projected
  back to node-constant, and the bits are the node's over node_size;
* an active ``FaultModel`` (policy "renormalize", detected corruption):
  each link's survival is hashed on the device from (step, source,
  receiver) over the step graph's neighbor table (``table_mask``); a
  dropped link's weight moves to the receiver's own decode, which is the
  reference's substitution of the own decode at the round's weight.

The dither: each leaf's and wire's random input comes from
``leaf_draws``, the counter hash of core/compression.py seeded from (run
seed, step, leaf, wire).  The reference draws threefry keys (one per leaf,
``fold_in`` per wire), which torch cannot reproduce; the parity tests
replace ``leaf_draws`` with the reference's draws.

``wire_pack=True`` ships the quantizer's codes as uint32 words
(kernels/ops.pack_codes), unpacked at the receiver; ``microbatches``
accumulates the gradient over batch chunks; ``compute_dtype`` and
``state_dtype`` select the forward's and the stored state's precision.
Metrics: grad_norm, bits_per_agent (the payload bits summed over leaves
and wires) and, under faults, dropped_links - 0-d tensors on the device,
read by nobody inside the step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core import topology
from repro_torch.core.compression import (QuantizePNorm, RandK, TopK,
                                          fast_uniform, sub_seed, wire_seed)
from repro_torch.core.engines import ENGINES, engine_for, is_exact
from repro_torch.core.engines.base import _LAYOUT_FIELDS
from repro_torch.core.gossip import EncodedNeighborGossip
from repro_torch.core.lead import LEADHyper, _at
from repro_torch.core.stage_timer import mark
from repro_torch.device import DeviceLike, resolve_device
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
    seq_parallel: bool = False           # a no-op with no model axis
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


def init_train_state(cfg, n_agents: int, dc: DistConfig,
                     generator: torch.Generator = None,
                     device: DeviceLike = None) -> TrainState:
    """Consensus start on `device`: every agent holds the same replica
    (init_params from `generator`), so W x = x exactly, and the engine's
    consensus_init spec makes each extra state field a copy of the params
    or zeros - no init communication or gradient."""
    dev = resolve_device(device)
    p0 = tfm.init_params(cfg, generator, dev)
    sd = getattr(torch, dc.state_dtype)

    def stack(l):
        l = l.to(sd) if l.is_floating_point() else l
        return l[None].expand((n_agents,) + tuple(l.shape)).contiguous()

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
               n: int, dim: int, device) -> Dict[str, torch.Tensor]:
    """The random input of ``comp.encode_blocks`` for leaf `leaf` (flatten
    order) at `step`, wire `wire` (None for a single-wire engine), for a
    message of n agents x dim logical elements: U[0, 1) of shape (n, dim)
    for the quantizers and RandK, the sample indices of approximate TopK,
    nothing for exact TopK.  Drawn by fast_uniform from the host seed
    ``sub_seed(sub_seed(seed, step), leaf)`` (``wire_seed`` of it per wire),
    on `device`: the trainer's one source of randomness, which the parity
    tests replace with the reference's draws."""
    s = sub_seed(sub_seed(seed, step), leaf)
    if wire is not None:
        s = wire_seed(s, wire)
    if isinstance(comp, TopK):
        if not comp.approx_threshold:
            return {}
        u = fast_uniform((n, comp.sample_size(dim)), s, device)
        return {"idx": TopK.indices_from_uniform(u, dim)}
    if isinstance(comp, (QuantizePNorm, RandK)):
        return {"u": fast_uniform((n, dim), s, device)}
    return {}


# -- the exchange ----------------------------------------------------------------

def _node_mean(x: torch.Tensor, node_size: int) -> torch.Tensor:
    """Exact mean over each block of node_size consecutive agents,
    broadcast back to every agent of the block."""
    A = x.shape[0]
    xn = x.reshape((A // node_size, node_size) + tuple(x.shape[1:]))
    return xn.mean(dim=1, keepdim=True).expand_as(xn).reshape(x.shape)


# -- train step ------------------------------------------------------------------

def make_train_step(cfg, n_agents: int, dc: DistConfig,
                    device: DeviceLike = None):
    """Returns step(state, batch, seed, step=None) -> (state, metrics).

    batch: {tokens, labels[, memory]} with leading (A, B_local, ...) dims
    on the device (memory: the vlm's or audio model's (A, B_local, M, d)
    stub embeddings; every key follows its agent and microbatch); seed:
    the run's dither seed (a host int); step: the host step counter (==
    state.step; read off the device when None).  metrics:
    grad_norm and, for decentralized algorithms, bits_per_agent (the
    payload bits this step put on the wire, summed over leaves and wires;
    leader-lane bits on hierarchical graphs, 0.0 on an interval's skipped
    steps); faulted runs add dropped_links, the directed gossip edges that
    did not deliver this step."""
    tfm.check_supported(cfg)
    dev = resolve_device(device)
    A = int(n_agents)
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
    if hier:
        # lanes: every inter edge (b -> c) carries node_size parallel
        # exchanges (b s + i -> c s + i); on the node-constant messages the
        # intra mean makes, lane-wise mixing equals kron(W_inter, J_s / s)
        lane_W = np.kron(topo.inter.W, np.eye(node_size))
        topo_mix = topology.from_matrix(lane_W, name=f"{topo.name}|lanes",
                                        validate=False)
    else:
        topo_mix = topo
    # the engines' sparse neighbor gather over the graph's padded table (a
    # bank's stacked tables, one round per step), copied to the device once
    gossip = EncodedNeighborGossip.from_topology(topo_mix, dev)
    agent_ids = torch.arange(A, device=dev)
    n_wires = 1 if eng is None else eng.n_wires

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
            for a in range(A):
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

    def exchange(payload, decode, nbr, mask):
        """(q, W q) of one wire: every agent's payload decoded once (the
        packed uint32 words when wire_pack), then the step's graph `nbr`
        mixes the decoded rows; under a link mask a dropped link's weight
        moves to the receiver's own decode (faults.renormalize_table)."""
        if dc.wire_pack and "code" in payload:
            code = payload["code"]
            words = [pack_codes(code[a], comp.bits) for a in range(A)]
            code = torch.stack([unpack_codes(w, code[a].numel(), comp.bits)
                                for a, w in enumerate(words)])
            payload = {"code": code.reshape(payload["code"].shape),
                       "scale": payload["scale"]}
        q = decode(payload)
        mark("decode")
        wq = nbr.mix(q) if mask is None else nbr.mix_masked(q, mask)
        mark("mix")
        return q, wq

    def comm_leaf(i, s_leaf, gb, d_leaf, hy, seed, k_host, nbr, mask):
        """One leaf's message, encode, exchange and apply: (new, bits)."""
        msg, ctx = eng.message(s_leaf, gb, hy)
        wires = msg if n_wires > 1 else (msg,)
        if len(wires) != n_wires:
            raise ValueError(f"{type(eng).__name__}.message must return one "
                             f"buffer per wire of {eng.wire_fields}")
        mark("message")
        if hier:
            wires = tuple(_node_mean(w, node_size) for w in wires)
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
                                   j if n_wires > 1 else None, A, d_leaf,
                                   dev)
                mark("dither")
                payload, b = comp.encode_blocks(m, d_leaf, **draws)
                del draws, m
                mark("encode")
                decode = comp.decode_blocks
            else:
                payload = {"values": m}
                b = torch.full((), float(d_leaf * 32), dtype=torch.float32,
                               device=dev)
                decode = _identity_decode
            q, wq = exchange(payload, decode, nbr, mask)
            del payload
            qs.append(q)
            wqs.append(wq)
            bits = bits + b
        if n_wires == 1:
            q, wq = qs[0], wqs[0]
        else:
            q, wq = tuple(qs), tuple(wqs)
        new = eng.apply_stage(s_leaf, gb, q, wq, hy, ctx, k_host)
        return new, bits

    def step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int,
             step: int = None):
        k_host = int(state.step) if step is None else int(step)
        g = grads(state.params, batch)
        mark("gradient")
        direction, opt_state = dc.optimizer.update(g, state.opt,
                                                   state.params)
        gnorm = torch.sqrt(sum(torch.sum(l.to(torch.float32) ** 2)
                               for l in tree_leaves(direction)))
        metrics = {"grad_norm": gnorm}
        mark("optimizer")

        if eng is None:                  # centralized allreduce reference
            eta = _at(_hyper_dict(dc).get("eta", _DEFAULT_ETA), state.step)
            x_new = tree_map(
                lambda xl, gl: xl - eta * gl.mean(0, keepdim=True),
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
        nbr = gossip.for_round(k_host)
        mask = None
        bits_total = torch.zeros((), dtype=torch.float32, device=dev)
        dropped = torch.zeros((), dtype=torch.float32, device=dev)
        if comm and fm is not None:
            # the step's graph only: its links, hashed on the device; the
            # table's pads (self index, weight 0) are no edge
            mask = fm.table_mask(k_host, nbr.neighbors)
            edge = nbr.neighbors != agent_ids[:, None]
            dropped = torch.sum(edge & ~mask).to(torch.float32)
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
                                     nbr, mask)
                bits_total = bits_total + bits
            else:
                ns = eng.local_stage(s_leaf, gb, hy)[0]
                mark("local")
            nx = _leaf_unblocks(ns.x, lx)
            na = {f: _leaf_unblocks(getattr(ns, f), lx) for f in leaves_algo}
            if comm and hier:
                # the full state back to node-constant: each node is one
                # logical agent
                nx = _node_mean(nx, node_size)
                na = {f: _node_mean(v, node_size) for f, v in na.items()}
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


def _identity_decode(payload):
    return payload["values"]
