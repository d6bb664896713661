"""Mesh-axis roles and the agents' layout over ranks (the port of
``src/repro/dist/sharding.py``).

The decentralized layout has two roles, as in the reference:

  * *agent* axes - the decentralized graph.  Default profile: every mesh
    axis but ``model`` (("data",) on one pod, ("pod", "data") across pods);
    the "xxl" profile rings agents over "pod" only.
  * the *tp* axis ("model") - tensor or sequence parallelism inside one
    agent.  The reference keeps the weights replicated over it and shards
    the batch over the agent axes only, so every rank along it computes
    the same agent: a replica.

Where the reference places each stacked leaf's agent axis on the agent
mesh axes (a PartitionSpec prefix rule), the port gives each agent rank -
a coordinate on the agent axes - a contiguous block of n_agents / R agents
(R = the agent axes' product), ``AgentLayout``: the rows of every stacked
train-state leaf and of the ``(A, B, S, ...)`` batch that the rank holds,
and the collectives that cross its agent group (the ranks of its model
index).  One agent per rank is the reference's layout; one process holding
all agents (no mesh) is the single-device trainer's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import host_array
from repro_torch.launch.mesh import agent_group
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class ShardingProfile:
    agent_axes: Tuple[str, ...]          # mesh axes forming the agent graph
    tp_axis: Optional[str]               # tensor-parallel axis (or None)


def make_profile(cfg, axis_names: Sequence[str]) -> ShardingProfile:
    names = tuple(axis_names)
    tp = "model" if "model" in names else None
    if getattr(cfg, "sharding_profile", "default") == "xxl" and "pod" in names:
        agents = ("pod",)
    else:
        agents = tuple(a for a in names if a != tp) or names[:1]
    return ShardingProfile(agent_axes=agents, tp_axis=tp)


# the mesh the rules resolve against; set once per launch or test (as the
# reference's launch drivers do)
_MESH = None


def set_mesh_for_rules(mesh) -> None:
    global _MESH
    _MESH = mesh


def mesh_for_rules():
    if _MESH is None:
        raise RuntimeError("call set_mesh_for_rules(mesh) first")
    return _MESH


def agent_ranks(mesh, prof: ShardingProfile) -> int:
    """R, the product of the agent axes: the distinct agent blocks."""
    n = 1
    for a in prof.agent_axes:
        n *= mesh.dims[a]
    return n


def agent_index(mesh, prof: ShardingProfile, rank: Optional[int] = None) -> int:
    """The rank's agent block, row-major over the agent axes (the
    reference's ``_agent_index``, src/repro/dist/trainer.py:505-511)."""
    c = mesh.coords(rank)
    idx = 0
    for a in prof.agent_axes:
        idx = idx * mesh.dims[a] + c[a]
    return idx


@dataclasses.dataclass(frozen=True, eq=False)
class AgentLayout:
    """Which of the run's n_agents this process holds: agents [first,
    first + count), on a mesh (None: one process, every agent).

    ``group`` is the agent group - the ranks of this rank's replica index,
    one per agent block, in agent order (``peers[b]`` the global rank of
    block b) - over which the payloads travel and the agent means are
    all-reduced."""
    n_agents: int
    first: int = 0
    count: Optional[int] = None
    mesh: Any = None
    group: Any = None
    peers: Tuple[int, ...] = (0,)

    @property
    def local(self) -> int:
        return self.n_agents if self.count is None else self.count

    @property
    def distributed(self) -> bool:
        return self.mesh is not None

    @property
    def stop(self) -> int:
        return self.first + self.local

    def owner(self, agent: int) -> int:
        """The global rank (in this rank's agent group) holding `agent`."""
        return self.peers[int(agent) // self.local]

    def holds(self, agent: int) -> bool:
        return self.first <= int(agent) < self.stop

    def rows(self, tree):
        """The rank's rows of every stacked leaf (leading axis n_agents),
        copied (they keep no whole leaf alive); 0-d leaves (the step
        counter, Adam's t) pass as they are."""
        if not self.distributed:
            return tree
        return tree_map(lambda l: l[self.first:self.stop].clone()
                        if l.ndim else l, tree)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` over the agent group, in place (a no-op without a
        mesh)."""
        if self.distributed:
            dist.all_reduce(t, group=self.group)
        return t

    def gather(self, tree):
        """Every agent's rows of every stacked leaf, gathered to global
        rank 0 (the first block of replica index 0) on the host: the whole
        tree there as numpy arrays (a bf16 leaf as f32, as checkpoints
        store it; 0-d leaves as they are), None on every other rank;
        replicas of other model indices take no part.  Without a mesh,
        `tree` itself.

        One leaf and one peer at a time: rank 0 copies each block of rows
        into the leaf's host array as it arrives, so at most one peer's
        rows of one leaf are on its device beyond the rank's own state."""
        if not self.distributed:
            return tree
        leaves, treedef = tree_flatten(tree)
        root = self.peers[0]
        if root != 0:                    # another replica index: not written
            return None
        if self.mesh.rank != root:
            for l in leaves:
                if l.ndim:
                    dist.send(l.contiguous(), dst=root, group=self.group)
            return None
        out = []
        for l in leaves:
            if l.ndim == 0:
                out.append(l)
                continue
            own = host_array(l)
            whole = np.empty((self.n_agents,) + own.shape[1:], own.dtype)
            whole[:self.local] = own
            buf = (torch.empty_like(l, memory_format=torch.contiguous_format)
                   if len(self.peers) > 1 else None)
            for b, peer in enumerate(self.peers[1:], start=1):
                dist.recv(buf, src=peer, group=self.group)
                whole[b * self.local:(b + 1) * self.local] = host_array(buf)
            out.append(whole)
        return tree_unflatten(treedef, out)


def agent_layout(mesh, prof: ShardingProfile, n_agents: int) -> AgentLayout:
    """This rank's AgentLayout on `mesh` (a launch/mesh.RankMesh), creating
    the agent groups collectively (every rank must call it).  The agent
    blocks must divide n_agents."""

    R = agent_ranks(mesh, prof)
    if n_agents % R:
        raise ValueError(f"{n_agents} agents do not split over {R} agent "
                         f"ranks (mesh {mesh.dims}, agent axes "
                         f"{prof.agent_axes})")
    L = n_agents // R
    return AgentLayout(n_agents=n_agents,
                       first=agent_index(mesh, prof) * L, count=L,
                       mesh=mesh, group=agent_group(mesh, prof.agent_axes),
                       peers=mesh.ranks_along(prof.agent_axes))


def train_batch_rows(layout: AgentLayout, batch):
    """The rank's slice of an (A, B, S[, ...]) batch: its agents' rows, every
    key alike (the counterpart of the reference's ``train_batch_spec``,
    agents sharded, the rest replicated)."""
    if not layout.distributed:
        return batch
    return {k: v[layout.first:layout.stop] for k, v in batch.items()}


@dataclasses.dataclass(frozen=True)
class BatchRows:
    """A rank's placement of a ``(B, ...)`` serving tensor: rows [start,
    stop) of dim 0 (the batch split over "data"), or, with start and stop
    None, the whole tensor (replicated).  The port's counterpart of the
    reference's ``P("data", None, ...)`` and ``P(None, ...)``."""
    start: Optional[int] = None
    stop: Optional[int] = None

    @property
    def split(self) -> bool:
        return self.start is not None

    def take(self, t):
        """The rank's part of the whole tensor `t`: its rows copied (they
        keep no whole tensor alive), or `t` itself when replicated."""
        return t[self.start:self.stop].clone() if self.split else t


def serve_batch_spec(mesh, ndim: int, batch: int) -> BatchRows:
    """This rank's placement of a (B, ...) serving tensor on `mesh` (a
    launch/mesh.RankMesh): its rows over "data" when "data" divides B and
    ndim >= 1, else replicated.  Ranks that differ only along "pod" or
    "model" hold the same rows, replicas as under ``P("data", ...)`` on a
    (pod, data, model) mesh."""
    data = mesh.dims.get("data")
    if ndim >= 1 and data and batch % data == 0:
        n = batch // data
        i = mesh.coords()["data"]
        return BatchRows(i * n, (i + 1) * n)
    return BatchRows()
