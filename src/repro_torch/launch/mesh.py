"""Rank grids for the trainer on torch.distributed (the port of
``src/repro/launch/mesh.py``).

The reference lays its devices out as a jax mesh with named axes; here
the processes of the default torch.distributed group form the same grid:
``(data, model)`` on one pod, ``(pod, data, model)`` across pods, a
rank's coordinate row-major over the axes (rank = ((p * D) + d) * M + m).
The mesh is a plain description: building one creates no process group,
and ``subgroup`` creates groups only when a caller asks, on every rank in
the same order (torch.distributed's rule for ``new_group``).

Functions only, so importing this module touches no process group:

    single pod:  make_production_mesh()               (data=16, model=16)
    multi-pod:   make_production_mesh(multi_pod=True) (pod=2, data=16, model=16)
    tests:       make_debug_mesh()                    (data=4, model=2)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


@dataclasses.dataclass(frozen=True, eq=False)
class RankMesh:
    """A grid of `shape` over `axis_names`, one process per cell; `rank` is
    this process's rank in the default group.  ``groups`` caches the
    subgroups created so far (key: the partition's rank lists)."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int = 0
    groups: Dict[tuple, object] = dataclasses.field(default_factory=dict,
                                                    repr=False)

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not match its "
                             f"axes {self.axis_names}")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a mesh of "
                             f"{self.size}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def dims(self) -> Dict[str, int]:
        """{axis: size}, the reference's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.shape))

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """{axis: index} of `rank` (this process's by default)."""
        r = self.rank if rank is None else int(rank)
        out = {}
        for a, n in reversed(list(zip(self.axis_names, self.shape))):
            out[a] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a, n in zip(self.axis_names, self.shape):
            r = r * n + int(coords[a])
        return r

    def partition(self, axes: Sequence[str]) -> Tuple[Tuple[int, ...], ...]:
        """Every rank grouped with the ranks that differ from it only along
        `axes`: one tuple per group, each row-major over `axes`, the
        groups in the order of their first rank."""
        seen, out = set(), []
        for r in range(self.size):
            if r in seen:
                continue
            c = self.coords(r)
            members = []
            for idx in _row_major([self.dims[a] for a in axes]):
                members.append(self.rank_of({**c, **dict(zip(axes, idx))}))
            seen.update(members)
            out.append(tuple(members))
        return tuple(out)

    def ranks_along(self, axes: Sequence[str],
                    rank: Optional[int] = None) -> Tuple[int, ...]:
        """The group of `partition(axes)` that holds `rank`."""
        r = self.rank if rank is None else int(rank)
        return next(g for g in self.partition(axes) if r in g)

    def subgroup(self, partition: Sequence[Sequence[int]]):
        """The process group of this rank's block of `partition` (a cover
        of some ranks by disjoint rank lists).  Creates every block's group
        the first time, collectively: all ranks must call this with the
        same partitions in the same order.  A block spanning the whole
        world is the default group; None when this rank is in no block."""
        key = tuple(tuple(int(r) for r in g) for g in partition)
        if key not in self.groups:
            made = {}
            for g in key:
                made[g] = (dist.group.WORLD if len(g) == self.size
                           else dist.new_group(list(g)))
            self.groups[key] = made
        for g, pg in self.groups[key].items():
            if self.rank in g:
                return pg
        return None


def agent_group(mesh: RankMesh, agent_axes: Sequence[str]):
    """This rank's agent group: the ranks of its index on every other axis
    (its model index), one per agent block, row-major over `agent_axes`."""
    return mesh.subgroup(mesh.partition(agent_axes))


def replica_group(mesh: RankMesh, agent_axes: Sequence[str]):
    """This rank's replica group: the ranks that hold the same agents (its
    coordinates on `agent_axes`, every index on the other axes)."""
    axes = [a for a in mesh.axis_names if a not in agent_axes]
    return mesh.subgroup(mesh.partition(axes))


def node_group(mesh: RankMesh, agent_axes: Sequence[str],
               blocks_per_node: int):
    """This rank's node group on a two-level graph whose nodes span
    `blocks_per_node` consecutive agent blocks: its agent group cut into
    runs of that many ranks."""
    k = int(blocks_per_node)
    return mesh.subgroup([g[i:i + k] for g in mesh.partition(agent_axes)
                          for i in range(0, len(g), k)])


def all_gather_bytes(t, group):
    """(world, nbytes) uint8: `t` of every rank of `group` in rank order,
    moved as raw bytes (any dtype, one collective of fixed size, no host
    sync); ``out[r].view(t.dtype).reshape(t.shape)`` is rank r's `t`."""
    buf = t.contiguous().reshape(-1).view(torch.uint8)
    out = buf.new_empty(dist.get_world_size(group) * buf.numel())
    gather = (getattr(dist, "all_gather_single", None)
              or dist.all_gather_into_tensor)
    gather(out, buf, group=group)
    return out.reshape(-1, buf.numel())


class CollectiveSpy:
    """Calls and bytes handed to each collective of ``torch.distributed``
    inside the with block: ``seen`` = {name: [calls, bytes]}, the
    all-gathers under one name.  For tests and measurement scripts."""

    NAMES = {"all_to_all_single": "all_to_all_single",
             "all_reduce": "all_reduce", "all_gather_single": "all_gather",
             "all_gather_into_tensor": "all_gather"}

    def __enter__(self):
        self.seen, self._orig = {}, {}
        for name, key in self.NAMES.items():
            orig = getattr(dist, name, None)
            if orig is None:
                continue
            self._orig[name] = orig

            def call(*a, _orig=orig, _key=key, **kw):
                inp = a[0] if _key == "all_reduce" else a[1]
                seen = self.seen.setdefault(_key, [0, 0])
                seen[0] += 1
                seen[1] += inp.numel() * inp.element_size()
                return _orig(*a, **kw)

            setattr(dist, name, call)
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(dist, name, orig)


def _row_major(sizes):
    if not sizes:
        yield ()
        return
    for i in range(sizes[0]):
        for rest in _row_major(sizes[1:]):
            yield (i,) + rest


def make_mesh(shape: Sequence[int], axes: Optional[Sequence[str]] = None,
              rank: Optional[int] = None) -> RankMesh:
    """A RankMesh of `shape` (axes: the reference's names for its length)
    over the default process group, whose world size must equal the
    product of the shape; without a process group, a one-process mesh."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes) if axes is not None else AXES.get(len(shape))
    if axes is None:
        raise ValueError(f"no default axis names for a {len(shape)}-d mesh")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} "
                         f"processes; the process group has {world}")
    return RankMesh(shape=shape, axis_names=axes, rank=rank)


def make_production_mesh(*, multi_pod: bool = False) -> RankMesh:
    """(data=16, model=16), 256 ranks; (pod=2, data=16, model=16), 512."""
    return make_mesh((2, 16, 16) if multi_pod else (16, 16))


def make_debug_mesh(shape=(4, 2), axes=("data", "model")) -> RankMesh:
    """The reference's small test mesh: 8 ranks, 4 agents x 2 replicas."""
    return make_mesh(shape, axes)
