"""Minimal functional optimizers over the port's pytrees (the port of
``src/repro/optim/optimizers.py``).

Each optimizer is  init(params) -> state,  update(g, state, params) ->
(direction, state).  `direction` is what the decentralized algorithm
consumes as its "gradient" (so plain SGD returns g itself - the
paper-faithful path).  Nothing is updated in place."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.utils.tree import Pytree, tree_leaves, tree_map, \
    tree_zeros_like


@dataclasses.dataclass(frozen=True)
class SGD:
    def init(self, params: Pytree):
        return ()

    def update(self, g: Pytree, state, params: Pytree):
        return g, state


class MomentumState(NamedTuple):
    v: Pytree


@dataclasses.dataclass(frozen=True)
class Momentum:
    beta: float = 0.9

    def init(self, params: Pytree):
        return MomentumState(v=tree_zeros_like(params))

    def update(self, g: Pytree, state: MomentumState, params: Pytree):
        v = tree_map(lambda vl, gl: self.beta * vl + gl, state.v, g)
        return v, MomentumState(v=v)


class AdamState(NamedTuple):
    m: Pytree
    v: Pytree
    t: torch.Tensor             # 0-d int32 step count, on the params' device


def _device_of(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class Adam:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Pytree):
        return AdamState(m=tree_zeros_like(params), v=tree_zeros_like(params),
                         t=torch.zeros((), dtype=torch.int32,
                                       device=_device_of(params)))

    def update(self, g: Pytree, state: AdamState, params: Pytree):
        t = state.t + 1
        m = tree_map(lambda ml, gl: self.b1 * ml + (1 - self.b1) * gl,
                     state.m, g)
        v = tree_map(lambda vl, gl: self.b2 * vl + (1 - self.b2) * gl * gl,
                     state.v, g)
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(torch.full_like(tf, self.b1), tf)
        bc2 = 1 - torch.pow(torch.full_like(tf, self.b2), tf)
        u = tree_map(lambda ml, vl: (ml / bc1) / (torch.sqrt(vl / bc2)
                                                   + self.eps), m, v)
        return u, AdamState(m=m, v=v, t=t)


def make_optimizer(name: str, **kw):
    return {"sgd": SGD, "momentum": Momentum, "adam": Adam}[name](**kw)
