"""Baseline decentralized algorithms the paper compares against (§2, §5).

The port's copy of the tree algorithms of ``src/repro/core/baselines.py``,
in the simulator representation: the iterate X is one (n, d) tensor (n
agents, d coordinates), the mixing is a DenseGossip, and gradients arrive
as an (n, d) tensor evaluated at the current X:

  * DGD / D-PSGD           [Nedic & Ozdaglar 2009; Lian et al. 2017]
  * NIDS                   [Li, Shi, Yan 2019] - two-step form, eqs. (4)-(5)
  * EXTRA                  [Shi et al. 2015]
  * D2                     [Tang et al. 2018b] - eq. (15)
  * CHOCO-SGD              [Koloskova et al. 2019]
  * DeepSqueeze            [Tang et al. 2019a]
  * QDGD                   [Reisizadeh et al. 2019a]
  * DCD-SGD                [Tang et al. 2018a]

Each exposes ``init(x0, g0, seed=None) -> state`` and ``step(state, g,
seed) -> state``; the compressed ones also ``step_with_metrics(state, g,
seed) -> (state, comp_err)``, comp_err the in-step relative error of the
message transmitted (the Trace convention of core/simulator.py).  `seed`
is the step's draw seed: the per-agent compress is
``core/compression.compress_each``, which takes its random input from
``compression.agent_draws`` (the counter hash seeded `seed`).  On the card
that compress is one kernel pass per wire: K4 then K2 for the p=inf
quantizer, K5 for RandK, K6 for TopK.  Every hyper-parameter is a Schedule
(core/lead.py) resolved at ``state.k``, a 0-d int64 tensor.

The flat engines (core/engines/baselines.py) are the twins of these on the
blocked (n, nb, block) layout; ``core.engines.flat_twin(algo, dim)`` builds
one.  The state NamedTuples below are shared with them, field for field
the reference's, so a reference state carries across with
``core/convert.state_from_numpy``.  CEDAS and C-GT are not ported yet
(ROADMAP.md, 'Modules still to port').
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core.compression import compress_each, rel_err
from repro_torch.core.gossip import DenseGossip
from repro_torch.core.lead import Schedule, _at
from repro_torch.core.stage_timer import mark


class SimpleState(NamedTuple):
    """DGD, QDGD."""
    x: torch.Tensor
    k: torch.Tensor


class PrevGradState(NamedTuple):
    """EXTRA, D2."""
    x: torch.Tensor
    x_prev: torch.Tensor
    g_prev: torch.Tensor
    k: torch.Tensor


class HatState(NamedTuple):
    """CHOCO-SGD, DCD-SGD."""
    x: torch.Tensor
    xhat: torch.Tensor       # public (quantized) copies, one per agent
    xhat_w: torch.Tensor     # sum_j w_ij xhat_j, tracked incrementally
    k: torch.Tensor


class ErrorState(NamedTuple):
    """DeepSqueeze."""
    x: torch.Tensor
    e: torch.Tensor          # error-compensation memory
    k: torch.Tensor


class DualState(NamedTuple):
    """NIDS."""
    x: torch.Tensor
    d: torch.Tensor
    k: torch.Tensor


def _k0(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=x.device)


@dataclasses.dataclass(frozen=True)
class DGD:
    """Decentralized gradient descent: X+ = W X - eta g (no compression)."""
    gossip: DenseGossip
    eta: Schedule = 0.1

    def init(self, x0, g0, seed=None):
        return SimpleState(x=x0, k=_k0(x0))

    def step(self, s: SimpleState, g, seed=None):
        x = self.gossip.mix(s.x) - _at(self.eta, s.k) * g
        return SimpleState(x=x, k=s.k + 1)


@dataclasses.dataclass(frozen=True)
class NIDS:
    """NIDS two-step primal-dual form (paper eqs. (4)-(5))."""
    gossip: DenseGossip
    eta: Schedule = 0.1

    def init(self, x0, g0, seed=None):
        k0 = _k0(x0)
        return DualState(x=x0 - _at(self.eta, k0) * g0,
                         d=torch.zeros_like(x0), k=k0)

    def step(self, s: DualState, g, seed=None):
        eta = _at(self.eta, s.k)
        y = s.x - eta * g - eta * s.d
        d = s.d + self.gossip.i_minus_w(y) / (2.0 * eta)
        x = s.x - eta * g - eta * d
        return DualState(x=x, d=d, k=s.k + 1)


@dataclasses.dataclass(frozen=True)
class EXTRA:
    """EXTRA [Shi et al. 2015]:
    X^{k+2} = (I+W) X^{k+1} - Wtilde X^k - eta (g^{k+1} - g^k),
    Wtilde = (I+W)/2."""
    gossip: DenseGossip
    eta: Schedule = 0.1

    def init(self, x0, g0, seed=None):
        k0 = _k0(x0)
        x1 = self.gossip.mix(x0) - _at(self.eta, k0) * g0
        return PrevGradState(x=x1, x_prev=x0, g_prev=g0, k=k0)

    def step(self, s: PrevGradState, g, seed=None):
        Wx = self.gossip.mix(s.x)
        Wtx_prev = 0.5 * (s.x_prev + self.gossip.mix(s.x_prev))
        x = s.x + Wx - Wtx_prev - _at(self.eta, s.k) * (g - s.g_prev)
        return PrevGradState(x=x, x_prev=s.x, g_prev=g, k=s.k + 1)


@dataclasses.dataclass(frozen=True)
class D2:
    """D2 [Tang et al. 2018b], paper eq. (15):
    X^{k+1} = (I+W)/2 (2 X^k - X^{k-1} - eta g^k + eta g^{k-1})."""
    gossip: DenseGossip
    eta: Schedule = 0.1

    def init(self, x0, g0, seed=None):
        k0 = _k0(x0)
        return PrevGradState(x=x0 - _at(self.eta, k0) * g0, x_prev=x0,
                             g_prev=g0, k=k0)

    def step(self, s: PrevGradState, g, seed=None):
        eta = _at(self.eta, s.k)
        inner = 2.0 * s.x - s.x_prev - eta * g + eta * s.g_prev
        x = 0.5 * (inner + self.gossip.mix(inner))
        return PrevGradState(x=x, x_prev=s.x, g_prev=g, k=s.k + 1)


@dataclasses.dataclass(frozen=True)
class CHOCO_SGD:
    """CHOCO-SGD [Koloskova et al. 2019].

    x_half = x - eta g
    q      = Q(x_half - xhat_self)                    (difference compression)
    xhat  += q   (all agents update their public copies with received q)
    x+     = x_half + gamma * (W xhat - xhat_self)    (quantized gossip)
    """
    gossip: DenseGossip
    compressor: Any
    eta: Schedule = 0.1
    gamma: Schedule = 0.8

    def init(self, x0, g0, seed=None):
        xhat = torch.zeros_like(x0)
        return HatState(x=x0, xhat=xhat, xhat_w=self.gossip.mix(xhat),
                        k=_k0(x0))

    def step_with_metrics(self, s: HatState, g, seed: int):
        """(new_state, comp_err): comp_err = ||q - (x_half - xhat)|| /
        ||x_half||, the error of the message this step transmitted."""
        x_half = s.x - _at(self.eta, s.k) * g
        diff = x_half - s.xhat
        mark("message")
        q = compress_each(self.compressor, seed, diff)
        wq = self.gossip.mix(q)
        mark("mix")
        xhat = s.xhat + q
        xhat_w = s.xhat_w + wq
        x = x_half + _at(self.gamma, s.k) * (xhat_w - xhat)
        mark("update")
        err = rel_err(q, diff, x_half)
        mark("comp_err")
        return HatState(x=x, xhat=xhat, xhat_w=xhat_w, k=s.k + 1), err

    def step(self, s: HatState, g, seed: int):
        return self.step_with_metrics(s, g, seed)[0]


@dataclasses.dataclass(frozen=True)
class DeepSqueeze:
    """DeepSqueeze [Tang et al. 2019a]: error-compensated direct compression.

    v   = x - eta g + e          (compensate last step's compression error)
    c   = Q(v);  e+ = v - c      (store new error)
    x+  = c + gamma * (W c - c)  (gossip on the compressed models)
    """
    gossip: DenseGossip
    compressor: Any
    eta: Schedule = 0.1
    gamma: Schedule = 0.2

    def init(self, x0, g0, seed=None):
        return ErrorState(x=x0, e=torch.zeros_like(x0), k=_k0(x0))

    def step_with_metrics(self, s: ErrorState, g, seed: int):
        """(new_state, comp_err): the transmitted message is the
        error-compensated v = x - eta g + e, not the raw iterate:
        comp_err = ||c - v|| / ||v||."""
        v = s.x - _at(self.eta, s.k) * g + s.e
        mark("message")
        c = compress_each(self.compressor, seed, v)
        wc = self.gossip.mix(c)
        mark("mix")
        e = v - c
        x = c + _at(self.gamma, s.k) * (wc - c)
        mark("update")
        err = rel_err(c, v, v)
        mark("comp_err")
        return ErrorState(x=x, e=e, k=s.k + 1), err

    def step(self, s: ErrorState, g, seed: int):
        return self.step_with_metrics(s, g, seed)[0]


@dataclasses.dataclass(frozen=True)
class QDGD:
    """QDGD [Reisizadeh et al. 2019a]: direct quantized model exchange.

    x+ = x + gamma * (W Q(x) - Q_self(x)) - eta g
    (each agent transmits Q(x_i); receives neighbors' quantized models).
    """
    gossip: DenseGossip
    compressor: Any
    eta: Schedule = 0.1
    gamma: Schedule = 0.2

    def init(self, x0, g0, seed=None):
        return SimpleState(x=x0, k=_k0(x0))

    def step_with_metrics(self, s: SimpleState, g, seed: int):
        """(new_state, comp_err): comp_err = ||q - x|| / ||x|| for the
        directly transmitted quantized model."""
        mark("message")
        q = compress_each(self.compressor, seed, s.x)
        wq = self.gossip.mix(q)
        mark("mix")
        x = (s.x + _at(self.gamma, s.k) * (wq - q)
             - _at(self.eta, s.k) * g)
        mark("update")
        err = rel_err(q, s.x, s.x)
        mark("comp_err")
        return SimpleState(x=x, k=s.k + 1), err

    def step(self, s: SimpleState, g, seed: int):
        return self.step_with_metrics(s, g, seed)[0]


@dataclasses.dataclass(frozen=True)
class DCD_SGD:
    """DCD-SGD [Tang et al. 2018a]: difference compression of the update.

    x+    = W xhat_local_view - eta g   with xhat the public copies
    q     = Q(x+ - xhat_self); xhat += q
    (unstable under aggressive compression - reproduced as in the paper.)
    """
    gossip: DenseGossip
    compressor: Any
    eta: Schedule = 0.1

    def init(self, x0, g0, seed=None):
        return HatState(x=x0, xhat=x0, xhat_w=self.gossip.mix(x0),
                        k=_k0(x0))

    def step_with_metrics(self, s: HatState, g, seed: int):
        """(new_state, comp_err): comp_err = ||q - (x+ - xhat)|| / ||x+||
        for the compressed difference of the post-gossip iterate."""
        x = s.xhat_w - _at(self.eta, s.k) * g
        diff = x - s.xhat
        mark("message")
        q = compress_each(self.compressor, seed, diff)
        wq = self.gossip.mix(q)
        mark("mix")
        xhat = s.xhat + q
        xhat_w = s.xhat_w + wq
        mark("update")
        err = rel_err(q, diff, x)
        mark("comp_err")
        return HatState(x=x, xhat=xhat, xhat_w=xhat_w, k=s.k + 1), err

    def step(self, s: HatState, g, seed: int):
        return self.step_with_metrics(s, g, seed)[0]
