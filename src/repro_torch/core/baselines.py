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
  * CEDAS                  [Huang & Pu 2023, arXiv:2301.05872] - compressed
                           exact diffusion
  * C-GT                   [Liao et al., arXiv:2205.12623] - compressed
                           gradient tracking, two wires per step

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
``core/convert.state_from_numpy``.

CEDAS and C-GT hold a first-class ``topology`` (a Topology, a
TopologyBank, a matrix or a periodic schedule, through
``topology.materialize``) and a ``device`` in place of a DenseGossip: on a
bank step k mixes with round ``k % P``, chosen on the device from
``state.k`` (an index_select, no host read).  C-GT's two wires draw from
``compression.wire_seed(seed, j)``, the flat engine's per-wire seeds.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import compression as compression_mod
from repro_torch.core import topology as topology_mod
from repro_torch.core.compression import compress_each, rel_err
from repro_torch.core.gossip import DenseGossip
from repro_torch.core.lead import Schedule, _at
from repro_torch.core.stage_timer import mark
from repro_torch.device import DeviceLike, resolve_device


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


class DiffusionState(NamedTuple):
    """CEDAS."""
    x: torch.Tensor
    psi_prev: torch.Tensor   # previous adapt half-step psi = x - eta g
    h: torch.Tensor          # public (compressed-tracking) copies
    hw: torch.Tensor         # mixed public copies (see CEDAS)
    k: torch.Tensor


class TrackingState(NamedTuple):
    """C-GT: the iterate wire and the gradient-tracker wire, each with its
    own error-feedback reference pair (see CGT).  The tracker is stored
    shifted: ``s`` holds the post-mix tracker of the last step and
    ``g_prev`` the gradient it already incorporates, so the live tracker
    of step k is ``s + g_k - g_prev`` and the stored invariant is
    ``sum_i s_i == sum_i g_prev_i`` (kept exactly by doubly stochastic
    realized mixing)."""
    x: torch.Tensor
    s: torch.Tensor          # gradient tracker (shifted: pre-refresh)
    g_prev: torch.Tensor     # gradient already folded into s
    h_x: torch.Tensor        # iterate wire: public copies
    hw_x: torch.Tensor       # iterate wire: mixed public copies
    h_s: torch.Tensor        # tracker wire: public copies
    hw_s: torch.Tensor       # tracker wire: mixed public copies
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


class _TopologyMixer:
    """What CEDAS and C-GT share: a first-class ``topology`` field,
    materialized (a periodic schedule becomes a bank), its dense W (a
    bank's stacked rounds) copied once to the ``device`` field's device,
    and the mix with step k's graph."""

    def __post_init__(self):
        object.__setattr__(self, "topology",
                           topology_mod.materialize(self.topology))
        object.__setattr__(self, "device", resolve_device(self.device))
        object.__setattr__(self, "_dense", DenseGossip.from_topology(
            self.topology, self.device))

    @property
    def _bank(self) -> bool:
        return isinstance(self.topology, topology_mod.TopologyBank)

    def _mix(self, v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """W_{k mod P} @ v on a bank (the round picked on the device by
        index_select: no host read), W @ v otherwise."""
        W = self._dense.W
        if self._bank:
            r = torch.remainder(k.to(torch.int64), W.shape[0]).reshape(1)
            W = torch.index_select(W, 0, r)[0]
        return DenseGossip(W=W).mix(v)


@dataclasses.dataclass(frozen=True)
class CEDAS(_TopologyMixer):
    """CEDAS [Huang & Pu 2023, arXiv:2301.05872]: compressed exact diffusion.

    psi  = x - eta g                      (adapt)
    phi  = psi + x - psi_prev             (exact-diffusion correction)
    q    = Q(phi - h)                     (difference compression; the wire)
    h+   = h + alpha q
    hw+  = hw + alpha W q                 (static W - incremental, hw == W h)
         = W_k h + alpha W_k q            (TopologyBank - the step's graph)
    x+   = phi + (gamma/2) (hw+ - h+);  psi_prev+ = psi

    With Identity compression and alpha = gamma = 1 this is exact
    diffusion, D2's eq. (15) with Wtilde = (I+W)/2.  On a bank ``hw`` is
    recomputed from the step's graph: the incremental sum would mix past
    q's with other rounds' graphs and lose hw == W h.  Over directed
    rounds (exponential_onepeer) the diffusion momentum phi = 2x - psi_prev
    is unstable past n ~ 16 at every gamma, as in the reference; symmetric
    rounds (random_matching) converge.
    """
    topology: Any
    compressor: Any
    eta: Schedule = 0.1
    gamma: Schedule = 0.5
    alpha: Schedule = 0.5
    device: DeviceLike = None

    def init(self, x0, g0, seed=None):
        k0 = _k0(x0)
        return DiffusionState(x=x0, psi_prev=x0, h=x0, hw=self._mix(x0, k0),
                              k=k0)

    def step_with_metrics(self, s: DiffusionState, g, seed: int):
        """(new_state, comp_err): comp_err = ||q - (phi - h)|| / ||phi||,
        the error of the compressed diffusion message this step."""
        eta, gamma, alpha = (_at(v, s.k)
                             for v in (self.eta, self.gamma, self.alpha))
        psi = s.x - eta * g
        phi = psi + s.x - s.psi_prev
        diff = phi - s.h
        mark("message")
        q = compress_each(self.compressor, seed, diff)
        wq = self._mix(q, s.k)
        mark("mix")
        h = s.h + alpha * q
        if self._bank:
            hw = self._mix(s.h, s.k) + alpha * wq
        else:
            hw = s.hw + alpha * wq
        x = phi + 0.5 * gamma * (hw - h)
        mark("update")
        err = rel_err(q, diff, phi)
        mark("comp_err")
        return DiffusionState(x=x, psi_prev=psi, h=h, hw=hw, k=s.k + 1), err

    def step(self, s: DiffusionState, g, seed: int):
        return self.step_with_metrics(s, g, seed)[0]


@dataclasses.dataclass(frozen=True)
class CGT(_TopologyMixer):
    """C-GT [Liao et al., arXiv:2205.12623]: compressed gradient tracking.

    Two tracked sequences cross the wire every step, the iterate x and the
    gradient tracker y, each through its own CHOCO-style difference
    compression with an error-feedback pair (h, hw).  With y = s + g -
    g_prev the live tracker (see TrackingState):

        q_x  = Q(x - h_x);   q_s = Q(y - h_s)          (the two wires)
        xhat = h_x + q_x;    xhat_w = hw_x + W q_x     (static W)
                             xhat_w = W_k (h_x + q_x)  (TopologyBank)
        shat, shat_w         likewise on the tracker wire
        x+   = x - gamma (xhat - xhat_w) - eta y
        s+   = y - gamma (shat - shat_w);   g_prev+ = g
        h+   = h + alpha q;  hw+ = hw + alpha W q      (each wire;
                             hw+ = W_k (h + alpha q) on a bank)

    ``sum_i s_i == sum_i g_prev_i`` holds at every step whenever the
    realized mixing is column-stochastic.  With Identity compression it is
    exact lazy gradient tracking, x+ = M x - eta y and y+ = M y + g+ - g
    with M = (1-gamma) I + gamma W (DIGing at gamma = 1).  Wire j draws
    from ``compression.wire_seed(seed, j)``, as the flat engine's does.
    """
    topology: Any
    compressor: Any
    eta: Schedule = 0.05
    gamma: Schedule = 0.5
    alpha: Schedule = 0.5
    device: DeviceLike = None

    def init(self, x0, g0, seed=None):
        k0 = _k0(x0)
        z = torch.zeros_like(x0)
        return TrackingState(x=x0, s=z, g_prev=z, h_x=x0,
                             hw_x=self._mix(x0, k0), h_s=z, hw_s=z, k=k0)

    def _compress(self, seed: int, j: int, diff):
        """Wire j's per-agent compress, drawn from wire_seed(seed, j)."""
        return compress_each(self.compressor,
                             compression_mod.wire_seed(seed, j), diff)

    def step_with_metrics(self, s: TrackingState, g, seed: int):
        """(new_state, comp_err): comp_err reports the iterate wire,
        ||q_x - (x - h_x)|| / ||x|| (the tracker wire's error enters the
        trajectory but not the metric)."""
        eta, gamma, alpha = (_at(v, s.k)
                             for v in (self.eta, self.gamma, self.alpha))
        y = s.s + g - s.g_prev                  # live tracker at step k
        diff_x = s.x - s.h_x
        diff_s = y - s.h_s
        mark("message")
        q_x = self._compress(seed, 0, diff_x)
        q_s = self._compress(seed, 1, diff_s)
        wq_x = self._mix(q_x, s.k)
        wq_s = self._mix(q_s, s.k)
        mark("mix")
        xhat = s.h_x + q_x
        shat = s.h_s + q_s
        if self._bank:
            wh_x = self._mix(s.h_x, s.k)
            wh_s = self._mix(s.h_s, s.k)
            xhat_w = wh_x + wq_x
            shat_w = wh_s + wq_s
            hw_x = wh_x + alpha * wq_x
            hw_s = wh_s + alpha * wq_s
        else:
            xhat_w = s.hw_x + wq_x
            shat_w = s.hw_s + wq_s
            hw_x = s.hw_x + alpha * wq_x
            hw_s = s.hw_s + alpha * wq_s
        x = s.x - gamma * (xhat - xhat_w) - eta * y
        s_new = y - gamma * (shat - shat_w)
        new = TrackingState(x=x, s=s_new, g_prev=g,
                            h_x=s.h_x + alpha * q_x, hw_x=hw_x,
                            h_s=s.h_s + alpha * q_s, hw_s=hw_s, k=s.k + 1)
        mark("update")
        err = rel_err(q_x, diff_x, s.x)
        mark("comp_err")
        return new, err

    def step(self, s: TrackingState, g, seed: int):
        return self.step_with_metrics(s, g, seed)[0]
