"""Flat engines for the paper's baseline algorithms (Figs. 2-4 sweep).

The port of ``src/repro/core/engines/baselines.py`` for static graphs.
State lives in the kernels' ``(n_agents, nb, block)`` f32 layout; the
compressed algorithms ship only their encoded payload across agents
(engines/base.py: the p=inf quantizer through K4 and K2, RandK through K5,
TopK through K6), and every step returns the actual per-agent payload bits.

Each engine is the base's stage methods - ``message`` (the buffer it
transmits), ``apply_stage`` (the state update given the decoded message q
and its mix wq) and, for the compressed ones, ``comp_err`` - plain
elementwise torch that the base sequences around its wire and gossip
stages.  ``state_cls`` / ``consensus_init`` are ported as data.
``apply_stage`` marks "update" after the new state, for
core/stage_timer.py.

Compressed baselines (encode stage = the compressor's wire):

  * FlatCHOCOEngine        CHOCO-SGD   - difference compression of
                           x_half - xhat; public copies xhat/xhat_w updated
                           from the decoded payload.
  * FlatDeepSqueezeEngine  DeepSqueeze - error-compensated direct
                           compression of v = x - eta g + e.
  * FlatQDGDEngine         QDGD        - direct compression of the iterate.
  * FlatDCDEngine          DCD-SGD     - difference compression of the
                           post-gossip iterate against the public copies.

Exact baselines (no encode stage; the raw buffer is the payload, d * 32
bits on the wire; comp_err exactly zero):

  * FlatDGDEngine, FlatNIDSEngine, FlatEXTRAEngine, FlatD2Engine

On a TopologyBank the hat-state engines (CHOCO, DCD) recompute their mixed
public copies ``xhat_w`` from the step's round graph W_{k mod P}, as
FlatLEADEngine does for H_w: the incremental ``xhat_w += W q`` would
integrate past rounds' graphs and drift off the xhat_w == W xhat
invariant.  On a local step of a communication interval they run plain
local SGD with the hats frozen (``local_stage``); the other engines take
the base's self-delivery step.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.baselines import (DualState, ErrorState, HatState,
                                        PrevGradState, SimpleState)
from repro_torch.core.compression import Identity, rel_err
from repro_torch.core.engines.base import FlatEngineBase
from repro_torch.core.lead import Schedule, _at
from repro_torch.core.stage_timer import mark


class ExtraState(NamedTuple):
    """EXTRA state in block layout; wx_prev caches W x from the previous
    step (the tree path re-mixes x_prev - same value, second transmission)."""
    x: torch.Tensor
    x_prev: torch.Tensor
    wx_prev: torch.Tensor
    g_prev: torch.Tensor
    k: torch.Tensor


def _k0(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)


def _zero_err(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def _exact(new):
    """An exact engine's new state, marking the update's end."""
    mark("update")
    return new


@dataclasses.dataclass(frozen=True)
class FlatCHOCOEngine(FlatEngineBase):
    """CHOCO-SGD [Koloskova et al. 2019] on the flat substrate.

    x_half = x - eta g
    q      = decode(encode(x_half - xhat))     (payload on the wire)
    xhat  += q
    xhat_w += W q                 (static W - incremental)
    xhat_w  = W_k xhat + W_k q    (TopologyBank - the step's graph)
    x+     = x_half + gamma * (xhat_w - xhat)
    """
    eta: Schedule = 0.1
    gamma: Schedule = 0.8

    state_cls = HatState
    consensus_init = {"xhat": "zeros", "xhat_w": "zeros"}

    def init(self, x0, g0, key=None):
        xb = self.blockify(x0)
        z = torch.zeros_like(xb)
        return HatState(x=xb, xhat=z, xhat_w=z, k=_k0(self.device))

    def message(self, s: HatState, gb, hy):
        x_half = s.x - hy["eta"] * gb
        return x_half - s.xhat, x_half

    def apply_stage(self, s: HatState, gb, q, wq, hy, ctx, step=None):
        x_half = ctx
        xhat = s.xhat + q
        if self._bank:
            # wq is W_k q; xhat_w+ = W_k (xhat + q) with the step's graph.
            # xhat is reference state, not wire traffic: a clean mix
            xhat_w = self.mix_round(s.xhat, self._host_step(s, step)) + wq
        else:
            xhat_w = s.xhat_w + wq
        x = x_half + hy["gamma"] * (xhat_w - xhat)
        new = HatState(x=x, xhat=xhat, xhat_w=xhat_w, k=s.k + 1)
        mark("update")
        return new

    def comp_err(self, s: HatState, gb, q, hy, ctx):
        return rel_err(q, ctx - s.xhat, ctx)

    def local_stage(self, s: HatState, gb, hy):
        """Interval step: plain local SGD (x+ = x - eta g) with the public
        copies xhat / xhat_w frozen: nothing was transmitted, so the
        receivers' replicas cannot have moved."""
        return (HatState(x=s.x - hy["eta"] * gb, xhat=s.xhat,
                         xhat_w=s.xhat_w, k=s.k + 1), _zero_err(s.x.device))


@dataclasses.dataclass(frozen=True)
class FlatDeepSqueezeEngine(FlatEngineBase):
    """DeepSqueeze [Tang et al. 2019a] on the flat substrate.

    v   = x - eta g + e          (compensate last step's compression error)
    c   = decode(encode(v));  e+ = v - c
    x+  = c + gamma * (W c - c)
    """
    eta: Schedule = 0.1
    gamma: Schedule = 0.2

    state_cls = ErrorState
    consensus_init = {"e": "zeros"}

    def init(self, x0, g0, key=None):
        xb = self.blockify(x0)
        return ErrorState(x=xb, e=torch.zeros_like(xb), k=_k0(self.device))

    def message(self, s: ErrorState, gb, hy):
        v = s.x - hy["eta"] * gb + s.e
        return v, v

    def apply_stage(self, s: ErrorState, gb, c, wc, hy, ctx, step=None):
        v = ctx
        e = v - c
        x = c + hy["gamma"] * (wc - c)
        new = ErrorState(x=x, e=e, k=s.k + 1)
        mark("update")
        return new

    def comp_err(self, s: ErrorState, gb, c, hy, ctx):
        # the transmitted message IS v (error-compensated), not state.x
        return rel_err(c, ctx, ctx)


@dataclasses.dataclass(frozen=True)
class FlatQDGDEngine(FlatEngineBase):
    """QDGD [Reisizadeh et al. 2019a] on the flat substrate.

    q  = decode(encode(x))       (direct quantized model exchange)
    x+ = x + gamma * (W q - q) - eta g
    """
    eta: Schedule = 0.1
    gamma: Schedule = 0.2

    state_cls = SimpleState
    consensus_init = {}

    def init(self, x0, g0, key=None):
        return SimpleState(x=self.blockify(x0), k=_k0(self.device))

    def message(self, s: SimpleState, gb, hy):
        return s.x, None

    def apply_stage(self, s: SimpleState, gb, q, wq, hy, ctx, step=None):
        x = s.x + hy["gamma"] * (wq - q) - hy["eta"] * gb
        new = SimpleState(x=x, k=s.k + 1)
        mark("update")
        return new

    def comp_err(self, s: SimpleState, gb, q, hy, ctx):
        return rel_err(q, s.x, s.x)


@dataclasses.dataclass(frozen=True)
class FlatDCDEngine(FlatEngineBase):
    """DCD-SGD [Tang et al. 2018a] on the flat substrate.

    x+    = xhat_w - eta g
    q     = decode(encode(x+ - xhat));  xhat += q
    xhat_w += W q                 (static W - incremental)
    xhat_w  = W_k xhat + W_k q    (TopologyBank - the step's graph)
    (unstable under aggressive compression - reproduced as in the paper.)
    """
    eta: Schedule = 0.1

    state_cls = HatState
    consensus_init = {"xhat": "copy", "xhat_w": "copy"}

    def init(self, x0, g0, key=None):
        xb = self.blockify(x0)
        return HatState(x=xb, xhat=xb, xhat_w=self._mix(xb),
                        k=_k0(self.device))

    def message(self, s: HatState, gb, hy):
        x = s.xhat_w - hy["eta"] * gb
        return x - s.xhat, x

    def apply_stage(self, s: HatState, gb, q, wq, hy, ctx, step=None):
        x = ctx
        if self._bank:
            xhat_w = self.mix_round(s.xhat, self._host_step(s, step)) + wq
        else:
            xhat_w = s.xhat_w + wq
        new = HatState(x=x, xhat=s.xhat + q, xhat_w=xhat_w, k=s.k + 1)
        mark("update")
        return new

    def comp_err(self, s: HatState, gb, q, hy, ctx):
        return rel_err(q, ctx - s.xhat, ctx)

    def local_stage(self, s: HatState, gb, hy):
        """Interval step: plain local SGD with the hats frozen (as
        FlatCHOCOEngine.local_stage)."""
        return (HatState(x=s.x - hy["eta"] * gb, xhat=s.xhat,
                         xhat_w=s.xhat_w, k=s.k + 1), _zero_err(s.x.device))


# -- exact baselines: no encode stage, the raw buffer is the payload --------

@dataclasses.dataclass(frozen=True)
class _FlatExactEngine(FlatEngineBase):
    """Shared base of the exact (uncompressed) flat engines: the message
    buffer itself is the payload - d * 32 bits per transmission, decode is
    the identity, and comp_err is exactly zero."""
    eta: Schedule = 0.1

    def __post_init__(self):
        super().__post_init__()
        if not (self.compressor is None
                or isinstance(self.compressor, Identity)):
            raise ValueError(
                f"{type(self).__name__} is an exact baseline; it does not "
                f"compress (got {type(self.compressor).__name__})")

    def _eta0(self) -> torch.Tensor:
        return _at(self.eta, _k0(self.device))


@dataclasses.dataclass(frozen=True)
class FlatDGDEngine(_FlatExactEngine):
    """DGD / D-PSGD: X+ = W X - eta g."""

    state_cls = SimpleState
    consensus_init = {}

    def init(self, x0, g0, key=None):
        return SimpleState(x=self.blockify(x0), k=_k0(self.device))

    def message(self, s: SimpleState, gb, hy):
        return s.x, None

    def apply_stage(self, s: SimpleState, gb, q, wx, hy, ctx, step=None):
        return _exact(SimpleState(x=wx - hy["eta"] * gb, k=s.k + 1))


@dataclasses.dataclass(frozen=True)
class FlatNIDSEngine(_FlatExactEngine):
    """NIDS two-step primal-dual form (paper eqs. (4)-(5))."""

    state_cls = DualState
    consensus_init = {"d": "zeros"}

    def init(self, x0, g0, key=None):
        xb, gb = self.blockify(x0), self.blockify(g0)
        return DualState(x=xb - self._eta0() * gb, d=torch.zeros_like(xb),
                         k=_k0(self.device))

    def message(self, s: DualState, gb, hy):
        y = s.x - hy["eta"] * gb - hy["eta"] * s.d
        return y, y

    def apply_stage(self, s: DualState, gb, q, wy, hy, ctx, step=None):
        y = ctx
        d = s.d + (y - wy) / (2.0 * hy["eta"])
        x = s.x - hy["eta"] * gb - hy["eta"] * d
        return _exact(DualState(x=x, d=d, k=s.k + 1))


@dataclasses.dataclass(frozen=True)
class FlatEXTRAEngine(_FlatExactEngine):
    """EXTRA [Shi et al. 2015]:
    X^{k+2} = (I+W) X^{k+1} - Wtilde X^k - eta (g^{k+1} - g^k),
    Wtilde = (I+W)/2.  W x_prev is carried over from the previous step's
    transmission (wx_prev), so each iteration ships exactly one vector."""

    state_cls = ExtraState
    consensus_init = {"x_prev": "copy", "wx_prev": "copy", "g_prev": "zeros"}

    def init(self, x0, g0, key=None):
        xb, gb = self.blockify(x0), self.blockify(g0)
        wx0 = self._mix(xb)
        return ExtraState(x=wx0 - self._eta0() * gb, x_prev=xb, wx_prev=wx0,
                          g_prev=gb, k=_k0(self.device))

    def message(self, s: ExtraState, gb, hy):
        return s.x, None

    def apply_stage(self, s: ExtraState, gb, q, wx, hy, ctx, step=None):
        wtx_prev = 0.5 * (s.x_prev + s.wx_prev)
        x = s.x + wx - wtx_prev - hy["eta"] * (gb - s.g_prev)
        return _exact(ExtraState(x=x, x_prev=s.x, wx_prev=wx, g_prev=gb,
                                 k=s.k + 1))


@dataclasses.dataclass(frozen=True)
class FlatD2Engine(_FlatExactEngine):
    """D2 [Tang et al. 2018b], paper eq. (15):
    X^{k+1} = (I+W)/2 (2 X^k - X^{k-1} - eta g^k + eta g^{k-1})."""

    state_cls = PrevGradState
    consensus_init = {"x_prev": "copy", "g_prev": "zeros"}

    def init(self, x0, g0, key=None):
        xb, gb = self.blockify(x0), self.blockify(g0)
        return PrevGradState(x=xb - self._eta0() * gb, x_prev=xb, g_prev=gb,
                             k=_k0(self.device))

    def message(self, s: PrevGradState, gb, hy):
        inner = 2.0 * s.x - s.x_prev - hy["eta"] * gb + hy["eta"] * s.g_prev
        return inner, inner

    def apply_stage(self, s: PrevGradState, gb, q, winner, hy, ctx, step=None):
        inner = ctx
        x = 0.5 * (inner + winner)
        return _exact(PrevGradState(x=x, x_prev=s.x, g_prev=gb, k=s.k + 1))
