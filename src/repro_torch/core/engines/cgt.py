"""Flat C-GT engine: compressed gradient tracking on the codes-on-the-wire
substrate [Liao et al., arXiv:2205.12623].

The port of ``src/repro/core/engines/cgt.py``, the family's multi-wire
engine: every communication step ships two encoded payloads, the iterate
difference x - h_x and the tracker difference y - h_s, each through its
own CHOCO-style error-feedback pair (h, hw).  The base loops the declared
``wire_fields`` through encode and mix: wire j is encoded under
``compression.wire_seed(seed, j)``, a faulted exchange shares one link
mask between the wires, and the wire bits are the sum of both payloads'.
Each wire's encode and decode are the base's kernels (K4 and K2 on the
p=inf quantizer, K5 on RandK, K6 on TopK), so a step launches each twice.

The gradient tracker is carried shifted (core/baselines.py
TrackingState): state.s is last step's post-mix tracker and state.g_prev
the gradient it already incorporates, so the live tracker at step k is
y = s + g_k - g_prev and the stored invariant reads

    sum_i s_i == sum_i g_prev_i

kept exactly by any column-stochastic realized mixing: doubly stochastic
static graphs, symmetric matching banks, and symmetric link drops under
the renormalize fault policy.  Directed banks (exponential_onepeer) keep
it on the clean path because every round matrix is doubly stochastic.

Identity compression collapses the recursion to exact lazy gradient
tracking, x+ = M x - eta y, y+ = M y + g+ - g with M = (1-gamma) I +
gamma W (DIGing at gamma = 1).  With ``comm_interval`` tau > 1 the
skipped steps run ``local_stage``: the tracker refreshes and drives the
descent x - eta y while both reference pairs freeze (they mirror what the
neighbors hold, and no wire fired).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.baselines import TrackingState
from repro_torch.core.engines.base import FlatEngineBase
from repro_torch.core.engines.baselines import _k0, _zero_err
from repro_torch.core.lead import Schedule
from repro_torch.core.stage_timer import mark


@dataclasses.dataclass(frozen=True)
class FlatCGTEngine(FlatEngineBase):
    """C-GT on the flat substrate; mirrors core/baselines.py CGT (wire j
    draws from wire_seed(seed, j) on both).

    compressor=None ships both raw differences (2 d * 32 bits); any
    encode_blocks compressor compresses both wires.  Hypers are Schedules
    resolved at state.k.
    """
    eta: Schedule = 0.05
    gamma: Schedule = 0.5
    alpha: Schedule = 0.5

    state_cls = TrackingState
    consensus_init = {"s": "zeros", "g_prev": "zeros",
                      "h_x": "copy", "hw_x": "copy",
                      "h_s": "zeros", "hw_s": "zeros"}
    wire_fields = ("x", "s")

    def init(self, x0, g0, key=None):
        xb = self.blockify(x0)
        z = torch.zeros_like(xb)
        return TrackingState(x=xb, s=z, g_prev=z, h_x=xb, hw_x=self._mix(xb),
                             h_s=z, hw_s=z, k=_k0(self.device))

    def message(self, s: TrackingState, gb, hy):
        y = s.s + gb - s.g_prev                 # live tracker at step k
        return (s.x - s.h_x, y - s.h_s), y

    def apply_stage(self, s: TrackingState, gb, q, wq, hy, ctx, step=None):
        y = ctx
        q_x, q_s = q
        wq_x, wq_s = wq
        alpha = hy["alpha"]
        xhat = s.h_x + q_x
        shat = s.h_s + q_s
        if self._bank:
            # wq is W_k q; recompute the mixed public copies with the
            # step's graph, as LEAD and CEDAS do
            k = self._host_step(s, step)
            wh_x = self.mix_round(s.h_x, k)
            wh_s = self.mix_round(s.h_s, k)
            xhat_w = wh_x + wq_x
            shat_w = wh_s + wq_s
            hw_x = wh_x + alpha * wq_x
            hw_s = wh_s + alpha * wq_s
        else:
            xhat_w = s.hw_x + wq_x
            shat_w = s.hw_s + wq_s
            hw_x = s.hw_x + alpha * wq_x
            hw_s = s.hw_s + alpha * wq_s
        x = s.x - hy["gamma"] * (xhat - xhat_w) - hy["eta"] * y
        s_new = y - hy["gamma"] * (shat - shat_w)
        new = TrackingState(x=x, s=s_new, g_prev=gb,
                            h_x=s.h_x + alpha * q_x, hw_x=hw_x,
                            h_s=s.h_s + alpha * q_s, hw_s=hw_s, k=s.k + 1)
        mark("update")
        return new

    def comp_err(self, s: TrackingState, gb, q, hy, ctx):
        # the Trace convention: comp_err reports the iterate wire
        return self.rel_err(q[0], s.x - s.h_x, s.x)

    def local_stage(self, s: TrackingState, gb, hy):
        """Interval (no-communication) step: the tracker refresh and the
        descent run locally; both wires' reference pairs freeze."""
        y = s.s + gb - s.g_prev
        new = TrackingState(x=s.x - hy["eta"] * y, s=y, g_prev=gb,
                            h_x=s.h_x, hw_x=s.hw_x,
                            h_s=s.h_s, hw_s=s.hw_s, k=s.k + 1)
        return new, _zero_err(s.x.device)
