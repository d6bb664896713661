"""Flat CEDAS engine: compressed exact diffusion on the codes-on-the-wire
substrate [Huang & Pu 2023, arXiv:2301.05872].

The port of ``src/repro/core/engines/cedas.py``.  Per agent:

    psi  = x - eta g                      (adapt)
    phi  = psi + x - psi_prev             (exact-diffusion correction)
    q    = decode(encode(phi - h))        (difference compression; the wire)
    h+   = h + alpha q
    hw+  = hw + alpha W q                 (static W - incremental)
         = W_k h + alpha W_k q            (TopologyBank - the step's graph)
    x+   = phi + (gamma/2) (hw+ - h+);  psi_prev+ = psi

Plain torch around the base's wire: the p=inf quantizer's encode and
decode are K4 and K2, RandK's encode K5, TopK's K6 (engines/base.py).
With Identity compression and alpha = gamma = 1 this is exact diffusion,
D2's eq. (15) recursion with Wtilde = (I+W)/2.  On a bank ``hw`` is
recomputed from the step's round graph, as FlatLEADEngine does for H_w:
the incremental sum would mix past q's with other rounds' graphs and lose
hw == W h.  H is reference state, not wire traffic, so that mix
(``mix_round``) takes no fault mask.

Stability over time-varying graphs needs symmetric rounds
(random_matching banks): over directed rounds such as
exponential_onepeer the diffusion momentum phi = 2x - psi_prev has a
joint spectral radius above 1 at every gamma past n ~ 16 (the reference
measures ~1.04 per step on exponential_onepeer(32), uncompressed).  The
port reproduces that; it does not fix it.  Per-step equality with the
tree CEDAS holds on any bank.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.baselines import DiffusionState
from repro_torch.core.engines.base import FlatEngineBase
from repro_torch.core.engines.baselines import _k0
from repro_torch.core.lead import Schedule
from repro_torch.core.stage_timer import mark


@dataclasses.dataclass(frozen=True)
class FlatCEDASEngine(FlatEngineBase):
    """CEDAS on the flat substrate; mirrors core/baselines.py CEDAS.

    compressor=None ships the raw diffusion message phi - h (d * 32 bits);
    any encode_blocks compressor compresses it.  Hypers are Schedules
    resolved at state.k.
    """
    eta: Schedule = 0.1
    gamma: Schedule = 0.5
    alpha: Schedule = 0.5

    state_cls = DiffusionState
    consensus_init = {"psi_prev": "copy", "h": "copy", "hw": "copy"}

    def init(self, x0, g0, key=None):
        xb = self.blockify(x0)
        return DiffusionState(x=xb, psi_prev=xb, h=xb, hw=self._mix(xb),
                              k=_k0(self.device))

    def message(self, s: DiffusionState, gb, hy):
        psi = s.x - hy["eta"] * gb
        phi = psi + s.x - s.psi_prev
        return phi - s.h, (psi, phi)

    def apply_stage(self, s: DiffusionState, gb, q, wq, hy, ctx, step=None):
        psi, phi = ctx
        h = s.h + hy["alpha"] * q
        if self._bank:
            # wq is W_k q; hw+ = W_k (h + alpha q) with the step's graph
            hw = (self.mix_round(s.h, self._host_step(s, step))
                  + hy["alpha"] * wq)
        else:
            hw = s.hw + hy["alpha"] * wq
        x = phi + 0.5 * hy["gamma"] * (hw - h)
        new = DiffusionState(x=x, psi_prev=psi, h=h, hw=hw, k=s.k + 1)
        mark("update")
        return new

    def comp_err(self, s: DiffusionState, gb, q, hy, ctx):
        _, phi = ctx
        return self.rel_err(q, phi - s.h, phi)
