"""Flat-buffer LEAD engine: the fused-kernel hot path of the simulator.

The LEAD state is kept as contiguous ``(n_agents, nb, block)`` f32 tensors
in the kernels' block layout, and the iteration runs as two fused passes
with the wire in between:

  * pre-communication - for the p=inf quantizer, kernels.lead_update.
    lead_diff_encode (K1): one read of (X, G, D, H, dither), one write of
    int8 codes + per-block scales.  Uncompressed (compressor=None), the
    difference Y - H itself is the payload; any other compressor (RandK,
    TopK, a p != inf quantizer) encodes Y - H through the base's generic
    wire (engines/base.py::encode_payload);
  * the wire - the receiver decodes the payload once (kernels.quantize.
    decode, K2) and mixes it densely or over the neighbor table;
  * post-communication - kernels.lead_update.lead_update (K3): fused
    H / H_w / D / X update, one read of (X, G, D, H, H_w, Qh, WQh), one
    write of the four new state buffers.

The fused kernels use the left-to-right subtraction order of the
reference, so from a common state, with the same gradient and the same
dither seed, a step matches ``src/repro/core/engines/lead.py`` up to
knife-edge code flips.

On a TopologyBank the engine mixes with the step's round graph W_{k mod P}
and recomputes H_w from it (``apply_stage``): the incremental H_w would
mix past rounds' graphs.  Stability is a property of the bank: the
reference measures LEAD reaching consensus on one-peer exponential banks
up to n = 16 and on random matchings at n = 32 (gamma <~ 0.3), while on
``exponential_onepeer(32)`` the dual recursion's period monodromy exceeds
radius 1 at every gamma; the port reproduces that, it does not fix it.
On the hier wire LEAD takes the base's encode path (the node mean comes
between the difference and the encode, so K1 does not apply): the
difference in plain torch, its node mean, K4 and K2, then K3.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.compression import rel_err
from repro_torch.core.engines.base import FlatEngineBase, _is_fused_quantizer
from repro_torch.core.lead import LEADHyper, Schedule, _at
from repro_torch.core.stage_timer import mark
from repro_torch.kernels import lead_update as _lu


class FlatLEADState(NamedTuple):
    """LEAD state in the kernels' block layout: all buffers (n, nb, block)
    f32, zero-padded past the logical dimension d; k a 0-d int64 tensor."""
    x: torch.Tensor
    h: torch.Tensor
    hw: torch.Tensor
    d: torch.Tensor
    k: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FlatLEADEngine(FlatEngineBase):
    """init/step over flat buffers; mirrors the reference's semantics.

    compressor=None runs Identity (Qh = Y - H, no encode stage).  The p=inf
    QuantizePNorm takes the fused diff+encode kernel with the counter-hash
    dither; every other compressor the base's generic wire.

    Two driving modes.  LEADSim passes a LEADHyper per call (init/
    step_wire); alternatively the engine's stored hypers (eta/gamma/alpha
    fields) drive the family's protocol - init(x0, g0) /
    step_with_wire(state, g, seed).  Every hyper is a Schedule: a float or
    a callable of the iteration counter k, resolved on the device.
    """
    eta: Schedule = 0.1
    gamma: Schedule = 1.0
    alpha: Schedule = 0.5

    state_cls = FlatLEADState
    consensus_init = {"h": "copy", "hw": "copy", "d": "zeros"}

    @property
    def hyper(self) -> LEADHyper:
        """The stored hypers, for the per-call-hyper entry points."""
        return LEADHyper(eta=self.eta, gamma=self.gamma, alpha=self.alpha)

    # -- algorithm ---------------------------------------------------------
    def init(self, x0: torch.Tensor, g0: torch.Tensor,
             hyper=None) -> FlatLEADState:
        """Paper init: X^1 = X^0 - eta0 g(X^0); H^1 = X^0; H_w^1 = W H^1;
        D^1 = 0.  x0, g0: (n, d).  `hyper` is a LEADHyper; any other value
        selects the stored hypers."""
        if not isinstance(hyper, LEADHyper):
            hyper = self.hyper
        k0 = torch.zeros((), dtype=torch.int64, device=self.device)
        eta0 = _at(hyper.eta, k0)
        xb, gb = self.blockify(x0), self.blockify(g0)
        h1 = xb
        return FlatLEADState(x=xb - eta0 * gb, h=h1, hw=self._mix(h1),
                             d=torch.zeros_like(xb), k=k0)

    # -- stage protocol ------------------------------------------------------
    def message(self, s: FlatLEADState, gb, hy):
        """Pre-communication difference Y - H (Alg. 1 line 4 + COMM line 10)."""
        y = s.x - hy["eta"] * gb - hy["eta"] * s.d
        return y - s.h, None

    def encode_stage(self, s: FlatLEADState, gb, seed: int, hy):
        """For the fused p=inf quantizer the Y-difference and the encode
        happen in one kernel pass (K1); otherwise, and on the hier wire,
        the base's message + encode_payload path."""
        comp = self.compressor
        if comp is not None and _is_fused_quantizer(comp) and not self._hier:
            u = self._dither_plane(seed, s.k)
            mark("dither")
            code, scale = _lu.lead_diff_encode(
                self._rows(s.x), self._rows(gb), self._rows(s.d),
                self._rows(s.h), self._rows(u), hy["eta"], bits=comp.bits)
            mark("diff_encode")
            payload, decode, bits = self.quant_payload(code, scale, comp.bits)
            return payload, decode, bits, None
        return super().encode_stage(s, gb, seed, hy)

    def apply_stage(self, s: FlatLEADState, gb, qh, wqh, hy, ctx=None,
                    step=None):
        """Post-communication fused H / H_w / D / X update (lines 5-7, K3).

        On a bank the invariant hw == W h no longer holds by increments
        (hw would sum alpha W_j q over past rounds' graphs).  K3 computes
        yh_w = hw + wqh, so it is fed the innovation (W_k h + wqh) - hw,
        which gives yh_w = W_k (h + qh) with the step's graph.  H is
        reference state, not wire traffic, so this mix is clean on the
        faulted path too."""
        if self._bank:
            wqh = (self.mix_round(s.h, self._host_step(s, step)) + wqh
                   - s.hw)
        xo, do, ho, hwo = _lu.lead_update(
            self._rows(s.x), self._rows(gb), self._rows(s.d),
            self._rows(s.h), self._rows(s.hw), self._rows(qh),
            self._rows(wqh), hy["eta"], hy["gamma"], hy["alpha"])
        mark("update")
        shape3 = s.x.shape
        new = FlatLEADState(x=xo.reshape(shape3), d=do.reshape(shape3),
                            h=ho.reshape(shape3), hw=hwo.reshape(shape3),
                            k=s.k + 1)
        return new

    def comp_err(self, s: FlatLEADState, gb, qh, hy, ctx):
        """The exact in-step ||Qh - (Y-H)|| / ||Y||: Y recomputed from the
        state before the step (K1 fuses it away on the wire)."""
        y = s.x - hy["eta"] * gb - hy["eta"] * s.d
        return rel_err(qh, y - s.h, y)

    def local_stage(self, s: FlatLEADState, gb, hy):
        """Interval (no-communication) step: X advances by its full primal
        direction -eta (g + D) while H / H_w / D freeze."""
        x = s.x - hy["eta"] * gb - hy["eta"] * s.d
        return (FlatLEADState(x=x, h=s.h, hw=s.hw, d=s.d, k=s.k + 1),
                torch.zeros((), dtype=torch.float32, device=x.device))

    # -- per-call-hyper entry points (LEADSim) -------------------------------
    def step_wire(self, state: FlatLEADState, g: torch.Tensor, seed: int,
                  hyper=None, step: int = None):
        """One LEAD iteration on flat buffers; g: gradients at state.x,
        either (n, d) or already (n, nb, block).  `seed` is the uint32
        dither seed (the step's plane is seeded with seed ^ k).  `hyper`
        defaults to the engine's stored hypers; `step` is the host step
        counter (== state.k), which run() passes.

        Returns (new_state, comp_err, wire_bits):
          comp_err  = ||Qh - (Y-H)|| / ||Y||, the compression error this
                      step incurred;
          wire_bits = bits per agent on the wire this step."""
        if not isinstance(hyper, LEADHyper):
            hyper = self.hyper
        hy = {f: _at(getattr(hyper, f), state.k)
              for f in ("eta", "gamma", "alpha")}
        return self._step_core(state, g, seed, hy, step)[:3]

    def step_with_wire(self, state: FlatLEADState, g, seed: int,
                       step: int = None):
        """The family's driver protocol with stored hypers."""
        return self.step_wire(state, g, seed, self.hyper, step)

    def step(self, state: FlatLEADState, g: torch.Tensor, seed: int,
             hyper=None, step: int = None) -> FlatLEADState:
        """The new state alone."""
        return self.step_wire(state, g, seed, hyper, step)[0]
