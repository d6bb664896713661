"""LEAD (Algorithm 1) hyper-parameters and their schedules.

Per iteration (paper Alg. 1, lines 4-7):

    Y    = X - eta * g - eta * D                         g = grad F(X; xi)
    Qh   = compress(Y - H)                               difference compression
    Yh   = H + Qh
    Yh_w = H_w + W Qh            <- the ONLY communication of the iteration
    H    = (1-alpha) H + alpha Yh                        momentum state update
    H_w  = (1-alpha) H_w + alpha Yh_w
    D    = D + gamma/(2 eta) (Yh - Yh_w)                 inexact dual ascent
    X    = X - eta * g - eta * D                         primal descent

Two implementations run it.  This module's ``init`` / ``step`` /
``step_with_metrics`` are the reference's tree path: the algorithm over any
pytree, with two injected primitives,

    mix(tree)             -> W @ tree   (core/gossip.DenseGossip.mix)
    compress(seed, tree)  -> tree_hat   (the per-agent compress,
                                         core/compression.compress_each)

so the difference Y - H is plain torch and the compressor's own compress
carries the wire (on the card: K4 and K2 for the p=inf quantizer).  The
flat engine (core/engines/lead.py) runs the same iteration as two fused
kernel passes (K1, K3) on the blocked state.

Hyper-parameters may be floats or callables of the iteration counter k
(diminishing-stepsize mode of Theorem 2); k is a 0-d tensor on the state's
device, so a schedule is resolved on the device with no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch.core.stage_timer import mark
from repro_torch.utils.tree import (Pytree, tree_axpy, tree_leaves, tree_lerp,
                                    tree_map, tree_norm, tree_sub,
                                    tree_zeros_like)

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def _at(s: Schedule, k: torch.Tensor) -> torch.Tensor:
    """The schedule's value at iteration k as a 0-d f32 tensor on k's
    device (a constant is filled on the device: no host-to-device copy)."""
    if callable(s):
        return s(k)
    if isinstance(s, torch.Tensor):
        return s.to(device=k.device, dtype=torch.float32)
    return torch.full((), float(s), dtype=torch.float32, device=k.device)


@dataclasses.dataclass(frozen=True)
class LEADHyper:
    """eta: primal stepsize, gamma: dual stepsize scale, alpha: state momentum.

    Theorem 1 guarantees linear convergence for eta in (0, 2/(mu+L)] with
    gamma, alpha in the ranges (9)-(10).  The paper's experiments simply use
    alpha = 0.5, gamma = 1.0 (robustness, App. D.1).
    """
    eta: Schedule = 0.1
    gamma: Schedule = 1.0
    alpha: Schedule = 0.5


class LEADState(NamedTuple):
    x: Pytree           # primal iterates (per agent)
    h: Pytree           # compression reference state H
    hw: Pytree          # H_w = W H (tracked, never recomputed via comms)
    d: Pytree           # dual variable, in Range(I - W)
    k: torch.Tensor     # iteration counter, 0-d int64


def init(x0: Pytree, g0: Pytree, hyper: LEADHyper,
         mix: Callable[[Pytree], Pytree],
         h0: Optional[Pytree] = None) -> LEADState:
    """Paper initialization: X^1 = X^0 - eta g(X^0); D^1 = 0 in Range(I-W);
    H^1 given (default X^0); H_w^1 = W H^1."""
    k0 = torch.zeros((), dtype=torch.int64,
                     device=tree_leaves(x0)[0].device)
    x1 = tree_axpy(-_at(hyper.eta, k0), g0, x0)
    h1 = h0 if h0 is not None else x0
    return LEADState(x=x1, h=h1, hw=mix(h1), d=tree_zeros_like(x0), k=k0)


def step_with_metrics(state: LEADState, g: Pytree, seed: int,
                      hyper: LEADHyper, mix: Callable[[Pytree], Pytree],
                      compress: Callable[[int, Pytree], Pytree]):
    """One LEAD iteration; also returns the compression error it incurred,
    ||Qh - (Y-H)|| / ||Y|| (Fig. 1d).  `seed` is the step's draw seed,
    handed to `compress`.

    The subtraction order (x - eta*g - eta*d, left to right) is the flat
    engine's fused-kernel order, so both paths feed the same Y into the
    quantizer."""
    eta = _at(hyper.eta, state.k)
    gamma = _at(hyper.gamma, state.k)
    alpha = _at(hyper.alpha, state.k)
    x, h, hw, d = state.x, state.h, state.hw, state.d

    # line 4: Y = X - eta g - eta D
    y = tree_map(lambda xl, gl, dl: xl - eta * gl - eta * dl, x, g, d)
    # COMM procedure (lines 9-16): difference compression + one exchange
    diff = tree_sub(y, h)
    mark("message")
    qh = compress(seed, diff)
    wqh = mix(qh)
    mark("mix")
    yh = tree_map(torch.add, h, qh)
    yh_w = tree_map(torch.add, hw, wqh)
    h_new = tree_lerp(alpha, h, yh)
    hw_new = tree_lerp(alpha, hw, yh_w)
    # line 6: inexact dual ascent; D stays in Range(I - W)
    d_new = tree_map(lambda dl, a, b: dl + gamma / (2.0 * eta) * (a - b),
                     d, yh, yh_w)
    # line 7: primal descent with the new dual
    x_new = tree_map(lambda xl, gl, dl: xl - eta * gl - eta * dl,
                     x, g, d_new)
    mark("update")
    comp_err = tree_norm(tree_sub(qh, diff)) / (tree_norm(y) + 1e-12)
    mark("comp_err")
    new = LEADState(x=x_new, h=h_new, hw=hw_new, d=d_new, k=state.k + 1)
    return new, comp_err


def step(state: LEADState, g: Pytree, seed: int, hyper: LEADHyper,
         mix: Callable[[Pytree], Pytree],
         compress: Callable[[int, Pytree], Pytree]) -> LEADState:
    """One LEAD iteration.  `g` must be (an unbiased estimate of) grad F at
    state.x; it is used in both line 4 and line 7 (computed once)."""
    return step_with_metrics(state, g, seed, hyper, mix, compress)[0]


def theorem1_ranges(mu: float, L: float, C: float, beta: float, eta: float):
    """Admissible (gamma, alpha) ranges from Theorem 1, eqs. (9)-(10)."""
    me = mu * eta * (2.0 - mu * eta)
    if C > 0:
        gamma_hi = min(2.0 / ((3 * C + 1) * beta), 2.0 * me / ((2.0 - me) * C * beta))
    else:
        gamma_hi = 2.0 / beta
    gamma = 0.9 * gamma_hi
    a1 = 4.0 * (1.0 + C) / (C * beta * gamma + 2.0)
    alpha_lo = C * beta * gamma / (2.0 * (1.0 + C))
    alpha_hi = (1.0 / a1) * min((2.0 - beta * gamma) / (4.0 - beta * gamma), me)
    return gamma, (alpha_lo, max(alpha_lo, alpha_hi))


def diminishing_schedules(mu: float, L: float, C: float, beta: float,
                          lam_max_pinv: float, theta4: Optional[float] = None):
    """Theorem 2 schedules: eta_k = 2 th5 / (th3 th4 th5 k + 2),
    gamma_k = th4 eta_k, alpha_k = C beta gamma_k / (2 (1+C))."""
    theta1 = 1.0 / (2.0 * lam_max_pinv)
    theta2 = C * beta / (2.0 * (1.0 + C)) if C > 0 else theta1
    theta3 = min(theta1, theta2)
    if theta4 is None:
        theta4 = 0.5 * mu / (C * beta) if C > 0 else mu
    eta_star = 2.0 * (mu - C * beta * theta4) / (mu ** 2) if C > 0 else 2.0 / (mu + L)
    if C > 0:
        q = (3 * C + 1) - ((3 * C + 1) ** 2 - 4 * C) ** 0.5
        theta5 = min(2.0 / (mu + L), eta_star, q / (C * beta * theta4), 2.0 / (beta * theta4))
    else:
        theta5 = min(2.0 / (mu + L), 2.0 / (beta * theta4))

    def eta(k):
        return 2.0 * theta5 / (theta3 * theta4 * theta5 * k + 2.0)

    def gamma(k):
        return theta4 * eta(k)

    def alpha(k):
        return C * beta * gamma(k) / (2.0 * (1.0 + C)) if C > 0 else torch.full_like(eta(k), 0.5)

    return LEADHyper(eta=eta, gamma=gamma, alpha=alpha)
