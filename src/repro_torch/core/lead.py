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

The flat engine (core/engines/lead.py) runs it.  Hyper-parameters may be
floats or callables of the iteration counter k (diminishing-stepsize mode
of Theorem 2); k is a 0-d tensor on the engine's device, so a schedule is
resolved on the device with no host sync.  The pytree ``init``/``step`` of
``src/repro/core/lead.py`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

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
