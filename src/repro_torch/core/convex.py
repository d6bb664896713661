"""Convex objectives from the paper's experiments (§5) + closed-form optima.

* Linear regression:  f_i(x) = ||A_i x - b_i||^2 + lambda ||x||^2
  (paper: A_i in R^{200x200}, b_i = A_i x' + noise, lambda = 0.1).

Objectives expose:
    full_grad(X)            (n, d)->(n, d)   per-agent full-batch gradients
    loss(X)                 mean of local losses at the agent-local iterates
    x_star                  the global optimizer (closed form)
    mu_L                    strong-convexity / smoothness constants

All arithmetic is float32, as in the reference.  ``LogisticRegression`` and
the minibatch oracle are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class LinearRegression:
    A: torch.Tensor       # (n, m, d)
    b: torch.Tensor       # (n, m)
    lam: float

    @staticmethod
    def generate(generator: torch.Generator, n_agents=8, m=200, d=200,
                 lam=0.1, noise=0.1,
                 device: DeviceLike = None) -> "LinearRegression":
        """Random instance drawn from `generator`, a torch.Generator on
        `device`.  The draws follow the reference's recipe but not its
        random stream."""
        dev = resolve_device(device)

        def normal(*shape):
            return torch.randn(shape, generator=generator,
                               dtype=torch.float32, device=dev)

        A = normal(n_agents, m, d) / float(np.sqrt(m))
        x_true = normal(d)
        b = torch.einsum("nmd,d->nm", A, x_true) + noise * normal(n_agents, m)
        return LinearRegression(A=A, b=b, lam=lam)

    @staticmethod
    def from_arrays(A, b, lam: float,
                    device: DeviceLike = None) -> "LinearRegression":
        """The instance with the given data (numpy arrays or tensors), e.g.
        the reference's, copied as f32 to `device`."""
        dev = resolve_device(device)

        def as_f32(a):
            if isinstance(a, torch.Tensor):
                return a.to(device=dev, dtype=torch.float32, copy=True)
            return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

        return LinearRegression(A=as_f32(A), b=as_f32(b), lam=float(lam))

    @property
    def n(self):
        return self.A.shape[0]

    @property
    def d(self):
        return self.A.shape[2]

    def full_grad(self, X):
        """X: (n, d) -> per-agent gradients (n, d)."""
        r = torch.einsum("nmd,nd->nm", self.A, X) - self.b
        return 2.0 * torch.einsum("nmd,nm->nd", self.A, r) + 2.0 * self.lam * X

    def loss(self, X):
        r = torch.einsum("nmd,nd->nm", self.A, X) - self.b
        return torch.mean(torch.sum(r ** 2, -1) + self.lam * torch.sum(X ** 2, -1))

    @property
    def x_star(self) -> torch.Tensor:
        """Closed form: x* = (sum 2 A_i^T A_i + 2 n lam I)^{-1} sum 2 A_i^T b_i."""
        eye = torch.eye(self.d, dtype=self.A.dtype, device=self.A.device)
        H = 2.0 * torch.einsum("nmd,nme->de", self.A, self.A) + \
            2.0 * self.n * self.lam * eye
        g = 2.0 * torch.einsum("nmd,nm->d", self.A, self.b)
        return torch.linalg.solve(H, g)

    @property
    def mu_L(self):
        """Assumption 4 constants: EACH f_i is L-smooth / mu-strongly convex,
        so mu = min_i lambda_min(H_i), L = max_i lambda_max(H_i)."""
        eye = torch.eye(self.d, dtype=self.A.dtype, device=self.A.device)
        H = 2.0 * torch.einsum("nmd,nme->nde", self.A, self.A) + \
            2.0 * self.lam * eye[None]
        ev = torch.linalg.eigvalsh(H)                   # (n, d)
        return float(torch.min(ev[:, 0])), float(torch.max(ev[:, -1]))


# -- metrics -----------------------------------------------------------------

def distance_to_opt(X, x_star):
    """(1/n) sum_i ||x_i - x*||^2   (paper Fig. 1a / 2a)."""
    return torch.mean(torch.sum((X - x_star[None]) ** 2, -1))


def consensus_error(X):
    """(1/n) sum_i ||x_i - xbar||^2   (paper Fig. 1c / Corollary 2)."""
    xbar = torch.mean(X, 0, keepdim=True)
    return torch.mean(torch.sum((X - xbar) ** 2, -1))
