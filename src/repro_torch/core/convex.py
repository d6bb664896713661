"""Convex objectives from the paper's experiments (§5) + closed-form optima.

* Linear regression:  f_i(x) = ||A_i x - b_i||^2 + lambda ||x||^2
  (paper: A_i in R^{200x200}, b_i = A_i x' + noise, lambda = 0.1).
* Multinomial logistic regression on a Gaussian-mixture surrogate for
  MNIST (paper Figs. 2-3: d = 784 features, 10 classes, 8 agents x 256
  samples, heterogeneous = sorted by label before partitioning).

Objectives expose:
    full_grad(X)            (n, d)->(n, d)   per-agent full-batch gradients
    minibatch_grad(X, idx)  stochastic gradients over the (n, batch) sample
                            indices idx (the paper's mini-batch setting)
    loss(X)                 mean of local losses at the agent-local iterates
    x_star / solve_x_star   the global optimizer (closed form / by descent)
    mu_L                    strong-convexity / smoothness constants (linreg)

All arithmetic is float32, as in the reference.  The reference draws its
batch indices from a threefry key; here ``batch_indices`` draws them from
the counter hash (core/compression.py ``counter_bits``), as integers, bit
for bit the same on the CPU and the card.  ``minibatch_grad`` takes them
as an argument, or draws them for a seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.compression import counter_bits
from repro_torch.device import DeviceLike, resolve_device


def batch_indices(n: int, batch: int, m: int, seed: int,
                  device: DeviceLike = None) -> torch.Tensor:
    """(n, batch) int64 sample indices, uniform over [0, m) with
    replacement per agent: each of the counter hash's 24-bit draws h
    (seeded `seed`) maps to floor(h * m / 2^24), in integer arithmetic."""
    h = counter_bits((n, batch), seed, device)
    return (h * m) >> 24


def _rows_at(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[i, idx[i]] for every agent i: (n, m, ...) -> (n, batch, ...)."""
    return a[torch.arange(a.shape[0], device=a.device)[:, None], idx]


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

    @property
    def m(self):
        """Samples per agent."""
        return self.A.shape[1]

    def local_grad(self, i: int, x):
        """Agent i's full gradient at x (d,)."""
        Ai, bi = self.A[i], self.b[i]
        return 2.0 * Ai.T @ (Ai @ x - bi) + 2.0 * self.lam * x

    def full_grad(self, X):
        """X: (n, d) -> per-agent gradients (n, d)."""
        r = torch.einsum("nmd,nd->nm", self.A, X) - self.b
        return 2.0 * torch.einsum("nmd,nm->nd", self.A, r) + 2.0 * self.lam * X

    def minibatch_grad(self, X, idx=None, *, batch=32, seed: int = 0):
        """Per-agent stochastic gradients over the (n, batch) sample
        indices `idx` (drawn by ``batch_indices`` for `seed` when None):
        the batch's sum scaled by m / batch, plus the full regularizer."""
        n, m, d = self.A.shape
        if idx is None:
            idx = batch_indices(n, batch, m, seed, X.device)
        batch = idx.shape[1]
        Ab, bb = _rows_at(self.A, idx), _rows_at(self.b, idx)
        r = torch.einsum("nmd,nd->nm", Ab, X) - bb
        return 2.0 * (m / batch) * torch.einsum("nmd,nm->nd", Ab, r) \
            + 2.0 * self.lam * X

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


@dataclasses.dataclass(frozen=True)
class LogisticRegression:
    """Multinomial logistic regression, one data shard per agent:

        f_i(w) = -mean_j log softmax(feats_ij @ w)[labels_ij]
                 + lam/2 ||w||^2,    w: (d_feat, n_classes) flattened.
    """
    feats: torch.Tensor    # (n, m, d_feat) f32
    labels: torch.Tensor   # (n, m) int64
    n_classes: int
    lam: float

    @staticmethod
    def generate(generator: torch.Generator, n_agents=8, m_per_agent=256,
                 d=784, n_classes=10, lam=1e-4, heterogeneous=True, sep=3.0,
                 device: DeviceLike = None) -> "LogisticRegression":
        """Gaussian-mixture surrogate for MNIST drawn from `generator`, a
        torch.Generator on `device`: the reference's distributions (class
        centers sep * N(0, I/d), uniform labels, samples center + N(0,
        I/d)), but not its random stream.  heterogeneous=True sorts by label
        (stably) before partitioning, the paper's heterogeneous setting;
        otherwise the samples are permuted at random."""
        dev = resolve_device(device)
        total = n_agents * m_per_agent
        root_d = float(np.sqrt(d))
        centers = sep * torch.randn((n_classes, d), generator=generator,
                                    dtype=torch.float32, device=dev) / root_d
        y = torch.randint(0, n_classes, (total,), generator=generator,
                          device=dev)
        xfeat = centers[y] + torch.randn((total, d), generator=generator,
                                         dtype=torch.float32,
                                         device=dev) / root_d
        if heterogeneous:
            order = torch.argsort(y, stable=True)
        else:
            order = torch.randperm(total, generator=generator, device=dev)
        return LogisticRegression(
            feats=xfeat[order].reshape(n_agents, m_per_agent, d),
            labels=y[order].reshape(n_agents, m_per_agent),
            n_classes=n_classes, lam=lam)

    @staticmethod
    def from_arrays(feats, labels, n_classes: int, lam: float,
                    device: DeviceLike = None) -> "LogisticRegression":
        """The instance with the given data (numpy arrays or tensors), e.g.
        the reference's: feats copied as f32, labels as int64."""
        dev = resolve_device(device)

        def copy(a, dtype):
            if isinstance(a, torch.Tensor):
                return a.to(device=dev, dtype=dtype, copy=True)
            return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

        return LogisticRegression(feats=copy(feats, torch.float32),
                                  labels=copy(labels, torch.int64),
                                  n_classes=int(n_classes), lam=float(lam))

    @property
    def n(self):
        return self.feats.shape[0]

    @property
    def d(self):
        """Flattened parameter dimension (d_features * n_classes)."""
        return self.feats.shape[2] * self.n_classes

    def _unflatten(self, X):
        return X.reshape(X.shape[0], self.feats.shape[2], self.n_classes)

    @property
    def m(self):
        """Samples per agent."""
        return self.feats.shape[1]

    def _grad(self, X, feats, labels):
        """Per-agent gradients of the mean loss over (feats, labels),
        analytically: feats^T (softmax(logits) - onehot(labels)) / m
        + lam w."""
        W = self._unflatten(X)
        p = torch.softmax(torch.bmm(feats, W), dim=-1)          # (n, m, c)
        p = p - torch.nn.functional.one_hot(labels,
                                            self.n_classes).to(p.dtype)
        g = torch.bmm(feats.transpose(1, 2), p) / feats.shape[1]
        return (g + self.lam * W).reshape(X.shape)

    def full_grad(self, X):
        """X: (n, d) -> per-agent gradients (n, d)."""
        return self._grad(X, self.feats, self.labels)

    def minibatch_grad(self, X, idx=None, *, batch=64, seed: int = 0):
        """Per-agent gradients of the batch-mean loss (plus the full
        regularizer) over the (n, batch) sample indices `idx` (drawn by
        ``batch_indices`` for `seed` when None)."""
        if idx is None:
            idx = batch_indices(self.n, batch, self.m, seed, X.device)
        return self._grad(X, _rows_at(self.feats, idx),
                          _rows_at(self.labels, idx))

    def loss(self, X):
        W = self._unflatten(X)
        logp = torch.log_softmax(torch.bmm(self.feats, W), dim=-1)
        nll = -torch.mean(torch.gather(logp, 2, self.labels[..., None]),
                          dim=(1, 2))
        return torch.mean(nll + 0.5 * self.lam * torch.sum(W ** 2, dim=(1, 2)))

    def solve_x_star(self, iters=500) -> torch.Tensor:
        """Global optimum by full-batch gradient descent on the average
        objective (strongly convex => unique), from w = 0 with step 1/L for
        the reference's crude Lipschitz estimate."""
        L = float(torch.mean(torch.sum(self.feats ** 2, -1))) + self.lam
        lr = 1.0 / L
        w = torch.zeros(self.d, dtype=torch.float32, device=self.feats.device)
        for _ in range(iters):
            g = torch.mean(self.full_grad(w.expand(self.n, self.d)), dim=0)
            w = w - lr * g
        return w


# -- metrics -----------------------------------------------------------------

def distance_to_opt(X, x_star):
    """(1/n) sum_i ||x_i - x*||^2   (paper Fig. 1a / 2a)."""
    return torch.mean(torch.sum((X - x_star[None]) ** 2, -1))


def consensus_error(X):
    """(1/n) sum_i ||x_i - xbar||^2   (paper Fig. 1c / Corollary 2)."""
    xbar = torch.mean(X, 0, keepdim=True)
    return torch.mean(torch.sum((X - xbar) ** 2, -1))
