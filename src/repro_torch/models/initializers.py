"""Weight initializers shared by the model modules (transformer, moe,
recurrent): f32 tensors on an explicit device from an explicit
``torch.Generator``.  On the ``meta`` device they give shapes only
(``ModelConfig.param_count`` counts the init there, allocating nothing)."""
from __future__ import annotations

import torch


def normal(gen, shape, device) -> torch.Tensor:
    """N(0, 1) f32 of `shape`; on the meta device, shapes only."""
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, dtype=torch.float32, device=device,
                       generator=gen)


def uniform(gen, shape, lo: float, hi: float, device) -> torch.Tensor:
    """U[lo, hi) f32 of `shape`; on the meta device, shapes only."""
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    u = torch.rand(shape, dtype=torch.float32, device=device, generator=gen)
    return lo + (hi - lo) * u


def dense(gen, d_in, d_out, device, scale=None) -> torch.Tensor:
    """A (d_in, d_out) weight, scale * N(0, 1) (scale d_in^-1/2 when
    None)."""
    scale = scale if scale is not None else d_in ** -0.5
    return scale * normal(gen, (d_in, d_out), device)


def ones(n, device) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.float32, device=device)


def zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)
