"""Plain PyTorch versions of the port's kernels.

Line for line the math of ``src/repro/kernels/ref.py``, in the same order
of operations, so that on the CPU they give the reference's eager oracles
bit for bit (the quantizer's floor() flips its code on a level boundary
under any change of rounding).  The CPU tests hold them against the JAX
oracles; ``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch


def quantize_encode_ref(x: torch.Tensor, u: torch.Tensor, bits: int):
    """Blockwise inf-norm b-bit stochastic quantization (paper Thm 3, p=inf).

    x, u: (nb, block) f32; u ~ U[0,1).  Returns (code int8, scale f32 (nb,1)).
    """
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    safe = torch.where(scale > 0, scale, 1.0)
    lvl = torch.floor((2.0 ** (bits - 1)) * torch.abs(x) / safe + u)
    lvl = torch.clamp_max(lvl, 2.0 ** (bits - 1))
    code = (torch.sign(x) * lvl).to(torch.int8)
    return code, torch.where(scale > 0, scale, 0.0).to(torch.float32)


def quantize_decode_ref(code: torch.Tensor, scale: torch.Tensor, bits: int):
    """Inverse of quantize_encode_ref: (nb, block) f32 values."""
    return scale * (2.0 ** (1 - bits)) * code.to(torch.float32)


def lead_update_ref(x, g, d, h, hw, qh, wqh, eta, gamma, alpha):
    """Fused LEAD post-communication state update (Alg. 1 lines 5-7).

    All tensors share one shape; scalars are python floats or 0-d f32
    tensors.  Returns (x_new, d_new, h_new, hw_new).
    """
    yh = h + qh
    yhw = hw + wqh
    h_new = (1.0 - alpha) * h + alpha * yh
    hw_new = (1.0 - alpha) * hw + alpha * yhw
    d_new = d + gamma / (2.0 * eta) * (yh - yhw)
    x_new = x - eta * g - eta * d_new
    return x_new, d_new, h_new, hw_new


def lead_diff_encode_ref(x, g, d, h, u, eta, bits):
    """Fused pre-communication pass: diff = (x - eta g - eta d) - h, then
    blockwise inf-norm b-bit quantization of the diff.

    x, g, d, h, u: (nb, block) f32.  Returns (code int8, scale (nb,1) f32).
    """
    diff = x - eta * g - eta * d - h
    return quantize_encode_ref(diff, u, bits)


def randk_encode_ref(x, u, ratio, scale):
    """Shared-seed random-k keep plane: x * scale where u < ratio, else 0.

    ratio and scale are python floats; torch takes them as f32 operands,
    as the reference's weakly typed scalars are."""
    return torch.where(u < ratio, x * scale, 0.0)


def mask_apply_ref(x, mask):
    """Top-k value plane: x * mask (mask is an exact-k 0/1 f32 plane)."""
    return x * mask.to(torch.float32)
