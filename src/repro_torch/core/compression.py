"""Communication-compression operators (paper §5 / Appendix C).

The paper's workhorse is the unbiased p-norm b-bit stochastic quantizer
(Theorem 3):

    Q_p(x) = (||x||_p * sign(x) * 2^{-(b-1)}) .* floor( 2^{b-1} |x| / ||x||_p + u )

with u ~ Uniform[0,1]^d, applied blockwise (block = 512, b = 2).  For p=inf
the flat engine runs it through the fused kernels
(kernels/lead_update.lead_diff_encode, kernels/quantize.decode), so the
operators here carry only their wire-bit accounting and variance bound.
The generic ``encode_blocks`` wire path (and with it ``quantize.encode``,
K4), ``TopK`` and ``RandK`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


def rel_err(q: torch.Tensor, target: torch.Tensor,
            ref: torch.Tensor) -> torch.Tensor:
    """||q - target|| / ||ref||: relative compression error of a transmitted
    message `target` with estimate `q`, normalized by the pre-communication
    iterate `ref` that carries it (the Trace comp_err convention)."""
    return (torch.linalg.vector_norm((q - target).reshape(-1))
            / (torch.linalg.vector_norm(ref.reshape(-1)) + 1e-12))


@dataclasses.dataclass(frozen=True)
class QuantizePNorm:
    """Unbiased blockwise p-norm b-bit stochastic quantizer (paper Thm 3).

    bits:  total bits per element for the integer code (paper uses 2).
    p:     norm order; inf is the paper's choice.
    block: block size for the blockwise application (paper uses 512).
    """
    bits: int = 2
    p: float = math.inf
    block: int = 512

    def __post_init__(self):
        # codes live in [-(2^{b-1}), 2^{b-1}] and are stored in int8 lanes:
        # bits <= 7 keeps the top level representable (the paper uses 2).
        if not 1 <= self.bits <= 7:
            raise ValueError("int8 code container supports bits in [1, 7]")

    def wire_bits(self, n_elements: int) -> float:
        # b bits of code per element + a sign bit + one f32 scale per block
        nb = -(-n_elements // self.block)
        return n_elements * (self.bits + 1) + nb * 32

    def variance_constant(self, d_block: Optional[int] = None) -> float:
        """Upper bound on C in  E||x - Q(x)||^2 <= C ||x||^2  (Remark 7).

        For p=inf and blockwise application, ||x||_inf <= ||x||_2 per block so
        C <= d_block * 2^{-2(b-1)} / 4.
        """
        d = d_block if d_block is not None else self.block
        return d * (2.0 ** (-2 * (self.bits - 1))) / 4.0


@dataclasses.dataclass(frozen=True)
class Identity:
    """No compression (C = 0); LEAD reduces to NIDS with gamma=1."""

    def wire_bits(self, n_elements: int) -> float:
        return n_elements * 32

    def variance_constant(self, d_block=None):
        return 0.0
