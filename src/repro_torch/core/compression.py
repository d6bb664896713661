"""Communication-compression operators (paper §5 / Appendix C).

The paper's workhorse is the unbiased p-norm b-bit stochastic quantizer
(Theorem 3):

    Q_p(x) = (||x||_p * sign(x) * 2^{-(b-1)}) .* floor( 2^{b-1} |x| / ||x||_p + u )

with u ~ Uniform[0,1]^d, applied blockwise (block = 512, b = 2).

Every operator implements the flat-layout wire protocol of the flat
engines, on the kernels' blocked ``(n_agents, nb, block)`` f32 buffers
(zero-padded past the logical per-agent dimension ``dim``):

    encode_blocks(buf, dim, ...) -> (payload, bits)
        payload: dict of tensors with leading agent axis n - exactly what
        crosses agents; bits: 0-d f32 tensor, bits per agent on the wire
        this step, counted from the payload (data-dependent for RandK and
        approximate TopK).
    decode_blocks(payload) -> (n, nb, block) f32 decoded estimate.

The kernels carry the wire: the p=inf quantizer encodes with
``kernels.quantize.encode`` (K4) and every quantizer decodes with
``kernels.quantize.decode`` (K2); RandK keeps with
``kernels.sparsify.randk_encode`` (K5); TopK applies its exact-k mask with
``kernels.sparsify.mask_apply`` (K6).  The p != inf quantizer is plain
torch, as the reference leaves it to XLA outside Pallas.

Randomness.  The reference draws RandK's and the p != inf quantizer's
uniforms, and approximate TopK's sample indices, from threefry keys, which
torch cannot reproduce.  So each ``encode_blocks`` here takes its random
input explicitly: ``u``, a (n, dim) f32 plane of U[0, 1) draws for the
logical elements (the quantizers and RandK), or ``idx``, the (n, m) int64
sample indices (approximate TopK).  The flat engines supply them from their
own counter-hash stream (engines/base.py); the parity tests inject the
reference's own draws.  The reference's tree-path methods (compress /
encode / decode) are not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.stage_timer import mark
from repro_torch.kernels import quantize as _q
from repro_torch.kernels.quantize import DEFAULT_BLOCK
from repro_torch.kernels.sparsify import mask_apply, randk_encode


def rel_err(q: torch.Tensor, target: torch.Tensor,
            ref: torch.Tensor) -> torch.Tensor:
    """||q - target|| / ||ref||: relative compression error of a transmitted
    message `target` with estimate `q`, normalized by the pre-communication
    iterate `ref` that carries it (the Trace comp_err convention)."""
    return (torch.linalg.vector_norm((q - target).reshape(-1))
            / (torch.linalg.vector_norm(ref.reshape(-1)) + 1e-12))


def _is_inf(p) -> bool:
    return p in (math.inf, "inf")


def _pnorm(x: torch.Tensor, p, axis=-1, keepdims=True) -> torch.Tensor:
    if _is_inf(p):
        return torch.amax(torch.abs(x), dim=axis, keepdim=keepdims)
    return torch.sum(torch.abs(x) ** p, dim=axis,
                     keepdim=keepdims) ** (1.0 / p)


def _stochastic_quantize(blocks: torch.Tensor, u: torch.Tensor, bits: int,
                         p):
    """The paper's p-norm b-bit stochastic quantize step (Thm 3), blockwise
    over the LAST axis, in the plain torch of the reference's formula.
    Returns (code int8, scale f32), shapes (..., block) / (..., 1)."""
    blocks = blocks.to(torch.float32)
    scale = _pnorm(blocks, p)
    safe = torch.where(scale > 0, scale, 1.0)
    lvl = torch.floor((2.0 ** (bits - 1)) * torch.abs(blocks) / safe + u)
    # levels live in [0, 2^{b-1}] (the upper end is reached when |x| ==
    # scale and u -> 1), which fits b bits alongside the sign
    lvl = torch.clamp_max(lvl, 2.0 ** (bits - 1))
    code = (torch.sign(blocks) * lvl).to(torch.int8)
    return code, torch.where(scale > 0, scale, 0.0).to(torch.float32)


def _nb_logical(dim: int, block: int) -> int:
    return -(-dim // block)


def _flat_to_rows(buf: torch.Tensor, dim: int) -> torch.Tensor:
    """(n, nb, block) -> (n, dim): drop the zero padding past the logical
    dim (a view)."""
    n = buf.shape[0]
    return buf.reshape(n, -1)[:, :dim]


def _rows_to_flat(rows: torch.Tensor, like: torch.Tensor,
                  value: float = 0.0) -> torch.Tensor:
    """(n, dim) -> (n, nb, block), padded with `value` to `like`'s blocked
    shape (a view when there is nothing to pad and rows is contiguous)."""
    n, nb, block = like.shape
    pad = nb * block - rows.shape[1]
    if pad:
        rows = F.pad(rows, (0, pad), value=value)
    return rows.reshape(n, nb, block)


def _bits(value, device) -> torch.Tensor:
    return torch.full((), float(value), dtype=torch.float32, device=device)


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

    # -- flat-layout wire path -------------------------------------------
    def encode_blocks(self, buf: torch.Tensor, dim: int, u: torch.Tensor):
        """buf: (n, nb, block) f32, zero-padded past dim; u: (n, dim) f32
        uniforms for the logical elements (zero-padded here: a padded
        element is zero, so its code is 0 whatever its dither).  p=inf
        encodes with K4; any other p with the plain formula."""
        n, nb, block = buf.shape
        if block != self.block:
            raise ValueError(f"buffer block {block} != quantizer block "
                             f"{self.block}")
        ub = _rows_to_flat(u, buf)
        if _is_inf(self.p):
            code, scale = _q.encode(buf.reshape(n * nb, block),
                                    ub.reshape(n * nb, block),
                                    bits=self.bits)
            code, scale = code.reshape(n, nb, block), scale.reshape(n, nb, 1)
        else:
            code, scale = _stochastic_quantize(buf, ub, self.bits, self.p)
        # the payload: (b+1)-bit codes for the dim logical elements + one
        # f32 scale per logical block (the padded tail rows never travel)
        bits = _bits(dim * (self.bits + 1)
                     + _nb_logical(dim, block) * 32, buf.device)
        return {"code": code, "scale": scale}, bits

    def decode_blocks(self, payload: dict) -> torch.Tensor:
        """scale * 2^(1-b) * code, the receiver's decode (K2)."""
        code = payload["code"]
        rows = _q.decode(code.reshape(-1, code.shape[-1]),
                         payload["scale"].reshape(-1, 1), bits=self.bits)
        return rows.reshape(code.shape)

    def variance_constant(self, d_block: Optional[int] = None) -> float:
        """Upper bound on C in  E||x - Q(x)||^2 <= C ||x||^2  (Remark 7).

        For p=inf and blockwise application, ||x||_inf <= ||x||_2 per block so
        C <= d_block * 2^{-2(b-1)} / 4.
        """
        d = d_block if d_block is not None else self.block
        return d * (2.0 ** (-2 * (self.bits - 1))) / 4.0


@dataclasses.dataclass(frozen=True)
class TopK:
    """Biased top-k sparsifier (used in the Fig. 6 compression-error study).

    ratio: fraction of entries kept.  Index transmission costs log2(d) bits
    per kept entry (no shared-seed trick possible).

    Exactly k entries are kept: the mask comes from ``torch.topk`` indices
    (a magnitude threshold `|x| >= kth` would keep every tied entry, sending
    more than the k values wire_bits charges).

    approx_threshold=True switches to a sampled-quantile threshold: each
    agent samples m = sample_per_block * ceil(d/block) of its magnitudes
    (at the given indices) and keeps everything at or above the sample's
    ratio-quantile.  The kept count is then only approximately k, so the
    payload bits are counted from the actual mask.
    """
    ratio: float = 0.1
    approx_threshold: bool = False
    sample_per_block: int = 8

    def _k(self, d: int) -> int:
        return max(1, int(d * self.ratio))

    def wire_bits(self, n_elements: int) -> float:
        k = self._k(n_elements)
        return k * (32 + math.log2(max(n_elements, 2)))

    def sample_size(self, d: int) -> int:
        """m, the magnitudes each agent samples in approximate mode."""
        return min(self.sample_per_block * _nb_logical(d, DEFAULT_BLOCK), d)

    @staticmethod
    def indices_from_uniform(u: torch.Tensor, d: int) -> torch.Tensor:
        """Sample indices in [0, d) from U[0, 1) draws of any shape."""
        return (u * d).to(torch.int64).clamp_(max=d - 1)

    def _mask_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """(n, d) -> boolean keep-mask with exactly k True per row."""
        n, d = rows.shape
        idx = torch.topk(torch.abs(rows), self._k(d), dim=1).indices
        return torch.zeros((n, d), dtype=torch.bool,
                           device=rows.device).scatter_(1, idx, True)

    def _approx_mask_rows(self, rows: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
        """(n, d) -> keep-mask from a sampled-quantile threshold: the
        (k*m/d)-th largest of each agent's m sampled magnitudes is its
        threshold, and |x| >= threshold is kept."""
        n, d = rows.shape
        m = idx.shape[1]
        rank = min(max(1, round(self._k(d) * m / d)), m)
        sample = torch.abs(torch.gather(rows, 1, idx))
        thr = torch.topk(sample, rank, dim=1).values[:, -1:]
        a = torch.abs(rows)
        # strict-positive guard: an all-zero sample row must not keep the
        # whole (zero) vector and charge d entries of wire traffic for it
        return (a >= thr) & (a > 0.0)

    # -- flat-layout wire path -------------------------------------------
    def encode_blocks(self, buf: torch.Tensor, dim: int,
                      idx: Optional[torch.Tensor] = None):
        """Threshold+mask over the logical rows; the mask is applied by the
        K6 pass and the payload is the masked values in block layout (kept
        values + indices on the wire; the dense zeros are layout, not
        traffic).  Exact mode (default) takes no random input; approximate
        mode takes the (n, m) sample indices `idx`."""
        n, nb, block = buf.shape
        rows = _flat_to_rows(buf, dim)
        if self.approx_threshold:
            if idx is None:
                raise ValueError("approx_threshold=True needs the sample "
                                 "indices idx=")
            maskr = self._approx_mask_rows(rows, idx)
            bits = torch.mean(torch.sum(maskr.to(torch.float32), dim=1)) \
                * (32.0 + math.log2(max(dim, 2)))
        else:
            if idx is not None:
                raise ValueError("exact TopK takes no sample indices")
            maskr = self._mask_rows(rows)
            bits = _bits(self.wire_bits(dim), buf.device)
        mask = _rows_to_flat(maskr.to(torch.float32), buf)
        mark("topk_mask")
        vals = mask_apply(buf.reshape(n * nb, block),
                          mask.reshape(n * nb, block))
        return {"values": vals.reshape(n, nb, block)}, bits

    def decode_blocks(self, payload: dict) -> torch.Tensor:
        return payload["values"]

    def variance_constant(self, d_block=None):
        return None  # biased: Assumption 2 does not hold


@dataclasses.dataclass(frozen=True)
class RandK:
    """Unbiased random-k sparsifier: keep a random fraction, rescale by 1/ratio.

    With a shared PRNG seed, indices need not be transmitted (paper App. C.2).
    """
    ratio: float = 0.1
    rescale: bool = True

    def wire_bits(self, n_elements: int) -> float:
        return n_elements * self.ratio * 32

    # -- flat-layout wire path -------------------------------------------
    def encode_blocks(self, buf: torch.Tensor, dim: int, u: torch.Tensor):
        """Shared-seed mask: the keep-mask u < ratio is reproducible from
        the shared seed on both sides of the wire, so the payload is
        values-only (no indices travel - paper App. C.2).  The mask and the
        rescale are the K5 pass.  u: (n, dim) uniforms for the logical
        elements, padded here with 1.0 (>= ratio: the layout tail is never
        kept).  Bits are data-dependent: 32 per kept entry, averaged over
        agents."""
        n, nb, block = buf.shape
        ub = _rows_to_flat(u, buf, value=1.0)
        vals = randk_encode(buf.reshape(n * nb, block),
                            ub.reshape(n * nb, block), ratio=self.ratio,
                            rescale=self.rescale)
        bits = torch.mean(torch.sum((u < self.ratio).to(torch.float32),
                                    dim=1)) * 32.0
        return {"values": vals.reshape(n, nb, block)}, bits

    def decode_blocks(self, payload: dict) -> torch.Tensor:
        return payload["values"]

    def variance_constant(self, d_block=None):
        # E||x - Q(x)||^2 = (1/ratio - 1)||x||^2 for the rescaled variant.
        return 1.0 / self.ratio - 1.0


@dataclasses.dataclass(frozen=True)
class Identity:
    """No compression (C = 0); LEAD reduces to NIDS with gamma=1."""

    def wire_bits(self, n_elements: int) -> float:
        return n_elements * 32

    # -- flat-layout wire path -------------------------------------------
    def encode_blocks(self, buf: torch.Tensor, dim: int):
        return {"values": buf}, _bits(dim * 32, buf.device)

    def decode_blocks(self, payload: dict) -> torch.Tensor:
        return payload["values"]

    def variance_constant(self, d_block=None):
        return 0.0
