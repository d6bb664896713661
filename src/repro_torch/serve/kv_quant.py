"""KV-page codec: the LEAD wire quantizer applied to KV-cache pages (the
port of ``src/repro/serve/kv_quant.py``).

A KV page holds ``page`` token positions of one layer's K (or V):
``page * kv_heads * head_dim`` contiguous elements.  Flattened page-major,
a pool of pages is a ``(n_pages * nb, block)`` plane, the wire layout of
``kernels/quantize.py``, so cold pages are stored as int8 codes and one f32
scale per block, encoded by K4 (``quantize.encode``) as a page flushes and
decoded by K2 (``quantize.decode``) on every read.

Two departures from the wire path, as in the reference:

* a deterministic half dither (u = 0.5): a cache is written once and read
  many times, so round-to-nearest minimises the per-read error and keeps
  serving reproducible with no random state in the cache;
* the meter is ``QuantizePNorm.wire_bits``': ``bits + 1`` bits per element
  (the sign rides along) and one 32-bit scale per block.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.kernels import quantize as _q


def pick_block(elems_per_page: int, target: int = _q.DEFAULT_BLOCK) -> int:
    """The largest divisor of elems_per_page up to target (a page must be a
    whole number of codec blocks)."""
    block = min(target, elems_per_page)
    while elems_per_page % block:
        block -= 1
    return block


@dataclasses.dataclass(frozen=True)
class KVQuantSpec:
    """The codec of one pool."""
    bits: int
    block: int

    def __post_init__(self):
        if not 1 <= self.bits <= 7:
            raise ValueError("int8 code container supports bits in [1, 7]")

    @property
    def bits_per_elem(self) -> float:
        """Wire-meter bits per cached element: the (b+1)-bit code and the
        f32 block scale spread over the block."""
        return (self.bits + 1) + 32.0 / self.block

    def page_bits(self, elems_per_page: int) -> int:
        """The exact meter of one page (QuantizePNorm.wire_bits)."""
        nb = elems_per_page // self.block
        return elems_per_page * (self.bits + 1) + nb * 32


@functools.lru_cache(maxsize=16)
def _half_plane(rows: int, block: int, device: torch.device) -> torch.Tensor:
    """The constant 0.5 dither plane of one shape, built once and shared:
    the kernels take u as a contiguous plane (a stride-0 expand is not
    one), and nothing ever writes to it."""
    return torch.full((rows, block), 0.5, dtype=torch.float32, device=device)


def encode_rows(x: torch.Tensor, spec: KVQuantSpec
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (R, *page_shape) -> codes (R, nb, block) int8, scales (R, nb, 1)
    f32, through K4 with the half dither."""
    R = x.shape[0]
    elems = x.numel() // max(R, 1)
    nb = elems // spec.block
    if nb * spec.block != elems:
        raise ValueError(f"a page of {elems} elements is not a whole number "
                         f"of {spec.block}-blocks")
    xb = x.to(torch.float32).reshape(R * nb, spec.block)
    u = _half_plane(R * nb, spec.block, xb.device)
    code, scale = _q.encode(xb, u, bits=spec.bits)
    return code.reshape(R, nb, spec.block), scale.reshape(R, nb, 1)


def decode_rows(code: torch.Tensor, scale: torch.Tensor, spec: KVQuantSpec,
                page_shape: Tuple[int, ...], dtype) -> torch.Tensor:
    """codes (..., nb, block) + scales (..., nb, 1) -> (..., *page_shape) in
    `dtype`: K2 gives f32, cast to the cache's dtype here."""
    lead = code.shape[:-2]
    rows = code.numel() // spec.block
    vals = _q.decode(code.reshape(rows, spec.block),
                     scale.reshape(rows, 1), bits=spec.bits)
    return vals.reshape(*lead, *page_shape).to(dtype)
