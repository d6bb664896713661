"""Public wrappers around the kernels for arrays of any shape.

They do the bookkeeping the kernels do not: flattening to the
(n_blocks, block) layout, padding to the reference's tile multiples (so
shapes compare directly with ``src/repro/kernels/ops.py``), the dither and
unpadding.  Zero rows are a fixed point of every kernel, so the padding
never leaks into the result.  ``pack_codes``/``unpack_codes`` give the
wire-accurate bit packing of the quantizer's codes.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import lead_update as _lu
from repro_torch.kernels import quantize as _q

DEFAULT_BLOCK = _q.DEFAULT_BLOCK


def _to_blocks(x: torch.Tensor, block: int, tile_b: int):
    """Flatten + pad to (nb, block) with nb a multiple of tile_b."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    nb = -(-n // block)
    nb_pad = -(-nb // tile_b) * tile_b
    flat = F.pad(flat, (0, nb_pad * block - n))
    return flat.reshape(nb_pad, block), n


def _from_blocks(blocks: torch.Tensor, n: int, shape, dtype):
    return blocks.reshape(-1)[:n].reshape(shape).to(dtype)


def _pick_tile(n_elements: int, block: int, tile_b: int) -> int:
    """Shrink the tile for small inputs so padding stays bounded."""
    nb = max(1, -(-n_elements // block))
    t = tile_b
    while t > 1 and t > nb:
        t //= 2
    return t


def _dither(shape, u: Optional[torch.Tensor],
            generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The given dither plane `u`, or one drawn U[0, 1) from `generator`;
    exactly one of the two."""
    if (u is None) == (generator is None):
        raise ValueError("give exactly one of u= or generator=")
    if u is None:
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=device)
    return u


def quantize_encode(x: torch.Tensor, *, u: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    bits: int = 2, block: int = DEFAULT_BLOCK,
                    tile_b: int = _q.DEFAULT_TILE_B):
    """Quantize any-shape x; returns (code (nb, block) int8, scale (nb,1)
    f32).  Blocks are the wire payload; decode with the original shape.

    The dither is either given as `u`, a (nb, block) plane in the padded
    block layout, or drawn U[0, 1) from `generator`; give exactly one."""
    tile_b = _pick_tile(x.numel(), block, tile_b)
    xb, _ = _to_blocks(x, block, tile_b)
    u = _dither(xb.shape, u, generator, xb.device)
    return _q.encode(xb, u, bits=bits)


def quantize_decode(code, scale, *, shape, bits: int = 2,
                    dtype=torch.float32):
    """Decode (nb, block) codes back to an array of `shape`."""
    n = 1
    for s in shape:
        n *= int(s)
    vals = _q.decode(code, scale, bits=bits)
    return _from_blocks(vals, n, shape, dtype)


def lead_update_flat(x, g, d, h, hw, qh, wqh, eta, gamma, alpha, *,
                     tile_b: int = _q.DEFAULT_TILE_B):
    """Fused LEAD post-comm update on flat 1-D vectors (any length)."""
    n = x.shape[0]
    tile_b = _pick_tile(n, DEFAULT_BLOCK, tile_b)
    blocks = [_to_blocks(a, DEFAULT_BLOCK, tile_b)[0]
              for a in (x, g, d, h, hw, qh, wqh)]
    outs = _lu.lead_update(*blocks, eta, gamma, alpha)
    return tuple(_from_blocks(o, n, (n,), x.dtype) for o in outs)


def lead_diff_encode_flat(x, g, d, h, eta, *, u: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          bits: int = 2, tile_b: int = _q.DEFAULT_TILE_B):
    """Fused pre-comm pass on flat 1-D vectors; returns (code, scale).

    The dither is either given as `u`, a (nb, block) plane in the padded
    block layout, or drawn U[0, 1) from `generator`; give exactly one."""
    n = x.shape[0]
    tile_b = _pick_tile(n, DEFAULT_BLOCK, tile_b)
    xb, gb, db, hb = (_to_blocks(a, DEFAULT_BLOCK, tile_b)[0]
                      for a in (x, g, d, h))
    u = _dither(xb.shape, u, generator, xb.device)
    return _lu.lead_diff_encode(xb, gb, db, hb, u, eta, bits=bits)


def pack_codes(code: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack b-bit signed codes (stored in int8 lanes) into dense uint32
    words: each code is a (bits+1)-bit two's-complement field, 32 //
    (bits+1) fields per word, the last word zero-padded - the wire
    accounting that QuantizePNorm.wire_bits charges.  The fields do not
    overlap, so their sum is their bitwise or; it is taken in int64 and the
    low 32 bits kept.  ``unpack_codes(pack_codes(c, b), c.numel(), b)``
    gives c back exactly."""
    width = bits + 1
    per32 = 32 // width
    flat = code.reshape(-1).to(torch.int64) & ((1 << width) - 1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % per32))
    shifts = torch.arange(per32, dtype=torch.int64,
                          device=code.device) * width
    words = (flat.reshape(-1, per32) << shifts[None, :]).sum(dim=1)
    return words.to(torch.uint32)


def unpack_codes(packed: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """The first `n` int8 codes of the uint32 words from pack_codes."""
    width = bits + 1
    per32 = 32 // width
    shifts = torch.arange(per32, dtype=torch.int64,
                          device=packed.device) * width
    fields = (packed.to(torch.int64)[:, None] >> shifts[None, :]) \
        & ((1 << width) - 1)
    sign = 1 << (width - 1)                 # sign-extend the width-bit field
    vals = (fields ^ sign) - sign
    return vals.reshape(-1)[:n].to(torch.int8)
