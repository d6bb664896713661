"""Public wrappers around the kernels for arrays of any shape.

They do the bookkeeping the kernels do not: flattening to the
(n_blocks, block) layout, padding to the reference's tile multiples (so
shapes compare directly with ``src/repro/kernels/ops.py``), the dither and
unpadding.  Zero rows are a fixed point of every kernel, so the padding
never leaks into the result.  ``quantize_encode``, ``pack_codes`` and
``unpack_codes`` are not ported yet.
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
    if (u is None) == (generator is None):
        raise ValueError("give exactly one of u= or generator=")
    n = x.shape[0]
    tile_b = _pick_tile(n, DEFAULT_BLOCK, tile_b)
    xb, gb, db, hb = (_to_blocks(a, DEFAULT_BLOCK, tile_b)[0]
                      for a in (x, g, d, h))
    if u is None:
        u = torch.rand(xb.shape, generator=generator, dtype=torch.float32,
                       device=xb.device)
    return _lu.lead_diff_encode(xb, gb, db, hb, u, eta, bits=bits)
