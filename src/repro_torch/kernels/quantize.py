"""Receiver decode of the blockwise inf-norm b-bit quantizer (K2).

Replaces ``src/repro/kernels/quantize.py::decode``.  The quantization block
(the paper's 512 contiguous elements) is one row of a (rows, 512) plane.
The encode (``quantize.py::encode``, K4) is not ported yet: LEAD's main path
encodes through the fused ``lead_update.lead_diff_encode``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.ref import quantize_decode_ref as decode_plain

DEFAULT_BLOCK = 512     # paper's quantization block
DEFAULT_TILE_B = 256    # the reference's rows per grid step; the flat
                        # engine pads nb to it so state shapes compare


def decode(code: torch.Tensor, scale: torch.Tensor, *,
           bits: int = 2) -> torch.Tensor:
    """code: (rows, block) int8, scale: (rows, 1) f32 -> (rows, block) f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not use_kernel(code, scale):
        return decode_plain(code, scale, bits)
    rows, block = code.shape
    if block % 4:
        raise ValueError(f"block={block} must be a multiple of 4")
    cuda_lib.check_operand(code, "code", torch.int8, (rows, block))
    cuda_lib.check_operand(scale, "scale", torch.float32, (rows, 1))
    out = torch.empty((rows, block), dtype=torch.float32, device=code.device)
    rc = cuda_lib.library().repro_quantize_decode(
        code.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, block, bits,
        cuda_lib.stream_handle())
    cuda_lib.LAUNCHES["quantize_decode"] += 1
    cuda_lib.check_launch(rc, "quantize_decode")
    return out
