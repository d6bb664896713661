"""Blockwise inf-norm b-bit stochastic quantization: encode (K4) and the
receiver's decode (K2).

Replaces ``src/repro/kernels/quantize.py``.  The quantization block (the
paper's 512 contiguous elements) is one row of a (rows, 512) plane.  The
dither u arrives as an input, so the kernel and its plain version see the
same random numbers.  LEAD encodes through the fused
``lead_update.lead_diff_encode`` (K1), which quantizes with the same row
routine as K4 (``csrc/quantize_row.cuh``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.ref import quantize_decode_ref as decode_plain
from repro_torch.kernels.ref import quantize_encode_ref as encode_plain

DEFAULT_BLOCK = 512     # paper's quantization block
DEFAULT_TILE_B = 256    # the reference's rows per grid step; the flat
                        # engine pads nb to it so state shapes compare


def encode(x: torch.Tensor, u: torch.Tensor, *, bits: int = 2):
    """x, u: (rows, 512) f32 -> (code int8 (rows, 512), scale f32 (rows, 1)).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not 1 <= bits <= 7:
        raise ValueError("int8 code container supports bits in [1, 7]")
    if not use_kernel(x, u):
        return encode_plain(x, u, bits)
    rows, block = x.shape
    if block != DEFAULT_BLOCK:
        raise ValueError(f"the kernel maps one warp to a {DEFAULT_BLOCK}-"
                         f"element row; got block={block}")
    cuda_lib.check_operand(x, "x", torch.float32, (rows, block))
    cuda_lib.check_operand(u, "u", torch.float32, (rows, block))
    code = torch.empty((rows, block), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    rc = cuda_lib.library().repro_quantize_encode(
        x.data_ptr(), u.data_ptr(), code.data_ptr(), scale.data_ptr(), rows,
        bits, cuda_lib.stream_handle())
    cuda_lib.LAUNCHES["quantize_encode"] += 1
    cuda_lib.check_launch(rc, "quantize_encode")
    return code, scale


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
