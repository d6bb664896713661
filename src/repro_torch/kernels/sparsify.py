"""The sparsifying compressors' wire passes: randk_encode (K5) and
mask_apply (K6).

Replaces ``src/repro/kernels/sparsify.py``.  Two elementwise passes over
the kernels' (rows, block) layout:

  * randk_encode - shared-seed random-k: keep = (u < ratio) formed in the
    pass (no mask plane is written), values x * (1/ratio) where kept.  The
    receiver rebuilds the mask from the shared seed, so the kept values are
    the whole payload (paper App. C.2);
  * mask_apply - top-k: x * mask for the exact-k 0/1 f32 mask that the
    caller builds from ``torch.topk`` indices.

CPU tensors take the plain versions (kernels/ref.py); CUDA tensors launch
the kernels (csrc/wire_kernels.cu) or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.quantize import DEFAULT_TILE_B
from repro_torch.kernels.ref import mask_apply_ref as mask_apply_plain
from repro_torch.kernels.ref import randk_encode_ref as randk_encode_plain


def _fit_tile(nb: int, tile_b: int = DEFAULT_TILE_B) -> int:
    """Largest power-of-two tile <= tile_b that divides nb (>= 1): the
    reference's grid constraint, kept so that callers can size buffers as
    it does.  The kernels here need no tile multiple."""
    t = min(tile_b, nb)
    while t > 1 and nb % t:
        t //= 2
    return max(t, 1)


def _check_planes(name: str, x: torch.Tensor, other: torch.Tensor,
                  other_name: str) -> None:
    cuda_lib.check_operand(x, "x", torch.float32, x.shape)
    cuda_lib.check_operand(other, other_name, torch.float32, x.shape)
    if x.numel() % 4:
        raise ValueError(f"{name}: {x.numel()} elements is not a multiple "
                         "of 4")


def randk_encode(x: torch.Tensor, u: torch.Tensor, *, ratio: float,
                 rescale: bool = True) -> torch.Tensor:
    """x, u: (rows, block) f32.  Returns the kept-value plane:
    x * (1/ratio if rescale else 1) where u < ratio, else 0.

    ratio and the scale reach the kernel as f32, rounded from the Python
    floats (the scale divided in double first), as the reference's Pallas
    kernel takes them."""
    scale = (1.0 / ratio) if rescale else 1.0
    if not use_kernel(x, u):
        return randk_encode_plain(x, u, ratio, scale)
    _check_planes("randk_encode", x, u, "u")
    out = torch.empty_like(x)
    rc = cuda_lib.library().repro_randk_encode(
        x.data_ptr(), u.data_ptr(), out.data_ptr(), x.numel(), ratio, scale,
        cuda_lib.stream_handle())
    cuda_lib.LAUNCHES["randk_encode"] += 1
    cuda_lib.check_launch(rc, "randk_encode")
    return out


def mask_apply(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x: (rows, block) f32, mask: same-shape f32 0/1 plane -> x * mask."""
    if not use_kernel(x, mask):
        return mask_apply_plain(x, mask)
    _check_planes("mask_apply", x, mask, "mask")
    out = torch.empty_like(x)
    rc = cuda_lib.library().repro_mask_apply(
        x.data_ptr(), mask.data_ptr(), out.data_ptr(), x.numel(),
        cuda_lib.stream_handle())
    cuda_lib.LAUNCHES["mask_apply"] += 1
    cuda_lib.check_launch(rc, "mask_apply")
    return out
