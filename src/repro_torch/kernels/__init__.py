"""Hopper kernels of the port and their plain PyTorch versions.

    ref.py          plain versions (the math of src/repro/kernels/ref.py)
    dispatch.py     CPU tensor -> plain version, CUDA tensor -> kernel
    cuda_lib.py     nvcc build of csrc/*.cu into one library, ctypes
                    loading, launch counts
    quantize.py     encode (K4), decode (K2)
    lead_update.py  lead_diff_encode (K1), lead_update (K3)
    sparsify.py     randk_encode (K5), mask_apply (K6)
    ops.py          any-shape wrappers: blocking, tile padding, dither,
                    code bit packing

Layout contract (the reference's): every kernel works row-wise on f32
(rows, block) planes, rows = n_agents * nb, and zero rows are a fixed
point of every kernel.  The quantizer's kernels (K1, K2, K4) take any
block >= 1; block 512, the paper's, is their hot path.

The package re-exports the reference's kernel entry points
(``src/repro/kernels/__init__.py``) that the port has; ``quantize_roundtrip``
belongs with the torch.distributed trainer and is not ported yet, and the
backend resolvers have no counterpart (a tensor's device picks the backend).
"""
from repro_torch.kernels import dispatch, ops, ref, sparsify
from repro_torch.kernels.ops import (
    lead_diff_encode_flat, lead_update_flat, pack_codes, quantize_decode,
    quantize_encode, unpack_codes,
)
from repro_torch.kernels.sparsify import mask_apply, randk_encode

__all__ = ["dispatch", "lead_diff_encode_flat", "lead_update_flat",
           "mask_apply", "ops", "pack_codes", "quantize_decode",
           "quantize_encode", "randk_encode", "ref", "sparsify",
           "unpack_codes"]
