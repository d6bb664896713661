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
(rows, block=512) planes, rows = n_agents * nb, and zero rows are a fixed
point of every kernel.
"""
