"""Kernel dispatch by the tensor's device.

Every kernel entry point in this package resolves its backend from the
tensors it is given, and from nothing else:

    CPU tensors    the plain PyTorch version (kernels/ref.py): the CPU
                   tests, and the reference the kernels are held against;
    CUDA tensors   the hand-written Hopper kernel (csrc/*.cu).

There is no override.  A CUDA tensor launches its kernel or raises; it
never falls back to the plain version.
"""
from __future__ import annotations

import torch


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on one CUDA device (launch the kernel),
    False when they lie on the CPU (run the plain version).  Mixed devices
    and any other device type raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs span several devices: {devices}")
    device = devices.pop()
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain version for device {device}")
