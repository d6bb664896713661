"""Where the port's entry points run.

Entry points run on the card unless the caller passes ``device="cpu"`` (as
the CPU tests do).  Asking for the card where there is none raises: nothing
in the port carries on on the CPU when no GPU is found.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device, "cuda" when None.  On the card it turns
    TF32 off for matmuls and convolutions: the reference computes in full
    fp32, and TF32 keeps only about three decimal digits."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
