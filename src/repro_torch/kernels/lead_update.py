"""The LEAD iteration's two fused passes (K1, K3).

Replaces ``src/repro/kernels/lead_update.py``:

  * lead_diff_encode (K1) - pre-communication: diff = (X - eta G - eta D) - H
    and its blockwise quantization in one pass (reads X, G, D, H and the
    dither, writes int8 codes and one scale per row);
  * lead_update (K3) - post-communication: given decoded Qh and W Qh,
    updates X, D, H, H_w in one pass (Alg. 1 lines 5-7).

Scalars (eta, gamma, alpha) are 0-d f32 tensors on the planes' device (or
python floats): the kernels read them through device pointers, so a
schedule resolved on the device costs no host sync.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.quantize import DEFAULT_BLOCK
from repro_torch.kernels.ref import lead_diff_encode_ref as lead_diff_encode_plain
from repro_torch.kernels.ref import lead_update_ref as lead_update_plain


def _scalar(v, device: torch.device, name: str) -> torch.Tensor:
    """A 0-d f32 tensor on `device`: tensors are checked, floats are filled
    on the device (no host-to-device copy)."""
    if isinstance(v, torch.Tensor):
        if v.device != device or v.numel() != 1:
            raise ValueError(f"{name}: expected a one-element tensor on "
                             f"{device}, got {tuple(v.shape)} on {v.device}")
        return v.reshape(()).to(torch.float32).contiguous()
    return torch.full((), float(v), dtype=torch.float32, device=device)


def lead_update(x, g, d, h, hw, qh, wqh, eta, gamma, alpha):
    """All planes (rows, block) f32.  Returns (x_new, d_new, h_new, hw_new).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    planes = (x, g, d, h, hw, qh, wqh)
    if not use_kernel(*planes):
        return tuple(lead_update_plain(x, g, d, h, hw, qh, wqh, eta, gamma,
                                       alpha))
    for name, t in zip(("x", "g", "d", "h", "hw", "qh", "wqh"), planes):
        cuda_lib.check_operand(t, name, torch.float32, x.shape)
    if x.numel() % 4:
        raise ValueError(f"lead_update: {x.numel()} elements is not a "
                         "multiple of 4")
    dev = x.device
    eta_t, gamma_t, alpha_t = (_scalar(v, dev, n) for v, n in
                               ((eta, "eta"), (gamma, "gamma"),
                                (alpha, "alpha")))
    outs = tuple(torch.empty_like(x) for _ in range(4))
    rc = cuda_lib.library().repro_lead_update(
        *(t.data_ptr() for t in planes),
        eta_t.data_ptr(), gamma_t.data_ptr(), alpha_t.data_ptr(),
        *(o.data_ptr() for o in outs), x.numel(), cuda_lib.stream_handle())
    cuda_lib.LAUNCHES["lead_update"] += 1
    cuda_lib.check_launch(rc, "lead_update")
    return outs


def lead_diff_encode(x, g, d, h, u, eta, *, bits: int = 2):
    """Fused Y-difference + quantization (pre-communication pass).

    x, g, d, h, u: (rows, 512) f32.  Returns (code int8, scale (rows,1) f32).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not 1 <= bits <= 7:
        raise ValueError("int8 code container supports bits in [1, 7]")
    planes = (x, g, d, h, u)
    if not use_kernel(*planes):
        return lead_diff_encode_plain(x, g, d, h, u, eta, bits)
    rows, block = x.shape
    if block != DEFAULT_BLOCK:
        raise ValueError(f"the kernel maps one warp to a {DEFAULT_BLOCK}-"
                         f"element row; got block={block}")
    for name, t in zip(("x", "g", "d", "h", "u"), planes):
        cuda_lib.check_operand(t, name, torch.float32, x.shape)
    eta_t = _scalar(eta, x.device, "eta")
    code = torch.empty((rows, block), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    rc = cuda_lib.library().repro_lead_diff_encode(
        *(t.data_ptr() for t in planes), eta_t.data_ptr(), code.data_ptr(),
        scale.data_ptr(), rows, bits, cuda_lib.stream_handle())
    cuda_lib.LAUNCHES["lead_diff_encode"] += 1
    cuda_lib.check_launch(rc, "lead_diff_encode")
    return code, scale
