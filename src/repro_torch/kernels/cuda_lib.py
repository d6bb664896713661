"""Build, load and launch-check the port's CUDA kernels.

``csrc/lead_kernels.cu`` is compiled with nvcc for ``sm_90a`` into a shared
library with a plain C interface and loaded with ctypes.  The build happens
at first use, into ``build/kernels/`` at the root of the checkout, under a
name keyed by a hash of the source and the flags, so a changed source
rebuilds and an unchanged one loads at once.  Nothing here runs at import:
the CPU tests import every module on a machine without nvcc.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a run
resets it and reads it back to show which path it went through.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "lead_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# -fmad=false: no FP contraction, which would flip knife-edge codes; no
# --use_fast_math, so the divide stays IEEE round-to-nearest
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = {"lead_diff_encode": 0, "quantize_decode": 0, "lead_update": 0}

_P = ctypes.c_void_p
_SIGNATURES = {
    # x, g, d, h, u, eta, code, scale, rows, bits, stream
    "repro_lead_diff_encode": [_P] * 8 + [ctypes.c_longlong, ctypes.c_int, _P],
    # code, scale, out, rows, block, bits, stream
    "repro_quantize_decode": [_P] * 3 + [ctypes.c_longlong, ctypes.c_longlong,
                                         ctypes.c_int, _P],
    # x, g, d, h, hw, qh, wqh, eta, gamma, alpha, xo, do, ho, hwo, n, stream
    "repro_lead_update": [_P] * 14 + [ctypes.c_longlong, _P],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           f"{SOURCE} with the CUDA toolkit")
    return path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source has no build.
    The build writes a temporary file and renames it, so concurrent
    processes never load a half-written library."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lead_kernels_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".lead_kernels_{tag}.{os.getpid()}.so"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype,
                  shape) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`,
    16-byte aligned for the kernels' vector loads."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc} ({torch.cuda.get_device_name()})")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream
