"""Build, load and launch-check the port's CUDA kernels.

The sources in ``csrc/`` (``lead_kernels.cu``: K1-K3; ``wire_kernels.cu``:
K4-K6; both include ``quantize_row.cuh``, and K6 runs on the TMA pipeline
of ``stream_tiles.cuh``) are compiled with nvcc for
``sm_90a``, one nvcc per source, all started together, and linked into one
shared library with a plain C interface, loaded with ctypes.  The build
happens at first use, into ``build/kernels/`` at the root of the checkout,
under a name keyed by a hash of every source and header and of the flags,
so a changed source rebuilds and an unchanged one loads at once.  Nothing
here runs at import: the CPU tests import every module on a machine
without nvcc.

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
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# compiled, one object each; the headers are included, and hashed
SOURCE = [CSRC / "lead_kernels.cu", CSRC / "wire_kernels.cu"]
HEADERS = [CSRC / "quantize_row.cuh", CSRC / "stream_tiles.cuh"]
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# -fmad=false: no FP contraction, which would flip knife-edge codes; no
# --use_fast_math, so the divide stays IEEE round-to-nearest
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                     "-fPIC")
LINK_FLAGS = ARCH + ("-shared",)

LAUNCHES = {"lead_diff_encode": 0, "quantize_decode": 0, "lead_update": 0,
            "quantize_encode": 0, "randk_encode": 0, "mask_apply": 0}

_P = ctypes.c_void_p
_SIGNATURES = {
    # x, g, d, h, u, eta, code, scale, rows, bits, stream
    "repro_lead_diff_encode": [_P] * 8 + [ctypes.c_longlong, ctypes.c_int, _P],
    # code, scale, out, rows, block, bits, stream
    "repro_quantize_decode": [_P] * 3 + [ctypes.c_longlong, ctypes.c_longlong,
                                         ctypes.c_int, _P],
    # x, g, d, h, hw, qh, wqh, eta, gamma, alpha, xo, do, ho, hwo, n, stream
    "repro_lead_update": [_P] * 14 + [ctypes.c_longlong, _P],
    # x, u, code, scale, rows, bits, stream
    "repro_quantize_encode": [_P] * 4 + [ctypes.c_longlong, ctypes.c_int, _P],
    # x, u, out, n, ratio, scale, stream (the floats rounded to f32 here)
    "repro_randk_encode": [_P] * 3 + [ctypes.c_longlong, ctypes.c_float,
                                      ctypes.c_float, _P],
    # x, mask, out, n, stream
    "repro_mask_apply": [_P] * 3 + [ctypes.c_longlong, _P],
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
                           f"{CSRC} with the CUDA toolkit")
    return path


def _run_all(cmds) -> None:
    """Start every command at once; raise with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [(p.communicate()[0], p.returncode) for p in procs]
    for (out, rc), cmd in zip(outs, cmds):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")


def build_tag() -> str:
    """Hash of every source and header in csrc/ and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in SOURCE + HEADERS:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if these sources have no
    build.  Each source compiles to its own object in a private temporary
    directory, all nvcc processes at once; the link writes a temporary
    file that is renamed into place, so concurrent processes never load a
    half-written library."""
    so = BUILD_DIR / f"repro_kernels_{build_tag()}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [Path(tmp) / f"{src.stem}.o" for src in SOURCE]
            _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                      for src, o in zip(SOURCE, objs)])
            lib = Path(tmp) / so.name
            _run_all([[nvcc, *LINK_FLAGS, "-o", str(lib),
                       *(str(o) for o in objs)]])
            os.replace(lib, so)
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
