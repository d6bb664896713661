#!/usr/bin/env python3
"""Time designs of K6 mask_apply (out = x * mask, f32) against each other
and against torch.mul(x, mask) on one NVIDIA Hopper GPU.

    PYTHONPATH=src python3 scripts/mask_apply_designs.py [--check]

The port ships one design: sparsify.mask_apply, which launches the kernel of
src/repro_torch/csrc/wire_kernels.cu on the TMA pipeline of
csrc/stream_tiles.cuh (timed here as "K6").  This script builds, beside it,
the designs it was chosen from, into build/designs/ with the port's nvcc
flags and -Xptxas -v, and prints that report and the one of
csrc/wire_kernels.cu as shipped:

  grid_stride   K6's earlier design: a grid-stride float4 loop, at most 16
                CTAs of 256 threads per SM
  reg4          one wave of resident CTAs, each thread issuing 4 float4
                loads of x and 4 of mask (__ldcs, streaming) before its
                4 stores (__stcs, evict-first)
  chunk2        torch.mul's own shape on sm_90: a CTA of 128 threads per
                4 KB of each plane, two float4 of each input a thread
  persistent    the TMA pipeline with one CTA per SM walking tiles b,
                b + grid, ... (16 KB tiles, 4 stages)
  ticket        the same persistent grid taking its tiles in address order
                from a global ticket (atomicAdd on a zeroed counter)
  run_T_S_R     stream_tiles.cuh with other sizes than K6's (16 KB tiles,
                4 stages, runs of 4): one CTA per run of R tiles of T KB, S
                stages (R > S refills the ring)

Every design is first held bit for bit against torch.mul at a few ragged
shapes and at the real size (2^28 elements: the TopK wire's plane at n = 8,
d = 2^25), its output's memory poisoned with NaN.  Then (unless --check)
all designs and torch.mul are timed at the real size in turns, forward then
backward; a turn is the median over 20 repetitions of the device time of 10
launches queued back to back behind one untimed launch (CUDA events), so
no host-side launch cost enters; a design's time is the mean of its two
turns.  Prints the card's name and power limit and one JSON line per design.
"""
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels import sparsify  # noqa: E402

ROWS, BLOCK = 8 * 65536, 512
REPS, BATCH = 20, 10
HBM_BPS = 3.35e12            # H100 SXM data sheet
RUNS = [(16, 2, 2), (8, 4, 4), (32, 3, 3), (16, 4, 8), (16, 4, 16)]  # T KB, S, R
TICKET = "ticket"            # the one design that takes a zeroed counter

SOURCE = r"""
#include <cuda_runtime.h>
#include "stream_tiles.cuh"

namespace {
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                     __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
}
struct MaskApply {
  __device__ __forceinline__ float4 operator()(const float4 (&v)[2]) const {
    return mul4(v[0], v[1]);
  }
};

int sms() {
  int dev = 0, n = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

__global__ void __launch_bounds__(256)
grid_stride_kernel(const float4* __restrict__ x, const float4* __restrict__ m,
                   float4* __restrict__ out, long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x; i < n4; i += stride)
    out[i] = mul4(__ldg(x + i), __ldg(m + i));
}

__global__ void __launch_bounds__(256)
reg4_kernel(const float4* __restrict__ x, const float4* __restrict__ m,
            float4* __restrict__ out, long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    float4 xv[4], mv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      xv[k] = __ldcs(x + i + k * stride);
      mv[k] = __ldcs(m + i + k * stride);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) __stcs(out + i + k * stride, mul4(xv[k], mv[k]));
  }
  for (; i < n4; i += stride) __stcs(out + i, mul4(__ldcs(x + i), __ldcs(m + i)));
}

__device__ __forceinline__ float4 ld4(const float4* p) {
  float4 v;
  asm volatile("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

__global__ void __launch_bounds__(128)
chunk2_kernel(const float4* __restrict__ x, const float4* __restrict__ m,
              float4* __restrict__ out, long long n4) {
  const long long base = static_cast<long long>(blockIdx.x) * 256;
  float4 xv[2], mv[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const long long i = base + k * 128 + threadIdx.x;
    if (i < n4) { xv[k] = ld4(x + i); mv[k] = ld4(m + i); }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const long long i = base + k * 128 + threadIdx.x;
    if (i < n4) out[i] = mul4(xv[k], mv[k]);
  }
}

// The persistent forms of the TMA pipeline: one CTA per SM, 16 KB tiles,
// 4 stages; tile i of a CTA is b + i * grid (kTicket false) or the next
// value of a global counter (kTicket true, tiles in address order).
constexpr int kT = 16 * 1024, kS = 4;

template <bool kTicket>
__global__ void __launch_bounds__(kStreamThreads)
persistent_kernel(StreamPlanes<2> planes, long long bytes,
                  unsigned long long* counter) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kS * 2 * kT);
  __shared__ long long tile_of[kS];
  const long long tiles = (bytes + kT - 1) / kT;
  const bool leader = threadIdx.x == 0;
  long long next = blockIdx.x;
  auto fill = [&](int s) {           // the CTA's next tile into stage s
    long long t = next;
    if (kTicket) t = static_cast<long long>(atomicAdd(counter, 1ULL));
    next += gridDim.x;
    tile_of[s] = t;
    if (t >= tiles) {                // none left: release the stage empty
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                       smem_addr(&full[s])) : "memory");
      return false;
    }
    const long long left = bytes - t * kT;
    const uint32_t nb = static_cast<uint32_t>(left < kT ? left : kT);
    mbar_expect_tx(&full[s], nb * 2);
    for (int j = 0; j < 2; ++j)
      bulk_load(smem + (s * 2 + j) * kT,
                reinterpret_cast<const unsigned char*>(planes.in[j]) + t * kT,
                nb, &full[s]);
    return true;
  };
  bool more = true;
  if (leader) {
    for (int s = 0; s < kS; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kS && more; ++s) more = fill(s);
  }
  __syncthreads();
  for (int i = 0;; ++i) {
    const int s = i % kS;
    mbar_wait(&full[s], (i / kS) & 1);
    const long long t = tile_of[s];
    if (t >= tiles) break;
    float4* dst = reinterpret_cast<float4*>(smem + s * 2 * kT);
    const float4* msk = reinterpret_cast<const float4*>(smem + (s * 2 + 1) * kT);
    const long long left = bytes - t * kT;
    const uint32_t nb = static_cast<uint32_t>(left < kT ? left : kT);
    for (int k = threadIdx.x; k < static_cast<int>(nb / 16); k += kStreamThreads)
      dst[k] = mul4(dst[k], msk[k]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (leader) {
      bulk_store(reinterpret_cast<unsigned char*>(planes.out) + t * kT, dst, nb);
      if (i >= 1 && more) {
        bulk_wait_read<1>();
        more = fill((i - 1) % kS);
      }
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <bool kTicket>
int persistent(const void* x, const void* m, void* out, long long n,
               void* counter, void* s) {
  StreamPlanes<2> p{{(const float*)x, (const float*)m}, (float*)out};
  auto kernel = persistent_kernel<kTicket>;
  const int smem = stream_smem_bytes<2, kT, kS>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (n * 4 + kT - 1) / kT, cap = sms();
  kernel<<<static_cast<unsigned>(tiles < cap ? tiles : cap), kStreamThreads,
           smem, (cudaStream_t)s>>>(p, n * 4, (unsigned long long*)counter);
  return cudaGetLastError();
}
}  // namespace

extern "C" {
int grid_stride(const void* x, const void* m, void* out, long long n, void* s) {
  const long long n4 = n / 4, need = (n4 + 255) / 256, cap = sms() * 16LL;
  const unsigned grid = static_cast<unsigned>(need < cap ? need : cap);
  grid_stride_kernel<<<grid, 256, 0, (cudaStream_t)s>>>(
      (const float4*)x, (const float4*)m, (float4*)out, n4);
  return cudaGetLastError();
}
int reg4(const void* x, const void* m, void* out, long long n, void* s) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reg4_kernel, 256, 0);
  const long long n4 = n / 4, need = (n4 + 255) / 256,
                  wave = static_cast<long long>(sms()) * per_sm;
  const unsigned grid = static_cast<unsigned>(need < wave ? need : wave);
  reg4_kernel<<<grid, 256, 0, (cudaStream_t)s>>>(
      (const float4*)x, (const float4*)m, (float4*)out, n4);
  return cudaGetLastError();
}
int chunk2(const void* x, const void* m, void* out, long long n, void* s) {
  const long long n4 = n / 4;
  chunk2_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 128, 0,
                  (cudaStream_t)s>>>(
      (const float4*)x, (const float4*)m, (float4*)out, n4);
  return cudaGetLastError();
}
int persistent_strided(const void* x, const void* m, void* out, long long n,
                       void* s) {
  return persistent<false>(x, m, out, n, nullptr, s);
}
int ticket(const void* x, const void* m, void* out, long long n,
           void* counter, void* s) {
  return persistent<true>(x, m, out, n, counter, s);
}
@RUNS@
}
"""

RUN_ENTRY = r"""
int run_%(t)d_%(s)d_%(r)d(const void* x, const void* m, void* out,
                          long long n, void* s) {
  StreamPlanes<2> p{{(const float*)x, (const float*)m}, (float*)out};
  return launch_stream_tiles<2, %(t)d * 1024, %(s)d, %(r)d>(
      p, n, MaskApply{}, (cudaStream_t)s);
}
"""


def report_shipped():
    """Print nvcc -Xptxas -v of csrc/wire_kernels.cu (K4, K5 and the shipped
    K6, stream_tiles_kernel), compiled alone with the port's flags."""
    res = subprocess.run(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         "-o", os.devnull, str(cuda_lib.CSRC / "wire_kernels.cu")],
        capture_output=True, text=True)
    print("wire_kernels.cu as shipped:\n" + res.stdout + res.stderr,
          flush=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed ({res.returncode})")


def build():
    src = SOURCE.replace("@RUNS@", "".join(
        RUN_ENTRY % dict(t=t, s=s, r=r) for t, s, r in RUNS))
    header = (cuda_lib.CSRC / "stream_tiles.cuh").read_bytes()
    tag = hashlib.sha256(src.encode() + header).hexdigest()[:16]
    out = os.path.join(ROOT, "build", "designs", tag)
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "designs.cu"), os.path.join(out, "designs.so")
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
         "-I", str(cuda_lib.CSRC), "-o", so, cu],
        capture_output=True, text=True)
    print(res.stdout + res.stderr, flush=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed ({res.returncode})")
    lib = ctypes.CDLL(so)
    names = (["grid_stride", "reg4", "chunk2", "persistent_strided", TICKET]
             + [f"run_{t}_{s}_{r}" for t, s, r in RUNS])
    fns = {}
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [
            ctypes.c_void_p] * (2 if name == TICKET else 1)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def caller(name, fn):
    """fn's launch on (x, m) into a new output, like the port's wrappers."""
    def call(x, m):
        out = torch.empty_like(x)
        extra = ()
        if name == TICKET:      # a zeroed tile counter for each launch
            extra = (torch.zeros(1, dtype=torch.int64,
                                 device=x.device).data_ptr(),)
        rc = fn(x.data_ptr(), m.data_ptr(), out.data_ptr(), x.numel(),
                *extra, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"{name}: launch failed with CUDA error {rc}")
        return out
    return call


def time_ms(fn):
    """Median over REPS of the device time of BATCH launches of fn queued
    back to back, divided by BATCH; one untimed launch ahead of the first
    event keeps the device busy while the host queues the rest."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        fn()
        a.record()
        for _ in range(BATCH):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / BATCH)
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        print("mask_apply_designs: no CUDA device is available",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report_shipped()
    calls = {name: caller(name, fn) for name, fn in build().items()}
    calls["K6"] = sparsify.mask_apply
    gen = torch.Generator("cuda").manual_seed(0)
    for shape in ((3, 20), (129, 512), (4097, 512), (ROWS, BLOCK)):
        x = torch.randn(shape, generator=gen, device="cuda")
        m = (torch.rand(shape, generator=gen, device="cuda") < 0.01).float()
        want = torch.mul(x, m)
        for name, call in calls.items():
            poison = torch.full_like(x, float("nan"))
            del poison
            got = call(x, m)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"{name} {shape}: differs from torch.mul")
            del got
        print(f"shape {shape}: every design equals torch.mul", flush=True)
    if "--check" in sys.argv[1:]:
        return 0

    calls["torch.mul"] = torch.mul
    order = list(calls)
    turns = {name: [] for name in order}
    for name in order + order[::-1]:
        turns[name].append(time_ms(lambda call=calls[name]: call(x, m)))
    bound_ms = 12 * x.numel() / HBM_BPS * 1e3
    for name in order:
        ms = sum(turns[name]) / 2
        print(json.dumps({"design": name, "ms": ms, "turns": turns[name],
                          "GBps": 12 * x.numel() / (ms * 1e-3) / 1e9,
                          "of_bound": bound_ms / ms, "bound_ms": bound_ms,
                          "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
