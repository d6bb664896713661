// Hopper (sm_90a) kernels for the compressed wires of the paper's baselines:
// the blockwise p=inf b-bit quantizer's encode (K4), the shared-seed random-k
// keep pass (K5) and the top-k mask pass (K6).  Every kernel works on f32
// (rows, block) planes, rows = n_agents * nb, in the layout of the flat
// engine; K4 takes the paper's block of 512 on its hot path and any width
// >= 1 otherwise, K5 and K6 are elementwise.
//
// Built with lead_kernels.cu into one shared library with a plain C
// interface by repro_torch/kernels/cuda_lib.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false), loaded through
// ctypes.  Every floating-point operation is an explicit round-to-nearest
// intrinsic in the plain PyTorch version's order (repro_torch/kernels/ref.py),
// so each kernel is bit-identical to its plain version on the same card.
//
// Each C entry point launches on the caller's stream, allocates nothing and
// returns the first CUDA error of the launch (0 = the launch was accepted).

#include <cuda_runtime.h>
#include <stdint.h>

#include "quantize_row.cuh"
#include "stream_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// K4 quantize encode.  Replaces src/repro/kernels/quantize.py::encode
// (_encode_kernel).  Bound: bytes.  Per element it reads x and u (8 B) and
// writes one int8 code (1 B), plus one f32 scale per 512-element row:
// 9 B/element + 4 B/row.
// Design: K1 without the difference.  One warp per row: each lane loads 16
// floats of x as four float4 loads at lane-contiguous addresses, and the
// row max, the dither read and the code pass are quantize_row(), the very
// routine K1 runs, so K1 and K4 give the same codes for the same values.
// The TPU kernel's 256-row VMEM tile is not carried over: rows need no tile
// multiple, and a warp exits as a whole past the last row.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
quantize_encode_kernel(const float* __restrict__ x,
                       const float* __restrict__ u,
                       signed char* __restrict__ code,
                       float* __restrict__ scale, long long rows, int bits) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= rows) return;                  // whole warps exit together
  const long long base4 = row * (kBlock / 4);

  float v[kValsPerLane];
#pragma unroll
  for (int j = 0; j < kVec4PerLane; ++j) {
    const float4 xv = load4(x, base4 + j * kWarp + lane);
    v[4 * j + 0] = xv.x;
    v[4 * j + 1] = xv.y;
    v[4 * j + 2] = xv.z;
    v[4 * j + 3] = xv.w;
  }
  quantize_row(v, u, code, scale, row, base4, lane, bits);
}

// K4 at any other block width: the same warp per row through
// quantize_row_any(), which reads each element of x once per pass.
struct PlaneValues {
  const float* __restrict__ x;
  __device__ __forceinline__ float operator()(long long i) const {
    return __ldg(x + i);
  }
};

__global__ void __launch_bounds__(kThreads)
quantize_encode_any_kernel(const float* __restrict__ x,
                           const float* __restrict__ u,
                           signed char* __restrict__ code,
                           float* __restrict__ scale, long long rows,
                           long long block, int bits) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= rows) return;                  // whole warps exit together
  quantize_row_any(PlaneValues{x}, u, code, scale, row, block, lane, bits);
}

// ---------------------------------------------------------------------------
// K5 randk encode.  Replaces src/repro/kernels/sparsify.py::randk_encode
// (_randk_kernel).  Bound: bytes.  Reads x and u, writes the kept values:
// 12 B/element.
// Design: a grid-stride pass of 4 elements per thread, float4 loads of x
// and u and a float4 store.  The keep mask u < ratio is formed in registers
// and never written.  ratio and scale arrive as f32, rounded on the host
// from the reference's Python floats (scale = 1/ratio in double, then
// rounded), which is what the TPU kernel's f32 operands are.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float keep(float x, float u, float ratio,
                                      float scale) {
  return u < ratio ? __fmul_rn(x, scale) : 0.f;
}

__global__ void __launch_bounds__(kThreads)
randk_encode_kernel(const float* __restrict__ x, const float* __restrict__ u,
                    float* __restrict__ out, long long n4, float ratio,
                    float scale) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += stride) {
    const float4 xv = load4(x, i), uv = load4(u, i);
    float4 o;
    o.x = keep(xv.x, uv.x, ratio, scale);
    o.y = keep(xv.y, uv.y, ratio, scale);
    o.z = keep(xv.z, uv.z, ratio, scale);
    o.w = keep(xv.w, uv.w, ratio, scale);
    reinterpret_cast<float4*>(out)[i] = o;
  }
}

// ---------------------------------------------------------------------------
// K6 mask apply.  Replaces src/repro/kernels/sparsify.py::mask_apply
// (_mask_apply_kernel).  Bound: bytes.  Reads x and the f32 0/1 mask, writes
// x * mask: 12 B/element.
// Design: the TMA pipeline of stream_tiles.cuh: one CTA per run of four
// 16 KB tiles of each plane, with four stages, so the whole run is in
// flight from the start (131 KB of shared memory, one CTA per SM at a
// time); the product is formed in shared memory in place of the x tile,
// which a bulk copy stores.  Run length, stages and tile size were chosen
// on an H100 by scripts/mask_apply_designs.py: longer runs through the
// refilled ring, and a persistent grid, measured slower.
// The mask stays the reference's f32 plane (a byte mask would cut 3 of the
// 12 B/element and is left to a later change).
// ---------------------------------------------------------------------------
constexpr int kMaskTileBytes = 16 * 1024;
constexpr int kMaskStages = 4;
constexpr int kMaskRunTiles = 4;

struct MaskApply {
  __device__ __forceinline__ float4 operator()(const float4 (&v)[2]) const {
    return make_float4(__fmul_rn(v[0].x, v[1].x), __fmul_rn(v[0].y, v[1].y),
                       __fmul_rn(v[0].z, v[1].z), __fmul_rn(v[0].w, v[1].w));
  }
};

}  // namespace

extern "C" {

// block == 512 takes the register-resident hot path, any other width >= 1
// the strided one.
int repro_quantize_encode(const void* x, const void* u, void* code,
                          void* scale, long long rows, long long block,
                          int bits, void* stream) {
  if (rows > 0 && block == kBlock) {
    quantize_encode_kernel<<<grid_for_rows(rows), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(u),
        static_cast<signed char*>(code), static_cast<float*>(scale), rows,
        bits);
  } else if (rows > 0 && block > 0) {
    quantize_encode_any_kernel<<<grid_for_rows(rows), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(u),
        static_cast<signed char*>(code), static_cast<float*>(scale), rows,
        block, bits);
  }
  return static_cast<int>(cudaGetLastError());
}

int repro_randk_encode(const void* x, const void* u, void* out, long long n,
                       float ratio, float scale, void* stream) {
  const long long n4 = n / 4;
  if (n4 > 0) {
    randk_encode_kernel<<<grid_for(n4), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(u),
        static_cast<float*>(out), n4, ratio, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

int repro_mask_apply(const void* x, const void* mask, void* out, long long n,
                     void* stream) {
  StreamPlanes<2> planes{{static_cast<const float*>(x),
                          static_cast<const float*>(mask)},
                         static_cast<float*>(out)};
  return static_cast<int>(
      launch_stream_tiles<2, kMaskTileBytes, kMaskStages, kMaskRunTiles>(
          planes, n, MaskApply{}, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
