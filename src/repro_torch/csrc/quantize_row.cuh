// Shared device code of the port's kernels: the (rows, block) row layout, the
// vector loads, the grid of the grid-stride passes, and the blockwise p=inf
// b-bit quantization of one row by one warp: quantize_row() for the paper's
// 512-element rows (the hot path, float4 loads, values in registers) and
// quantize_row_any() for a row of any other width.
//
// K1 (lead_kernels.cu, lead_diff_encode) and K4 (wire_kernels.cu,
// quantize_encode) both quantize through these routines, so the two cannot
// drift apart: for the same row values and dither they write the same codes
// and scale, bit for bit.
//
// Exactness.  The quantizer computes floor(2^{b-1} |v| / scale + u): an
// element sitting on a level boundary flips its code under any change of
// rounding.  Every floating-point operation is an explicit round-to-nearest
// intrinsic (__fmul_rn, __fdiv_rn, __fadd_rn), which nvcc never contracts
// into an FMA and which keeps the divide IEEE, in the operation order of the
// plain PyTorch version (repro_torch/kernels/ref.py::quantize_encode_ref).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 512;                 // the paper's block: the hot path
constexpr int kWarp = 32;
constexpr int kVec4PerLane = kBlock / (4 * kWarp);   // 4 float4 per lane
constexpr int kValsPerLane = 4 * kVec4PerLane;       // 16 floats per lane
constexpr int kRowsPerCta = 8;              // 8 warps = 256 threads
constexpr int kThreads = 256;

__device__ __forceinline__ float4 load4(const float* p, long long i4) {
  return __ldg(reinterpret_cast<const float4*>(p) + i4);
}

// sign(v) * min(floor(c*|v| / safe + u), c) as int8; c = 2^{b-1} <= 64.
__device__ __forceinline__ signed char quant(float v, float u, float c,
                                             float safe) {
  float lvl = floorf(__fadd_rn(__fdiv_rn(__fmul_rn(c, fabsf(v)), safe), u));
  int l = static_cast<int>(fminf(lvl, c));
  return static_cast<signed char>(v > 0.f ? l : (v < 0.f ? -l : 0));
}

// Quantize row `row` (base4 = its first float4) whose values the calling
// warp holds in registers: lane `lane` holds v[4j + e] = element
// 4 * (j * 32 + lane) + e of the row, j < 4, e < 4.  The row max is a
// 5-step __shfl_xor_sync reduction (no shared memory, no second pass over
// device memory); the dither is read only after it, to keep register
// pressure low; codes are written as char4, the scale by lane 0.  An
// all-zero row gives codes 0 and scale 0.
__device__ __forceinline__ void quantize_row(const float (&v)[kValsPerLane],
                                             const float* __restrict__ u,
                                             signed char* __restrict__ code,
                                             float* __restrict__ scale,
                                             long long row, long long base4,
                                             int lane, int bits) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kValsPerLane; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  const float c = static_cast<float>(1 << (bits - 1));
  const float safe = amax > 0.f ? amax : 1.f;   // a zero row stays zero
#pragma unroll
  for (int j = 0; j < kVec4PerLane; ++j) {
    const long long i4 = base4 + j * kWarp + lane;
    const float4 uv = load4(u, i4);
    char4 out;
    out.x = quant(v[4 * j + 0], uv.x, c, safe);
    out.y = quant(v[4 * j + 1], uv.y, c, safe);
    out.z = quant(v[4 * j + 2], uv.z, c, safe);
    out.w = quant(v[4 * j + 3], uv.w, c, safe);
    reinterpret_cast<char4*>(code)[i4] = out;
  }
  if (lane == 0) scale[row] = amax > 0.f ? amax : 0.f;
}

// Quantize row `row` of a (rows, block) plane, any block >= 1, by one warp:
// a strided scalar loop (lane l takes elements l, l + 32, ...), so nothing
// is assumed of the row's alignment.  `value(i)` gives element i of the
// plane (K4: x[i]; K1: the rounded difference) and is called twice per
// element, once per pass: pass 1 takes the row max and reduces it across the
// warp with __shfl_xor_sync, pass 2 writes the codes through quant().  The
// max is exact and independent of the order it is taken in (fmaxf), and
// value(i) is the same rounded sequence in both passes, so the codes and
// the scale are those of the plain version, bit for bit.  A row narrower
// than a warp leaves lanes idle (a 16-wide row runs at half occupancy).
template <class Value>
__device__ __forceinline__ void quantize_row_any(const Value& value,
                                                 const float* __restrict__ u,
                                                 signed char* __restrict__ code,
                                                 float* __restrict__ scale,
                                                 long long row, long long block,
                                                 int lane, int bits) {
  const long long base = row * block;
  float amax = 0.f;
  for (long long i = lane; i < block; i += kWarp)
    amax = fmaxf(amax, fabsf(value(base + i)));
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  const float c = static_cast<float>(1 << (bits - 1));
  const float safe = amax > 0.f ? amax : 1.f;   // a zero row stays zero
  for (long long i = lane; i < block; i += kWarp)
    code[base + i] = quant(value(base + i), __ldg(u + base + i), c, safe);
  if (lane == 0) scale[row] = amax > 0.f ? amax : 0.f;
}

// Grid for the grid-stride passes: enough resident CTAs to cover every SM
// several times over, never more than the work needs.
inline unsigned grid_for(long long n4) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (n4 + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 16;
  return static_cast<unsigned>(need < cap ? need : cap);
}

// Grid for the one-warp-per-row kernels (K1, K4), at any block width.
inline unsigned grid_for_rows(long long rows) {
  return static_cast<unsigned>((rows + kRowsPerCta - 1) / kRowsPerCta);
}

}  // namespace
