// Hopper (sm_90a) kernels for LEAD's main path: the fused pre-communication
// pass (K1), the receiver's decode (K2) and the fused post-communication
// state update (K3).  Every kernel works row-wise on f32 (rows, block)
// planes, rows = n_agents * nb, in the layout of the flat engine; block is
// the paper's 512 on the hot path and any width >= 1 otherwise.
//
// Built with wire_kernels.cu into one shared library with a plain C
// interface by repro_torch/kernels/cuda_lib.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false), loaded through
// ctypes.  K1 quantizes through quantize_row.cuh, which K4 shares.
//
// Exactness.  The quantizer computes floor(2^{b-1} |diff| / scale + u): an
// element sitting on a level boundary flips its code under any change of
// rounding.  Every floating-point operation below is therefore an explicit
// round-to-nearest intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn, ...), which
// nvcc never contracts into an FMA and which keeps the divide IEEE, in the
// operation order of the plain PyTorch versions (repro_torch/kernels/ref.py).
// -fmad=false guards any expression written without them.  The kernels are
// then bit-identical to the plain versions on the same card.
//
// Each C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 = the launch was accepted).

#include <cuda_runtime.h>
#include <stdint.h>

#include "quantize_row.cuh"

namespace {

// diff = x - eta*g - eta*d - h, left to right, each operation rounded.
__device__ __forceinline__ float lead_diff(float x, float g, float d, float h,
                                           float eta) {
  return __fsub_rn(__fsub_rn(__fsub_rn(x, __fmul_rn(eta, g)),
                             __fmul_rn(eta, d)),
                   h);
}

// ---------------------------------------------------------------------------
// K1 lead_diff_encode.  Replaces src/repro/kernels/lead_update.py::
// lead_diff_encode (_diff_encode_kernel).  Bound: bytes.  Per element it
// reads x, g, d, h, u (20 B) and writes one int8 code (1 B), plus one f32
// scale per 512-element row: 21 B/element + 4 B/row, about 0.2 flop/B.
// Design: one warp per row, so the row's max|diff| is a register reduction
// (__shfl_xor_sync) with no shared memory and no second pass over device
// memory.  Each lane loads 16 floats of each input as four float4 loads at
// lane-contiguous addresses (a warp reads 512 contiguous bytes per load), so
// every byte moves once in full 128-byte transactions; diff stays in
// registers between the reduction and the code pass.  u is read only after
// the reduction to keep register pressure low.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
lead_diff_encode_kernel(const float* __restrict__ x,
                        const float* __restrict__ g,
                        const float* __restrict__ d,
                        const float* __restrict__ h,
                        const float* __restrict__ u,
                        const float* __restrict__ eta_p,
                        signed char* __restrict__ code,
                        float* __restrict__ scale,
                        long long rows, int bits) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= rows) return;                  // whole warps exit together
  const float eta = __ldg(eta_p);
  const long long base4 = row * (kBlock / 4);

  float diff[kValsPerLane];
#pragma unroll
  for (int j = 0; j < kVec4PerLane; ++j) {
    const long long i4 = base4 + j * kWarp + lane;
    const float4 xv = load4(x, i4), gv = load4(g, i4);
    const float4 dv = load4(d, i4), hv = load4(h, i4);
    diff[4 * j + 0] = lead_diff(xv.x, gv.x, dv.x, hv.x, eta);
    diff[4 * j + 1] = lead_diff(xv.y, gv.y, dv.y, hv.y, eta);
    diff[4 * j + 2] = lead_diff(xv.z, gv.z, dv.z, hv.z, eta);
    diff[4 * j + 3] = lead_diff(xv.w, gv.w, dv.w, hv.w, eta);
  }
  quantize_row(diff, u, code, scale, row, base4, lane, bits);
}

// K1 at any other block width: the same warp per row, through
// quantize_row_any(), which evaluates the difference once per pass with the
// same rounded sequence (so both passes see the same bits) instead of
// holding it in registers.  Each plane is read twice; the second read of a
// row mostly hits L1/L2.
struct DiffValues {
  const float* __restrict__ x;
  const float* __restrict__ g;
  const float* __restrict__ d;
  const float* __restrict__ h;
  float eta;
  __device__ __forceinline__ float operator()(long long i) const {
    return lead_diff(__ldg(x + i), __ldg(g + i), __ldg(d + i), __ldg(h + i),
                     eta);
  }
};

__global__ void __launch_bounds__(kThreads)
lead_diff_encode_any_kernel(const float* __restrict__ x,
                            const float* __restrict__ g,
                            const float* __restrict__ d,
                            const float* __restrict__ h,
                            const float* __restrict__ u,
                            const float* __restrict__ eta_p,
                            signed char* __restrict__ code,
                            float* __restrict__ scale, long long rows,
                            long long block, int bits) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= rows) return;                  // whole warps exit together
  const DiffValues diff{x, g, d, h, __ldg(eta_p)};
  quantize_row_any(diff, u, code, scale, row, block, lane, bits);
}

// ---------------------------------------------------------------------------
// K2 quantize decode.  Replaces src/repro/kernels/quantize.py::decode
// (_decode_kernel).  Bound: bytes.  Reads one int8 code (1 B) and writes one
// f32 (4 B) per element, plus one f32 scale per row: 5 B/element + 4 B/row.
// Design: a grid-stride pass of 4 elements per thread (char4 in, float4
// out, both coalesced) when the block is a multiple of 4, so that no group
// of 4 straddles two rows; otherwise the same pass one element per thread.
// The row's scale is a broadcast read that stays in L1/L2.
// (scale * 2^{1-b}) * code is the plain version's order; the first product
// is exact, so the result is exact.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
quantize_decode_kernel(const signed char* __restrict__ code,
                       const float* __restrict__ scale,
                       float* __restrict__ out,
                       long long n4, long long block4, float step) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += stride) {
    const char4 c = __ldg(reinterpret_cast<const char4*>(code) + i);
    const float s = __fmul_rn(__ldg(scale + i / block4), step);
    float4 o;
    o.x = __fmul_rn(s, static_cast<float>(c.x));
    o.y = __fmul_rn(s, static_cast<float>(c.y));
    o.z = __fmul_rn(s, static_cast<float>(c.z));
    o.w = __fmul_rn(s, static_cast<float>(c.w));
    reinterpret_cast<float4*>(out)[i] = o;
  }
}

__global__ void __launch_bounds__(kThreads)
quantize_decode_any_kernel(const signed char* __restrict__ code,
                           const float* __restrict__ scale,
                           float* __restrict__ out, long long n,
                           long long block, float step) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float s = __fmul_rn(__ldg(scale + i / block), step);
    out[i] = __fmul_rn(s, static_cast<float>(__ldg(code + i)));
  }
}

// ---------------------------------------------------------------------------
// K3 lead_update.  Replaces src/repro/kernels/lead_update.py::lead_update
// (_lead_update_kernel).  Bound: bytes.  Reads x, g, d, h, hw, qh, wqh and
// writes x', d', h', hw': 44 B/element, about 0.4 flop/B.
// Design: a grid-stride float4 pass, every plane read and written once with
// 16-byte coalesced accesses; eta, gamma and alpha are read from device
// scalars (a schedule resolved on the device costs no host sync) and
// gamma / (2 eta) is formed here, in the plain version's order.
// ---------------------------------------------------------------------------
struct Upd {
  float eta, one_m_alpha, alpha, gain;
  __device__ __forceinline__ void apply(float x, float g, float d, float h,
                                        float hw, float qh, float wqh,
                                        float& xo, float& dout, float& ho,
                                        float& hwo) const {
    const float yh = __fadd_rn(h, qh);
    const float yhw = __fadd_rn(hw, wqh);
    ho = __fadd_rn(__fmul_rn(one_m_alpha, h), __fmul_rn(alpha, yh));
    hwo = __fadd_rn(__fmul_rn(one_m_alpha, hw), __fmul_rn(alpha, yhw));
    dout = __fadd_rn(d, __fmul_rn(gain, __fsub_rn(yh, yhw)));
    xo = __fsub_rn(__fsub_rn(x, __fmul_rn(eta, g)), __fmul_rn(eta, dout));
  }
};

__global__ void __launch_bounds__(kThreads)
lead_update_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ d, const float* __restrict__ h,
                   const float* __restrict__ hw,
                   const float* __restrict__ qh,
                   const float* __restrict__ wqh,
                   const float* __restrict__ eta_p,
                   const float* __restrict__ gamma_p,
                   const float* __restrict__ alpha_p,
                   float* __restrict__ xo, float* __restrict__ dout,
                   float* __restrict__ ho, float* __restrict__ hwo,
                   long long n4) {
  Upd up;
  up.eta = __ldg(eta_p);
  up.alpha = __ldg(alpha_p);
  up.one_m_alpha = __fsub_rn(1.f, up.alpha);
  up.gain = __fdiv_rn(__ldg(gamma_p), __fmul_rn(2.f, up.eta));
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += stride) {
    const float4 xv = load4(x, i), gv = load4(g, i), dv = load4(d, i);
    const float4 hv = load4(h, i), hwv = load4(hw, i);
    const float4 qv = load4(qh, i), wv = load4(wqh, i);
    float4 a, b, c, e;
    up.apply(xv.x, gv.x, dv.x, hv.x, hwv.x, qv.x, wv.x, a.x, b.x, c.x, e.x);
    up.apply(xv.y, gv.y, dv.y, hv.y, hwv.y, qv.y, wv.y, a.y, b.y, c.y, e.y);
    up.apply(xv.z, gv.z, dv.z, hv.z, hwv.z, qv.z, wv.z, a.z, b.z, c.z, e.z);
    up.apply(xv.w, gv.w, dv.w, hv.w, hwv.w, qv.w, wv.w, a.w, b.w, c.w, e.w);
    reinterpret_cast<float4*>(xo)[i] = a;
    reinterpret_cast<float4*>(dout)[i] = b;
    reinterpret_cast<float4*>(ho)[i] = c;
    reinterpret_cast<float4*>(hwo)[i] = e;
  }
}

}  // namespace

extern "C" {

// block == 512 takes the register-resident hot path, any other width >= 1
// the strided one.
int repro_lead_diff_encode(const void* x, const void* g, const void* d,
                           const void* h, const void* u, const void* eta,
                           void* code, void* scale, long long rows,
                           long long block, int bits, void* stream) {
  if (rows > 0 && block == kBlock) {
    lead_diff_encode_kernel<<<grid_for_rows(rows), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(d), static_cast<const float*>(h),
        static_cast<const float*>(u), static_cast<const float*>(eta),
        static_cast<signed char*>(code), static_cast<float*>(scale), rows,
        bits);
  } else if (rows > 0 && block > 0) {
    lead_diff_encode_any_kernel<<<grid_for_rows(rows), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(d), static_cast<const float*>(h),
        static_cast<const float*>(u), static_cast<const float*>(eta),
        static_cast<signed char*>(code), static_cast<float*>(scale), rows,
        block, bits);
  }
  return static_cast<int>(cudaGetLastError());
}

int repro_quantize_decode(const void* code, const void* scale, void* out,
                          long long rows, long long block, int bits,
                          void* stream) {
  const long long n = rows * block;
  const float step = ldexpf(1.f, 1 - bits);     // 2^{1-b}, exact
  if (n > 0 && block % 4 == 0) {
    quantize_decode_kernel<<<grid_for(n / 4), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const signed char*>(code),
        static_cast<const float*>(scale), static_cast<float*>(out), n / 4,
        block / 4, step);
  } else if (n > 0) {
    quantize_decode_any_kernel<<<grid_for(n), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const signed char*>(code),
        static_cast<const float*>(scale), static_cast<float*>(out), n, block,
        step);
  }
  return static_cast<int>(cudaGetLastError());
}

int repro_lead_update(const void* x, const void* g, const void* d,
                      const void* h, const void* hw, const void* qh,
                      const void* wqh, const void* eta, const void* gamma,
                      const void* alpha, void* xo, void* dout, void* ho,
                      void* hwo, long long n, void* stream) {
  const long long n4 = n / 4;
  if (n4 > 0) {
    lead_update_kernel<<<grid_for(n4), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(d), static_cast<const float*>(h),
        static_cast<const float*>(hw), static_cast<const float*>(qh),
        static_cast<const float*>(wqh), static_cast<const float*>(eta),
        static_cast<const float*>(gamma), static_cast<const float*>(alpha),
        static_cast<float*>(xo), static_cast<float*>(dout),
        static_cast<float*>(ho), static_cast<float*>(hwo), n4);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
