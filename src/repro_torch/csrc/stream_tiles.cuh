// A Hopper (sm_90) streaming pass over f32 planes: kIn input planes of n
// elements go through an elementwise body into one f32 output plane, tile by
// tile, with the Tensor Memory Accelerator's 1-D bulk copies (cp.async.bulk)
// moving every byte between device and shared memory.
//
// Why: one thread per CTA keeps whole tiles in flight (HBM latency at
// 3.35 TB/s wants ~26 KB in flight per SM), the copy engine, not the
// threads, computes the addresses, and the SMs stream in address order.
//
// Design.  CTA b takes the run of kRunTiles consecutive tiles that starts at
// tile b * kRunTiles; the grid holds one CTA per run, so the hardware hands
// out runs in address order and every SM streams near the same window of
// device memory.  (A persistent grid of one CTA per SM walking tiles b,
// b + grid, ... measured slower on an H100, and as fast once it took its
// tiles in address order: scripts/mask_apply_designs.py.)  A ring of
// kStages stages in dynamic shared memory holds, per stage, one tile of
// each input and a "full" mbarrier:
//   * thread 0 fills a stage: mbarrier.arrive.expect_tx with the stage's
//     byte count, then one bulk copy per input, each completing its bytes on
//     that barrier;
//   * every thread waits on the barrier's phase parity (the k-th use of a
//     stage waits parity k & 1), applies the body in place into the stage's
//     first input tile, and makes its writes visible to the copy engine
//     (fence.proxy.async.shared::cta) before a CTA barrier;
//   * thread 0 stores that tile with one bulk copy (cp.async.bulk.global.
//     shared::cta.bulk_group) and commits it as a bulk group; one tile
//     later, once cp.async.bulk.wait_group.read 1 says that store has read
//     its source, it refills the stage with the tile kStages ahead.
// So kStages - 1 stages of loads and one store are in flight while a stage
// is computed (a run of kStages tiles or fewer is in flight whole and never
// refills).  The last tile may be partial: its byte count is the
// remainder, a multiple of 16 because the caller requires n % 4 == 0 (and
// 16-byte aligned planes, which bulk copies need).
//
// The body is a functor with `float4 operator()(const float4 (&v)[kIn])`;
// every operation in it should be an explicit round-to-nearest intrinsic,
// so that the pass stays bit-identical to its plain PyTorch version.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStreamThreads = 256;

template <int kIn>
struct StreamPlanes {
  const float* in[kIn];
  float* out;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred p;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n\t"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// global -> shared, `bytes` (a multiple of 16), completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global, `bytes` (a multiple of 16), in the current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int kIn, int kTileBytes, int kStages>
constexpr int stream_smem_bytes() {
  return kStages * (kIn * kTileBytes + 8);
}

template <int kIn, int kTileBytes, int kStages, int kRunTiles, class Body>
__global__ void __launch_bounds__(kStreamThreads)
stream_tiles_kernel(StreamPlanes<kIn> planes, long long bytes, Body body) {
  static_assert(kTileBytes % (16 * kStreamThreads) == 0,
                "a full tile is a whole number of float4 per thread");
  extern __shared__ __align__(128) unsigned char smem[];
  // stage s, input j: smem + (s * kIn + j) * kTileBytes; then the barriers
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kStages * kIn * kTileBytes);
  const long long tiles = (bytes + kTileBytes - 1) / kTileBytes;
  const long long first = static_cast<long long>(blockIdx.x) * kRunTiles;
  const int mine = static_cast<int>(
      tiles - first < kRunTiles ? tiles - first : kRunTiles);
  const bool leader = threadIdx.x == 0;

  auto tile_bytes = [&](int i) {            // bytes of this CTA's i-th tile
    const long long left = bytes - (first + i) * kTileBytes;
    return static_cast<uint32_t>(left < kTileBytes ? left : kTileBytes);
  };
  auto fill = [&](int i) {                  // issue this CTA's i-th tile
    const int s = i % kStages;
    const uint32_t nb = tile_bytes(i);
    mbar_expect_tx(&full[s], nb * kIn);
#pragma unroll
    for (int j = 0; j < kIn; ++j)
      bulk_load(smem + (s * kIn + j) * kTileBytes,
                reinterpret_cast<const unsigned char*>(planes.in[j]) +
                    (first + i) * kTileBytes,
                nb, &full[s]);
  };

  if (leader) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kStages && i < mine; ++i) fill(i);
  }
  __syncthreads();

  for (int i = 0; i < mine; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    float4* dst = reinterpret_cast<float4*>(smem + s * kIn * kTileBytes);
    const uint32_t nb = tile_bytes(i);
    const int n4 = static_cast<int>(nb / 16);
    for (int k = threadIdx.x; k < n4; k += kStreamThreads) {
      float4 v[kIn];
#pragma unroll
      for (int j = 0; j < kIn; ++j)
        v[j] = reinterpret_cast<const float4*>(
            smem + (s * kIn + j) * kTileBytes)[k];
      dst[k] = body(v);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (leader) {
      bulk_store(reinterpret_cast<unsigned char*>(planes.out) +
                     (first + i) * kTileBytes,
                 dst, nb);
      // the stage of tile i - 1 is free once its store has read it
      if (i >= 1 && i - 1 + kStages < mine) {
        bulk_wait_read<1>();
        fill(i - 1 + kStages);
      }
    }
  }
  if (leader)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Launch the pass on `stream` over n f32 elements (n % 4 == 0, every plane
// 16-byte aligned): one CTA per run of kRunTiles tiles.  Sets the kernel's
// dynamic shared memory limit first (above 48 KB it must be raised before
// the launch).  Returns the first CUDA error.
template <int kIn, int kTileBytes, int kStages, int kRunTiles, class Body>
cudaError_t launch_stream_tiles(StreamPlanes<kIn> planes, long long n,
                                Body body, cudaStream_t stream) {
  const long long bytes = n * 4;
  if (bytes <= 0) return cudaSuccess;
  auto kernel = stream_tiles_kernel<kIn, kTileBytes, kStages, kRunTiles, Body>;
  constexpr int smem = stream_smem_bytes<kIn, kTileBytes, kStages>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long tile_run = static_cast<long long>(kTileBytes) * kRunTiles;
  const unsigned grid = static_cast<unsigned>((bytes + tile_run - 1) / tile_run);
  kernel<<<grid, kStreamThreads, smem, stream>>>(planes, bytes, body);
  return cudaGetLastError();
}

}  // namespace
