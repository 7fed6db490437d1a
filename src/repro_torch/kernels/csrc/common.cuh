// Shared helpers of the repro_torch CUDA kernels: element conversions,
// the murmur3 hash of core/hashing.py in native uint32_t wrap-around
// arithmetic, the exact bucket reduction, a warp sum, and 16-byte cp.async
// copies into shared memory.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kJOffset = 0x165667B1u;
constexpr uint32_t kSignSeedXor = 0x5BF03635u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 13;
  x *= kM2;
  x ^= x >> 16;
  return x;
}

// h mod kp for every uint32 h and every kp >= 1, without a division:
// with magic = floor((2^32 - 1) / kp), q = mulhi(h, magic) is h / kp
// rounded down, or one less (magic >= 2^32 / kp - 1, so the product
// misses h / kp by under h / 2^32 < 1); r = h - q kp is then h mod kp or
// h mod kp + kp, and the unsigned min of r and r - kp (which wraps past
// 2^32 when r < kp) is h mod kp.  Four integer instructions and no branch
// (kp a power of two or not), where `%` by a runtime divisor takes a
// reciprocal on the quarter-rate pipe and a dozen more.  The one
// definition of the element-mode bucket: the wrapper computes magic per
// spec (kernels/hashed_matmul.py bucket_magic).
__device__ __forceinline__ uint32_t bucket_mod(uint32_t h, uint32_t kp,
                                               uint32_t magic) {
  const uint32_t r = h - __umulhi(h, magic) * kp;
  return min(r, r - kp);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte cp.async; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace rt
