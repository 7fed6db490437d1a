// Top-k logit mask for the sampler: per row, values strictly below the
// row's k-th largest become `fill`; ties at the threshold all survive;
// k <= 0 or k >= V leaves the row untouched.
//
// Replaces the JAX package's kernels/topk.py _topk_kernel (topk_mask).
// Same threshold: the k-th largest element of the row under the monotone
// fp32 -> uint32 map (-0.0 canonicalised to +0.0 first, as `_sortable`
// does), found exactly.  The TPU kernel builds it bit by bit in 32
// compare-and-count passes over a row held in VMEM.  A 151936-wide fp32
// row is 594 KB, more than shared memory holds, so here the row streams
// from L2 on every pass; the design cuts the passes to four by selecting
// eight bits at a time: a 256-bin histogram (shared-memory atomics) of
// the candidates that still match the chosen prefix, then a scan from the
// top bin for the bin that holds the k-th largest.  Padding columns do
// not exist here: the row is walked to V only.
//
// What bounds it: bytes — five reads of the row (four histogram passes
// and the masking pass) and one write, against one read and one write as
// the least the function needs.  One block of 1024 threads per row.
#include "common.cuh"

namespace {

constexpr int NT = 1024;

__device__ __forceinline__ uint32_t ukey(float x) {
  if (x == 0.f) x = 0.f;                      // -0.0 -> +0.0
  const uint32_t i = __float_as_uint(x);
  return (i & 0x80000000u) ? ~i : (i | 0x80000000u);
}

template <typename T>
__global__ void __launch_bounds__(NT)
topk_kernel(const T* __restrict__ x, T* __restrict__ out,
            const int* __restrict__ kvec, int V, float fill) {
  __shared__ unsigned hist[256];
  __shared__ uint32_t s_prefix;
  __shared__ int s_krem;
  const int b = blockIdx.x, tid = threadIdx.x;
  const T* row = x + (long long)b * V;
  T* orow = out + (long long)b * V;
  const int k = kvec[b];
  if (k <= 0 || k >= V) {
    for (int v = tid; v < V; v += NT) orow[v] = row[v];
    return;
  }
  uint32_t prefix = 0, mask = 0;
  int krem = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += NT) hist[i] = 0;
    __syncthreads();
    for (int v = tid; v < V; v += NT) {
      const uint32_t u = ukey(rt::to_f(row[v]));
      if ((u & mask) == prefix) atomicAdd(&hist[(u >> shift) & 0xFFu], 1u);
    }
    __syncthreads();
    if (tid == 0) {
      int cum = 0;
      for (int dgt = 255; dgt >= 0; --dgt) {
        const int h = (int)hist[dgt];
        if (cum + h >= krem) {
          s_prefix = prefix | ((uint32_t)dgt << shift);
          s_krem = krem - cum;
          break;
        }
        cum += h;
      }
    }
    __syncthreads();
    prefix = s_prefix;
    krem = s_krem;
    mask |= 0xFFu << shift;
    __syncthreads();   // s_prefix read by all before the next pass writes it
  }
  const T f = rt::from_f<T>(fill);
  for (int v = tid; v < V; v += NT) {
    const T val = row[v];
    orow[v] = ukey(rt::to_f(val)) >= prefix ? val : f;
  }
}

}  // namespace

// logits/out (B, V) of dtype (0 fp32, 1 bf16); k (B,) int32.
extern "C" int topk_mask(const void* x, void* out, const void* k, int B, int V,
                         float fill, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    topk_kernel<__nv_bfloat16><<<B, NT, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, (const int*)k, V, fill);
  else
    topk_kernel<float><<<B, NT, 0, s>>>((const float*)x, (float*)out,
                                        (const int*)k, V, fill);
  return (int)cudaGetLastError();
}
