// Element-mode bank gradient (paper Eq. 12):
//   dw[k] = sum over (i, j) with bucket(i, j) = k of xi(i, j) * (x^T g)[i, j].
//
// Replaces the JAX package's kernels/hashed_matmul.py _element_dw_kernel
// (element_dw).  The TPU kernel walks its grid in order and lets each
// column panel's bucket slice revisit VMEM: it computes one tile of x^T g,
// segment-sums it into the slice, stores on the panel's first tile and adds
// on the later ones.  Blocks on the card run in no order, and float
// atomics into the buckets would make dw change from launch to launch.
// So the work is split in two passes, both deterministic:
//
//  1. dw_products: P[i, j] = xi(i, j) * sum_m x[m, i] g[m, j] for one
//     64 x 64 tile per block, in fp32, into a workspace of R x C floats
//     (50 MB at qwen3-1.7b's ffn.out, mostly L2-resident).
//  2. dw_segments: one thread per bucket walks that bucket's virtual
//     positions (a static inverse map: positions sorted by bucket, in
//     row-major order inside each bucket, built once per spec by the
//     wrapper) and sums P over them in that fixed order.
//
// What bounds it: pass 1 is the product x^T g, 2 M R C flops on the fp32
// CUDA cores (no tensor cores yet); pass 2 is a gather of R C floats and
// R C map entries, random inside each panel, served mostly from L2.
#include "tile_gemm.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rt::TG_NT)
dw_products(const T* __restrict__ x, const T* __restrict__ g,
            float* __restrict__ ws, int M, int R, int C, uint32_t seed,
            int use_sign) {
  __shared__ float xs[rt::XTG_BM][rt::XTG_T];
  __shared__ float gs[rt::XTG_BM][rt::XTG_T];
  const int r0 = blockIdx.y * rt::XTG_T, c0 = blockIdx.x * rt::XTG_T;
  float acc[4][4] = {};
  rt::xtg_accumulate<T>(acc, x, g, M, R, C, r0, min(rt::XTG_T, R - r0), c0,
                        min(rt::XTG_T, C - c0), 1.f, xs, gs);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const uint32_t sseed = seed ^ rt::kSignSeedXor;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = r0 + ty + 16 * a;
    if (i >= R) continue;
    const uint32_t si = rt::mix32((uint32_t)i * rt::kGolden + sseed);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = c0 + tx + 16 * b;
      if (j >= C) continue;
      float v = acc[a][b];
      if (use_sign &&
          (rt::mix32(si ^ ((uint32_t)j * rt::kM1 + rt::kJOffset)) >> 31))
        v = -v;
      ws[(long long)i * C + j] = v;
    }
  }
}

__global__ void dw_segments(const float* __restrict__ ws,
                            const int* __restrict__ order,
                            const int* __restrict__ offsets,
                            float* __restrict__ dw, int num_buckets) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= num_buckets) return;
  float s = 0.f;
  for (int p = offsets[k]; p < offsets[k + 1]; ++p) s += ws[order[p]];
  dw[k] = s;
}

}  // namespace

// x (M, R), g (M, C) of dtype (0 fp32, 1 bf16); ws fp32 (R * C); order
// int32 (R * C) virtual positions i * C + j grouped by bucket; offsets
// int32 (num_buckets + 1); dw fp32 (num_buckets).
extern "C" int hashed_element_dw(const void* x, const void* g, void* ws,
                                 const void* order, const void* offsets,
                                 void* dw, int M, int R, int C, unsigned seed,
                                 int use_sign, int num_buckets, int dtype,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((C + rt::XTG_T - 1) / rt::XTG_T, (R + rt::XTG_T - 1) / rt::XTG_T);
  if (dtype == 1)
    dw_products<__nv_bfloat16><<<grid, rt::TG_NT, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (float*)ws, M, R,
        C, seed, use_sign);
  else
    dw_products<float><<<grid, rt::TG_NT, 0, s>>>(
        (const float*)x, (const float*)g, (float*)ws, M, R, C, seed,
        use_sign);
  dw_segments<<<(num_buckets + 255) / 256, 256, 0, s>>>(
      (const float*)ws, (const int*)order, (const int*)offsets, (float*)dw,
      num_buckets);
  return (int)cudaGetLastError();
}
