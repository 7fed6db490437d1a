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
//  1. the product P = x^T g (R x C, fp32) into a workspace (50 MB at
//     qwen3-1.7b's ffn.out, mostly L2-resident), by one of two bodies
//     (the wrapper's plan, element_dw_plan in kernels/hashed_matmul.py):
//     - bf16: tile_gemm.cuh's tc_xtg, block_dw's tensor-core x^T g
//       (wgmma.m64n128k16, bf16 in, fp32 sums, contracting over M).
//       Element mode is its degenerate case: one "bank tile" of R x C
//       whose chain is one virtual tile of sign +1 (kOneTile below), so
//       tc_xtg's 128 x 128 output pieces tile the whole product.  Split
//       over M only when the plan asks (the pieces' fp32 partials then
//       added in split order by splitk_reduce); at qwen3-1.7b's widths
//       and M = 1024 the 128 x 128 tiles alone fill the SMs.
//     - fp32 (and shapes whose R or C is not a multiple of 8):
//       dw_products, 64 x 64 tiles on the CUDA cores (full fp32 products).
//  2. dw_segments: one thread per bucket walks that bucket's virtual
//     positions (a static inverse map: positions sorted by bucket, in
//     row-major order inside each bucket, built once per spec by the
//     wrapper) and sums xi * P over them in that fixed order.  The sign
//     xi(i, j) rides in bit 31 of each map entry (set for -1): a sign flip
//     rounds nothing, so applying it here gives the same bits as applying
//     it to P, and the product bodies stay sign-free.  Each thread loads
//     four map entries and their values before adding them, in order.
//
// What bounds it: pass 1 is the product x^T g, 2 M R C flops (on the
// tensor cores for bf16); pass 2 is a gather of R C floats and R C map
// entries, random inside each panel, served mostly from L2.
#include "tile_gemm.cuh"

namespace {

// The single chain of the element product for tc_xtg: order {0},
// offsets {0, 1}, sign {+1}, launch order {0}.
__device__ int kOneTile[5] = {0, 0, 1, 1, 0};

template <typename T>
__global__ void __launch_bounds__(rt::TG_NT)
dw_products(const T* __restrict__ x, const T* __restrict__ g,
            float* __restrict__ ws, int M, int R, int C) {
  __shared__ float xs[rt::XTG_BM][rt::XTG_T];
  __shared__ float gs[rt::XTG_BM][rt::XTG_T];
  const int r0 = blockIdx.y * rt::XTG_T, c0 = blockIdx.x * rt::XTG_T;
  float acc[4][4] = {};
  rt::xtg_accumulate<T>(acc, x, g, M, R, C, r0, min(rt::XTG_T, R - r0), c0,
                        min(rt::XTG_T, C - c0), 1.f, xs, gs);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = r0 + ty + 16 * a;
    if (i >= R) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = c0 + tx + 16 * b;
      if (j < C) ws[(long long)i * C + j] = acc[a][b];
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
  const int p1 = offsets[k + 1];
  int p = offsets[k];
  for (; p + 4 <= p1; p += 4) {
    int o[4];
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) o[u] = order[p + u];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = ws[o[u] & 0x7FFFFFFF];
#pragma unroll
    for (int u = 0; u < 4; ++u) s += o[u] < 0 ? -v[u] : v[u];
  }
  for (; p < p1; ++p) {
    const int o = order[p];
    const float v = ws[o & 0x7FFFFFFF];
    s += o < 0 ? -v : v;
  }
  dw[k] = s;
}

}  // namespace

// x (M, R), g (M, C) of dtype (0 fp32, 1 bf16); ws fp32 (R * C) for the
// product; split_ws fp32 (splits * R * C) when tc and splits > 1, else
// unused; order int32 (R * C) virtual positions i * C + j grouped by
// bucket, bit 31 set where xi(i, j) = -1; offsets int32 (num_buckets + 1);
// dw fp32 (num_buckets).  tc: the tensor-core product (bf16, R and C
// multiples of 8), cut into `splits` pieces over M.
extern "C" int hashed_element_dw(const void* x, const void* g, void* ws,
                                 void* split_ws, const void* order,
                                 const void* offsets, void* dw, int M, int R,
                                 int C, int num_buckets, int dtype, int tc,
                                 int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tc) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    const int* one = nullptr;
    cudaError_t err = cudaGetSymbolAddress((void**)&one, kOneTile);
    if (err != cudaSuccess) return (int)err;
    err = rt::launch_tc_xtg(x, g, one, one + 1, one + 3, one + 4, (float*)ws,
                            (float*)split_ws, M, R, C, R, C, 1, 1, splits, s);
    if (err != cudaSuccess) return (int)err;
  } else {
    dim3 grid((C + rt::XTG_T - 1) / rt::XTG_T,
              (R + rt::XTG_T - 1) / rt::XTG_T);
    if (dtype == 1)
      dw_products<__nv_bfloat16><<<grid, rt::TG_NT, 0, s>>>(
          (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (float*)ws, M, R,
          C);
    else
      dw_products<float><<<grid, rt::TG_NT, 0, s>>>(
          (const float*)x, (const float*)g, (float*)ws, M, R, C);
  }
  dw_segments<<<(num_buckets + 255) / 256, 256, 0, s>>>(
      (const float*)ws, (const int*)order, (const int*)offsets, (float*)dw,
      num_buckets);
  return (int)cudaGetLastError();
}
