// Element-mode fused decompress-GEMM: y = x @ V, V[i,j] = xi(i,j) *
// w[panel(j) * Kp + h(i,j) % Kp], V never stored.
//
// Replaces the JAX package's kernels/hashed_matmul.py _element_fwd_kernel
// (element_matmul, transpose=False).  The TPU kernel stages a panel's
// whole bucket slice in VMEM; at full width that slice is 512 KB to
// 1.5 MB, more than a block's 227 KB of shared memory, so here the
// gather reads global memory and mostly hits the 50 MB L2.  The TPU
// carries the K-sum across a sequential grid axis; here it is a loop
// over K inside the block, optionally split across blocks (split-K into
// an fp32 workspace plus a deterministic reduction) so that decode, with
// M <= 8 rows, still fills the card.
//
// What bounds it: not bytes (the bank is ~1/8 of a dense weight) nor
// the product, but hashing every virtual weight of V: two murmur rounds
// for the bucket and one more for the sign per element.  The design pays
// that once per (BM-row block, BK x BN tile) and reuses each decompressed
// tile for all BM rows; the first murmur round depends only on the row i
// and is computed once per tile row into shared memory.
#include "common.cuh"

namespace {

constexpr int BN = 64;
constexpr int BK = 32;
constexpr int NT = 256;   // threads: 64 columns x 4 row groups

template <typename T, int BM>
__global__ void __launch_bounds__(NT)
element_fwd(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
            float* __restrict__ ws, int M, int R, int C, uint32_t kp,
            int panel_cols, uint32_t seed, int use_sign, int k_per_split) {
  constexpr int RPT = BM / 4;   // output rows per thread
  __shared__ float xs[BM][BK];
  __shared__ float vs[BK][BN];
  __shared__ uint32_t hrow[BK];
  __shared__ uint32_t srow[BK];

  const int tid = threadIdx.x;
  const int col = tid % BN;
  const int rg = tid / BN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(R, kbeg + k_per_split);
  const int j = n0 + col;
  const uint32_t jkey = (uint32_t)j * rt::kM1 + rt::kJOffset;
  const long long base =
      panel_cols > 0 ? (long long)(j / panel_cols) * (long long)kp : 0;
  const uint32_t sseed = seed ^ rt::kSignSeedXor;

  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    if (tid < BK) {
      const uint32_t i = (uint32_t)(k0 + tid);
      hrow[tid] = rt::mix32(i * rt::kGolden + seed);
      srow[tid] = rt::mix32(i * rt::kGolden + sseed);
    }
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, kk = e % BK;
      const int gm = m0 + r, gk = k0 + kk;
      xs[r][kk] = (gm < M && gk < kend) ? rt::to_f(x[(long long)gm * R + gk]) : 0.f;
    }
    __syncthreads();
    for (int kk = rg; kk < BK; kk += NT / BN) {
      float v = 0.f;
      if (k0 + kk < kend && j < C) {
        const uint32_t h = rt::mix32(hrow[kk] ^ jkey);
        v = rt::to_f(w[base + (h % kp)]);
        if (use_sign && (rt::mix32(srow[kk] ^ jkey) >> 31)) v = -v;
      }
      vs[kk][col] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float v = vs[kk][col];
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] += xs[rg * RPT + r][kk] * v;
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int gm = m0 + rg * RPT + r;
    if (gm >= M || j >= C) continue;
    if (ws != nullptr)
      ws[((long long)blockIdx.z * M + gm) * C + j] = acc[r];
    else
      y[(long long)gm * C + j] = rt::from_f<T>(acc[r]);
  }
}

// y = sum over splits of the fp32 partials, in split order (deterministic).
template <typename T>
__global__ void splitk_reduce(const float* __restrict__ ws, T* __restrict__ y,
                              long long mc, int splits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= mc) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[z * mc + idx];
  y[idx] = rt::from_f<T>(s);
}

template <typename T, int BM>
void launch(const void* x, const void* w, void* y, float* ws, int M, int R,
            int C, uint32_t kp, int panel_cols, uint32_t seed, int use_sign,
            int splits, cudaStream_t stream) {
  const int k_per_split = ((R + splits - 1) / splits + BK - 1) / BK * BK;
  const int nz = (R + k_per_split - 1) / k_per_split;
  dim3 grid((C + BN - 1) / BN, (M + BM - 1) / BM, nz);
  element_fwd<T, BM><<<grid, NT, 0, stream>>>(
      (const T*)x, (const T*)w, (T*)y, nz > 1 ? ws : nullptr, M, R, C, kp,
      panel_cols, seed, use_sign, k_per_split);
  if (nz > 1) {
    const long long mc = (long long)M * C;
    splitk_reduce<T><<<(unsigned)((mc + 255) / 256), 256, 0, stream>>>(
        ws, (T*)y, mc, nz);
  }
}

}  // namespace

// x (M, R), w (n_panels * kp,), y (M, C), all of dtype (0 fp32, 1 bf16);
// ws: fp32 workspace of splits * M * C floats when splits > 1.
extern "C" int hashed_element_matmul(const void* x, const void* w, void* y,
                                     void* ws, int M, int R, int C,
                                     unsigned kp, int panel_cols,
                                     unsigned seed, int use_sign, int dtype,
                                     int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* wsf = (float*)ws;
  const bool small = M <= 8;
  if (dtype == 1) {
    if (small)
      launch<__nv_bfloat16, 8>(x, w, y, wsf, M, R, C, kp, panel_cols, seed, use_sign, splits, s);
    else
      launch<__nv_bfloat16, 64>(x, w, y, wsf, M, R, C, kp, panel_cols, seed, use_sign, splits, s);
  } else {
    if (small)
      launch<float, 8>(x, w, y, wsf, M, R, C, kp, panel_cols, seed, use_sign, splits, s);
    else
      launch<float, 64>(x, w, y, wsf, M, R, C, kp, panel_cols, seed, use_sign, splits, s);
  }
  return (int)cudaGetLastError();
}
