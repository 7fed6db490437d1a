// Shared bodies of the hashed GEMM kernels.
//
// decompress_gemm: y (M, N) = x (M, K) @ Vop, where Vop (K, N) is a
// virtual matrix that is never stored.  A Tile policy decompresses one
// (TG_BK x TG_BN) tile of it into shared memory per K step; the block
// reuses that tile for all BM rows of x.  The element-mode tiles
// (hashed_matmul.cu) recompute bucket and sign from the murmur hash, the
// block-mode tiles (hashed_block.cu) copy a piece of one bank tile.
// Vop is V (forward, y = x @ V) or V^T (transpose, dx = g @ V^T).  The
// K loop may be split across blocks (split-K): each split writes an fp32
// partial into a workspace and splitk_reduce adds them in split order,
// so the result does not depend on scheduling.
//
// xtg_accumulate: one 64 x 64 tile of x^T g (x (M, R), g (M, C)) summed
// over all M rows into registers, the product both dw kernels need.
#pragma once
#include "common.cuh"

namespace rt {

constexpr int TG_BN = 64;    // output columns per block
constexpr int TG_BK = 32;    // contraction step
constexpr int TG_NT = 256;   // threads per block: 64 columns x 4 row groups

template <typename T, int BM, class Tile>
__global__ void __launch_bounds__(TG_NT)
decompress_gemm(const T* __restrict__ x, T* __restrict__ y,
                float* __restrict__ ws, int M, int K, int N, int k_per_split,
                Tile tile) {
  constexpr int RPT = BM / (TG_NT / TG_BN);   // output rows per thread
  __shared__ float xs[BM][TG_BK];
  __shared__ float vs[TG_BK][TG_BN + 1];
  __shared__ typename Tile::Shared sh;

  const int tid = threadIdx.x;
  const int col = tid % TG_BN;
  const int rg = tid / TG_BN;
  const int n0 = blockIdx.x * TG_BN;
  const int m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  tile.init_cols(sh, n0, tid);

  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += TG_BK) {
    tile.init_rows(sh, k0, tid);
    for (int e = tid; e < BM * TG_BK; e += TG_NT) {
      const int r = e / TG_BK, kk = e % TG_BK;
      const int gm = m0 + r, gk = k0 + kk;
      xs[r][kk] = (gm < M && gk < kend) ? to_f(x[(long long)gm * K + gk]) : 0.f;
    }
    __syncthreads();
    tile.fill(sh, vs, k0, kend, n0, N, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TG_BK; ++kk) {
      const float v = vs[kk][col];
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] += xs[rg * RPT + r][kk] * v;
    }
    __syncthreads();
  }

  const int j = n0 + col;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int gm = m0 + rg * RPT + r;
    if (gm >= M || j >= N) continue;
    if (ws != nullptr)
      ws[((long long)blockIdx.z * M + gm) * N + j] = acc[r];
    else
      y[(long long)gm * N + j] = from_f<T>(acc[r]);
  }
}

// y = sum over splits of the fp32 partials, in split order (deterministic).
template <typename T>
__global__ void splitk_reduce(const float* __restrict__ ws, T* __restrict__ y,
                              long long mn, int splits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[z * mn + idx];
  y[idx] = from_f<T>(s);
}

template <typename T, int BM, class Tile>
void launch_gemm_bm(const void* x, void* y, float* ws, int M, int K, int N,
                    int splits, const Tile& tile, cudaStream_t stream) {
  const int k_per_split = ((K + splits - 1) / splits + TG_BK - 1) / TG_BK * TG_BK;
  const int nz = (K + k_per_split - 1) / k_per_split;
  dim3 grid((N + TG_BN - 1) / TG_BN, (M + BM - 1) / BM, nz);
  decompress_gemm<T, BM, Tile><<<grid, TG_NT, 0, stream>>>(
      (const T*)x, (T*)y, nz > 1 ? ws : nullptr, M, K, N, k_per_split, tile);
  if (nz > 1) {
    const long long mn = (long long)M * N;
    splitk_reduce<T><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
        ws, (T*)y, mn, nz);
  }
}

// 8-row blocks for decode-sized M (with split-K filling the card), else 64.
template <typename T, class Tile>
void launch_gemm(const void* x, void* y, float* ws, int M, int K, int N,
                 int splits, const Tile& tile, cudaStream_t stream) {
  if (M <= 8)
    launch_gemm_bm<T, 8, Tile>(x, y, ws, M, K, N, splits, tile, stream);
  else
    launch_gemm_bm<T, 64, Tile>(x, y, ws, M, K, N, splits, tile, stream);
}

// ---------------------------------------------------------------------------
// x^T g tiles for the dw kernels
// ---------------------------------------------------------------------------

constexpr int XTG_T = 64;    // output tile edge
constexpr int XTG_BM = 16;   // rows of x / g staged per step

// acc[a][b] += sum_m sigma * x[m, xr0 + ty + 16a] * g[m, gc0 + tx + 16b]
// for a, b in 0..3 (tx = tid % 16, ty = tid / 16, 256 threads); tile rows
// at or past rlim and columns at or past clim read as zero.  sigma is +-1,
// so folding it into the x operand rounds nothing.
template <typename T>
__device__ __forceinline__ void xtg_accumulate(
    float (&acc)[4][4], const T* __restrict__ x, const T* __restrict__ g,
    int M, int R, int C, int xr0, int rlim, int gc0, int clim, float sigma,
    float (*xs)[XTG_T], float (*gs)[XTG_T]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int m0 = 0; m0 < M; m0 += XTG_BM) {
    for (int e = tid; e < XTG_BM * XTG_T; e += TG_NT) {
      const int mm = e / XTG_T, rr = e % XTG_T;
      const int gm = m0 + mm;
      xs[mm][rr] = (gm < M && rr < rlim)
          ? sigma * to_f(x[(long long)gm * R + xr0 + rr]) : 0.f;
      gs[mm][rr] = (gm < M && rr < clim)
          ? to_f(g[(long long)gm * C + gc0 + rr]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < XTG_BM; ++mm) {
      float xa[4], gb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) xa[a] = xs[mm][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) gb[b] = gs[mm][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] += xa[a] * gb[b];
    }
    __syncthreads();
  }
}

}  // namespace rt
