// Block-mode hashed GEMM and bank gradient.  Virtual tile (ti, tj) of V
// (block_shape brow x bcol) is sigma(ti, tj) * bank[idx(ti, tj)]; the
// (gi, gj) tables idx and sigma are row-major, linear index ti * gj + tj,
// in both orientations.
//
// block_matmul replaces the JAX package's kernels/hashed_matmul.py
// _block_fwd_kernel (block_matmul, transpose=False and True): y = x @ V
// or dx = g @ V^T.  The TPU kernel DMAs the chosen bank tile into VMEM
// through a scalar-prefetched index map and casts it to x's dtype.
// Nothing is hashed per element here, so the product is the work:
//
// - bf16, M > 8: block_decompress copies the bank tiles, signs folded
//   in (a sign flip rounds nothing), into a dense bf16 V (R, C) in a
//   workspace the wrapper allocates for this call, then the tensor-core
//   body (tile_gemm.cuh tc_gemm) multiplies: V MN-major for the forward,
//   K-major for the transpose (the same rows, taken transposed by the
//   MMA).  Each 16-byte chunk of 8 virtual columns lies in one bank tile
//   row (bcol % 8 == 0).  Gathering the bank tiles inside the GEMM's
//   loader instead (each chunk's tile index and sign looked up per K
//   tile, the sign folded into shared memory) was timed slower on the
//   card at M = 1024 (PERF.md): the dense copy costs 2 R C bytes
//   written and read back, the loader's lookups stall every K tile.
//   What bounds it: the GEMM's operand traffic from L2 (tile_gemm.cuh).
// - fp32, or M <= 8: the CUDA-core body (decompress_gemm with BlockTile),
//   which stages each 32 x 64 piece of V or V^T into shared memory, the
//   copy coalesced along the bank tile's rows (threads step along the
//   bank's column index in both orientations; the transpose writes shared
//   memory transposed, padded against bank conflicts).
//
// block_dw replaces _block_dw_kernel (block_dw): dbank[b] = sum over the
// virtual tiles t with idx(t) = b of sigma(t) * (x^T g)[tile t].  The
// TPU walks virtual tiles sorted by bank index (a stable argsort),
// takes each x^T g as a bf16 dot with fp32 sums, and revisits the
// output tile with store-then-add.  Here every bank tile's chain (its
// virtual tiles in the same sorted order) is summed in a fixed order
// and written once: deterministic, no atomics, and a bank tile no
// virtual tile maps to gets zeros.  Same work and operand bytes as one
// hashed GEMM of the shape (2 M R C flops), so the tensor cores bound it.
//
// - bf16 (tile rows and columns multiples of 8): tile_gemm.cuh tc_xtg,
//   wgmma.m64n128k16 with bf16 operands and fp32 sums (the TPU kernel's
//   own arithmetic: a bf16 x bf16 product is exact in fp32, only the
//   summation order differs).  One block multiplies one piece of one
//   bank tile's chain (virtual tile x 64-row step of M) into a 128 x 128
//   output tile; the wrapper's plan (kernels/hashed_matmul.py
//   block_dw_plan) cuts every chain into the same number of pieces so
//   that enough blocks fill the 132 SMs, and splitk_reduce adds the
//   pieces' fp32 partials in split order.
// - fp32, or tile shapes the tensor-core body does not take: one block
//   owns a 64 x 64 piece of one bank tile and sums sigma * x^T g over all
//   M rows in registers on the CUDA cores (xtg_accumulate).
#include "tile_gemm.cuh"

namespace {

using rt::TG_BK;
using rt::TG_BN;
using rt::TG_NT;

template <typename T, bool TRANS>
struct BlockTile {
  const T* bank;
  const int* idx;
  const int* sgn;
  int brow, bcol, gj;

  // Each element of the staged piece splits into a contribution of its
  // K index (row kk) and of its output column: linear tile index
  // kt + ct, offset inside the bank tile ko + co.
  struct Shared {
    int kt[TG_BK];
    int ko[TG_BK];
    int ct[TG_BN];
    int co[TG_BN];
  };

  __device__ void init_cols(Shared& s, int n0, int tid) const {
    if (tid >= TG_BN) return;
    const int n = n0 + tid;
    if (!TRANS) {            // n is the virtual column j
      s.ct[tid] = n / bcol;
      s.co[tid] = n % bcol;
    } else {                 // n is the virtual row i
      s.ct[tid] = (n / brow) * gj;
      s.co[tid] = (n % brow) * bcol;
    }
  }

  __device__ void init_rows(Shared& s, int k0, int tid) const {
    if (tid >= TG_BK) return;
    const int k = k0 + tid;
    if (!TRANS) {            // k is the virtual row i
      s.kt[tid] = (k / brow) * gj;
      s.ko[tid] = (k % brow) * bcol;
    } else {                 // k is the virtual column j
      s.kt[tid] = k / bcol;
      s.ko[tid] = k % bcol;
    }
  }

  __device__ void fill(const Shared& s, float (*vs)[TG_BN + 1], int k0,
                       int kend, int n0, int N, int tid) const {
    const long long tile_elems = (long long)brow * bcol;
    for (int e = tid; e < TG_BK * TG_BN; e += TG_NT) {
      // consecutive threads step along the bank tile's column index j
      const int kk = TRANS ? e % TG_BK : e / TG_BN;
      const int c = TRANS ? e / TG_BK : e % TG_BN;
      float v = 0.f;
      if (k0 + kk < kend && n0 + c < N) {
        const int t = s.kt[kk] + s.ct[c];
        v = rt::to_f(bank[(long long)idx[t] * tile_elems + s.ko[kk] + s.co[c]]);
        if (sgn[t] < 0) v = -v;
      }
      vs[kk][c] = v;
    }
  }
};

// V (R, C) in bf16 for the tensor-core body, 8 consecutive columns of
// one row per thread: a 16-byte copy from the bank tile, its sign folded
// in (a sign flip rounds nothing).  bcol % 8 == 0, so the 8 columns lie
// in one bank tile row.
__global__ void __launch_bounds__(256)
block_decompress(const uint4* __restrict__ bank, const int* __restrict__ idx,
                 const int* __restrict__ sgn, uint4* __restrict__ v, int R,
                 int C, int brow, int bcol, int gj) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int cpr = C / 8;
  if (e >= (long long)R * cpr) return;
  const int i = (int)(e / cpr), j = (int)(e % cpr) * 8;
  const int t = (i / brow) * gj + j / bcol;
  uint4 u = bank[((long long)idx[t] * brow * bcol + (i % brow) * bcol +
                  j % bcol) / 8];
  if (sgn[t] < 0) {
    u.x ^= 0x80008000u; u.y ^= 0x80008000u;
    u.z ^= 0x80008000u; u.w ^= 0x80008000u;
  }
  v[e] = u;
}

template <typename T>
__global__ void __launch_bounds__(rt::TG_NT)
block_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                const int* __restrict__ order, const int* __restrict__ offsets,
                const int* __restrict__ sgn, float* __restrict__ dbank, int M,
                int R, int C, int brow, int bcol, int gj) {
  __shared__ float xs[rt::XTG_BM][rt::XTG_T];
  __shared__ float gs[rt::XTG_BM][rt::XTG_T];
  const int b = blockIdx.z;
  const int pr0 = blockIdx.y * rt::XTG_T, pc0 = blockIdx.x * rt::XTG_T;
  const int rlim = min(rt::XTG_T, brow - pr0), clim = min(rt::XTG_T, bcol - pc0);
  float acc[4][4] = {};
  for (int p = offsets[b]; p < offsets[b + 1]; ++p) {
    const int t = order[p];
    const int ti = t / gj, tj = t % gj;
    rt::xtg_accumulate<T>(acc, x, g, M, R, C, ti * brow + pr0, rlim,
                          tj * bcol + pc0, clim, sgn[t] < 0 ? -1.f : 1.f,
                          xs, gs);
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* out = dbank + (long long)b * brow * bcol;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (r >= rlim) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cc = tx + 16 * c;
      if (cc < clim) out[(long long)(pr0 + r) * bcol + pc0 + cc] = acc[a][c];
    }
  }
}

template <typename T>
void run_cuda_core(const void* x, const void* bank, const int* idx,
                   const int* sgn, void* y, float* ws, int M, int K, int N,
                   int brow, int bcol, int gj, int bm, int splits,
                   int transpose, cudaStream_t s) {
  if (transpose) {
    BlockTile<T, true> tile{(const T*)bank, idx, sgn, brow, bcol, gj};
    rt::launch_gemm<T>(x, y, ws, M, K, N, bm, splits, tile, s);
  } else {
    BlockTile<T, false> tile{(const T*)bank, idx, sgn, brow, bcol, gj};
    rt::launch_gemm<T>(x, y, ws, M, K, N, bm, splits, tile, s);
  }
}

}  // namespace

// Forward: x (M, K=R) -> y (M, N=C); transpose: g (M, K=C) -> dx (M, N=R).
// bank (tiles, brow, bcol); idx, sgn int32 (gi * gj); dtype 0 fp32 / 1
// bf16; bm the plan's row block: 8 or 64 run the CUDA-core body, 128 the
// tensor-core body (bf16, K, N and bcol multiples of 8), which first
// writes V (R, C) bf16 into vws.  ws fp32 splits * M * N when splits >
// 1.  R = gi * brow and C = gj * bcol exactly (the wrapper refuses
// ragged tile grids).
extern "C" int hashed_block_matmul(const void* x, const void* bank,
                                   const void* idx, const void* sgn, void* y,
                                   void* vws, void* ws, int M, int K, int N,
                                   int brow, int bcol, int gj, int dtype,
                                   int bm, int splits, int transpose,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bm == rt::TC_BM) {
    if (dtype != 1 || K % 8 || N % 8 || bcol % 8 || vws == nullptr)
      return (int)cudaErrorInvalidValue;
    const int R = transpose ? N : K, C = transpose ? K : N;
    const long long chunks = (long long)R * C / 8;
    block_decompress<<<(unsigned)((chunks + 255) / 256), 256, 0, s>>>(
        (const uint4*)bank, (const int*)idx, (const int*)sgn, (uint4*)vws, R,
        C, brow, bcol, gj);
    float* wsf = (float*)ws;
    return (int)(transpose
                     ? rt::launch_tc_gemm<true>(x, vws, y, wsf, M, K, N, splits, s)
                     : rt::launch_tc_gemm<false>(x, vws, y, wsf, M, K, N, splits, s));
  }
  if (dtype == 1)
    run_cuda_core<__nv_bfloat16>(x, bank, (const int*)idx, (const int*)sgn, y,
                                 (float*)ws, M, K, N, brow, bcol, gj, bm,
                                 splits, transpose, s);
  else
    run_cuda_core<float>(x, bank, (const int*)idx, (const int*)sgn, y,
                         (float*)ws, M, K, N, brow, bcol, gj, bm, splits,
                         transpose, s);
  return (int)cudaGetLastError();
}

// x (M, R), g (M, C) of dtype; order int32 (gi * gj) linear virtual tile
// indices stably sorted by bank tile; offsets int32 (bank_tiles + 1);
// sgn int32 (gi * gj); heavy int32 (bank_tiles) bank tiles by descending
// chain length; dbank fp32 (bank_tiles, brow, bcol).  tensor_core 1 runs
// tc_xtg (bf16; brow, bcol multiples of 8) cutting each chain into
// `splits` pieces, with ws fp32 (splits, bank_tiles, brow, bcol) when
// splits > 1; 0 the CUDA-core body.
extern "C" int hashed_block_dw(const void* x, const void* g,
                               const void* order, const void* offsets,
                               const void* sgn, const void* heavy,
                               void* dbank, void* ws, int M, int R, int C,
                               int brow, int bcol, int gj, int bank_tiles,
                               int dtype, int tensor_core, int splits,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tensor_core) {
    if (dtype != 1 || brow % 8 || bcol % 8 || splits < 1 ||
        (splits > 1 && ws == nullptr))
      return (int)cudaErrorInvalidValue;
    return (int)rt::launch_tc_xtg(
        x, g, (const int*)order, (const int*)offsets, (const int*)sgn,
        (const int*)heavy, (float*)dbank, (float*)ws, M, R, C, brow, bcol,
        gj, bank_tiles, splits, s);
  }
  dim3 grid((bcol + rt::XTG_T - 1) / rt::XTG_T,
            (brow + rt::XTG_T - 1) / rt::XTG_T, bank_tiles);
  if (dtype == 1)
    block_dw_kernel<__nv_bfloat16><<<grid, rt::TG_NT, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (const int*)order,
        (const int*)offsets, (const int*)sgn, (float*)dbank, M, R, C, brow,
        bcol, gj);
  else
    block_dw_kernel<float><<<grid, rt::TG_NT, 0, s>>>(
        (const float*)x, (const float*)g, (const int*)order,
        (const int*)offsets, (const int*)sgn, (float*)dbank, M, R, C, brow,
        bcol, gj);
  return (int)cudaGetLastError();
}
