// Element-mode hashed GEMM: y = x @ V (forward) or dx = g @ V^T
// (transpose), V[i,j] = xi(i,j) * w[panel(j) * Kp + h(i,j) % Kp].
//
// Replaces the JAX package's kernels/hashed_matmul.py _element_fwd_kernel
// (element_matmul, transpose=False and transpose=True).  The TPU kernel
// stages a panel's whole bucket slice in VMEM and decompresses each
// (bk, bn) tile of V next to the product, once per row block.  At full
// width that slice is 256 to 768 KB of bf16, more than a block's 227 KB
// of shared memory, so on the card every gathered value is a random L2
// read (a 32-byte sector for 2 bytes).  Two bodies, picked by the
// wrapper's plan (kernels/hashed_matmul.py gemm_plan):
//
// - bf16, M > 8 (training, prefill): decompress once per call, then
//   multiply on the tensor cores.  element_decompress writes V (R, C) in
//   bf16 into a workspace the wrapper allocates for this call (25.2 MB at
//   qwen3-1.7b's ffn.out; the product casts V to x's dtype, as the TPU
//   kernel does, so the values are the ones the TPU multiplies), hashing
//   each virtual weight once instead of once per 128-row block; then
//   tc_gemm (tile_gemm.cuh) reads it as dense tiles: MN-major for the
//   forward, K-major for the transpose, any panel_cols either way.  What
//   bounds it: the decompression's random L2 gathers, one 32-byte sector
//   per virtual weight (0.091 of 0.159 ms at ffn.out, M = 1024: the
//   H100 run of gemm_timing.py --split, PERF.md), then the GEMM's operand
//   traffic from L2.  Decompressing per 128-row
//   block inside the GEMM instead would pay those gathers M / 128 times.
// - fp32, or M <= 8 (decode): the fused CUDA-core body (decompress_gemm
//   with ElementTile), where the hashing of every virtual weight bounds
//   the kernel and tensor cores would add nothing.  The design pays that
//   once per (BM-row block, BK x BN tile) and reuses each decompressed
//   tile for all BM rows.  The first murmur round depends only on the
//   virtual row i: in the forward i runs along K and the round is
//   computed once per tile row into shared memory; in the transpose i is
//   the output column, so the round is a per-thread register, and the
//   virtual column j (the contraction index) contributes its key and its
//   panel's bucket base from shared memory.  The panel therefore follows
//   the contraction index in the transpose, and every K tile reads its
//   panel per tile row.  Split-K fills the card at M <= 8.
#include <algorithm>
#include "tile_gemm.cuh"

namespace {

using rt::TG_BK;
using rt::TG_BN;
using rt::TG_NT;

template <typename T, bool TRANS>
struct ElementTile {
  const T* w;
  uint32_t kp;
  int panel_cols;
  uint32_t seed;
  int use_sign;

  struct Shared {
    uint32_t a[TG_BK];      // fwd: first round of row i; trans: key of column j
    uint32_t b[TG_BK];      // fwd: first sign round of row i
    long long base[TG_BK];  // trans: bucket base of column j's panel
  };

  __device__ void init_cols(Shared&, int, int) const {}

  __device__ void init_rows(Shared& s, int k0, int tid) const {
    if (tid >= TG_BK) return;
    const uint32_t k = (uint32_t)(k0 + tid);
    if (!TRANS) {
      s.a[tid] = rt::mix32(k * rt::kGolden + seed);
      s.b[tid] = rt::mix32(k * rt::kGolden + (seed ^ rt::kSignSeedXor));
    } else {
      s.a[tid] = k * rt::kM1 + rt::kJOffset;
      s.base[tid] = panel_cols > 0
          ? (long long)((int)k / panel_cols) * (long long)kp : 0;
    }
  }

  __device__ void fill(const Shared& s, float (*vs)[TG_BN + 1], int k0,
                       int kend, int n0, int N, int tid) const {
    const int c = tid % TG_BN;
    const int n = n0 + c;
    uint32_t ck, cs = 0;      // per-thread constants of output column n
    long long cbase = 0;
    if (!TRANS) {             // n is the virtual column j
      ck = (uint32_t)n * rt::kM1 + rt::kJOffset;
      cbase = panel_cols > 0 ? (long long)(n / panel_cols) * (long long)kp : 0;
    } else {                  // n is the virtual row i
      ck = rt::mix32((uint32_t)n * rt::kGolden + seed);
      if (use_sign)
        cs = rt::mix32((uint32_t)n * rt::kGolden + (seed ^ rt::kSignSeedXor));
    }
    for (int kk = tid / TG_BN; kk < TG_BK; kk += TG_NT / TG_BN) {
      float v = 0.f;
      if (k0 + kk < kend && n < N) {
        if (!TRANS) {
          const uint32_t h = rt::mix32(s.a[kk] ^ ck);
          v = rt::to_f(w[cbase + (h % kp)]);
          if (use_sign && (rt::mix32(s.b[kk] ^ ck) >> 31)) v = -v;
        } else {
          const uint32_t h = rt::mix32(ck ^ s.a[kk]);
          v = rt::to_f(w[s.base[kk] + (h % kp)]);
          if (use_sign && (rt::mix32(cs ^ s.a[kk]) >> 31)) v = -v;
        }
      }
      vs[kk][c] = v;
    }
  }
};

// V (R, C) in bf16, 8 consecutive columns per thread: the bucket and
// sign of ElementTile's forward, with the two row rounds once per thread.
// Threads are ordered panel by panel (all rows of one panel's columns,
// then the next panel), so the blocks resident on an SM gather from one
// panel's bucket slice (256 KB at most qwen3-1.7b projections) and hit
// L1 more often; the gathers are random 2-byte reads, one 32-byte L2
// sector each, and bound this kernel.
__global__ void __launch_bounds__(256)
element_decompress(const uint16_t* __restrict__ w, uint4* __restrict__ v,
                   int R, int C, uint32_t kp, int panel_cols, uint32_t seed,
                   int use_sign) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int cpr = C / 8;
  const int pw = panel_cols > 0 ? min((panel_cols + 7) / 8, cpr) : cpr;
  const long long per_group = (long long)R * pw;
  const int g = (int)(e / per_group);
  const long long rem = e % per_group;
  const uint32_t i = (uint32_t)(rem / pw);
  const int cc = g * pw + (int)(rem % pw);
  if (cc >= cpr || (long long)i >= R) return;
  const int j0 = cc * 8;
  const uint32_t ra = rt::mix32(i * rt::kGolden + seed);
  const uint32_t rs = rt::mix32(i * rt::kGolden + (seed ^ rt::kSignSeedXor));
  uint32_t out[4];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int j = j0 + t;
    const uint32_t ck = (uint32_t)j * rt::kM1 + rt::kJOffset;
    const long long base =
        panel_cols > 0 ? (long long)(j / panel_cols) * (long long)kp : 0;
    uint32_t bits = w[base + rt::mix32(ra ^ ck) % kp];
    if (use_sign && (rt::mix32(rs ^ ck) >> 31)) bits ^= 0x8000u;
    if (t % 2 == 0) out[t / 2] = bits;
    else out[t / 2] |= bits << 16;
  }
  v[(long long)i * cpr + cc] = make_uint4(out[0], out[1], out[2], out[3]);
}

template <typename T>
void run_cuda_core(const void* x, const void* w, void* y, float* ws, int M,
                   int K, int N, uint32_t kp, int panel_cols, uint32_t seed,
                   int use_sign, int bm, int splits, int transpose,
                   cudaStream_t s) {
  if (transpose) {
    ElementTile<T, true> tile{(const T*)w, kp, panel_cols, seed, use_sign};
    rt::launch_gemm<T>(x, y, ws, M, K, N, bm, splits, tile, s);
  } else {
    ElementTile<T, false> tile{(const T*)w, kp, panel_cols, seed, use_sign};
    rt::launch_gemm<T>(x, y, ws, M, K, N, bm, splits, tile, s);
  }
}

}  // namespace

// Forward: x (M, K=R), y (M, N=C).  Transpose: x is g (M, K=C), y is dx
// (M, N=R).  w (n_panels * kp,); all of dtype (0 fp32, 1 bf16).  bm is
// the plan's row block: 8 or 64 run the CUDA-core body, 128 the
// tensor-core body (bf16 only, K and N multiples of 8), which first
// writes V (R, C) bf16 into vws.  ws: fp32 workspace of splits * M * N
// floats when splits > 1.
extern "C" int hashed_element_matmul(const void* x, const void* w, void* y,
                                     void* vws, void* ws, int M, int K, int N,
                                     unsigned kp, int panel_cols,
                                     unsigned seed, int use_sign, int dtype,
                                     int bm, int splits, int transpose,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* wsf = (float*)ws;
  if (bm == rt::TC_BM) {
    if (dtype != 1 || K % 8 || N % 8 || vws == nullptr)
      return (int)cudaErrorInvalidValue;
    const int R = transpose ? N : K, C = transpose ? K : N;
    const int cpr = C / 8;
    const int pw = panel_cols > 0 ? std::min((panel_cols + 7) / 8, cpr) : cpr;
    const long long chunks = (long long)R * pw * ((cpr + pw - 1) / pw);
    element_decompress<<<(unsigned)((chunks + 255) / 256), 256, 0, s>>>(
        (const uint16_t*)w, (uint4*)vws, R, C, kp, panel_cols, seed,
        use_sign);
    return (int)(transpose
                     ? rt::launch_tc_gemm<true>(x, vws, y, wsf, M, K, N, splits, s)
                     : rt::launch_tc_gemm<false>(x, vws, y, wsf, M, K, N, splits, s));
  }
  if (dtype == 1)
    run_cuda_core<__nv_bfloat16>(x, w, y, wsf, M, K, N, kp, panel_cols, seed,
                                 use_sign, bm, splits, transpose, s);
  else
    run_cuda_core<float>(x, w, y, wsf, M, K, N, kp, panel_cols, seed,
                         use_sign, bm, splits, transpose, s);
  return (int)cudaGetLastError();
}
