// Element-mode fused decompress-GEMM: y = x @ V (forward) or
// dx = g @ V^T (transpose), V[i,j] = xi(i,j) * w[panel(j) * Kp + h(i,j) % Kp],
// V never stored.
//
// Replaces the JAX package's kernels/hashed_matmul.py _element_fwd_kernel
// (element_matmul, transpose=False and transpose=True).  The TPU kernel
// stages a panel's whole bucket slice in VMEM; at full width that slice is
// 512 KB to 1.5 MB, more than a block's 227 KB of shared memory, so here
// the gather reads global memory and mostly hits the 50 MB L2.  The TPU
// carries the K-sum across a sequential grid axis; here it is a loop over
// K inside the block (tile_gemm.cuh), optionally split across blocks so
// that decode, with M <= 8 rows, still fills the card.
//
// What bounds it: not bytes (the bank is ~1/8 of a dense weight) nor the
// product, but hashing every virtual weight of V: two murmur rounds for
// the bucket and one more for the sign per element.  The design pays that
// once per (BM-row block, BK x BN tile) and reuses each decompressed tile
// for all BM rows.  The first murmur round depends only on the virtual
// row i: in the forward i runs along K and the round is computed once per
// tile row into shared memory; in the transpose i is the output column,
// so the round is a per-thread register, and the virtual column j (the
// contraction index) contributes its key and its panel's bucket base from
// shared memory.  The panel therefore follows the contraction index in
// the transpose, and every K tile reads its panel per tile row.
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

template <typename T>
void run(const void* x, const void* w, void* y, float* ws, int M, int K,
         int N, uint32_t kp, int panel_cols, uint32_t seed, int use_sign,
         int splits, int transpose, cudaStream_t s) {
  if (transpose) {
    ElementTile<T, true> tile{(const T*)w, kp, panel_cols, seed, use_sign};
    rt::launch_gemm<T>(x, y, ws, M, K, N, splits, tile, s);
  } else {
    ElementTile<T, false> tile{(const T*)w, kp, panel_cols, seed, use_sign};
    rt::launch_gemm<T>(x, y, ws, M, K, N, splits, tile, s);
  }
}

}  // namespace

// Forward: x (M, K=R), y (M, N=C).  Transpose: x is g (M, K=C), y is dx
// (M, N=R).  w (n_panels * kp,); all of dtype (0 fp32, 1 bf16); ws: fp32
// workspace of splits * M * N floats when splits > 1.
extern "C" int hashed_element_matmul(const void* x, const void* w, void* y,
                                     void* ws, int M, int K, int N,
                                     unsigned kp, int panel_cols,
                                     unsigned seed, int use_sign, int dtype,
                                     int splits, int transpose, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* wsf = (float*)ws;
  if (dtype == 1)
    run<__nv_bfloat16>(x, w, y, wsf, M, K, N, kp, panel_cols, seed, use_sign,
                       splits, transpose, s);
  else
    run<float>(x, w, y, wsf, M, K, N, kp, panel_cols, seed, use_sign, splits,
               transpose, s);
  return (int)cudaGetLastError();
}
