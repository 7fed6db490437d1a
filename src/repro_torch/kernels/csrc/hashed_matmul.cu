// Element-mode hashed GEMM: y = x @ V (forward) or dx = g @ V^T
// (transpose), V[i,j] = xi(i,j) * w[panel(j) * Kp + h(i,j) % Kp].
//
// Replaces the JAX package's kernels/hashed_matmul.py _element_fwd_kernel
// (element_matmul, transpose=False and transpose=True).  The TPU kernel
// stages a panel's whole bucket slice in VMEM and decompresses each
// (bk, bn) tile of V next to the product, once per row block.  At full
// width that slice is 256 to 768 KB of bf16, more than a block's 227 KB
// of shared memory, so on the card every gathered value is a random read
// from L1 or L2 (a 32-byte sector for 2 bytes).  Three bodies, picked by
// the wrapper's plan (kernels/hashed_matmul.py gemm_plan):
//
// - gemv: the forward of at most 16 rows (decode; bf16 or fp32), where
//   the hashing of every virtual weight bounds the kernel and an MMA would
//   be mostly padding.  Each thread owns GV_CPT adjacent output columns,
//   their column keys in registers, and walks a K range: it hashes GV_U
//   rows of its columns, issues those bank reads, applies the signs and
//   adds x[m][i] * V[i][j] straight into its M accumulators (M a template
//   parameter: one FMA per weight at M = 1).  No V tile in shared memory
//   and no barrier per K step: x's rows over the block's K range and the
//   row rounds of the hash are staged once.  GV_KSUB threads share a
//   column, splitting the block's K range; their sums are added in shared
//   memory in a fixed order, and the blocks' K splits in split order by
//   splitk_reduce (no float atomics: the same bits every launch).  A block
//   covers GV_BN columns, inside one 512-column panel at qwen3-1.7b's
//   widths, one block an SM: it stages as much of that panel's bucket
//   slice in shared memory as fits (gv_held: 113K of the 131K values of a
//   256 KB slice, 113K of ffn.out's 393K) and reads the rest by
//   predicated loads through L1 and L2.  A warp's 32 scattered reads cost
//   a few shared-memory bank conflicts there, against one L1 pass per
//   line (or one L2 request per sector) from global memory.  What bounds
//   it (H100 timings in PERF.md): the integer pipes (~38 instructions a
//   weight at M = 8, the two murmur mixes first) where most of the slice
//   fits, L2 requests for the rest at ffn.out; a cluster of CTAs sharing
//   one slice over distributed shared memory and 1024-thread blocks
//   timed slower.
// - bf16 otherwise, M > 8 (training, prefill): decompress once per call,
//   then multiply on the tensor cores.  element_decompress writes V (R, C) in
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
// - fp32 otherwise, and the transpose at M <= 8: the fused CUDA-core body
//   (decompress_gemm with ElementTile), which decompresses each
//   (BK x BN) tile into shared memory once per BM-row block and reuses it
//   for all BM rows.  The first murmur round depends only on the
//   virtual row i: in the forward i runs along K and the round is
//   computed once per tile row into shared memory; in the transpose i is
//   the output column, so the round is a per-thread register, and the
//   virtual column j (the contraction index) contributes its key and its
//   panel's bucket base from shared memory.  The panel therefore follows
//   the contraction index in the transpose, and every K tile reads its
//   panel per tile row.  Split-K fills the card at M <= 8.
//
// Every body reduces the hash to a bucket with rt::bucket_mod
// (common.cuh) and the per-spec magic constant the wrapper passes.
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
  uint32_t magic;
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
          v = rt::to_f(w[cbase + rt::bucket_mod(h, kp, magic)]);
          if (use_sign && (rt::mix32(s.b[kk] ^ ck) >> 31)) v = -v;
        } else {
          const uint32_t h = rt::mix32(ck ^ s.a[kk]);
          v = rt::to_f(w[s.base[kk] + rt::bucket_mod(h, kp, magic)]);
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
                   int R, int C, uint32_t kp, uint32_t magic, int panel_cols,
                   uint32_t seed, int use_sign) {
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
    uint32_t bits = w[base + rt::bucket_mod(rt::mix32(ra ^ ck), kp, magic)];
    if (use_sign && (rt::mix32(rs ^ ck) >> 31)) bits ^= 0x8000u;
    if (t % 2 == 0) out[t / 2] = bits;
    else out[t / 2] |= bits << 16;
  }
  v[(long long)i * cpr + cc] = make_uint4(out[0], out[1], out[2], out[3]);
}

template <typename T>
void run_cuda_core(const void* x, const void* w, void* y, float* ws, int M,
                   int K, int N, uint32_t kp, uint32_t magic, int panel_cols,
                   uint32_t seed, int use_sign, int bm, int splits,
                   int transpose, cudaStream_t s) {
  if (transpose) {
    ElementTile<T, true> tile{(const T*)w, kp, magic, panel_cols, seed,
                              use_sign};
    rt::launch_gemm<T>(x, y, ws, M, K, N, bm, splits, tile, s);
  } else {
    ElementTile<T, false> tile{(const T*)w, kp, magic, panel_cols, seed,
                               use_sign};
    rt::launch_gemm<T>(x, y, ws, M, K, N, bm, splits, tile, s);
  }
}

// ---------------------------------------------------------------------------
// gemv body: the forward at decode size
// ---------------------------------------------------------------------------

constexpr int GV_NT = 512;                   // threads per block
constexpr int GV_CPT = 2;                    // adjacent output columns a thread
constexpr int GV_KSUB = 4;                   // threads (K sub-ranges) a column
constexpr int GV_GROUPS = GV_NT / GV_KSUB;   // column groups a block
constexpr int GV_BN = GV_GROUPS * GV_CPT;    // output columns a block: 256
constexpr int GV_U = 8;                      // rows hashed before their FMAs
constexpr int GV_KSTEP = GV_KSUB * GV_U;     // K granularity of a split
constexpr int GV_KC = 512;                   // rows of x staged at a time
constexpr int GV_SMEM_MAX = 232448 - 1024;   // dynamic shared memory a block

// Dynamic shared memory: a chunk's row rounds (GV_KC x uint2) and x's
// rows over it (GV_KC x MT fp32, row-interleaved), then as many bank
// values of the block's panel as fit (`held`, a multiple of 8), reused
// after the K walk for the partial sums of sub-ranges 1..
__host__ __device__ constexpr int gv_stage_bytes(int mt) {
  return GV_KC * 8 + GV_KC * mt * 4;
}
template <typename T>
inline int gv_held(int mt, uint32_t kp) {
  const int room = (GV_SMEM_MAX - gv_stage_bytes(mt)) / (int)sizeof(T) / 8 * 8;
  return (int)std::min<long long>(((long long)kp + 7) / 8 * 8, room);
}
template <typename T>
inline int gv_smem_bytes(int mt, uint32_t kp) {
  const int red = (GV_KSUB - 1) * mt * GV_CPT * GV_GROUPS * 4;
  return gv_stage_bytes(mt) +
         std::max(red, gv_held<T>(mt, kp) * (int)sizeof(T));
}

// A bank value's fp32 bits (bf16: the upper half), from global memory
// by the read-only path, or bucket b from the `held` values staged in
// shared memory at `sbank` and the rest from global memory at `wp`: two
// complementary predicated loads into one register, so the lanes of a
// warp that read shared memory add no branch and no select.
__device__ __forceinline__ uint32_t global_bits(const float* p) {
  return __float_as_uint(__ldg(p));
}
__device__ __forceinline__ uint32_t global_bits(const __nv_bfloat16* p) {
  return (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16;
}
__device__ __forceinline__ uint32_t split_bits(uint32_t b, uint32_t held,
                                               uint32_t sbank,
                                               const float* wp) {
  uint32_t v;
  asm("{\n.reg .pred q;\nsetp.lt.u32 q, %1, %2;\n"
      "@q ld.shared.u32 %0, [%3];\n@!q ld.global.nc.u32 %0, [%4];\n}\n"
      : "=r"(v) : "r"(b), "r"(held), "r"(sbank + 4 * b), "l"(wp + b));
  return v;
}
__device__ __forceinline__ uint32_t split_bits(uint32_t b, uint32_t held,
                                               uint32_t sbank,
                                               const __nv_bfloat16* wp) {
  unsigned short v;
  asm("{\n.reg .pred q;\nsetp.lt.u32 q, %1, %2;\n"
      "@q ld.shared.u16 %0, [%3];\n@!q ld.global.nc.u16 %0, [%4];\n}\n"
      : "=h"(v) : "r"(b), "r"(held), "r"(sbank + 2 * b), "l"(wp + b));
  return (uint32_t)v << 16;
}

// One block's walk over K rows [kbeg, kend) in chunks of GV_KC (one
// chunk at qwen3-1.7b's decode shapes): stage the chunk's row rounds and
// x, then each K sub-range hashes GV_U rows of the thread's columns,
// issues all their bank reads (`read(c, bucket)`), applies the signs and
// adds x[m][i] * V[i][j] into acc.
template <typename T, int MT, bool SIGN, class Read>
__device__ __forceinline__ void gv_walk(float (&acc)[MT][GV_CPT],
                                        const T* __restrict__ x, int M,
                                        int K, int kbeg, int kend,
                                        const uint32_t (&ck)[GV_CPT],
                                        uint32_t seed, uint32_t kp,
                                        uint32_t magic, uint2* sab,
                                        float* sx, const Read& read) {
  const int tid = threadIdx.x, sub = tid / GV_GROUPS;
  const uint32_t sseed = seed ^ rt::kSignSeedXor;
  for (int k0 = kbeg; k0 < kend; k0 += GV_KC) {
    // the chunk's rows, padded to whole steps: x zero past K (and past
    // M), so a padded row adds exact zeros
    const int rows = min(GV_KC, kend - k0);
    const int span = (rows + GV_KSTEP - 1) / GV_KSTEP * GV_KSTEP;
    for (int r = tid; r < span; r += GV_NT) {
      const uint32_t i = (uint32_t)(k0 + r);
      sab[r] = make_uint2(rt::mix32(i * rt::kGolden + seed),
                          SIGN ? rt::mix32(i * rt::kGolden + sseed) : 0u);
    }
    for (int e = tid; e < span * MT; e += GV_NT) {
      const int m = e / span, r = e % span;
      sx[r * MT + m] = (m < M && r < rows)
          ? rt::to_f(x[(long long)m * K + k0 + r]) : 0.f;
    }
    rt::cp_async_wait<0>();      // the bank values this thread staged
    __syncthreads();
    const int per = span / GV_KSUB;      // a multiple of GV_U
    for (int r0 = sub * per; r0 < (sub + 1) * per; r0 += GV_U) {
      // all GV_U x GV_CPT reads in flight before the first use
      uint32_t bits[GV_U][GV_CPT], neg[GV_U][GV_CPT];
#pragma unroll
      for (int u = 0; u < GV_U; ++u) {
        const uint32_t a = sab[r0 + u].x;
#pragma unroll
        for (int c = 0; c < GV_CPT; ++c)
          bits[u][c] = read(c, rt::bucket_mod(rt::mix32(a ^ ck[c]), kp,
                                              magic));
      }
#pragma unroll
      for (int u = 0; u < GV_U; ++u) {
        const uint32_t b = sab[r0 + u].y;
#pragma unroll
        for (int c = 0; c < GV_CPT; ++c)
          neg[u][c] = SIGN ? rt::mix32(b ^ ck[c]) & 0x80000000u : 0u;
      }
#pragma unroll
      for (int u = 0; u < GV_U; ++u) {
        float xv[MT];
        const float* xr = sx + (r0 + u) * MT;
        if constexpr (MT % 4 == 0) {
#pragma unroll
          for (int q = 0; q < MT / 4; ++q) {
            const float4 t = reinterpret_cast<const float4*>(xr)[q];
            xv[4 * q] = t.x;
            xv[4 * q + 1] = t.y;
            xv[4 * q + 2] = t.z;
            xv[4 * q + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int m = 0; m < MT; ++m) xv[m] = xr[m];
        }
#pragma unroll
        for (int c = 0; c < GV_CPT; ++c) {
          const float v = __uint_as_float(bits[u][c] ^ neg[u][c]);
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(xv[m], v, acc[m][c]);
        }
      }
    }
    __syncthreads();    // the chunk and the bank values are read
  }
}

// Issue the copies of n values from src (global) to dst (shared), 16
// bytes a copy by cp.async where src is aligned, the rest by plain
// loads; the walk waits for them before its first barrier, so they land
// while x is staged.
template <typename T>
__device__ __forceinline__ void gv_fill(T* dst, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x;
  int head = 0;
  if (((uintptr_t)src & 15) == 0) {
    head = n / V * V;
    for (int e = tid * V; e < head; e += GV_NT * V)
      rt::cp_async16(rt::smem_u32(dst + e), src + e, true);
    rt::cp_async_commit();
  }
  for (int e = head + tid; e < n; e += GV_NT) dst[e] = src[e];
}

// y (M, N) = x (M, K) @ V, V (K, N) the virtual matrix, M <= MT; or fp32
// partials into ws[blockIdx.y] when ws is set (splitk_reduce adds them in
// split order).  Grid: (column blocks of GV_BN, K splits of k_per_split
// rows, a multiple of GV_KSTEP).
template <typename T, int MT, bool SIGN>
__global__ void __launch_bounds__(GV_NT, 1)
hashed_gemv(const T* __restrict__ x, const T* __restrict__ w,
            T* __restrict__ y, float* __restrict__ ws, int M, int K, int N,
            int k_per_split, uint32_t kp, uint32_t magic, int panel_cols,
            uint32_t seed, int held) {
  extern __shared__ float4 gv_smem4[];
  uint2* sab = reinterpret_cast<uint2*>(gv_smem4);
  float* sx = reinterpret_cast<float*>(sab + GV_KC);
  float* tail = sx + GV_KC * MT;
  T* sbank = reinterpret_cast<T*>(tail);   // bank values, then partials

  const int tid = threadIdx.x;
  const int grp = tid % GV_GROUPS, sub = tid / GV_GROUPS;
  const int jb = blockIdx.x * GV_BN;
  const int j0 = jb + grp * GV_CPT;
  const int kbeg = blockIdx.y * k_per_split;
  const int kend = min(K, kbeg + k_per_split);

  // per column: its key and its panel's slice of the bank (columns past N
  // read panel 0 and are not written)
  uint32_t ck[GV_CPT];
  const T* wc[GV_CPT];
#pragma unroll
  for (int c = 0; c < GV_CPT; ++c) {
    const int j = j0 + c;
    ck[c] = (uint32_t)j * rt::kM1 + rt::kJOffset;
    wc[c] = w + ((j < N && panel_cols > 0)
                     ? (long long)(j / panel_cols) * (long long)kp : 0);
  }
  float acc[MT][GV_CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < GV_CPT; ++c) acc[m][c] = 0.f;

  // the block's columns in one panel (block-uniform): the slice's first
  // `held` values staged in shared memory; else every value from global
  // memory (panels narrower than a block)
  const int jlast = min(N, jb + GV_BN) - 1;
  if (panel_cols <= 0 || jb / panel_cols == jlast / panel_cols) {
    const T* wp = w + (panel_cols > 0 ? (long long)(jb / panel_cols) * kp : 0);
    const uint32_t hv = min((uint32_t)held, kp);
    gv_fill(sbank, wp, (int)hv);
    const uint32_t sbase = rt::smem_u32(sbank);
    gv_walk<T, MT, SIGN>(
        acc, x, M, K, kbeg, kend, ck, seed, kp, magic, sab, sx,
        [&](int, uint32_t b) { return split_bits(b, hv, sbase, wp); });
  } else {
    gv_walk<T, MT, SIGN>(
        acc, x, M, K, kbeg, kend, ck, seed, kp, magic, sab, sx,
        [&](int c, uint32_t b) { return global_bits(wc[c] + b); });
  }

  // sub-ranges 1.. park their sums; sub-range 0 adds them in order
  float* red = tail;
  if (sub > 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < GV_CPT; ++c)
        red[(((sub - 1) * MT + m) * GV_CPT + c) * GV_GROUPS + grp] =
            acc[m][c];
  }
  __syncthreads();
  if (sub != 0) return;
#pragma unroll
  for (int s = 1; s < GV_KSUB; ++s)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < GV_CPT; ++c)
        acc[m][c] += red[(((s - 1) * MT + m) * GV_CPT + c) * GV_GROUPS + grp];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int c = 0; c < GV_CPT; ++c) {
      const int j = j0 + c;
      if (j >= N) continue;
      if (ws != nullptr)
        ws[((long long)blockIdx.y * M + m) * N + j] = acc[m][c];
      else
        y[(long long)m * N + j] = rt::from_f<T>(acc[m][c]);
    }
  }
}

template <typename T, int MT, bool SIGN>
cudaError_t launch_gemv(const void* x, const void* w, void* y, float* ws,
                        int M, int K, int N, uint32_t kp, uint32_t magic,
                        int panel_cols, uint32_t seed, int splits,
                        cudaStream_t s) {
  auto fn = hashed_gemv<T, MT, SIGN>;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, GV_SMEM_MAX);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  int k_per_split, nz;
  rt::split_k(K, splits, GV_KSTEP, &k_per_split, &nz);
  dim3 grid((N + GV_BN - 1) / GV_BN, nz);
  fn<<<grid, GV_NT, gv_smem_bytes<T>(MT, kp), s>>>(
      (const T*)x, (const T*)w, (T*)y, nz > 1 ? ws : nullptr, M, K, N,
      k_per_split, kp, magic, panel_cols, seed, gv_held<T>(MT, kp));
  if (nz > 1) rt::launch_reduce<T>(ws, y, M, N, nz, s);
  return cudaSuccess;
}

template <typename T, bool SIGN>
cudaError_t run_gemv_sign(const void* x, const void* w, void* y, float* ws,
                          int M, int K, int N, uint32_t kp, uint32_t magic,
                          int panel_cols, uint32_t seed, int mt, int splits,
                          cudaStream_t s) {
  switch (mt) {
    case 1:
      return launch_gemv<T, 1, SIGN>(x, w, y, ws, M, K, N, kp, magic,
                                     panel_cols, seed, splits, s);
    case 2:
      return launch_gemv<T, 2, SIGN>(x, w, y, ws, M, K, N, kp, magic,
                                     panel_cols, seed, splits, s);
    case 4:
      return launch_gemv<T, 4, SIGN>(x, w, y, ws, M, K, N, kp, magic,
                                     panel_cols, seed, splits, s);
    case 8:
      return launch_gemv<T, 8, SIGN>(x, w, y, ws, M, K, N, kp, magic,
                                     panel_cols, seed, splits, s);
    case 16:
      return launch_gemv<T, 16, SIGN>(x, w, y, ws, M, K, N, kp, magic,
                                      panel_cols, seed, splits, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t run_gemv(const void* x, const void* w, void* y, float* ws,
                     int M, int K, int N, uint32_t kp, uint32_t magic,
                     int panel_cols, uint32_t seed, int use_sign, int mt,
                     int splits, cudaStream_t s) {
  return use_sign
      ? run_gemv_sign<T, true>(x, w, y, ws, M, K, N, kp, magic, panel_cols,
                               seed, mt, splits, s)
      : run_gemv_sign<T, false>(x, w, y, ws, M, K, N, kp, magic, panel_cols,
                                seed, mt, splits, s);
}

}  // namespace

// Forward: x (M, K=R), y (M, N=C).  Transpose: x is g (M, K=C), y is dx
// (M, N=R).  w (n_panels * kp,); all of dtype (0 fp32, 1 bf16).  magic:
// rt::bucket_mod's constant for kp.  body: 0 the CUDA-core body with row
// block bm (8 or 64), 1 the tensor-core body (bf16 only, K and N
// multiples of 8), which first writes V (R, C) bf16 into vws, 2 the gemv
// body (forward only) for M <= bm rows, bm one of 1, 2, 4, 8, 16.  ws:
// fp32 workspace of splits * M * N floats when splits > 1.
extern "C" int hashed_element_matmul(const void* x, const void* w, void* y,
                                     void* vws, void* ws, int M, int K, int N,
                                     unsigned kp, unsigned magic,
                                     int panel_cols, unsigned seed,
                                     int use_sign, int dtype, int body,
                                     int bm, int splits, int transpose,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* wsf = (float*)ws;
  if (body == 1) {
    if (dtype != 1 || K % 8 || N % 8 || vws == nullptr)
      return (int)cudaErrorInvalidValue;
    const int R = transpose ? N : K, C = transpose ? K : N;
    const int cpr = C / 8;
    const int pw = panel_cols > 0 ? std::min((panel_cols + 7) / 8, cpr) : cpr;
    const long long chunks = (long long)R * pw * ((cpr + pw - 1) / pw);
    element_decompress<<<(unsigned)((chunks + 255) / 256), 256, 0, s>>>(
        (const uint16_t*)w, (uint4*)vws, R, C, kp, magic, panel_cols, seed,
        use_sign);
    return (int)(transpose
                     ? rt::launch_tc_gemm<true>(x, vws, y, wsf, M, K, N, splits, s)
                     : rt::launch_tc_gemm<false>(x, vws, y, wsf, M, K, N, splits, s));
  }
  if (body == 2) {
    if (transpose || M > bm)
      return (int)cudaErrorInvalidValue;
    const cudaError_t e =
        dtype == 1
            ? run_gemv<__nv_bfloat16>(x, w, y, wsf, M, K, N, kp, magic,
                                      panel_cols, seed, use_sign, bm, splits,
                                      s)
            : run_gemv<float>(x, w, y, wsf, M, K, N, kp, magic, panel_cols,
                              seed, use_sign, bm, splits, s);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  if (dtype == 1)
    run_cuda_core<__nv_bfloat16>(x, w, y, wsf, M, K, N, kp, magic,
                                 panel_cols, seed, use_sign, bm, splits,
                                 transpose, s);
  else
    run_cuda_core<float>(x, w, y, wsf, M, K, N, kp, magic, panel_cols, seed,
                         use_sign, bm, splits, transpose, s);
  return (int)cudaGetLastError();
}
