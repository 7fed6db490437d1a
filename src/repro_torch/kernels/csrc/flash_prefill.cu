// Ragged batched flash-prefill through a paged KV cache.
//
// Replaces the JAX package's kernels/flash_prefill.py _prefill_kernel
// (paged_prefill_attention).  Query slot s of row b sits at position
// starts[b] + s and attends the causal band kv <= q_pos intersected with
// kv < starts[b] + counts[b] (and the sliding window); slots s >= counts[b]
// are pad and count-0 rows are inert: both give exact zeros.  _NEG =
// -1e30, the re-mask after exp and the l > 0 guard are kept.  The public
// layout stays (B, S, Hq, D): the TPU wrapper's (B, n_kv, g*S, d)
// reshuffle was a layout choice for its matrix unit.  The TPU walks pages
// on a sequential grid axis with m/l/acc in VMEM; here one block per
// (query tile, kv head, row) loops over just the positions its tile can
// see.  A tile holds the G query heads of one kv head for several slots
// (GQA without repeating K/V), each page's K and V staged once for all
// of them.
//
// prefill_tc — bf16, the serving path: FlashAttention-2 on the tensor
// cores (mma.sync.m16n8k16, bf16 operands, fp32 accumulators), what the
// TPU kernel's default-precision dots do on its matrix unit.  A block is
// 4 warps and 64 query rows (row r: slot s0 + r / G, head r % G of the
// kv head), one warp per 16 rows.  K and V of BN consecutive positions
// (64; 32 at D = 256), looked up through the page table row by row, are
// copied by cp.async in bf16 into a double-buffered, XOR-swizzled
// shared-memory tile while the previous BN are multiplied; fragments come
// from ldmatrix (.trans for V).  S = Q K^T in fp32, scaled by 1/sqrt(D)
// (in the exp2 domain), masked, online softmax in registers; the
// probabilities are rounded to bf16 and fed straight back as the A
// operand of P V; O is divided by the row sum at the end.  What bounds
// it at prefill sizes (64-256 rows per kv head, a few hundred
// positions): latency of the per-step page lookups, copies and
// barriers, not the card's bytes or flops; at B = 4 only a few dozen
// blocks have work.
//
// prefill_kernel — fp32: the CUDA-core version (full fp32 products).
// One block of D threads per (32-row tile, kv head, row); each page's K
// and V are staged in shared memory as fp32 and each thread owns one
// output column for all 32 rows; bound by shared-memory bandwidth.
#include "common.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int ROWS = 32;

template <typename T, int D>
__global__ void __launch_bounds__(D)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ pk,
               const T* __restrict__ pv, const int* __restrict__ table,
               const int* __restrict__ starts, const int* __restrict__ counts,
               T* __restrict__ out, int S, int G, int maxp, int ps, int n_kv,
               int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                         // [ROWS][D + 1]
  float* ks = qs + ROWS * (D + 1);          // [ps][D + 1]
  float* vs = ks + ps * (D + 1);            // [ps][D]
  float* sc = vs + ps * D;                  // [ROWS][ps]
  float* alpha_s = sc + ROWS * ps;          // [ROWS]

  const int qt = ROWS / G;                  // query slots per tile
  const int s0 = blockIdx.x * qt;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int d = threadIdx.x;
  const int hq = n_kv * G;
  const int start = starts[b], count = counts[b];

  // row r: head gi = r / qt of this kv head, slot si = s0 + r % qt
  for (int r = 0; r < ROWS; ++r) {
    const int si = s0 + r % qt, gi = r / qt;
    qs[r * (D + 1) + d] =
        si < S ? rt::to_f(q[(((long long)b * S + si) * hq + kvh * G + gi) * D + d]) * scale
               : 0.f;
  }

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  float m_r = kNeg, l_r = 0.f;                 // softmax state of row d (d < ROWS)
  const int my_si = s0 + d % qt;

  const int last_slot = min(s0 + qt, count) - 1;   // last real slot of the tile
  if (last_slot >= s0) {
    const int kv_hi = start + last_slot;           // inclusive
    const int kv_lo = window > 0 ? max(0, start + s0 - window + 1) : 0;
    const int p_hi = min(kv_hi / ps, maxp - 1);
    for (int p = kv_lo / ps; p <= p_hi; ++p) {
      const long long page = table[(long long)b * maxp + p];
      __syncthreads();   // previous page fully consumed
      for (int t = 0; t < ps; ++t) {
        const long long off = ((page * ps + t) * n_kv + kvh) * D + d;
        ks[t * (D + 1) + d] = rt::to_f(pk[off]);
        vs[t * D + d] = rt::to_f(pv[off]);
      }
      __syncthreads();
      for (int e = d; e < ROWS * ps; e += D) {
        const int r = e / ps, t = e % ps;
        const int si = s0 + r % qt;
        const int q_pos = start + si, kv = p * ps + t;
        const bool valid = si < count && kv <= q_pos && kv < start + count &&
                           (window <= 0 || q_pos - kv < window);
        float dot = 0.f;
        const float* qrow = qs + r * (D + 1);
        const float* krow = ks + t * (D + 1);
#pragma unroll 8
        for (int c = 0; c < D; ++c) dot += qrow[c] * krow[c];
        sc[e] = valid ? dot : kNeg;
      }
      __syncthreads();
      if (d < ROWS) {
        float mx = kNeg;
        for (int t = 0; t < ps; ++t) mx = fmaxf(mx, sc[d * ps + t]);
        const float m_new = fmaxf(m_r, mx);
        const float a = expf(m_r - m_new);
        const int q_pos = start + my_si;
        float lsum = 0.f;
        for (int t = 0; t < ps; ++t) {
          const int kv = p * ps + t;
          const bool valid = my_si < count && kv <= q_pos && kv < start + count &&
                             (window <= 0 || q_pos - kv < window);
          // exp of a fully masked row is exp(0) = 1: re-mask to exact zero
          const float wt = valid ? expf(sc[d * ps + t] - m_new) : 0.f;
          sc[d * ps + t] = wt;
          lsum += wt;
        }
        l_r = l_r * a + lsum;
        m_r = m_new;
        alpha_s[d] = a;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float vsum = 0.f;
        for (int t = 0; t < ps; ++t) vsum += sc[r * ps + t] * vs[t * D + d];
        acc[r] = acc[r] * alpha_s[r] + vsum;
      }
    }
  }
  __syncthreads();
  if (d < ROWS) alpha_s[d] = l_r;             // reuse as the row sums
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int si = s0 + r % qt, gi = r / qt;
    if (si >= S) continue;
    const float l = alpha_s[r];
    out[(((long long)b * S + si) * hq + kvh * G + gi) * D + d] =
        rt::from_f<T>(acc[r] / (l > 0.f ? l : 1.f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* pk, const void* pv, const int* table,
           const int* starts, const int* counts, void* out, int B, int S,
           int n_kv, int G, int maxp, int ps, int window, cudaStream_t s) {
  const int qt = ROWS / G;
  dim3 grid((S + qt - 1) / qt, n_kv, B);
  const size_t smem = sizeof(float) *
      (ROWS * (D + 1) + ps * (D + 1) + ps * D + ROWS * ps + ROWS);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(prefill_kernel<T, D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  prefill_kernel<T, D><<<grid, D, smem, s>>>(
      (const T*)q, (const T*)pk, (const T*)pv, table, starts, counts, (T*)out,
      S, G, maxp, ps, n_kv, window, 1.0f / sqrtf((float)D));
  return 0;
}

// -- tensor-core version (bf16) ---------------------------------------------

constexpr int TC_ROWS = 64;     // query rows per block: 4 warps x 16

template <int D>
struct Tc {
  static constexpr int BN = D == 256 ? 32 : 64;   // positions per step
  static constexpr int CH = D / 8;                // 16-byte chunks a row
  static constexpr int Q_BYTES = TC_ROWS * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;     // one K or V tile
  static constexpr int SMEM = Q_BYTES + 4 * KV_BYTES;   // Q, 2 x (K, V)
};

// byte offset of chunk ch of row r in a [rows][D] bf16 tile, the chunk
// index XORed with the row's low 3 bits: the 8 rows an ldmatrix reads at
// one chunk land in 8 different bank groups
template <int D>
__device__ __forceinline__ uint32_t sw(int r, int ch) {
  return r * (D * 2) + ((ch ^ (r & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row) b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(128)
prefill_tc(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ pk,
           const __nv_bfloat16* __restrict__ pv, const int* __restrict__ table,
           const int* __restrict__ starts, const int* __restrict__ counts,
           __nv_bfloat16* __restrict__ out, int S, int G, int maxp, int ps,
           int n_kv, int window, float scale_log2) {
  using P = Tc<D>;
  constexpr int BN = P::BN, CH = P::CH;
  extern __shared__ __align__(128) uint8_t tc_smem[];
  const uint32_t sq = rt::smem_u32(tc_smem);
  const uint32_t skv = sq + P::Q_BYTES;   // stage st: K, then V

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = TC_ROWS / G;                 // query slots per tile
  const int s0 = blockIdx.x * qt;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int hq = n_kv * G;
  const int start = starts[b], count = counts[b];
  const int kv_lim = min(start + count, maxp * ps);   // positions < kv_lim

  // this thread's two accumulator rows: lane / 4 and lane / 4 + 8 of the
  // warp's 16
  int q_pos[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int si = s0 + (warp * 16 + (lane >> 2) + 8 * h) / G;
    q_pos[h] = start + si;
    row_ok[h] = si < count;
  }
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {kNeg, kNeg}, l_run[2] = {0.f, 0.f};

  const int last_slot = min(s0 + qt, count) - 1;    // last real slot
  if (last_slot >= s0) {                            // uniform per block
    const int hi = min(start + last_slot + 1, kv_lim);   // exclusive
    const int lo = window > 0 ? max(0, start + s0 - window + 1) : 0;
    const int j0 = lo / BN, j1 = (hi + BN - 1) / BN;

    for (int c = tid; c < TC_ROWS * CH; c += 128) {
      const int r = c / CH, ch = c % CH;
      const int si = s0 + r / G;
      const bool ok = si < S;
      rt::cp_async16(sq + sw<D>(r, ch),
                     ok ? q + (((long long)b * S + si) * hq + kvh * G + r % G)
                              * D + ch * 8
                        : q,
                     ok);
    }
    // positions j BN .. j BN + BN - 1 into stage st, row by row through
    // the page table; positions at or past hi read zeros
    auto load_kv = [&](int j, int st) {
      const uint32_t sk = skv + st * 2 * P::KV_BYTES, sv = sk + P::KV_BYTES;
      for (int c = tid; c < BN * CH; c += 128) {
        const int t = c / CH, ch = c % CH;
        const int kv = j * BN + t;
        const bool ok = kv < hi;
        long long off = 0;
        if (ok) {
          const long long page = table[(long long)b * maxp + kv / ps];
          off = ((page * ps + kv % ps) * n_kv + kvh) * D + ch * 8;
        }
        rt::cp_async16(sk + sw<D>(t, ch), pk + off, ok);
        rt::cp_async16(sv + sw<D>(t, ch), pv + off, ok);
      }
    };
    load_kv(j0, 0);
    rt::cp_async_commit();                 // Q and the first positions

    for (int j = j0; j < j1; ++j) {
      const int st = (j - j0) & 1;
      if (j + 1 < j1) load_kv(j + 1, st ^ 1);
      rt::cp_async_commit();
      rt::cp_async_wait<1>();              // all but the newest group
      __syncthreads();
      const uint32_t sk = skv + st * 2 * P::KV_BYTES, sv = sk + P::KV_BYTES;

      // S (16 x BN) = Q K^T for this warp's rows
      float sc[BN / 8][4];
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      const int mi = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, sq + sw<D>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t kb[4];
          ldsm_x4(kb, sk + sw<D>(np * 16 + (lane & 7) + (mi >> 1) * 8,
                                 kk * 2 + (mi & 1)));
          mma16816(sc[2 * np], a, kb[0], kb[1]);
          mma16816(sc[2 * np + 1], a, kb[2], kb[3]);
        }
      }

      // mask, scale into the exp2 domain, online softmax by row
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int kv = j * BN + n * 8 + (lane & 3) * 2 + (e & 1);
          const bool valid = row_ok[h] && kv <= q_pos[h] && kv < kv_lim &&
                             (window <= 0 || q_pos[h] - kv < window);
          sc[n][e] = valid ? sc[n][e] * scale_log2 : kNeg;
          mx[h] = fmaxf(mx[h], sc[n][e]);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h]);
        alpha[h] = exp2f(m_run[h] - m_new);
        m_run[h] = m_new;
        l_run[h] *= alpha[h];
      }
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          // exp of a fully masked row is exp(0) = 1: re-mask to zero
          const float p = sc[n][e] == kNeg ? 0.f : exp2f(sc[n][e] - m_run[h]);
          sc[n][e] = p;
          l_run[h] += p;
        }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
        o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
      }

      // O (16 x D) += P V, P in bf16 straight from the score registers
#pragma unroll
      for (int ks = 0; ks < BN / 16; ++ks) {
        const uint32_t a[4] = {pack_bf16(sc[2 * ks][0], sc[2 * ks][1]),
                               pack_bf16(sc[2 * ks][2], sc[2 * ks][3]),
                               pack_bf16(sc[2 * ks + 1][0], sc[2 * ks + 1][1]),
                               pack_bf16(sc[2 * ks + 1][2], sc[2 * ks + 1][3])};
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vb[4];
          ldsm_x4_t(vb, sv + sw<D>(ks * 16 + (lane & 7) + (mi & 1) * 8,
                                   dp * 2 + (mi >> 1)));
          mma16816(o[2 * dp], a, vb[0], vb[1]);
          mma16816(o[2 * dp + 1], a, vb[2], vb[3]);
        }
      }
      __syncthreads();                     // stage st free for j + 2
    }
  }

  // row sums over the quad, then O / l (pad rows: l = 0, O = 0)
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[h] = 1.f / (l > 0.f ? l : 1.f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + (lane >> 2) + 8 * h;
    const int si = s0 + r / G;
    if (si >= S) continue;
    __nv_bfloat16* orow =
        out + (((long long)b * S + si) * hq + kvh * G + r % G) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + (lane & 3) * 2) =
          __floats2bfloat162_rn(o[n][2 * h] * inv[h],
                                o[n][2 * h + 1] * inv[h]);
  }
}

template <int D>
int launch_tc(const void* q, const void* pk, const void* pv, const int* table,
              const int* starts, const int* counts, void* out, int B, int S,
              int n_kv, int G, int maxp, int ps, int window, cudaStream_t s) {
  // set on every launch (see tile_gemm.cuh launch_tc_gemm)
  const cudaError_t attr = cudaFuncSetAttribute(
      prefill_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tc<D>::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int qt = TC_ROWS / G;
  dim3 grid((S + qt - 1) / qt, n_kv, B);
  prefill_tc<D><<<grid, 128, Tc<D>::SMEM, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)pk,
      (const __nv_bfloat16*)pv, table, starts, counts, (__nv_bfloat16*)out, S,
      G, maxp, ps, n_kv, window, 1.4426950408889634f / sqrtf((float)D));
  return 0;
}

int by_d_tc(int D, const void* q, const void* pk, const void* pv,
            const int* table, const int* starts, const int* counts, void* out,
            int B, int S, int n_kv, int G, int maxp, int ps, int window,
            cudaStream_t s) {
  switch (D) {
    case 64: return launch_tc<64>(q, pk, pv, table, starts, counts, out, B, S, n_kv, G, maxp, ps, window, s);
    case 128: return launch_tc<128>(q, pk, pv, table, starts, counts, out, B, S, n_kv, G, maxp, ps, window, s);
    case 256: return launch_tc<256>(q, pk, pv, table, starts, counts, out, B, S, n_kv, G, maxp, ps, window, s);
  }
  return -1;
}

int by_d(int D, const void* q, const void* pk, const void* pv, const int* table,
         const int* starts, const int* counts, void* out, int B, int S,
         int n_kv, int G, int maxp, int ps, int window, cudaStream_t s) {
  switch (D) {
    case 64: return launch<float, 64>(q, pk, pv, table, starts, counts, out, B, S, n_kv, G, maxp, ps, window, s);
    case 128: return launch<float, 128>(q, pk, pv, table, starts, counts, out, B, S, n_kv, G, maxp, ps, window, s);
    case 256: return launch<float, 256>(q, pk, pv, table, starts, counts, out, B, S, n_kv, G, maxp, ps, window, s);
  }
  return -1;
}

}  // namespace

// q (B, S, n_kv*G, D); pages_k/v (P, ps, n_kv, D); table (B, maxp),
// starts/counts (B,) int32; out like q.  G must divide 32.  bf16 (dtype
// 1) runs prefill_tc (q and pages 16-byte aligned), fp32 prefill_kernel.
// Returns -1 for an unsupported (D, G), else the first CUDA error.
extern "C" int paged_prefill(const void* q, const void* pk, const void* pv,
                             const void* table, const void* starts,
                             const void* counts, void* out, int B, int S,
                             int n_kv, int G, int D, int maxp, int ps,
                             int window, int dtype, void* stream) {
  if (G <= 0 || ROWS % G != 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const int* tb = (const int*)table;
  const int* st = (const int*)starts;
  const int* cn = (const int*)counts;
  const int rc = dtype == 1
      ? by_d_tc(D, q, pk, pv, tb, st, cn, out, B, S, n_kv, G, maxp, ps, window, s)
      : by_d(D, q, pk, pv, tb, st, cn, out, B, S, n_kv, G, maxp, ps, window, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
