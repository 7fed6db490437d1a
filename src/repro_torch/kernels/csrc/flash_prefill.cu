// Ragged batched flash-prefill through a paged KV cache.
//
// Replaces the JAX package's kernels/flash_prefill.py _prefill_kernel
// (paged_prefill_attention).  Query slot s of row b sits at position
// starts[b] + s and attends the causal band kv <= q_pos intersected with
// kv < starts[b] + counts[b] (and the sliding window); slots s >= counts[b]
// are pad and count-0 rows are inert: both give exact zeros.
//
// The TPU walks pages on a sequential grid axis with m/l/acc in VMEM; here
// one block per (query tile, kv head, row) loops over just the pages its
// tile can see.  A tile is 32 query rows: 32/G slots times the G query
// heads of one kv head (GQA without repeating K/V).  Each page's K and V
// (page_size x D) are staged in shared memory once and used by all 32
// rows; each thread owns one output column for all 32 rows.  _NEG =
// -1e30, the re-mask after exp and the l > 0 guard are kept.  The public
// layout stays (B, S, Hq, D): the TPU wrapper's (B, n_kv, g*S, d)
// reshuffle was a layout choice for its matrix unit.
//
// What bounds it: at prefill sizes the score and value products
// (4 * rows * kv * D flops per head) against bytes read once; this simple
// version runs them on the CUDA cores in fp32 from shared memory, so it
// is bound by shared-memory bandwidth, far from either card limit.
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

template <typename T>
int by_d(int D, const void* q, const void* pk, const void* pv, const int* table,
         const int* starts, const int* counts, void* out, int B, int S,
         int n_kv, int G, int maxp, int ps, int window, cudaStream_t s) {
  switch (D) {
    case 64: return launch<T, 64>(q, pk, pv, table, starts, counts, out, B, S, n_kv, G, maxp, ps, window, s);
    case 128: return launch<T, 128>(q, pk, pv, table, starts, counts, out, B, S, n_kv, G, maxp, ps, window, s);
    case 256: return launch<T, 256>(q, pk, pv, table, starts, counts, out, B, S, n_kv, G, maxp, ps, window, s);
  }
  return -1;
}

}  // namespace

// q (B, S, n_kv*G, D); pages_k/v (P, ps, n_kv, D); table (B, maxp),
// starts/counts (B,) int32; out like q.  G must divide 32.
// Returns -1 for an unsupported (D, G), else cudaGetLastError().
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
      ? by_d<__nv_bfloat16>(D, q, pk, pv, tb, st, cn, out, B, S, n_kv, G, maxp, ps, window, s)
      : by_d<float>(D, q, pk, pv, tb, st, cn, out, B, S, n_kv, G, maxp, ps, window, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
