// Paged flash-decode: one-token GQA attention per row through a page
// table, online softmax over the row's pages.
//
// Replaces the JAX package's kernels/paged_attention.py _decode_kernel
// (paged_decode_attention).  The TPU walks pages on a sequential grid
// axis with m/l/acc in VMEM scratch; here one block per (kv head, row)
// loops over the row's pages with m/l/acc in registers.  Pages entirely
// outside [max(0, length - window), length) are skipped: they would add
// exactly zero weight (the TPU kernel masks them to zero), so skipping
// them changes no output.  _NEG = -1e30, the re-mask after exp and the
// l > 0 divide guard are kept, so trash-page slots and length == 0 rows
// give exact zeros.
//
// What bounds it: bytes — each live K/V token is read once (D values of
// K and of V per kv head), the arithmetic is ~4 flops per byte.  Each
// warp reads whole K rows (coalesced) for its tokens and reduces the dot
// with shuffles; every thread then owns one of the D output columns for
// all G query heads of its kv head, so V rows are read coalesced too.
#include "common.cuh"

namespace {

constexpr float kNeg = -1e30f;

template <typename T, int D, int G>
__global__ void __launch_bounds__(D)
decode_kernel(const T* __restrict__ q, const T* __restrict__ pk,
              const T* __restrict__ pv, const int* __restrict__ table,
              const int* __restrict__ lengths, T* __restrict__ out, int maxp,
              int ps, int n_kv, int window, float scale) {
  constexpr int PER_LANE = D / 32;
  constexpr int NW = D / 32;
  extern __shared__ float smem[];
  float* sc = smem;              // [G][ps] scores, then weights
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int d = threadIdx.x, lane = d & 31, warp = d >> 5;
  const int hq = n_kv * G;
  const int length = lengths[b];
  const int q_pos = length - 1;

  float qr[G][PER_LANE];
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int c = 0; c < PER_LANE; ++c)
      qr[h][c] = rt::to_f(q[((long long)b * hq + kvh * G + h) * D + lane + 32 * c]) * scale;

  float m[G], l[G], acc[G];
#pragma unroll
  for (int h = 0; h < G; ++h) { m[h] = kNeg; l[h] = 0.f; acc[h] = 0.f; }

  const int lo = window > 0 ? max(0, length - window) : 0;
  const int p_lo = lo / ps;
  const int p_hi = length > 0 ? min((length + ps - 1) / ps, maxp) : 0;
  for (int p = p_lo; p < p_hi; ++p) {
    const long long page = table[(long long)b * maxp + p];
    for (int t = warp; t < ps; t += NW) {
      const int kv = p * ps + t;
      const bool valid = kv < length && (window <= 0 || q_pos - kv < window);
      const T* krow = pk + ((page * ps + t) * n_kv + kvh) * D;
      float kr[PER_LANE];
#pragma unroll
      for (int c = 0; c < PER_LANE; ++c) kr[c] = rt::to_f(krow[lane + 32 * c]);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < PER_LANE; ++c) part += qr[h][c] * kr[c];
        part = rt::warp_sum(part);
        if (lane == 0) sc[h * ps + t] = valid ? part : kNeg;
      }
    }
    __syncthreads();
    float m_new[G], alpha[G];
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float mx = kNeg;
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, sc[h * ps + t]);
      m_new[h] = fmaxf(m[h], mx);
      alpha[h] = expf(m[h] - m_new[h]);
    }
    __syncthreads();   // every thread has read the scores
    for (int e = d; e < G * ps; e += D) {
      const int h = e / ps, t = e % ps;
      const int kv = p * ps + t;
      const bool valid = kv < length && (window <= 0 || q_pos - kv < window);
      // exp of a fully masked row is exp(0) = 1: re-mask to exact zero
      float mh = m_new[0];
#pragma unroll
      for (int hh = 1; hh < G; ++hh) if (hh == h) mh = m_new[hh];
      sc[e] = valid ? expf(sc[e] - mh) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float lsum = 0.f, vsum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float wt = sc[h * ps + t];
        lsum += wt;
        vsum += wt * rt::to_f(pv[((page * ps + t) * n_kv + kvh) * D + d]);
      }
      l[h] = l[h] * alpha[h] + lsum;
      acc[h] = acc[h] * alpha[h] + vsum;
      m[h] = m_new[h];
    }
    __syncthreads();   // weights consumed before the next page's scores
  }
#pragma unroll
  for (int h = 0; h < G; ++h)
    out[((long long)b * hq + kvh * G + h) * D + d] =
        rt::from_f<T>(acc[h] / (l[h] > 0.f ? l[h] : 1.f));
}

template <typename T, int D, int G>
int launch(const void* q, const void* pk, const void* pv, const int* table,
           const int* lengths, void* out, int B, int n_kv, int maxp, int ps,
           int window, cudaStream_t s) {
  dim3 grid(n_kv, B);
  const size_t smem = sizeof(float) * G * ps;
  decode_kernel<T, D, G><<<grid, D, smem, s>>>(
      (const T*)q, (const T*)pk, (const T*)pv, table, lengths, (T*)out, maxp,
      ps, n_kv, window, 1.0f / sqrtf((float)D));
  return 0;
}

template <typename T, int D>
int by_g(int G, const void* q, const void* pk, const void* pv, const int* table,
         const int* lengths, void* out, int B, int n_kv, int maxp, int ps,
         int window, cudaStream_t s) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, pk, pv, table, lengths, out, B, n_kv, maxp, ps, window, s);
    case 2: return launch<T, D, 2>(q, pk, pv, table, lengths, out, B, n_kv, maxp, ps, window, s);
    case 4: return launch<T, D, 4>(q, pk, pv, table, lengths, out, B, n_kv, maxp, ps, window, s);
    case 8: return launch<T, D, 8>(q, pk, pv, table, lengths, out, B, n_kv, maxp, ps, window, s);
  }
  return -1;
}

template <typename T>
int by_d(int D, int G, const void* q, const void* pk, const void* pv,
         const int* table, const int* lengths, void* out, int B, int n_kv,
         int maxp, int ps, int window, cudaStream_t s) {
  switch (D) {
    case 64: return by_g<T, 64>(G, q, pk, pv, table, lengths, out, B, n_kv, maxp, ps, window, s);
    case 128: return by_g<T, 128>(G, q, pk, pv, table, lengths, out, B, n_kv, maxp, ps, window, s);
    case 256: return by_g<T, 256>(G, q, pk, pv, table, lengths, out, B, n_kv, maxp, ps, window, s);
  }
  return -1;
}

}  // namespace

// q (B, n_kv*G, D); pages_k/v (P, ps, n_kv, D); table (B, maxp) int32;
// lengths (B,) int32 including the current token; out like q.
// Returns -1 for an unsupported (D, G), else cudaGetLastError().
extern "C" int paged_decode(const void* q, const void* pk, const void* pv,
                            const void* table, const void* lengths, void* out,
                            int B, int n_kv, int G, int D, int maxp, int ps,
                            int window, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* tb = (const int*)table;
  const int* ln = (const int*)lengths;
  const int rc = dtype == 1
      ? by_d<__nv_bfloat16>(D, G, q, pk, pv, tb, ln, out, B, n_kv, maxp, ps, window, s)
      : by_d<float>(D, G, q, pk, pv, tb, ln, out, B, n_kv, maxp, ps, window, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
