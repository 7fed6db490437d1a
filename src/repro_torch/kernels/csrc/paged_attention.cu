// Paged flash-decode: one-token GQA attention per row through a page
// table, split over the row's KV positions (flash-decoding).
//
// Replaces the JAX package's kernels/paged_attention.py _decode_kernel
// (paged_decode_attention).  The TPU walks a row's pages on a sequential
// grid axis with m/l/acc in VMEM scratch.  On the card one block per
// (kv head, row) walking the pages in turn leaves most SMs idle (64 blocks
// at B = 8 with 8 kv heads) and waits on one page's loads after another,
// so the work is cut across the row's positions instead, in two passes:
//
//  1. decode_split: one block per (kv head, row, chunk of kChunk = 64
//     positions).  Blocks whose chunk holds no live position (at or past
//     the row's length, or wholly before its window) exit at once; that
//     is the window's page skipping.  A block looks each live position up
//     through the table (any page size, any window) and copies its K and
//     V rows into shared memory with 16-byte cp.async, K and V in two
//     commit groups so the scores run while V is still in flight; dead
//     positions read zeros and nothing from memory.  The lanes that hold
//     one K row (16 bytes each) take q . k for the G query heads of the
//     kv head with shuffle reductions; the softmax runs in the exp2
//     domain with scale * log2(e) folded into q; one warp per head finds
//     the chunk's max, the weights and their sum; every thread then owns
//     one of the D output columns for all G heads and sums the chunk's V
//     rows.  The chunk's (m, l, acc) go to an fp32 workspace.
//  2. decode_combine: one block per (query head, row) merges the live
//     chunks' partials in chunk order (the same bits on every launch) and
//     divides.
//
// _NEG = -1e30 for masked scores, the re-mask after exp and the l > 0
// divide guard are kept, so trash-page slots read nothing and rows of
// length 0 (no live chunk) give exact zeros.
//
// What bounds it: bytes, every live K/V token read once (D values of K
// and of V per kv head) at ~4 flops a byte; at serving's batch sizes the
// latency of the dependent loads (length, table, K/V rows) does.  G = 1
// to 8 query heads per kv head (2 in qwen3-1.7b) cannot fill the 16 rows
// of an mma.sync or the 64 of a wgmma, so this kernel stays on the CUDA
// cores.
#include "common.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kChunk = 64;      // positions per block (decode_split)
static_assert(kChunk == 64, "the softmax gives each lane two positions");

// 16 bytes of T as floats
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

// The live positions [lo, hi) of a row: at most maxp * ps, the window's.
__device__ __forceinline__ void live_range(int length, int window, int maxp,
                                           int ps, int* lo, int* hi) {
  *hi = min(length, maxp * ps);
  *lo = window > 0 ? max(0, length - window) : 0;
}

template <typename T>
constexpr size_t split_smem(int D, int G) {
  return 2 * kChunk * D * sizeof(T) + G * kChunk * sizeof(float);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(D)
decode_split(const T* __restrict__ q, const T* __restrict__ pk,
             const T* __restrict__ pv, const int* __restrict__ table,
             const int* __restrict__ lengths, float* __restrict__ ws_acc,
             float* __restrict__ ws_ml, int maxp, int ps, int n_kv,
             int n_chunks, int window, float qscale) {
  constexpr int VEC = Vec<T>::N;           // elements in 16 bytes
  constexpr int NV = D / VEC;              // 16-byte vectors a row
  constexpr int LPR = NV < 32 ? NV : 32;   // lanes holding one row
  constexpr int VPL = NV / LPR;            // vectors a lane
  constexpr int RPW = 32 / LPR;            // rows a warp takes at once
  constexpr int NW = D / 32;
  constexpr int ITER = kChunk * NV / D;    // rows a thread copies
  extern __shared__ __align__(16) uint8_t dsmem[];
  T* ks = reinterpret_cast<T*>(dsmem);
  T* vs = ks + kChunk * D;
  float* sc = reinterpret_cast<float*>(vs + kChunk * D);   // [G][kChunk]

  const int kvh = blockIdx.x, b = blockIdx.y, chunk = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hq = n_kv * G;
  int lo, hi;
  live_range(lengths[b], window, maxp, ps, &lo, &hi);
  const int base = chunk * kChunk;
  const int t0 = max(base, lo), t1 = min(base + kChunk, hi);
  if (t0 >= t1) return;                    // no live position here

  // K then V rows of the chunk, looked up through the table: thread tid
  // copies vector tid % NV of rows tid / NV + VEC i
  long long off[ITER];
  const int vcol = tid % NV;
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int pos = base + tid / NV + VEC * i;
    off[i] = -1;
    if (pos >= t0 && pos < t1) {
      const long long page = table[(long long)b * maxp + pos / ps];
      off[i] = ((page * ps + pos % ps) * n_kv + kvh) * D + vcol * VEC;
    }
  }
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int r = tid / NV + VEC * i;
    rt::cp_async16(rt::smem_u32(ks + r * D + vcol * VEC),
                   off[i] >= 0 ? pk + off[i] : pk, off[i] >= 0);
  }
  rt::cp_async_commit();
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int r = tid / NV + VEC * i;
    rt::cp_async16(rt::smem_u32(vs + r * D + vcol * VEC),
                   off[i] >= 0 ? pv + off[i] : pv, off[i] >= 0);
  }
  rt::cp_async_commit();

  // this lane's slice of q for the G heads, scale * log2(e) folded in
  const int part = lane % LPR;
  float qr[G][VPL * VEC];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    const T* qrow = q + ((long long)b * hq + kvh * G + h) * D;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      Vec<T>::load(qrow + (part + v * LPR) * VEC, &qr[h][v * VEC]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[h][v * VEC + e] *= qscale;
    }
  }

  rt::cp_async_wait<1>();                  // this thread's K rows landed
  __syncthreads();

  // scores: RPW rows a warp at a time, LPR lanes a row
  for (int r0 = warp * RPW; r0 < kChunk; r0 += NW * RPW) {
    const int r = r0 + lane / LPR;
    float kr[VPL * VEC];
#pragma unroll
    for (int v = 0; v < VPL; ++v)
      Vec<T>::load(ks + r * D + (part + v * LPR) * VEC, &kr[v * VEC]);
    const bool valid = base + r >= t0 && base + r < t1;
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < VPL * VEC; ++e) s += qr[h][e] * kr[e];
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (part == 0) sc[h * kChunk + r] = valid ? s : kNeg;
    }
  }
  __syncthreads();

  // softmax over the chunk, one warp per head: max, weights, their sum
  __shared__ float ml[G][2];
  for (int h = warp; h < G; h += NW) {
    const float s0 = sc[h * kChunk + lane], s1 = sc[h * kChunk + lane + 32];
    float mx = fmaxf(s0, s1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    // exp of a masked score is not exactly 0 when every score is masked:
    // re-mask to exact zero
    const bool v0 = base + lane >= t0 && base + lane < t1;
    const bool v1 = base + lane + 32 >= t0 && base + lane + 32 < t1;
    const float p0 = v0 ? exp2f(s0 - mx) : 0.f;
    const float p1 = v1 ? exp2f(s1 - mx) : 0.f;
    sc[h * kChunk + lane] = p0;
    sc[h * kChunk + lane + 32] = p1;
    const float l = rt::warp_sum(p0 + p1);
    if (lane == 0) {
      ml[h][0] = mx;
      ml[h][1] = l;
    }
  }
  rt::cp_async_wait<0>();                  // this thread's V rows landed
  __syncthreads();

  // acc[h] over the chunk's live rows, thread tid = output column d
  float acc[G];
#pragma unroll
  for (int h = 0; h < G; ++h) acc[h] = 0.f;
  for (int r = t0 - base; r < t1 - base; ++r) {
    const float v = rt::to_f(vs[r * D + tid]);
#pragma unroll
    for (int h = 0; h < G; ++h) acc[h] += sc[h * kChunk + r] * v;
  }
#pragma unroll
  for (int h = 0; h < G; ++h) {
    const long long row = ((long long)b * hq + kvh * G + h) * n_chunks + chunk;
    ws_acc[row * D + tid] = acc[h];
    if (tid == 0) {
      ws_ml[row * 2] = ml[h][0];
      ws_ml[row * 2 + 1] = ml[h][1];
    }
  }
}

// out[b, h] = (sum over live chunks c, in order, of 2^(m_c - M) acc_c) /
// (the same sum of l_c), M the largest m_c; 0 where no chunk is live.
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_combine(const float* __restrict__ ws_acc,
               const float* __restrict__ ws_ml,
               const int* __restrict__ lengths, T* __restrict__ out,
               int maxp, int ps, int n_chunks, int window) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int hq = gridDim.x;
  int lo, hi;
  live_range(lengths[b], window, maxp, ps, &lo, &hi);
  const int c_lo = lo / kChunk;
  const int c_hi = hi > lo ? (hi + kChunk - 1) / kChunk : c_lo;
  const long long row = ((long long)b * hq + h) * n_chunks;
  float m = kNeg;
  for (int c = c_lo; c < c_hi; ++c) m = fmaxf(m, ws_ml[(row + c) * 2]);
  float l = 0.f, acc = 0.f;
  for (int c = c_lo; c < c_hi; ++c) {
    const float w = exp2f(ws_ml[(row + c) * 2] - m);
    l += ws_ml[(row + c) * 2 + 1] * w;
    acc += ws_acc[(row + c) * D + d] * w;
  }
  out[((long long)b * hq + h) * D + d] = rt::from_f<T>(acc / (l > 0.f ? l : 1.f));
}

template <typename T, int D, int G>
int launch(const void* q, const void* pk, const void* pv, const int* table,
           const int* lengths, void* out, float* ws, int B, int n_kv,
           int maxp, int ps, int n_chunks, int window, cudaStream_t s) {
  constexpr size_t smem = split_smem<T>(D, G);
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        decode_split<T, D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  const int hq = n_kv * G;
  float* ws_ml = ws + (long long)B * hq * n_chunks * D;
  decode_split<T, D, G><<<dim3(n_kv, B, n_chunks), D, smem, s>>>(
      (const T*)q, (const T*)pk, (const T*)pv, table, lengths, ws, ws_ml,
      maxp, ps, n_kv, n_chunks, window, kLog2e / sqrtf((float)D));
  decode_combine<T, D><<<dim3(hq, B), D, 0, s>>>(
      ws, ws_ml, lengths, (T*)out, maxp, ps, n_chunks, window);
  return 0;
}

template <typename T, int D>
int by_g(int G, const void* q, const void* pk, const void* pv,
         const int* table, const int* lengths, void* out, float* ws, int B,
         int n_kv, int maxp, int ps, int n_chunks, int window,
         cudaStream_t s) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, pk, pv, table, lengths, out, ws, B, n_kv, maxp, ps, n_chunks, window, s);
    case 2: return launch<T, D, 2>(q, pk, pv, table, lengths, out, ws, B, n_kv, maxp, ps, n_chunks, window, s);
    case 4: return launch<T, D, 4>(q, pk, pv, table, lengths, out, ws, B, n_kv, maxp, ps, n_chunks, window, s);
    case 8: return launch<T, D, 8>(q, pk, pv, table, lengths, out, ws, B, n_kv, maxp, ps, n_chunks, window, s);
  }
  return -1;
}

template <typename T>
int by_d(int D, int G, const void* q, const void* pk, const void* pv,
         const int* table, const int* lengths, void* out, float* ws, int B,
         int n_kv, int maxp, int ps, int n_chunks, int window,
         cudaStream_t s) {
  switch (D) {
    case 64: return by_g<T, 64>(G, q, pk, pv, table, lengths, out, ws, B, n_kv, maxp, ps, n_chunks, window, s);
    case 128: return by_g<T, 128>(G, q, pk, pv, table, lengths, out, ws, B, n_kv, maxp, ps, n_chunks, window, s);
    case 256: return by_g<T, 256>(G, q, pk, pv, table, lengths, out, ws, B, n_kv, maxp, ps, n_chunks, window, s);
  }
  return -1;
}

}  // namespace

// q (B, n_kv*G, D); pages_k/v (P, ps, n_kv, D); table (B, maxp) int32;
// lengths (B,) int32 including the current token; out like q; ws fp32
// (B * n_kv * G * n_chunks * (D + 2)), n_chunks = max(1, ceil(maxp * ps /
// 64))
// (the chunks' partials).  Returns -1 for an unsupported (D, G) or chunk
// count, else cudaGetLastError().
extern "C" int paged_decode(const void* q, const void* pk, const void* pv,
                            const void* table, const void* lengths, void* out,
                            void* ws, int B, int n_kv, int G, int D, int maxp,
                            int ps, int n_chunks, int window, int dtype,
                            void* stream) {
  if (n_chunks != max(1, (maxp * ps + kChunk - 1) / kChunk)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const int* tb = (const int*)table;
  const int* ln = (const int*)lengths;
  const int rc = dtype == 1
      ? by_d<__nv_bfloat16>(D, G, q, pk, pv, tb, ln, out, (float*)ws, B, n_kv, maxp, ps, n_chunks, window, s)
      : by_d<float>(D, G, q, pk, pv, tb, ln, out, (float*)ws, B, n_kv, maxp, ps, n_chunks, window, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
