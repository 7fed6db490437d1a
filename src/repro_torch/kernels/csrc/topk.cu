// Top-k logit mask for the sampler: per row, values strictly below the
// row's k-th largest become `fill`; ties at the threshold all survive;
// k <= 0 or k >= V leaves the row untouched.
//
// Replaces the JAX package's kernels/topk.py _topk_kernel (topk_mask).
// Same threshold: the k-th largest element of the row under the monotone
// fp32 -> uint32 map (-0.0 canonicalised to +0.0 first, as `_sortable`
// does), found exactly.  The TPU kernel builds it bit by bit in 32
// compare-and-count passes over a row held in VMEM.  A 151936-wide fp32
// row is 594 KB, more than one block's shared memory, so here a row is
// held by a thread-block cluster (Hopper): each of its `cs` CTAs loads a
// contiguous slice of the row into shared memory once (37 KB at 16 CTAs)
// and the cluster selects the threshold an 8-bit digit at a time, from
// the top (four passes):
//
// - each CTA histograms the candidates of its slice (the keys that match
//   the digits chosen so far), in the first pass into private histograms,
//   one a warp, so its few hot bins (logits share their sign and exponent
//   bits) do not serialize the whole block on one address;
// - after cluster.sync() every CTA sums the cluster's histograms over
//   distributed shared memory (cluster.map_shared_rank, 16 bytes a read),
//   scans the summed counts from the top digit with a block-wide scan,
//   and picks the digit that holds the k-th largest key.  The counts are
//   integers, so every CTA picks the same digit and the threshold is
//   exact;
// - the slice lands by 16-byte cp.async copies and the masking pass
//   writes it from shared memory, 16 bytes a store.
//
// A row whose slice does not fit in shared memory (the wrapper's plan,
// kernels/topk.py topk_plan: past 847,872 fp32 values at 16 CTAs) reads
// its slice from global memory on every pass instead (RESIDENT false).
//
// What bounds it: bytes (one read and one write of each row) against the
// latency of the passes: each pass ends in a cluster barrier and a round
// of remote shared-memory reads.
#include <cooperative_groups.h>
#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TK_NT = 512;
constexpr int TK_WARPS = TK_NT / 32;
constexpr int TK_MAX_CLUSTER = 16;
constexpr int TK_NB = 256;          // bins of an 8-bit digit
constexpr int TK_PASSES = 4;        // digits of a 32-bit key
static_assert(TK_NB <= TK_NT, "the scan gives each thread one digit");

__device__ __forceinline__ uint32_t ukey(float x) {
  if (x == 0.f) x = 0.f;                      // -0.0 -> +0.0
  const uint32_t i = __float_as_uint(x);
  return (i & 0x80000000u) ? ~i : (i | 0x80000000u);
}

// Dynamic shared memory: TK_WARPS private histograms, two buffers of the
// CTA's counts (read by the cluster, alternating between passes), the
// cluster's counts, then the slice when RESIDENT.  The wrapper sizes it
// (topk_plan).
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(TK_NT, 1)
topk_cluster(const T* __restrict__ x, T* __restrict__ out,
             const int* __restrict__ kvec, int V, int slice, float fill) {
  constexpr int NB = TK_NB;
  constexpr int VEC = 16 / sizeof(T);             // values a 16-byte copy
  extern __shared__ uint4 tk_smem4[];
  unsigned* hist = reinterpret_cast<unsigned*>(tk_smem4);
  unsigned* counts = hist + TK_WARPS * NB;    // [2][NB], read remotely
  unsigned* tot = counts + 2 * NB;            // the cluster's counts
  T* vals = reinterpret_cast<T*>(tot + NB);
  __shared__ unsigned s_warp[TK_WARPS];
  __shared__ unsigned s_digit, s_krem;

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / cs;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lo = rank * slice;
  const int n = max(0, min(V, lo + slice) - lo);
  const T* src = x + (long long)row * V + lo;    // this CTA's slice
  T* dst = out + (long long)row * V + lo;
  const int k = kvec[row];
  if (k <= 0 || k >= V) {           // the whole cluster returns here
    for (int i = tid; i < n; i += TK_NT) dst[i] = src[i];
    return;
  }
  if (RESIDENT) {                   // 16-byte cp.async copies where aligned
    int head = 0;
    if (((uintptr_t)src & 15) == 0) {
      head = n / VEC * VEC;
      for (int e = tid * VEC; e < head; e += TK_NT * VEC)
        rt::cp_async16(rt::smem_u32(vals + e), src + e, true);
      rt::cp_async_commit();
    }
    for (int i = head + tid; i < n; i += TK_NT) vals[i] = src[i];
    rt::cp_async_wait<0>();
  }
  auto at = [&](int i) { return RESIDENT ? vals[i] : src[i]; };

  uint32_t prefix = 0, mask = 0;
  unsigned krem = (unsigned)k;
#pragma unroll 1
  for (int p = 0; p < TK_PASSES; ++p) {
    const int shift = 24 - 8 * p;
    const uint32_t dmask = NB - 1;
    // private histograms for the first pass, whose few hot bins every
    // warp hits; one for the later ones, whose candidates are few
    const int hists = p == 0 ? TK_WARPS : 1;
    unsigned* myh = hist + (warp % hists) * NB;
    for (int i = tid; i < hists * NB; i += TK_NT) hist[i] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += TK_NT) {
      const uint32_t u = ukey(rt::to_f(at(i)));
      if ((u & mask) == prefix) atomicAdd(&myh[(u >> shift) & dmask], 1u);
    }
    __syncthreads();
    unsigned* cnt = counts + (p & 1) * NB;
    for (int b = tid; b < NB; b += TK_NT) {
      unsigned s = 0;
      for (int h = 0; h < hists; ++h) s += hist[h * NB + b];
      cnt[b] = s;
    }
    cluster.sync();
    // the cluster's counts, four digits a 16-byte read from each CTA, all
    // the reads of a thread in flight together
    for (int b4 = tid; b4 < NB / 4; b4 += TK_NT) {
      uint4 v[TK_MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < TK_MAX_CLUSTER; ++r)
        v[r] = r < cs ? reinterpret_cast<const uint4*>(
                            cluster.map_shared_rank(cnt, r))[b4]
                      : make_uint4(0, 0, 0, 0);
      uint4 t = v[0];
#pragma unroll
      for (int r = 1; r < TK_MAX_CLUSTER; ++r) {
        t.x += v[r].x;
        t.y += v[r].y;
        t.z += v[r].z;
        t.w += v[r].w;
      }
      reinterpret_cast<uint4*>(tot)[b4] = t;
    }
    __syncthreads();

    // thread t < NB holds digit NB - 1 - t, so the digits descend with
    // the threads; a block-wide exclusive scan of their counts, and the
    // one thread whose count holds the krem-th largest candidate names
    // the digit
    const unsigned local = tid < NB ? tot[NB - 1 - tid] : 0u;
    unsigned incl = local;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    unsigned before = incl - local;
    for (int w = 0; w < warp; ++w) before += s_warp[w];
    if (before < krem && krem <= before + local) {
      s_digit = (unsigned)(NB - 1 - tid);
      s_krem = krem - before;
    }
    __syncthreads();
    prefix |= s_digit << shift;
    mask |= dmask << shift;
    krem = s_krem;
  }

  // the mask, 16 bytes a store where aligned
  const T f = rt::from_f<T>(fill);
  auto keep = [&](T v) { return ukey(rt::to_f(v)) >= prefix ? v : f; };
  int head = 0;
  if (RESIDENT && ((uintptr_t)dst & 15) == 0) {
    head = n / VEC * VEC;
    for (int e = tid * VEC; e < head; e += TK_NT * VEC) {
      uint4 u = *reinterpret_cast<const uint4*>(vals + e);
      T* t = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int q = 0; q < VEC; ++q) t[q] = keep(t[q]);
      *reinterpret_cast<uint4*>(dst + e) = u;
    }
  }
  for (int i = head + tid; i < n; i += TK_NT) dst[i] = keep(at(i));
  cluster.sync();   // the CTA's counts stay readable until the cluster is done
}

template <typename T, bool RESIDENT>
cudaError_t launch_topk(const void* x, void* out, const int* k, int B, int V,
                        float fill, int cs, int slice, int smem,
                        cudaStream_t s) {
  auto fn = topk_cluster<T, RESIDENT>;
  static int smem_set = -1;
  static bool nonportable = false;
  cudaError_t e;
  if (smem > smem_set) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  if (cs > 8 && !nonportable) {
    e = cudaFuncSetAttribute(fn,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    nonportable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * cs));
  cfg.blockDim = dim3(TK_NT);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fn, (const T*)x, (T*)out, k, V, slice,
                            fill);
}

}  // namespace

// logits/out (B, V) of dtype (0 fp32, 1 bf16); k (B,) int32.  The plan
// (kernels/topk.py topk_plan): `cluster` CTAs a row (1 to 16), each
// holding `slice` values of it; the row resident in shared memory or
// streamed; `smem` dynamic bytes a CTA.
extern "C" int topk_mask(const void* x, void* out, const void* k, int B, int V,
                         float fill, int dtype, int cluster, int slice,
                         int resident, int smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster < 1 || cluster > TK_MAX_CLUSTER || (cluster & (cluster - 1)) ||
      slice < 1 || (long long)slice * cluster < V)
    return (int)cudaErrorInvalidValue;
  const int* kk = (const int*)k;
  const cudaError_t e =
      dtype == 1
          ? (resident ? launch_topk<__nv_bfloat16, true>
                      : launch_topk<__nv_bfloat16, false>)(
                x, out, kk, B, V, fill, cluster, slice, smem, s)
          : (resident ? launch_topk<float, true> : launch_topk<float, false>)(
                x, out, kk, B, V, fill, cluster, slice, smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
