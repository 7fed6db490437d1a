// Shared bodies of the hashed GEMM kernels.  Both compute
// y (M, N) = x (M, K) @ Vop, where Vop (K, N) is V (forward, y = x @ V)
// or V^T (transpose, dx = g @ V^T) of a virtual matrix V (R, C).  They
// replace the GEMM part of the JAX package's kernels/hashed_matmul.py
// _element_fwd_kernel and _block_fwd_kernel, which cast each
// decompressed tile to x's dtype and take the product in fp32
// (preferred_element_type=jnp.float32): bf16 operands with fp32 sums.
//
// tc_gemm — bf16, M > 8 rows but the element forward up to 16 rows (the
// wrapper's plan, TC_MIN_ROWS and GEMV_MAX_ROWS in
// kernels/hashed_matmul.py, from H100 timings of both bodies at M = 8 to
// 1024): the products run on Hopper's tensor cores, from a V that the
// caller decompressed once per call into a bf16 workspace
// (element_decompress, block_decompress).  A 128 x 128
// output tile per block of 256 threads: two consumer warpgroups of 64
// rows, each issuing wgmma.m64n128k16 (bf16 in, fp32 accumulators in
// registers) from shared memory.  x and V are staged in 64-deep K tiles
// by cp.async (16 bytes a thread, zero-filled past the ragged M, K and N
// edges) into a 4-slot ring in dynamic shared memory (128 KB): while
// tile kt is multiplied, tile kt - 1's wgmma group may still run and
// tiles kt + 1 and kt + 2 are in flight.  Every operand tile is stored in
// the 128-byte-swizzled layout its wgmma descriptor names: x as K-major
// rows of 64 bf16; V K-major for the transpose (a row of V holds the
// contraction index j contiguous) and MN-major for the forward (a row of
// V holds the output column j contiguous: two 64-column swizzle atoms,
// wgmma's transpose bit).  Requires K % 8 == 0 and N % 8 == 0 (the plan
// checks).  What bounds it at qwen3-1.7b's widths: most likely operand
// traffic from L2 into shared memory, not the products: each 128 x 128
// tile reads 128 x K bf16 of x and of V, 400 MB at ffn.out, M = 1024,
// which the 0.063 ms the GEMM takes there moves at 6.3 TB/s
// (gemm_timing.py --split); a library GEMM of the same shape takes
// 0.040 ms (chip_smoke library_ms).  Larger tiles shared
// across a cluster (TMA multicast, a producer warp) would read less:
// future work.  H100 timings picked the ring depth (3 to 5 slots timed, one
// or two blocks per SM) and the V workspace over gathering bank tiles
// inside the loader (PERF.md).
//
// decompress_gemm — the CUDA-core body: fp32 inputs, and at decode size
// (M <= 8) the element transpose and both block-mode orientations (the
// element forward up to 16 rows takes hashed_matmul.cu's gemv body).  A Tile policy decompresses one (TG_BK x TG_BN) tile of Vop
// into shared memory per K step and the block reuses it for all BM rows.
// At M <= 8 the hashing bounds it, not the product, and tensor cores
// would add nothing; fp32 keeps full fp32 products (TF32 would change
// them).
//
// Split-K (both bodies): the K loop may be split across blocks; each
// split writes an fp32 partial into a workspace and splitk_reduce adds
// them in split order, so the result does not depend on scheduling and
// no float atomics are used.
//
// tc_xtg — bf16 block_dw and element dw: x^T g on the tensor cores,
// contracting over M, summed over a bank tile's chain of virtual tiles in
// the same ring and wgmma pipeline as tc_gemm (tc_mainloop); both operands
// MN-major; the pieces of a chain added in split order by splitk_reduce.
// Element mode's product is the degenerate case of one R x C bank tile
// whose chain is one virtual tile of sign +1 (hashed_dw.cu).
//
// xtg_accumulate: one 64 x 64 tile of x^T g (x (M, R), g (M, C)) summed
// over all M rows into registers on the CUDA cores, the product the fp32
// element dw and fp32 block_dw need.
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

// K per split rounded up to whole K tiles of bk, and the number of
// non-empty splits it leaves.
inline void split_k(int K, int splits, int bk, int* k_per_split, int* nz) {
  *k_per_split = ((K + splits - 1) / splits + bk - 1) / bk * bk;
  *nz = (K + *k_per_split - 1) / *k_per_split;
}

template <typename T>
void launch_reduce(const float* ws, void* y, int M, int N, int nz,
                   cudaStream_t stream) {
  const long long mn = (long long)M * N;
  splitk_reduce<T><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      ws, (T*)y, mn, nz);
}

template <typename T, int BM, class Tile>
void launch_gemm_bm(const void* x, void* y, float* ws, int M, int K, int N,
                    int splits, const Tile& tile, cudaStream_t stream) {
  int k_per_split, nz;
  split_k(K, splits, TG_BK, &k_per_split, &nz);
  dim3 grid((N + TG_BN - 1) / TG_BN, (M + BM - 1) / BM, nz);
  decompress_gemm<T, BM, Tile><<<grid, TG_NT, 0, stream>>>(
      (const T*)x, (T*)y, nz > 1 ? ws : nullptr, M, K, N, k_per_split, tile);
  if (nz > 1) launch_reduce<T>(ws, y, M, N, nz, stream);
}

// The CUDA-core body with the plan's row block: 8 (decode-sized M, with
// split-K filling the card) or 64.
template <typename T, class Tile>
void launch_gemm(const void* x, void* y, float* ws, int M, int K, int N,
                 int bm, int splits, const Tile& tile, cudaStream_t stream) {
  if (bm == 8)
    launch_gemm_bm<T, 8, Tile>(x, y, ws, M, K, N, splits, tile, stream);
  else
    launch_gemm_bm<T, 64, Tile>(x, y, ws, M, K, N, splits, tile, stream);
}

// ---------------------------------------------------------------------------
// tensor-core body (sm_90a: cp.async ring + wgmma)
// ---------------------------------------------------------------------------

constexpr int TC_BM = 128;        // output rows per block (2 warpgroups x 64)
constexpr int TC_BN = 128;        // output columns per block
constexpr int TC_BK = 64;         // contraction tile: one 128-byte bf16 row
constexpr int TC_STAGES = 4;      // ring slots (see the K loop)
constexpr int TC_NT = 256;
constexpr int TC_OPERAND = TC_BM * TC_BK * 2;   // 16 KB: x tile, or B tile
constexpr int TC_STAGE = 2 * TC_OPERAND;
constexpr int TC_SMEM = TC_STAGES * TC_STAGE + 1024;   // + 1 KB alignment
constexpr int TC_CHUNKS = TC_BM * TC_BK / 8 / TC_NT;   // 16-byte chunks a
                                                       // thread copies per
                                                       // operand and stage

// wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d (64 x 128 fp32, 64 registers a thread) += A (64 x 16) B (16 x 128);
// A K-major (TRANS_A 0) or MN-major (TRANS_A 1), B likewise with TRANS_B.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %68, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B), "n"(TRANS_A));
}

// Descriptors of one k16 step: A and B.
struct TcStep {
  uint64_t a, b;
};

// The K loop of both tensor-core bodies, on the 4-slot ring at `base`:
// load(kt, slot) issues this thread's cp.async copies of K tile kt into
// a slot; land(kt, slot) runs once they have landed, before any wgmma
// reads the slot (this thread may rewrite its own chunks);
// step(stage, kk) names the descriptors of the kk-th k16 step of the
// slot at address `stage`.  While tile kt is multiplied, tile kt - 1's
// wgmma group may still run and tiles kt + 1 and kt + 2 are in flight.
// Returns with every wgmma finished and acc readable.
template <int TRANS_A, int TRANS_B, class Load, class Land, class Step>
__device__ __forceinline__ void tc_mainloop(float (&acc)[64], int nk,
                                            uint32_t base, const Load& load,
                                            const Land& land,
                                            const Step& step) {
#pragma unroll
  for (int s = 0; s < TC_STAGES - 2; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int slot = kt % TC_STAGES;
    cp_async_wait<TC_STAGES - 3>();          // this thread's tile kt landed
    land(kt, slot);
    // its cp.async writes (generic proxy) before wgmma reads them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t stage = base + slot * TC_STAGE;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const TcStep d = step(stage, kk);
      wgmma_m64n128k16<TRANS_A, TRANS_B>(acc, d.a, d.b);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    {  // every warpgroup has finished tile kt - 2's wgmma group (it waited
       // for all but its newest group before the barrier above), so that
       // slot is refilled while this tile's group runs
      const int nt = kt + TC_STAGES - 2;
      if (nt < nk) load(nt, nt % TC_STAGES);
      cp_async_commit();
    }
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int r = 0; r < 64; ++r)     // keep accumulator reads after the wait
    asm volatile("" : "+f"(acc[r])::"memory");
}

// Shared-memory offset of 16-byte chunk `ch` (0..15) of row `r` of a
// 128-column MN-major bf16 tile (two 64-column swizzle atoms of TC_BK
// rows, TC_BK * 128 bytes apart).
__device__ __forceinline__ uint32_t mn_major_off(int r, int ch) {
  return (ch >> 3) * (TC_BK * 128) + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

// y = x @ Vop on the tensor cores: x bf16 (M, K) row-major, V bf16
// (R, C) row-major with row stride ld, y bf16 (M, N), or fp32 partials
// into ws[split] when ws is set.  TRANS: Vop = V^T (K runs along V's
// columns j), else Vop = V (K along V's rows i).
template <bool TRANS>
__global__ void __launch_bounds__(TC_NT)
tc_gemm(const __nv_bfloat16* __restrict__ x,
        const __nv_bfloat16* __restrict__ v, int ld,
        __nv_bfloat16* __restrict__ y, float* __restrict__ ws, int M, int K,
        int N, int k_per_split) {
  extern __shared__ uint8_t tc_smem_raw[];
  const uint32_t raw = smem_u32(tc_smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1 KB

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int n0 = blockIdx.x * TC_BN;
  const int m0 = blockIdx.y * TC_BM;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int nk = (kend - kbeg + TC_BK - 1) / TC_BK;

  float acc[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = 0.f;

  // Stage K tile kt into ring slot `slot`: 1024 16-byte chunks of x and
  // as many of V, TC_CHUNKS each per thread, neighbouring threads on
  // neighbouring addresses.  Chunk c = tid + q TC_NT: x row c / 8, K
  // chunk c % 8; V (transpose, K-major) row n = c / 8, K chunk c % 8, or
  // (forward, MN-major) row k = c / 16, N chunk c % 16.  A V chunk holds
  // 8 consecutive columns j of one row i.
  auto load = [&](int kt, int slot) {
    const int k0 = kbeg + kt * TC_BK;
    const uint32_t sa = base + slot * TC_STAGE;
    const uint32_t sb = sa + TC_OPERAND;
#pragma unroll
    for (int q = 0; q < TC_CHUNKS; ++q) {
      const int c = tid + q * TC_NT;
      {
        const int r = c >> 3, kc = c & 7;
        const int gm = m0 + r, gk = k0 + kc * 8;
        const bool ok = gm < M && gk < kend;
        cp_async16(sa + r * 128 + ((kc ^ (r & 7)) << 4),
                   ok ? x + (long long)gm * K + gk : x, ok);
      }
      int i, j;
      uint32_t dst;
      bool ok;
      if constexpr (TRANS) {
        const int r = c >> 3, kc = c & 7;
        i = n0 + r;
        j = k0 + kc * 8;
        ok = i < N && j < kend;
        dst = sb + r * 128 + ((kc ^ (r & 7)) << 4);
      } else {
        const int r = c >> 4, nc = c & 15;
        i = k0 + r;
        j = n0 + nc * 8;
        ok = i < kend && j < N;
        dst = sb + mn_major_off(r, nc);
      }
      cp_async16(dst, ok ? v + (long long)i * ld + j : v, ok);
    }
  };
  // x K-major, this warpgroup's 64 rows; V K-major (transpose) or
  // MN-major (forward: atoms of 64 columns TC_BK * 128 bytes apart)
  auto step = [&](uint32_t stage, int kk) {
    const uint32_t sb = stage + TC_OPERAND;
    return TcStep{gmma_desc(stage + wg * (64 * 128) + kk * 32, 16, 1024),
                  TRANS ? gmma_desc(sb + kk * 32, 16, 1024)
                        : gmma_desc(sb + kk * 2048, TC_BK * 128, 1024)};
  };
  tc_mainloop<0, TRANS ? 0 : 1>(acc, nk, base, load, [](int, int) {}, step);

  // accumulator fragment: register r of lane l in warp w of the
  // warpgroup holds row 16 w + l / 4 + 8 ((r / 2) % 2), column
  // 8 (r / 4) + 2 (l % 4) + r % 2
  const int lane = tid & 31;
  const int row0 = m0 + wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int col = n0 + p * 8 + (lane & 3) * 2;
    if (col >= N) continue;               // N % 8 == 0: col + 1 < N too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      const float v0 = acc[p * 4 + h * 2], v1 = acc[p * 4 + h * 2 + 1];
      if (ws != nullptr) {
        float2* o = reinterpret_cast<float2*>(
            ws + ((long long)blockIdx.z * M + row) * N + col);
        *o = make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(y + (long long)row * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// Launch tc_gemm (and the split-K reduction) on x and the decompressed
// V (R, C), R * C == K * N.  Returns the first CUDA error: the > 48 KB
// shared-memory attribute, or the launches.
template <bool TRANS>
cudaError_t launch_tc_gemm(const void* x, const void* v, void* y, float* ws,
                           int M, int K, int N, int splits,
                           cudaStream_t stream) {
  // set on every launch: a function-local static would be one symbol
  // shared by every library of the process that instantiates it
  const cudaError_t attr = cudaFuncSetAttribute(
      tc_gemm<TRANS>, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (attr != cudaSuccess) return attr;
  int k_per_split, nz;
  split_k(K, splits, TC_BK, &k_per_split, &nz);
  dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM, nz);
  tc_gemm<TRANS><<<grid, TC_NT, TC_SMEM, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)v, TRANS ? K : N,
      (__nv_bfloat16*)y, nz > 1 ? ws : nullptr, M, K, N, k_per_split);
  if (nz > 1) launch_reduce<__nv_bfloat16>(ws, y, M, N, nz, stream);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tensor-core x^T g over a bank tile's chain of virtual tiles (block_dw)
// ---------------------------------------------------------------------------

// out (128 x 128 piece of bank tile b) = sum over b's chain of sigma(t) *
// x[:, tile t's rows]^T g[:, tile t's columns], fp32.
//
// The chain of bank tile b is its virtual tiles in `order` (positions
// offsets[b] .. offsets[b + 1], the JAX kernel's stable-argsort order)
// times M in steps of TC_BK rows: K tile q is virtual tile q / nm, rows
// 64 (q % nm) ...  It is cut into `splits` pieces of equal length; a
// block multiplies one piece into one 128 x 128 output tile (two
// warpgroups of 64 bank-tile rows) and writes its fp32 sum to
// out + split * split_stride: dbank itself for one piece, else an fp32
// workspace that splitk_reduce adds up in split order.  No atomics,
// same bits on every launch.  (Adding the pieces of a tile through a
// thread block cluster's distributed shared memory instead, with no
// workspace, was built and timed slower on the card at ffn.out and
// attn.q: a cluster's blocks must be resident together, so the pieces
// cannot fill the SMs as freely; PERF.md.)
//
// Both operands are MN-major in global memory (x^T has its bank-tile row
// r contiguous, g its column c), so both are staged like tc_gemm's
// forward V: rows of 64 m, 128 columns in two swizzle atoms, and both
// descriptors take wgmma's transpose bit.  A virtual tile of sign -1 has
// the sign bits of its staged g chunks flipped by the threads that
// copied them, once they land (exact; no branch around the wgmmas).
// Rows past M and bank-tile rows or columns past the tile read zeros.
// The loader walks its piece incrementally: one lookup of `order` and
// `sgn` per virtual tile, none per K tile.  Blocks run the bank tiles in
// `heavy` order (longest chain first), so the longest pieces start in
// the first wave.  Needs brow, bcol, R and C multiples of 8 (16-byte
// chunks inside one tile row).
__global__ void __launch_bounds__(TC_NT)
tc_xtg(const __nv_bfloat16* __restrict__ x,
       const __nv_bfloat16* __restrict__ g, const int* __restrict__ order,
       const int* __restrict__ offsets, const int* __restrict__ sgn,
       const int* __restrict__ heavy, float* __restrict__ out,
       long long split_stride, int M, int R, int C, int brow, int bcol,
       int gj, int splits) {
  extern __shared__ uint8_t tc_smem_raw[];
  const uint32_t raw = smem_u32(tc_smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int nrb = (brow + TC_BM - 1) / TC_BM, ncb = (bcol + TC_BN - 1) / TC_BN;
  // blockIdx.x = ((tile rank * nrb + rb) * ncb + cb) * splits + split
  const int split = blockIdx.x % splits;
  const int piece = blockIdx.x / splits;
  const int b = heavy[piece / (nrb * ncb)];
  const int pr0 = piece / ncb % nrb * TC_BM, pc0 = piece % ncb * TC_BN;
  const int rlim = min(TC_BM, brow - pr0), clim = min(TC_BN, bcol - pc0);

  const int nm = (M + TC_BK - 1) / TC_BK;
  const int chain = offsets[b], chain_end = offsets[b + 1];
  const int len = (chain_end - chain) * nm;
  const int per_piece = (len + splits - 1) / splits;
  const int q0 = min(len, split * per_piece);
  const int nk = min(len, q0 + per_piece) - q0;

  float acc[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = 0.f;

  // loader state: the next K tile to stage is rows 64 lm ... of the
  // virtual tile at chain position li (loads come in K-tile order)
  int li = chain + q0 / nm, lm = q0 % nm;
  const __nv_bfloat16* xs = x;
  const __nv_bfloat16* gs = g;
  bool neg = false;
  uint32_t negs = 0;                // bit s: ring slot s holds a -1 tile
  auto seek = [&]() {
    const int t = order[li];
    xs = x + (t / gj) * brow + pr0;
    gs = g + (t % gj) * bcol + pc0;
    neg = sgn[t] < 0;
  };
  if (nk > 0) seek();
  auto chunk = [&](int k, int* r, int* ch) {
    const int c = tid + k * TC_NT;
    *r = c >> 4;
    *ch = c & 15;
  };
  // one K tile: 64 rows m of x (bank-tile rows r) and of g (bank-tile
  // columns c), TC_CHUNKS 16-byte chunks of each per thread
  auto load = [&](int, int slot) {
    const int m0 = lm * TC_BK;
    const uint32_t sa = base + slot * TC_STAGE;
    const uint32_t sb = sa + TC_OPERAND;
    negs = (negs & ~(1u << slot)) | ((uint32_t)neg << slot);
#pragma unroll
    for (int k = 0; k < TC_CHUNKS; ++k) {
      int r, ch;
      chunk(k, &r, &ch);
      const int gm = m0 + r;
      const bool okx = gm < M && ch * 8 < rlim;
      const bool okg = gm < M && ch * 8 < clim;
      cp_async16(sa + mn_major_off(r, ch),
                 okx ? xs + (long long)gm * R + ch * 8 : x, okx);
      cp_async16(sb + mn_major_off(r, ch),
                 okg ? gs + (long long)gm * C + ch * 8 : g, okg);
    }
    if (++lm == nm) {
      lm = 0;
      if (++li < chain_end) seek();
    }
  };
  auto land = [&](int, int slot) {
    if (!((negs >> slot) & 1u)) return;
    uint8_t* sb = tc_smem_raw + (base - raw) + slot * TC_STAGE + TC_OPERAND;
#pragma unroll
    for (int k = 0; k < TC_CHUNKS; ++k) {
      int r, ch;
      chunk(k, &r, &ch);
      uint4* u = reinterpret_cast<uint4*>(sb + mn_major_off(r, ch));
      uint4 v = *u;
      v.x ^= 0x80008000u; v.y ^= 0x80008000u;
      v.z ^= 0x80008000u; v.w ^= 0x80008000u;
      *u = v;
    }
  };
  // A = this warpgroup's 64 bank-tile rows (one swizzle atom), B = all
  // 128 columns; a k16 step is 16 rows m, 2 KB into each atom
  auto step = [&](uint32_t stage, int kk) {
    return TcStep{gmma_desc(stage + wg * (TC_BK * 128) + kk * 2048,
                            TC_BK * 128, 1024),
                  gmma_desc(stage + TC_OPERAND + kk * 2048, TC_BK * 128,
                            1024)};
  };
  tc_mainloop<1, 1>(acc, nk, base, load, land, step);

  // accumulator fragment as in tc_gemm: rows are bank-tile rows r,
  // columns bank-tile columns c
  const int lane = tid & 31;
  const int row0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  float* o = out + split * split_stride + (long long)b * brow * bcol;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int col = p * 8 + (lane & 3) * 2;
    if (col >= clim) continue;            // clim % 8 == 0: col + 1 too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= rlim) continue;
      *reinterpret_cast<float2*>(o + (long long)(pr0 + row) * bcol + pc0 +
                                 col) =
          make_float2(acc[p * 4 + h * 2], acc[p * 4 + h * 2 + 1]);
    }
  }
}

// Launch tc_xtg over every (bank tile, 128 x 128 piece, split) and, when
// splits > 1, reduce ws (splits, bank_tiles, brow, bcol) into dbank.
inline cudaError_t launch_tc_xtg(const void* x, const void* g,
                                 const int* order, const int* offsets,
                                 const int* sgn, const int* heavy,
                                 float* dbank, float* ws, int M, int R, int C,
                                 int brow, int bcol, int gj, int bank_tiles,
                                 int splits, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      tc_xtg, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (attr != cudaSuccess) return attr;
  const int nrb = (brow + TC_BM - 1) / TC_BM, ncb = (bcol + TC_BN - 1) / TC_BN;
  const long long elems = (long long)bank_tiles * brow * bcol;
  tc_xtg<<<(unsigned)(bank_tiles * nrb * ncb * splits), TC_NT, TC_SMEM,
           stream>>>((const __nv_bfloat16*)x, (const __nv_bfloat16*)g, order,
                     offsets, sgn, heavy, splits > 1 ? ws : dbank, elems, M,
                     R, C, brow, bcol, gj, splits);
  if (splits > 1)
    launch_reduce<float>(ws, dbank, bank_tiles, brow * bcol, splits, stream);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// x^T g tiles for the dw kernels (CUDA cores)
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
