// Chunked commit scan with top-k alternates and the tie jitter, for Hopper
// (sm_90a).
//
// Replaces: grove_tpu/solver/engine.py:commit_scan (a lax.scan over chunks
// of gangs with lax.top_k, jitter included; not a Pallas kernel). Gangs are
// taken C rows at a time (the last chunk may be shorter). Per chunk:
//   1. select: each row adds the murmur tie jitter to its live values
//      (value > -5e8), masks the row to the domains that are residually
//      feasible (resid[d, r] + 1e-6 >= td[g, r] for every r; else -1e9)
//      and keeps the top K ordered by (value desc, index asc), exactly as
//      lax.top_k and a stable descending sort order them, the -1e9 entries
//      included;
//   2. commit: every row whose first choice has value > -5e8 subtracts its
//      demand from that domain's ancestor chain (anc_ids[choice], padded
//      with the absorbing id D), in the flattened [C, L+1] order of JAX's
//      scatter.
//
// Precondition (checked where DomainSpace builds anc_ids): column j of
// anc_ids holds only domains of level j - 1 (column 0 the root), so a
// domain appears in one column only. The row-major scatter then adds to
// each domain in row order, and walking the chunk column by column in row
// order gives the same sums bit for bit whatever the data.
//
// What bounds it on this card: the chain of G / C dependent chunks (each
// chunk's select needs the previous chunk's commit), not bytes. The bytes
// (the [G, D] value tensor read once, ~21.8 MB at the stress shape) take
// ~6.5 us at 3.35 TB/s.
//
// What the design does about it: one cooperative launch of C blocks, one
// per chunk row, all co-resident, each keeping its own copy of the
// residual in shared memory ([D, R] f32, 64 KB at the stress shape), so
// one grid barrier a chunk is the only cross-block wait. Per chunk:
//   - the row's values are already in shared memory: they were copied
//     there with cp.async before the previous chunk's grid barrier (they do
//     not depend on the residual);
//   - one masking pass computes jitter and mask per element and keeps, per
//     thread, a sorted top-K of 64-bit keys in registers (order-preserving
//     float bits above the complemented index, so one unsigned compare is
//     the (value desc, index asc) order);
//   - each warp merges its 32 lists with shuffles (K rounds of a warp max),
//     then, after one block barrier, each of the 16 x K warp-list keys
//     counts the keys above it: a rank below K is its place in the row's
//     top-K;
//   - after the grid barrier, warp (j, r) of the block applies column j of
//     the chunk's chains to resource r: lane i holds row i, lanes naming
//     one domain form a group (match.any), and each lane sums its group's
//     demands in row order from 32 shuffles, so domains proceed in
//     parallel and each domain's adds keep the scatter's order.
// Two block barriers and one grid barrier a chunk.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e9f;
constexpr float kNegHalf = -5e8f;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

using Key = unsigned long long;

// The tie jitter of grove_tpu/solver/engine.py:commit_scan, bit for bit:
// murmur-style uint32 mixing of (row, domain), 1e-4 * (h / 2**32) in f32.
__device__ __forceinline__ float jittered(float v, unsigned g, unsigned d) {
  unsigned h = g * 0x9E3779B1u + d * 0x85EBCA77u;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  // h / 2**32 as a multiplication by 2**-32: exact either way, so equal
  const float jit = __fmul_rn(1e-4f, __fmul_rn(__uint2float_rn(h), 0x1p-32f));
  return v > kNegHalf ? __fadd_rn(v, jit) : v;
}

// A key whose unsigned order is lax.top_k's order: the float's bits made
// order-preserving above the complemented index (lower index first among
// equal values). Values are finite and never -0.0 (a live value gets a
// jitter >= +0, and -0 + +0 rounds to +0), so equal floats have equal
// bits. Key 0 is below every real key: the empty slot.
__device__ __forceinline__ Key make_key(float v, int d) {
  unsigned b = __float_as_uint(v);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<Key>(b) << 32) | (0xffffffffu - static_cast<unsigned>(d));
}

__device__ __forceinline__ float key_value(Key key) {
  unsigned b = static_cast<unsigned>(key >> 32);
  b = (b & 0x80000000u) ? (b & 0x7fffffffu) : ~b;
  return __uint_as_float(b);
}

__device__ __forceinline__ int key_index(Key key) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(key));
}

__device__ __forceinline__ Key warp_max(Key x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Key o = __shfl_xor_sync(kFull, x, off);
    x = o > x ? o : x;
  }
  return x;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// Start copying row g of `value` into `row`; completed by cp_async_wait_all.
__device__ __forceinline__ void prefetch_row(float* row, const float* value,
                                             int g, int D) {
  const float* src = value + static_cast<size_t>(g) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) cp_async4(row + d, src + d);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
commit_topk_kernel(const float* __restrict__ value,     // [G, D] un-jittered
                   const float* __restrict__ dom_free,  // [D, R]
                   const int* __restrict__ anc_ids,     // [D, L1]
                   const float* __restrict__ td,        // [G, R]
                   float* top_val,                      // [G, K]
                   int* top_dom,                        // [G, K]
                   int G, int D, int R, int L1, int K, int C) {
  extern __shared__ Key smem[];
  Key* lists = smem;                              // [kWarps * K]
  float* resid = reinterpret_cast<float*>(lists + kWarps * K);  // [D * R]
  float* row = resid + static_cast<size_t>(D) * R;     // [D]
  float* td_row = row + D;                             // [R]
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;

  for (int i = threadIdx.x; i < D * R; i += blockDim.x) resid[i] = dom_free[i];
  if (b < G) prefetch_row(row, value, b, D);
  for (int r = threadIdx.x; r < R && b < G; r += blockDim.x) td_row[r] = td[b * R + r];
  cp_async_wait_all();
  __syncthreads();

  for (int start = 0; start < G; start += C) {
    const int rows = min(C, G - start);
    const int g = start + b;
    if (b < rows) {
      // mask + per-thread top-KMAX (top KMAX contains the top K)
      Key best[KMAX];
#pragma unroll
      for (int j = 0; j < KMAX; ++j) best[j] = 0;
      for (int d = threadIdx.x; d < D; d += blockDim.x) {
        bool fits = true;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (r < R) fits &= resid[d * R + r] + 1e-6f >= td_row[r];
        }
        for (int r = 4; r < R; ++r) fits &= resid[d * R + r] + 1e-6f >= td_row[r];
        const float v = fits ? jittered(row[d], g, d) : kNeg;
        const Key key = make_key(v, d);
        if (key > best[KMAX - 1]) {
          best[KMAX - 1] = key;
#pragma unroll
          for (int j = KMAX - 1; j > 0; --j) {
            if (best[j] > best[j - 1]) {
              const Key t = best[j];
              best[j] = best[j - 1];
              best[j - 1] = t;
            }
          }
        }
      }
      // warp merge: K rounds of a warp max; the owner pops its head
      for (int k = 0; k < K; ++k) {
        const Key m = warp_max(best[0]);
        if (best[0] == m) {
#pragma unroll
          for (int j = 0; j < KMAX - 1; ++j) best[j] = best[j + 1];
          best[KMAX - 1] = 0;
        }
        if (lane == 0) lists[warp * K + k] = m;
      }
    }
    __syncthreads();  // warp lists written; every read of `row` done
    if (b < rows && threadIdx.x < kWarps * K) {
      // a warp list holds its warp's top K, so the row's top K are among
      // these keys; real keys are unique and at least K of them are here,
      // so a key's rank below K is its place (an empty 0 never ranks < K)
      const Key x = lists[threadIdx.x];
      int rank = 0;
      for (int q = 0; q < kWarps * K; ++q) rank += lists[q] > x;
      if (rank < K) {
        top_val[static_cast<size_t>(g) * K + rank] = key_value(x);
        top_dom[static_cast<size_t>(g) * K + rank] = key_index(x);
      }
    }
    // the next chunk's row does not depend on the residual: start its copy
    const int next = g + C;
    const bool has_next = start + C < G && b < min(C, G - start - C);
    if (has_next) prefetch_row(row, value, next, D);
    grid.sync();  // the chunk's picks are in global memory

    // commit: warp (j, r) applies column j of the chunk's chains to
    // resource r, 32 rows at a time, lane i holding row i. Every lane adds,
    // in row order, the demands of the rows that name its domain to that
    // domain's residual; the first lane of each such group stores the sum.
    for (int col = warp; col < L1 * R; col += kWarps) {
      const int j = col / R;
      const int r = col - j * R;
      for (int i0 = 0; i0 < rows; i0 += 32) {
        const int i = i0 + lane;
        int c = D;  // the absorbing id: no domain
        float t = 0.0f;
        if (i < rows) {
          const size_t first = static_cast<size_t>(start + i) * K;
          const bool ok = __ldcg(top_val + first) > kNegHalf;
          c = ok ? anc_ids[__ldcg(top_dom + first) * L1 + j] : D;
          t = td[(start + i) * R + r];
        }
        const unsigned group = __match_any_sync(kFull, c);
        float acc = c < D ? resid[c * R + r] : 0.0f;
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          const int cq = __shfl_sync(kFull, c, q);
          const float tq = __shfl_sync(kFull, t, q);
          if (cq == c) acc = acc + (-tq);
        }
        if (c < D && lane == __ffs(group) - 1) resid[c * R + r] = acc;
        __syncwarp();
      }
    }
    if (has_next) {
      for (int r = threadIdx.x; r < R; r += blockDim.x) td_row[r] = td[next * R + r];
    }
    cp_async_wait_all();
    __syncthreads();  // residual committed, next row and its demand landed
  }
}

template <int KMAX>
int launch(const float* value, const float* dom_free, const int* anc_ids,
           const float* td, float* top_val, int* top_dom, int G, int D, int R,
           int L1, int K, int C, cudaStream_t stream) {
  const int blocks = C < G ? C : G;
  const size_t smem = static_cast<size_t>(kWarps) * K * sizeof(Key) +
                      (static_cast<size_t>(D) * R + D + R) * sizeof(float);
  auto kernel = commit_topk_kernel<KMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm * sms < blocks) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  void* args[] = {&value, &dom_free, &anc_ids, &td, &top_val, &top_dom,
                  &G, &D, &R, &L1, &K, &C};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point: one cooperative launch of min(C, G) blocks on `stream`.
// K <= 8 keeps 8 keys a thread, K <= 32 keeps 32. Returns
// cudaGetLastError()-style codes: the error of raising the dynamic
// shared-memory limit, cudaErrorCooperativeLaunchTooLarge when the blocks
// cannot all be resident at once, cudaErrorInvalidValue for K outside
// 1..32, or the launch's own error.
extern "C" int grove_commit_topk(const float* value, const float* dom_free,
                                 const int* anc_ids, const float* td,
                                 float* top_val, int* top_dom, int G, int D,
                                 int R, int L1, int K, int C, void* stream) {
  if (G == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K >= 1 && K <= 8) {
    return launch<8>(value, dom_free, anc_ids, td, top_val, top_dom, G, D, R,
                     L1, K, C, s);
  }
  if (K >= 1 && K <= 32) {
    return launch<32>(value, dom_free, anc_ids, td, top_val, top_dom, G, D, R,
                      L1, K, C, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
