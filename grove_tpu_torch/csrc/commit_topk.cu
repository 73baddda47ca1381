// Chunked commit scan with top-k alternates, for Hopper (sm_90a).
//
// Replaces: grove_tpu/solver/engine.py:commit_scan (a lax.scan over chunks
// of gangs with lax.top_k, not a Pallas kernel; in eager PyTorch the loop
// costs ~15 launches and a sort per chunk). Gangs are taken C rows at a
// time (the last chunk may be shorter). Per chunk:
//   1. select: each row masks its jittered value row to the domains that
//      are residually feasible (resid[d, r] + 1e-6 >= td[g, r] for every
//      r; else -1e9) and keeps the top K ordered by (value desc, index
//      asc), exactly as lax.top_k and a stable descending sort order
//      them, the -1e9 entries included;
//   2. commit: every row whose first choice has value > -5e8 subtracts its
//      demand from that domain's ancestor chain (anc_ids[choice], padded
//      with the absorbing id D), in the flattened [C, L+1] order of JAX's
//      scatter: row by row, chain entry by chain entry.
// The residual sums are therefore bit-equal to the CPU's sequential
// scatter whatever the data; the atomics of a CUDA index_add_ are not.
//
// What bounds it on this card: the chain of G / C dependent chunks (each
// chunk's select needs the previous chunk's commit), not bytes. The bytes
// (the [G, D] value tensor read once, ~21.8 MB at the stress shape) take
// ~6.5 us at 3.35 TB/s.
//
// What the design does about it: one cooperative launch of C blocks, one
// per chunk row, all co-resident. Every block keeps its own copy of the
// residual in shared memory ([D, R] f32, 64 KB at the stress shape) and
// its row's masked values ([D] f32). Select: the block's threads mask the
// row in one coalesced pass, then K block-wide rounds each pick the next
// element in (value desc, index asc) order (warp shuffles, then one warp
// over the warp winners). The row's K picks go to global memory; one
// grid.sync() per chunk makes the chunk's first choices visible to every
// block, which reads them through L2 (__ldcg). Commit: every block applies
// the same commits to its own residual copy, so no residual crosses
// blocks and no second grid barrier is needed. The C*(L+1) chain entries
// are staged in shared memory; the first entry that names a domain owns
// it and adds, per resource, every later entry's demand for that domain
// in entry order -- sequential per domain (bit-exact), parallel across
// domains.

#include <climits>
#include <cmath>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e9f;
constexpr float kNegHalf = -5e8f;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// (va, ia) comes before (vb, ib) in lax.top_k's order.
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__global__ void __launch_bounds__(kThreads)
commit_topk_kernel(const float* __restrict__ value,     // [G, D] jittered
                   const float* __restrict__ dom_free,  // [D, R]
                   const int* __restrict__ anc_ids,     // [D, L1]
                   const float* __restrict__ td,        // [G, R]
                   float* top_val,                      // [G, K]
                   int* top_dom,                        // [G, K]
                   int G, int D, int R, int L1, int K, int C) {
  extern __shared__ float smem[];
  float* resid = smem;                                 // [D * R]
  float* row = resid + static_cast<size_t>(D) * R;     // [D]
  int* target = reinterpret_cast<int*>(row + D);       // [C * L1]
  __shared__ float warp_v[kWarps + 1];
  __shared__ int warp_i[kWarps + 1];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < D * R; i += blockDim.x) resid[i] = dom_free[i];
  __syncthreads();

  for (int start = 0; start < G; start += C) {
    const int rows = min(C, G - start);
    if (static_cast<int>(blockIdx.x) < rows) {
      const int g = start + blockIdx.x;
      for (int d = threadIdx.x; d < D; d += blockDim.x) {
        bool fits = true;
        for (int r = 0; r < R; ++r) {
          fits = fits && resid[d * R + r] + 1e-6f >= td[g * R + r];
        }
        row[d] = fits ? value[static_cast<size_t>(g) * D + d] : kNeg;
      }
      __syncthreads();
      float prev_v = INFINITY;  // every element comes after the start key
      int prev_i = -1;
      for (int k = 0; k < K; ++k) {
        float best_v = -INFINITY;
        int best_i = INT_MAX;
        for (int d = threadIdx.x; d < D; d += blockDim.x) {
          const float v = row[d];
          const bool after_prev = v < prev_v || (v == prev_v && d > prev_i);
          if (after_prev && before(v, d, best_v, best_i)) {
            best_v = v;
            best_i = d;
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_down_sync(kFull, best_v, off);
          const int oi = __shfl_down_sync(kFull, best_i, off);
          if (before(ov, oi, best_v, best_i)) {
            best_v = ov;
            best_i = oi;
          }
        }
        if (lane == 0) {
          warp_v[warp] = best_v;
          warp_i[warp] = best_i;
        }
        __syncthreads();
        if (warp == 0) {
          best_v = lane < kWarps ? warp_v[lane] : -INFINITY;
          best_i = lane < kWarps ? warp_i[lane] : INT_MAX;
          for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_down_sync(kFull, best_v, off);
            const int oi = __shfl_down_sync(kFull, best_i, off);
            if (before(ov, oi, best_v, best_i)) {
              best_v = ov;
              best_i = oi;
            }
          }
          if (lane == 0) {
            warp_v[kWarps] = best_v;
            warp_i[kWarps] = best_i;
            top_val[static_cast<size_t>(g) * K + k] = best_v;
            top_dom[static_cast<size_t>(g) * K + k] = best_i;
          }
        }
        __syncthreads();
        prev_v = warp_v[kWarps];
        prev_i = warp_i[kWarps];
      }
    }
    grid.sync();  // the chunk's picks are in global memory

    const int entries = rows * L1;
    for (int u = threadIdx.x; u < entries; u += blockDim.x) {
      const int i = u / L1;
      const size_t first = static_cast<size_t>(start + i) * K;
      const bool ok = __ldcg(top_val + first) > kNegHalf;
      target[u] = ok ? anc_ids[__ldcg(top_dom + first) * L1 + (u - i * L1)] : D;
    }
    __syncthreads();
    for (int u = threadIdx.x; u < entries; u += blockDim.x) {
      const int c = target[u];
      if (c >= D) continue;  // the absorbing row: no domain
      bool owner = true;
      for (int w = 0; w < u && owner; ++w) owner = target[w] != c;
      if (!owner) continue;
      for (int r = 0; r < R; ++r) {
        float acc = resid[c * R + r];
        for (int w = u; w < entries; ++w) {
          if (target[w] == c) acc = acc + (-td[(start + w / L1) * R + r]);
        }
        resid[c * R + r] = acc;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// C entry point: one cooperative launch of min(C, G) blocks on `stream`.
// Returns cudaGetLastError()-style codes: the error of raising the
// dynamic shared-memory limit, cudaErrorCooperativeLaunchTooLarge when
// the blocks cannot all be resident at once, or the launch's own error.
extern "C" int grove_commit_topk(const float* value, const float* dom_free,
                                 const int* anc_ids, const float* td,
                                 float* top_val, int* top_dom, int G, int D,
                                 int R, int L1, int K, int C, void* stream) {
  if (G == 0) return static_cast<int>(cudaSuccess);
  const int blocks = C < G ? C : G;
  const size_t smem =
      (static_cast<size_t>(D) * R + D + static_cast<size_t>(blocks) * L1) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      commit_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, commit_topk_kernel, kThreads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm * sms < blocks) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  void* args[] = {&value, &dom_free, &anc_ids, &td, &top_val, &top_dom,
                  &G, &D, &R, &L1, &K, &C};
  err = cudaLaunchCooperativeKernel(commit_topk_kernel, dim3(blocks),
                                    dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
