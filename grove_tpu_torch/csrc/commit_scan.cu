// Greedy on-device commit over the packed top-k, for Hopper (sm_90a).
//
// Replaces: grove_tpu/solver/pallas_core.py:device_commit_scan (a
// sequential lax.scan, not a Pallas kernel; in eager PyTorch the same
// scan would cost several launches per gang). Gangs in priority order
// (= row order) each take the FIRST of their K candidates that is still
// residually feasible at aggregate granularity
// (resid[dom, r] + 1e-6 >= td[g, r] for every r, and value > -5e8), then
// subtract their demand from the chosen domain's whole ancestor chain
// (anc_ids[choice], padded with the absorbing id D). A gang with no
// feasible candidate gets value -1e9 and domain top_dom[g, 0], and
// commits nothing -- exactly pallas_core.py:246-253.
//
// Precondition (checked where DomainSpace builds anc_ids): column j of
// anc_ids holds only domains of level j - 1, so a chain names each domain
// at most once and its decrements touch distinct residual cells.
//
// What bounds it on this card: the chain of G dependent steps, not bytes
// (the inputs are ~0.3 MB at the stress shape). Each step tests K
// candidates against the residual that the previous step decremented.
//
// What the design does about it: one block, the residual in dynamic shared
// memory ([D, R] f32, 64 KB at the stress shape), updated by one warp (the
// walker) in a fixed order with no atomics. Everything that does not
// depend on the residual is taken off the walker's path: the other warps
// (the fillers) stage tiles of kTile gangs -- their candidates' values and
// domains, their demands, and the gathered chains anc_ids[top_dom[g, k]]
// of all K candidates -- into a ring of kSlots tiles in shared memory,
// ahead of the walker; the two sides meet once a tile on named barriers
// (a "full" and an "empty" barrier per slot). A walker step then reads
// shared memory only: lane k tests candidate k over all R resources with
// no early exit (its value and domain loaded during the previous step), a
// ballot gives the first feasible k, and lane (j, r) -- a role fixed before
// the walk -- decrements resource r of chain entry j, all L+1 x R cells at
// once. The outputs are written from the staged values. A step is then a
// chain of some ten dependent shared-memory, vote and shuffle operations
// on one warp, with no other warp to hide their latency.
//
// Layouts (the `layout` argument, chosen by kernel_core.scan_layout):
// bit 0 keeps the residual in shared memory; clear, it lives in the global
// `scratch` [D, R] that the caller allocates (256 KB at D = 21335, R = 3:
// it stays in L2), and only the ring stays in shared memory. The walker's
// reads and decrements keep their order, so both layouts give the same
// bits. The residual is written inside the kernel, so it is read with
// plain loads only (no __ldg, no const __restrict__); the walker's
// __syncwarp() orders its global writes before the next step's reads.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr float kNegHalf = -5e8f;
constexpr int kThreads = 256;  // warp 0 walks, warps 1.. fill the ring
constexpr int kFillers = kThreads - 32;
constexpr int kTile = 64;      // gangs a ring slot holds
constexpr int kSlots = 3;      // ring slots; barriers 1..2*kSlots
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(kThreads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("barrier.arrive %0, %1;\n" ::"r"(id), "r"(kThreads) : "memory");
}

__device__ __forceinline__ int full_bar(int slot) { return 1 + slot; }
__device__ __forceinline__ int empty_bar(int slot) { return 1 + kSlots + slot; }

__global__ void __launch_bounds__(kThreads)
commit_scan_kernel(const float* __restrict__ top_val,   // [G, K]
                   const int* __restrict__ top_dom,     // [G, K]
                   const float* __restrict__ dom_free,  // [D, R]
                   const int* __restrict__ anc_ids,     // [D, L1]
                   const float* __restrict__ td,        // [G, R]
                   float* __restrict__ out_val,         // [G]
                   int* __restrict__ out_dom,           // [G]
                   float* scratch,  // [D, R] unless bit 0 of layout
                   int G, int K, int D, int R, int L1, int layout) {
  extern __shared__ float smem[];
  const bool resid_shared = layout & 1;
  // [D * R]; the absorbing row D is never stored
  float* resid = resid_shared ? smem : scratch;
  // a ring slot: val [kTile * K], dom [kTile * K], td [kTile * R],
  // chain [kTile * K * L1]
  const int slot_words = kTile * (2 * K + R + K * L1);
  float* ring = resid_shared ? smem + static_cast<size_t>(D) * R : smem;
  const int tiles = (G + kTile - 1) / kTile;

  for (int i = threadIdx.x; i < D * R; i += blockDim.x) resid[i] = dom_free[i];
  __syncthreads();

  if (threadIdx.x >= 32) {  // fillers
    const int f = threadIdx.x - 32;
    for (int t = 0; t < tiles; ++t) {
      const int s = t % kSlots;
      if (t >= kSlots) named_sync(empty_bar(s));  // the walker is done with it
      float* val_s = ring + static_cast<size_t>(s) * slot_words;
      int* dom_s = reinterpret_cast<int*>(val_s + kTile * K);
      float* td_s = reinterpret_cast<float*>(dom_s + kTile * K);
      int* chain_s = reinterpret_cast<int*>(td_s + kTile * R);
      const int g0 = t * kTile;
      const int n = min(kTile, G - g0);
      for (int e = f; e < n * K; e += kFillers) {
        const int dom = top_dom[static_cast<size_t>(g0) * K + e];
        val_s[e] = top_val[static_cast<size_t>(g0) * K + e];
        dom_s[e] = dom;
        for (int j = 0; j < L1; ++j) chain_s[e * L1 + j] = anc_ids[dom * L1 + j];
      }
      for (int e = f; e < n * R; e += kFillers) {
        td_s[e] = td[static_cast<size_t>(g0) * R + e];
      }
      named_arrive(full_bar(s));
    }
    return;
  }

  const int lane = threadIdx.x;
  // lane u < (L+1) R decrements resource u % R of chain entry u / R
  const int my_j = lane / R;
  const int my_r = lane - my_j * R;
  const bool decrements = lane < L1 * R;
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kSlots;
    named_sync(full_bar(s));  // the fillers have staged tile t
    const float* val_s = ring + static_cast<size_t>(s) * slot_words;
    const int* dom_s = reinterpret_cast<const int*>(val_s + kTile * K);
    const float* td_s = reinterpret_cast<const float*>(dom_s + kTile * K);
    const int* chain_s = reinterpret_cast<const int*>(td_s + kTile * R);
    const int g0 = t * kTile;
    const int n = min(kTile, G - g0);
    float v = kNeg;
    int dom = 0;
    if (lane < K) {
      v = val_s[lane];
      dom = dom_s[lane];
    }
    for (int i = 0; i < n; ++i) {
      bool fits = false;
      if (lane < K) {
        fits = v > kNegHalf;
        const float* resid_row = resid + dom * R;
        const float* td_row = td_s + i * R;
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // no early exit: the reads overlap
          if (r < R) fits &= resid_row[r] + 1e-6f >= td_row[r];
        }
        for (int r = 4; r < R; ++r) fits &= resid_row[r] + 1e-6f >= td_row[r];
      }
      const unsigned feasible = __ballot_sync(kFull, fits);
      const int k = feasible ? __ffs(feasible) - 1 : 0;  // first feasible
      const int choice = __shfl_sync(kFull, dom, k);
      const float chosen = __shfl_sync(kFull, v, k);
      // the next gang's candidates do not depend on the residual
      if (lane < K && i + 1 < n) {
        v = val_s[(i + 1) * K + lane];
        dom = dom_s[(i + 1) * K + lane];
      }
      if (lane == 0) {
        out_val[g0 + i] = feasible ? chosen : kNeg;
        out_dom[g0 + i] = choice;
      }
      if (feasible) {
        const int* chain = chain_s + (i * K + k) * L1;
        if (decrements) {
          const int c = chain[my_j];
          if (c < D) {
            resid[c * R + my_r] = resid[c * R + my_r] + (-td_s[i * R + my_r]);
          }
        }
        if (L1 * R > 32) {  // more cells than lanes
          for (int u = lane + 32; u < L1 * R; u += 32) {
            const int j = u / R;
            const int r = u - j * R;
            const int c = chain[j];
            if (c < D) resid[c * R + r] = resid[c * R + r] + (-td_s[i * R + r]);
          }
        }
      }
      __syncwarp();
    }
    if (t + kSlots < tiles) named_arrive(empty_bar(s));  // refill this slot
  }
}

}  // namespace

// C entry point: launches one block on `stream` and returns
// cudaGetLastError() (or the error of raising the kernel's dynamic
// shared-memory limit, or cudaErrorInvalidValue for a residual in global
// memory without scratch). `layout` as above; `scratch` is read only when
// bit 0 is clear (it may be null otherwise).
extern "C" int grove_commit_scan(const float* top_val, const int* top_dom,
                                 const float* dom_free, const int* anc_ids,
                                 const float* td, float* out_val, int* out_dom,
                                 float* scratch, int G, int K, int D, int R,
                                 int L1, int layout, void* stream) {
  if (G == 0) return static_cast<int>(cudaSuccess);
  if (!(layout & 1) && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      ((layout & 1 ? static_cast<size_t>(D) * R : 0) +
       static_cast<size_t>(kSlots) * kTile * (2 * K + R + K * L1)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      commit_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  commit_scan_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      top_val, top_dom, dom_free, anc_ids, td, out_val, out_dom, scratch, G, K,
      D, R, L1, layout);
  return static_cast<int>(cudaGetLastError());
}
