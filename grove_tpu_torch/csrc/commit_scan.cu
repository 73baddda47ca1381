// Greedy on-device commit over the packed top-k, for Hopper (sm_90a).
//
// Replaces: grove_tpu/solver/pallas_core.py:device_commit_scan (a
// sequential lax.scan, not a Pallas kernel; in eager PyTorch the same
// scan would cost several launches per gang). Gangs in priority order
// (= row order) each take the FIRST of their K candidates that is still
// residually feasible at aggregate granularity
// (resid[dom, r] + 1e-6 >= td[g, r] for every r, and value > -5e8), then
// subtract their demand from the chosen domain's whole ancestor chain
// (anc_ids[choice], padded with the absorbing row D). A gang with no
// feasible candidate gets value -1e9 and domain top_dom[g, 0], and
// commits nothing -- exactly pallas_core.py:246-253.
//
// What bounds it on this card: the chain of G dependent steps, not bytes
// (the inputs are ~0.3 MB at the stress shape). Each step reads its
// gang's candidates from global memory, tests them against the residual,
// then decrements L+1 residual rows that the next step may read.
//
// What the design does about it: one block; its threads first copy
// dom_free into a residual held in dynamic shared memory ((D+1) x R
// floats, 64 KB at the stress shape, above the 48 KB static limit, hence
// cudaFuncSetAttribute), then one warp walks the gangs. Lane k tests
// candidate k over all R resources; a ballot gives the first feasible k
// with no shared-memory round trip; lanes r < R then decrement resource r
// down the ancestor chain in chain order. One thread per resource and a
// fixed order keep the residual deterministic (no atomics). The residual
// never leaves shared memory, so each step costs shared-memory latency
// plus two dependent global loads (the candidates, then the chain).

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr float kNegHalf = -5e8f;
constexpr int kThreads = 256;

__global__ void commit_scan_kernel(const float* __restrict__ top_val,   // [G, K]
                                   const int* __restrict__ top_dom,     // [G, K]
                                   const float* __restrict__ dom_free,  // [D, R]
                                   const int* __restrict__ anc_ids,     // [D, L1]
                                   const float* __restrict__ td,        // [G, R]
                                   float* __restrict__ out_val,         // [G]
                                   int* __restrict__ out_dom,           // [G]
                                   int G, int K, int D, int R, int L1) {
  extern __shared__ float resid[];  // [(D + 1) * R]
  for (int i = threadIdx.x; i < D * R; i += blockDim.x) resid[i] = dom_free[i];
  for (int i = threadIdx.x; i < R; i += blockDim.x) resid[D * R + i] = 0.0f;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  for (int g = 0; g < G; ++g) {
    bool fits = false;
    int dom = 0;
    if (lane < K) {
      dom = top_dom[g * K + lane];
      fits = top_val[g * K + lane] > kNegHalf;
      for (int r = 0; r < R && fits; ++r) {
        fits = resid[dom * R + r] + 1e-6f >= td[g * R + r];
      }
    }
    const unsigned feasible = __ballot_sync(0xffffffffu, fits);
    const int k = feasible ? __ffs(feasible) - 1 : 0;  // first feasible
    const int choice = __shfl_sync(0xffffffffu, dom, k);
    if (lane == 0) {
      out_val[g] = feasible ? top_val[g * K + k] : kNeg;
      out_dom[g] = choice;
    }
    if (feasible && lane < R) {
      const float t = td[g * R + lane];
      for (int j = 0; j < L1; ++j) {
        const int c = anc_ids[choice * L1 + j];
        resid[c * R + lane] = resid[c * R + lane] + (-t);
      }
    }
    __syncwarp();
  }
}

}  // namespace

// C entry point: launches on `stream` and returns cudaGetLastError() (or
// the error of raising the kernel's dynamic shared-memory limit).
extern "C" int grove_commit_scan(const float* top_val, const int* top_dom,
                                 const float* dom_free, const int* anc_ids,
                                 const float* td, float* out_val, int* out_dom,
                                 int G, int K, int D, int R, int L1,
                                 void* stream) {
  if (G == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(D + 1) * R * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      commit_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  commit_scan_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      top_val, top_dom, dom_free, anc_ids, td, out_val, out_dom, G, K, D, R,
      L1);
  return static_cast<int>(cudaGetLastError());
}
