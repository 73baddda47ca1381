// Value tensor of the placement solve, fp32, for Hopper (sm_90a).
//
// Replaces: grove_tpu/solver/pallas_core.py:_value_kernel (launched by
// pallas_value), the repo's one Pallas kernel. Per gang g and domain d:
//
//   value[g, d] = 2.5 * (lev + 2) + [lev >= pref] - 0.5 * s / (1 + |s|) + fair
//   s           = max_r (dom_free[d, r] - td[g, r]) / cap[r]
//
// where the mask (cnt_fit >= 1, lev >= required, valid) holds, else -1e9.
// The operations and their order are those of value_from_aggregates, so
// with IEEE division and -fmad=false (see build.py) the result is
// bit-equal to the plain PyTorch version (kernel_core.value_plain).
//
// What bounds it on this card: bytes. Each element reads one cnt_fit float
// and writes one value float; the per-domain and per-gang vectors are
// small and reused. At the stress shape (G = 1024, D = 5334) that is
// 21.8 MB read + 21.8 MB written, about 13 us at 3.35 TB/s, against ~20
// fp32 operations per element (~1.6 us at 67 TFLOP/s).
//
// What the design does about it: one thread per (g, d) element, with d the
// fast axis, so a warp reads and writes 128 contiguous bytes of cnt_fit
// and value. The per-column dom_free/dom_level and per-row
// td/required/preferred/valid/fairness come from global memory, where
// L1/L2 serve the reuse. The ragged edge is masked by a bounds check; no
// padding to tiles as the TPU wrapper does. Vectorised 16-byte loads and
// fusing the cnt_fit product in are left for later.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void value_kernel(const float* __restrict__ dom_free,    // [D, R]
                             const float* __restrict__ cnt_fit,     // [G, D]
                             const int* __restrict__ dom_level,     // [D]
                             const float* __restrict__ td,          // [G, R]
                             const int* __restrict__ required,      // [G]
                             const int* __restrict__ preferred,     // [G]
                             const unsigned char* __restrict__ valid,  // [G]
                             const float* __restrict__ cap,         // [R]
                             const float* __restrict__ fairness,    // [G]
                             float* __restrict__ out,               // [G, D]
                             int G, int D, int R) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const int lev = dom_level[d];
  const float level_score = 2.5f * (static_cast<float>(lev) + 2.0f);
  for (int g = blockIdx.y; g < G; g += gridDim.y) {
    const size_t e = static_cast<size_t>(g) * D + d;
    const bool mask = cnt_fit[e] >= 1.0f && lev >= required[g] && valid[g];
    if (!mask) {
      out[e] = kNeg;
      continue;
    }
    const float pref_bonus = lev >= preferred[g] ? 1.0f : 0.0f;
    float slack = 0.0f;
    for (int r = 0; r < R; ++r) {
      const float cur = (dom_free[d * R + r] - td[g * R + r]) / cap[r];
      // torch.maximum / jnp.maximum: NaN propagates
      slack = (r == 0 || cur > slack || cur != cur) ? cur : slack;
    }
    slack = slack / (1.0f + fabsf(slack));
    float value = level_score + 1.0f * pref_bonus - 0.5f * slack;
    value = value + fairness[g];
    out[e] = value;
  }
}

}  // namespace

// C entry point: launches on `stream` and returns cudaGetLastError().
extern "C" int grove_value(const float* dom_free, const float* cnt_fit,
                           const int* dom_level, const float* td,
                           const int* required, const int* preferred,
                           const unsigned char* valid, const float* cap,
                           const float* fairness, float* out,
                           int G, int D, int R, void* stream) {
  if (G == 0 || D == 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kThreads);
  const dim3 grid((D + kThreads - 1) / kThreads, G < kMaxGridY ? G : kMaxGridY);
  value_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      dom_free, cnt_fit, dom_level, td, required, preferred, valid, cap,
      fairness, out, G, D, R);
  return static_cast<int>(cudaGetLastError());
}
