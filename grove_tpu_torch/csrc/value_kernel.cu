// Value tensor of the placement solve, fp32 or bf16, for Hopper (sm_90a).
//
// Replaces: grove_tpu/solver/pallas_core.py:_value_kernel (launched by
// pallas_value), the repo's one Pallas kernel, in both of its precisions.
// Per gang g and domain d:
//
//   value[g, d] = 2.5 * (lev + 2) + [lev >= pref] - 0.5 * s / (1 + |s|) + fair
//   s           = max_r (dom_free[d, r] - td[g, r]) / cap[r]
//
// where the mask (cnt_fit >= 1, lev >= required, valid) holds, else -1e9.
// The operations and their order are those of value_from_aggregates, so
// with IEEE division and -fmad=false (see build.py) the fp32 result is
// bit-equal to the plain PyTorch version (kernel_core.value_plain).
//
// bf16 (grove_value_bf16): the same chain with the score operands (lev,
// the constants, dom_free, td, cap, fair) rounded to bf16 first and every
// operation computed in fp32 and rounded to bf16, nearest-even -- what a
// PyTorch bf16 elementwise op does -- so it is bit-equal to
// kernel_core.value_plain_bf16. The mask stays fp32-exact and the output
// is f32. One template serves both: for fp32 the rounding is the identity.
//
// What bounds it on this card: bytes, in either precision. Each element
// reads one cnt_fit float and writes one value float; the per-domain and
// per-gang vectors are small and reused. At the stress shape (G = 1024,
// D = 5334) that is 21.8 MB read + 21.8 MB written, about 13 us at
// 3.35 TB/s, against ~20 fp32 operations per element (~1.6 us at
// 67 TFLOP/s; bf16 adds ~15 conversions per element, still far below).
//
// What the design does about it: one thread per (g, d) element, with d the
// fast axis, so a warp reads and writes 128 contiguous bytes of cnt_fit
// and value. The per-column dom_free/dom_level and per-row
// td/required/preferred/valid/fairness come from global memory, where
// L1/L2 serve the reuse. The ragged edge is masked by a bounds check; no
// padding to tiles as the TPU wrapper does. Vectorised 16-byte loads and
// fusing the cnt_fit product in are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

// The working precision's rounding of an fp32 result.
template <bool kBf16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

template <bool kBf16>
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
  const float dlev = rnd<kBf16>(static_cast<float>(lev));
  const float level_score = rnd<kBf16>(2.5f * rnd<kBf16>(dlev + 2.0f));
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
      const float diff = rnd<kBf16>(rnd<kBf16>(dom_free[d * R + r]) -
                                    rnd<kBf16>(td[g * R + r]));
      const float cur = rnd<kBf16>(diff / rnd<kBf16>(cap[r]));
      // torch.maximum / jnp.maximum: NaN propagates
      slack = (r == 0 || cur > slack || cur != cur) ? cur : slack;
    }
    slack = rnd<kBf16>(slack / rnd<kBf16>(1.0f + fabsf(slack)));
    float value = rnd<kBf16>(level_score + rnd<kBf16>(1.0f * pref_bonus));
    value = rnd<kBf16>(value - rnd<kBf16>(0.5f * slack));
    value = rnd<kBf16>(value + rnd<kBf16>(fairness[g]));
    out[e] = value;
  }
}

template <bool kBf16>
int launch(const float* dom_free, const float* cnt_fit, const int* dom_level,
           const float* td, const int* required, const int* preferred,
           const unsigned char* valid, const float* cap,
           const float* fairness, float* out, int G, int D, int R,
           void* stream) {
  if (G == 0 || D == 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kThreads);
  const dim3 grid((D + kThreads - 1) / kThreads, G < kMaxGridY ? G : kMaxGridY);
  value_kernel<kBf16><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      dom_free, cnt_fit, dom_level, td, required, preferred, valid, cap,
      fairness, out, G, D, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points: launch on `stream` and return cudaGetLastError().
extern "C" int grove_value(const float* dom_free, const float* cnt_fit,
                           const int* dom_level, const float* td,
                           const int* required, const int* preferred,
                           const unsigned char* valid, const float* cap,
                           const float* fairness, float* out,
                           int G, int D, int R, void* stream) {
  return launch<false>(dom_free, cnt_fit, dom_level, td, required, preferred,
                       valid, cap, fairness, out, G, D, R, stream);
}

extern "C" int grove_value_bf16(const float* dom_free, const float* cnt_fit,
                                const int* dom_level, const float* td,
                                const int* required, const int* preferred,
                                const unsigned char* valid, const float* cap,
                                const float* fairness, float* out,
                                int G, int D, int R, void* stream) {
  return launch<true>(dom_free, cnt_fit, dom_level, td, required, preferred,
                      valid, cap, fairness, out, G, D, R, stream);
}
