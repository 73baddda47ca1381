// Value tensor of the placement solve, fp32 or bf16, for Hopper (sm_90a),
// straight from the per-signature fit counts.
//
// Replaces: grove_tpu/solver/pallas_core.py:_value_kernel (launched by
// pallas_value), the repo's one Pallas kernel, in both of its precisions,
// and with it the gather and min that feed it in the JAX engine
// (`cnt_fit = (node_fits @ m)[sig_idx].min(axis=1)`,
// grove_tpu/solver/engine.py:324). Per gang g and domain d:
//
//   cnt[g, d]   = min_s sig_cnt[sig_idx[g, s], d]
//   value[g, d] = 2.5 * (lev + 2) + [lev >= pref] - 0.5 * s / (1 + |s|) + fair
//   s           = max_r (dom_free[d, r] - td[tix[g], r]) / cap[r]
//
// where the mask (cnt >= 1, lev >= required, valid) holds, else -1e9.
// The value reads cnt only through `cnt >= 1`, and min_s x_s >= 1 holds
// exactly when every x_s >= 1 (a NaN fails both), so the kernel tests the
// signatures one by one and never forms the min: the result is bit-equal
// to the plain version on the gathered min (kernel_core.value_sig_plain).
// The score operations and their order are those of
// value_from_aggregates, so with IEEE division (div.rn, no reciprocal)
// and -fmad=false (see build.py) the fp32 result is bit-equal to the plain
// PyTorch version.
//
// bf16: the same chain with the score operands (lev, the constants,
// dom_free, td, cap, fair) rounded to bf16 first and every operation
// computed in fp32 and rounded to bf16, nearest-even -- what a PyTorch
// bf16 elementwise op does -- so it is bit-equal to
// kernel_core.value_plain_bf16. The mask stays fp32-exact and the output
// is f32. One template serves both: for fp32 the rounding is the identity.
//
// What bounds it on this card. Bytes: the [G, D] f32 output is written
// once (21.8 MB at the stress shape G = 1024, D = 5334, ~6.5 us at
// 3.35 TB/s); the inputs are small ([U, D] counts, [D, R] aggregates and
// per-gang vectors). Instructions: the score chain holds R + 1 IEEE
// divisions, and in SASS each is a MUFU.RCP, a Newton sequence and an
// FCHK whose slow path is a call behind a branch, so the divisions of a
// thread run one after another. A zero numerator takes that slow path,
// and a resource used up exactly (dom_free == td) makes one: most cells
// of a real backlog have one, so div_rn returns those zeros without the
// division. The chain -- slack = max_r (dom_free - td) / cap, squashed
// and halved -- depends on the domain and the gang's demand row only, and
// the gangs of a backlog share few demand rows (each replica of a
// PodCliqueSet, and each scaled replica of a scaling group, is a gang
// built from the same pod templates). So the caller passes the demand
// rows deduplicated: a table td [T, R] and each gang's row in it, tix [G]
// (the engine dedupes on the host, by bits), and the chain is work per
// (table row, domain), not per (gang, domain).
//
// What the design does about it:
// - One block of 128 threads covers a strip of 256 domains and a tile of
//   gang rows (<= 32). Each thread owns 2 consecutive domains and keeps
//   their operands in registers for the whole tile: the level, the two
//   possible bases (level score plus no/one preference bonus), the R
//   aggregates already rounded to the working precision, and a bit mask
//   of the signatures whose count there is >= 1.
// - Warp 0 stages the tile's rows in shared memory once, a row a lane:
//   td and fair rounded, the required and preferred levels, the row's
//   table index or -1 where the row is dead (not valid, or an index out
//   of range) and the OR of its signature bits, so a row's count test is
//   one AND and one compare per element, whatever S is. The first tile's
//   loads are issued before the prologue's, so the two latencies overlap.
// - Where the table holds at most kMaxTable rows, each thread computes
//   the chain of a table row for its domains the first time a live row of
//   its tiles uses it, into its own column of a shared-memory table (no
//   barrier: a thread reads only what it wrote), and every later row
//   reads it back. Each chain a block needs is computed once, whatever
//   the order of the gangs; bit-equal, since it is the same operations
//   on the same operands. A larger table: every live row computes its
//   own chain.
// - A thread whose domains are all masked in a row skips the score.
// - A thread stores its two values as one 8-byte store where the row's
//   address allows it (every row when D is even; an odd D's odd rows take
//   4-byte stores), and element by element at the last strip's ragged
//   edge. (Four domains a thread, with 16-byte stores where the row starts
//   16-byte aligned, measured slower in kernel_probe's variants: more
//   registers, fewer blocks.)
//   Stores carry no cache hint: the output stays in the 50 MB L2 for the
//   commit kernel that reads it next.
// - The launcher sizes the tile so that every (strip, tile) block is
//   resident at once (one wave over the SMs at the kernel's occupancy).
// - Fast path: R <= 4 (unrolled, in registers) and U <= 32 (the bit
//   masks). Otherwise a general path reads dom_free and td per element,
//   computes every chain, and tests each signature's count in device
//   memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kThreads = 128;
constexpr int kVec = 2;                       // consecutive domains a thread owns
constexpr int kStrip = kThreads * kVec;       // domains a block covers
constexpr int kWarp = 32;
constexpr int kMaxRows = kWarp;               // gang rows a block stages at once
constexpr int kMaxR = 4;                      // fast path: resources in registers
constexpr int kMaxBitsU = 32;                 // fast path: signatures as u32 bits
constexpr int kMaxGridY = 65535;
constexpr int kMaxDevices = 64;
constexpr int kMaxTable = 8;                  // demand rows whose h a block keeps

// The working precision's rounding of an fp32 result.
template <bool kBf16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// torch.maximum / jnp.maximum: NaN propagates
__device__ __forceinline__ float nan_max(float slack, float cur) {
  return (cur > slack || cur != cur) ? cur : slack;
}

// IEEE a / b (div.rn, no reciprocal). A zero numerator over a finite
// nonzero b gives a zero with the xor of the two signs, returned here
// without the division (the same bits): in SASS a division is MUFU.RCP, a
// Newton sequence and FCHK, whose slow path (a call) a zero numerator
// takes, and a resource used up exactly makes the slack's numerator 0.
__device__ __forceinline__ float div_rn(float a, float b) {
  if (a == 0.0f && isfinite(b) && b != 0.0f) {
    return __uint_as_float((__float_as_uint(a) ^ __float_as_uint(b)) & 0x80000000u);
  }
  return a / b;
}

// The working precision's rounding of kVec results.
template <bool kBf16>
__device__ __forceinline__ void rnd_all(float (&x)[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) x[j] = rnd<kBf16>(x[j]);
}

// s -> h = rnd(0.5 * rnd(s / rnd(1 + |s|))): the squashed slack's term of
// the value, for kVec elements.
template <bool kBf16>
__device__ __forceinline__ void half_squash(float (&s)[kVec]) {
  float den[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) den[j] = 1.0f + fabsf(s[j]);
  rnd_all<kBf16>(den);
#pragma unroll
  for (int j = 0; j < kVec; ++j) s[j] = div_rn(s[j], den[j]);
  rnd_all<kBf16>(s);
#pragma unroll
  for (int j = 0; j < kVec; ++j) s[j] = 0.5f * s[j];
  rnd_all<kBf16>(s);
}

// h of a thread's kVec domains against one gang's demand row (both
// rounded): slack = max_r rnd(rnd(df - td) / cap), then half_squash. It
// depends on the domain and the demand row only.
template <bool kBf16, int kR>
__device__ __forceinline__ void half_slack(const float (&df)[kVec][kR],
                                           const float (&td)[kMaxR],
                                           const float (&capr)[kR],
                                           float (&h)[kVec]) {
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float cur[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) cur[j] = df[j][r] - td[r];
    rnd_all<kBf16>(cur);
#pragma unroll
    for (int j = 0; j < kVec; ++j) cur[j] = div_rn(cur[j], capr[r]);
    rnd_all<kBf16>(cur);
#pragma unroll
    for (int j = 0; j < kVec; ++j) h[j] = r == 0 ? cur[j] : nan_max(h[j], cur[j]);
  }
  half_squash<kBf16>(h);
}

// A thread's kV values of one row at dst, `left` of them inside the
// row: the row's first element is 16-, 8- or 4-byte aligned by g * D, so
// the widest store the address allows, element by element at the edge.
template <int kV>
__device__ __forceinline__ void store(float* dst, const float (&v)[kV],
                                      int left) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dst);
  if constexpr (kV == 4) {
    if (left >= 4 && (addr & 15) == 0) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  }
  if constexpr (kV % 2 == 0) {
    if (left >= kV && (addr & 7) == 0) {
#pragma unroll
      for (int j = 0; j < kV; j += 2) {
        reinterpret_cast<float2*>(dst)[j / 2] = make_float2(v[j], v[j + 1]);
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    if (j < left) dst[j] = v[j];
  }
}

// One gang row's staged operands (two 16-byte shared loads).
struct alignas(16) Row {
  float td[kMaxR];   // rounded (fast path only)
  unsigned need;     // OR of the row's signature bits (fast path only)
  int req;
  int pref;
  float fair;        // rounded
};

template <bool kBf16, int kR, bool kBits>
__global__ void __launch_bounds__(kThreads)
value_kernel(const float* __restrict__ dom_free,        // [D, R]
             const float* __restrict__ sig_cnt,         // [U, D]
             const int* __restrict__ sig_idx,           // [G, S]
             const int* __restrict__ dom_level,         // [D]
             const float* __restrict__ td,              // [T, R]
             const int* __restrict__ tix,               // [G]
             const int* __restrict__ required,          // [G]
             const int* __restrict__ preferred,         // [G]
             const unsigned char* __restrict__ valid,   // [G]
             const float* __restrict__ cap,             // [R]
             const float* __restrict__ fairness,        // [G]
             float* __restrict__ out,                   // [G, D]
             int G, int D, int R, int U, int S, int T, int rows) {
  constexpr int kRegR = kR > 0 ? kR : 1;
  constexpr int kTableRows = kMaxTable > 0 ? kMaxTable : 1;
  __shared__ Row s_row[kMaxRows];
  // the row's demand-table index, or -1 where the row is dead
  __shared__ int s_t[kMaxRows];
  // the table rows the tile's live rows use, as bits
  __shared__ unsigned s_used;
  // h of table row t at a thread's domain j: s_h[t][j][thread]; each
  // thread writes and reads its own column only
  __shared__ float s_h[kTableRows][kVec][kThreads];
  const bool table = kR > 0 && T <= kMaxTable;

  // One gang row's operands as device memory holds them.
  struct RowIn {
    float td[kMaxR];
    float fair;
    int req, pref, idx0, t;
    bool valid;
  };
  auto load_row = [&](int g) {
    RowIn in;
    in.t = tix[g];
    const bool in_table = in.t >= 0 && in.t < T;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      in.td[r] = r < kR && in_table ? td[static_cast<size_t>(in.t) * R + r] : 0.0f;
    }
    in.fair = fairness[g];
    in.req = required[g];
    in.pref = preferred[g];
    in.idx0 = sig_idx[static_cast<size_t>(g) * S];
    in.valid = valid[g] != 0 && in_table;
    return in;
  };
  // warp 0 loads its first tile's rows before the prologue, so that the
  // two sets of loads are in flight together
  RowIn first_rows{};
  if (static_cast<int>(threadIdx.x) < min(rows, G - static_cast<int>(blockIdx.y) * rows)) {
    first_rows = load_row(blockIdx.y * rows + threadIdx.x);
  }

  // this thread's domains and their operands, held for every row
  const int d0 = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  int lev[kVec];
  float base0[kVec], base1[kVec];
  unsigned fit[kVec];
  float df[kVec][kRegR];
  float capr[kRegR];
#pragma unroll
  for (int r = 0; r < kRegR; ++r) capr[r] = kR > 0 ? rnd<kBf16>(cap[r]) : 0.0f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int d = d0 + j;
    const bool in = d < D;
    lev[j] = in ? dom_level[d] : INT_MIN;
    const float dlev = rnd<kBf16>(static_cast<float>(lev[j]));
    const float level_score = rnd<kBf16>(2.5f * rnd<kBf16>(dlev + 2.0f));
    base0[j] = rnd<kBf16>(level_score + rnd<kBf16>(1.0f * 0.0f));
    base1[j] = rnd<kBf16>(level_score + rnd<kBf16>(1.0f * 1.0f));
#pragma unroll
    for (int r = 0; r < kRegR; ++r) {
      df[j][r] = (kR > 0 && in) ? rnd<kBf16>(dom_free[static_cast<size_t>(d) * R + r])
                                : 0.0f;
    }
    fit[j] = 0u;
  }
  if (kBits) {
#pragma unroll 4
    for (int u = 0; u < U; ++u) {
      const float* cnt = sig_cnt + static_cast<size_t>(u) * D;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (d0 + j < D) fit[j] |= static_cast<unsigned>(cnt[d0 + j] >= 1.0f) << u;
      }
    }
  }

  unsigned done = 0u;  // the table rows whose h this thread holds
  const int tiles = (G + rows - 1) / rows;
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int g0 = tile * rows;
    const int n = min(rows, G - g0);
    __syncthreads();  // the previous tile's rows are read
    if (threadIdx.x < kWarp) {  // warp 0 stages the tile's rows, one a lane
      const int i = threadIdx.x;
      int t = -1;
      if (i < n) {
        const int g = g0 + i;
        const RowIn in = tile == static_cast<int>(blockIdx.y) ? first_rows : load_row(g);
        bool live = in.valid;
        unsigned need = 0u;
        for (int s = 0; s < S; ++s) {
          const int idx = s == 0 ? in.idx0 : sig_idx[static_cast<size_t>(g) * S + s];
          if (idx < 0 || idx >= U) {
            live = false;
          } else if (kBits) {
            need |= 1u << idx;
          }
        }
        Row& row = s_row[i];
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) row.td[r] = rnd<kBf16>(in.td[r]);
        row.need = need;
        row.req = in.req;
        row.pref = in.pref;
        row.fair = rnd<kBf16>(in.fair);
        t = live ? in.t : -1;
        s_t[i] = t;
      }
      const unsigned used = __reduce_or_sync(0xffffffffu, table && t >= 0 ? 1u << t : 0u);
      if (i == 0) s_used = used;
    }
    __syncthreads();
    if (d0 >= D) continue;
    const int left = D - d0;
    if constexpr (kR > 0) {
      // h of the table rows this tile uses first, once for the block
      unsigned todo = s_used & ~done;
      done |= todo;
      while (todo) {
        const int t = __ffs(todo) - 1;
        todo &= todo - 1u;
        float trow[kMaxR];
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          trow[r] = r < kR ? rnd<kBf16>(td[static_cast<size_t>(t) * R + r]) : 0.0f;
        }
        float h[kVec];
        half_slack<kBf16, kRegR>(df, trow, capr, h);
#pragma unroll
        for (int j = 0; j < kVec; ++j) s_h[t][j][threadIdx.x] = h[j];
      }
    }
    float* dst = out + static_cast<size_t>(g0) * D + d0;
    for (int i = 0; i < n; ++i, dst += D) {
      const int g = g0 + i;
      const int t = s_t[i];
      float v[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = kNeg;
      if (t >= 0) {
        const Row row = s_row[i];
        bool ok[kVec];
        bool any = false;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          ok[j] = lev[j] >= row.req && j < left;
          if (kBits) ok[j] = ok[j] && (fit[j] & row.need) == row.need;
        }
        if (!kBits) {
          for (int s = 0; s < S; ++s) {
            const size_t at =
                static_cast<size_t>(sig_idx[static_cast<size_t>(g) * S + s]) * D + d0;
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              ok[j] = ok[j] && sig_cnt[at + j] >= 1.0f;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kVec; ++j) any = any || ok[j];
        if (any) {
          float h[kVec];
          if constexpr (kR > 0) {
            if (table) {
#pragma unroll
              for (int j = 0; j < kVec; ++j) h[j] = s_h[t][j][threadIdx.x];
            } else {
              half_slack<kBf16, kRegR>(df, row.td, capr, h);
            }
          } else {
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              h[j] = 0.0f;
              if (!ok[j]) continue;
              const size_t d = static_cast<size_t>(d0 + j);
              for (int r = 0; r < R; ++r) {
                const float diff =
                    rnd<kBf16>(rnd<kBf16>(dom_free[d * R + r]) -
                               rnd<kBf16>(td[static_cast<size_t>(t) * R + r]));
                const float cur = rnd<kBf16>(div_rn(diff, rnd<kBf16>(cap[r])));
                h[j] = r == 0 ? cur : nan_max(h[j], cur);
              }
            }
            half_squash<kBf16>(h);
          }
          // the preference base, the slack and the fairness terms
          float value[kVec];
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            value[j] = (lev[j] >= row.pref ? base1[j] : base0[j]) - h[j];
          }
          rnd_all<kBf16>(value);
#pragma unroll
          for (int j = 0; j < kVec; ++j) value[j] = value[j] + row.fair;
          rnd_all<kBf16>(value);
#pragma unroll
          for (int j = 0; j < kVec; ++j) v[j] = ok[j] ? value[j] : kNeg;
        }
      }
      store(dst, v, left);
    }
  }
}

// SM count and the kernel's resident blocks per SM, cached per device.
std::atomic<int> g_sms[kMaxDevices];

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, std::atomic<int>* per_sm_cache,
                            int* slots) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int sms = g_sms[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    g_sms[dev].store(sms, std::memory_order_relaxed);
  }
  int per_sm = per_sm_cache[dev].load(std::memory_order_relaxed);
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
    per_sm_cache[dev].store(per_sm, std::memory_order_relaxed);
  }
  *slots = sms * per_sm;
  return cudaSuccess;
}

template <bool kBf16, int kR, bool kBits>
int launch(const float* dom_free, const float* sig_cnt, const int* sig_idx,
           const int* dom_level, const float* td, const int* tix,
           const int* required, const int* preferred,
           const unsigned char* valid, const float* cap, const float* fairness,
           float* out, int G, int D, int R, int U, int S, int T,
           cudaStream_t stream) {
  static std::atomic<int> per_sm[kMaxDevices];
  auto kernel = value_kernel<kBf16, kR, kBits>;
  const int strips = (D + kStrip - 1) / kStrip;
  // the fewest rows a block that still puts every block in one wave
  int slots = 0;
  const cudaError_t err = resident_blocks(kernel, per_sm, &slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pairs = static_cast<long long>(G) * strips;
  int rows = static_cast<int>((pairs + slots - 1) / slots);
  rows = rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
  const int tiles = (G + rows - 1) / rows;
  const dim3 grid(strips, tiles < kMaxGridY ? tiles : kMaxGridY);
  kernel<<<grid, kThreads, 0, stream>>>(dom_free, sig_cnt, sig_idx, dom_level,
                                        td, tix, required, preferred, valid,
                                        cap, fairness, out, G, D, R, U, S, T,
                                        rows);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int dispatch(const float* dom_free, const float* sig_cnt, const int* sig_idx,
             const int* dom_level, const float* td, const int* tix,
             const int* required, const int* preferred,
             const unsigned char* valid, const float* cap,
             const float* fairness, float* out, int G, int D, int R, int U,
             int S, int T, void* stream) {
  if (G <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (R < 1 || U < 1 || S < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#define GROVE_VALUE_LAUNCH(KR, KBITS)                                          \
  launch<kBf16, KR, KBITS>(dom_free, sig_cnt, sig_idx, dom_level, td, tix,     \
                           required, preferred, valid, cap, fairness, out, G,  \
                           D, R, U, S, T, st)
#define GROVE_VALUE_CASE(KR)                                                   \
  return U <= kMaxBitsU ? GROVE_VALUE_LAUNCH(KR, true)                         \
                        : GROVE_VALUE_LAUNCH(KR, false)
  switch (R) {
    case 1: GROVE_VALUE_CASE(1);
    case 2: GROVE_VALUE_CASE(2);
    case 3: GROVE_VALUE_CASE(3);
    case 4: GROVE_VALUE_CASE(4);
    default: GROVE_VALUE_CASE(0);
  }
#undef GROVE_VALUE_CASE
#undef GROVE_VALUE_LAUNCH
}

}  // namespace

// C entry points: launch on `stream` and return cudaGetLastError().
// td [T, R] holds the demand rows, tix [G] each gang's row in it. Every
// sig_idx entry must lie in [0, U) and every tix entry in [0, T): a row
// with one outside is written -1e9 (the engine builds tix itself and
// refuses a sig_idx out of range before upload).
extern "C" int grove_value_sig(const float* dom_free, const float* sig_cnt,
                               const int* sig_idx, const int* dom_level,
                               const float* td, const int* tix,
                               const int* required, const int* preferred,
                               const unsigned char* valid, const float* cap,
                               const float* fairness, float* out, int G,
                               int D, int R, int U, int S, int T,
                               void* stream) {
  return dispatch<false>(dom_free, sig_cnt, sig_idx, dom_level, td, tix,
                         required, preferred, valid, cap, fairness, out, G, D,
                         R, U, S, T, stream);
}

extern "C" int grove_value_sig_bf16(const float* dom_free, const float* sig_cnt,
                                    const int* sig_idx, const int* dom_level,
                                    const float* td, const int* tix,
                                    const int* required, const int* preferred,
                                    const unsigned char* valid,
                                    const float* cap, const float* fairness,
                                    float* out, int G, int D, int R, int U,
                                    int S, int T, void* stream) {
  return dispatch<true>(dom_free, sig_cnt, sig_idx, dom_level, td, tix,
                        required, preferred, valid, cap, fairness, out, G, D,
                        R, U, S, T, stream);
}
