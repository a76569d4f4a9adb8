// Fused MaskGIT token sampler for Hopper (sm_90a).
//
// Port of the Pallas kernel `_kernel` in vampnet_tpu/ops/sampler_kernel.py:80.
// For every (row, position) it reads the V = 1024 logits once and, without
// writing anything back but the result:
//   1. the locally-typical filter: bisection of the typicality threshold,
//      24 steps, until the kept mass reaches typical_mass and the kept count
//      reaches typical_min_tokens (optional);
//   2. the nucleus (top-p) filter, bisection form, 24 steps (optional);
//   3. a temperature softmax;
//   4. where the row's flag is > 0.5, Gumbel noise from Philox4x32-10 keyed
//      by the row's two key words, with counter (step, position, vocab/4, 0);
//      the argmax (first maximum wins) of scaled logits + noise; else the
//      argmax of the filtered logits (greedy);
//   5. the chosen token's probability under the temperature softmax.
//
// Design: one warp per position, 32 logits per lane in registers, every
// reduction a butterfly of warp shuffles (each lane ends with the same,
// bit-identical value, so all lanes take the same bisection branch).
// See ops/sampler_kernel.py for the determinism contract and the bound.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int V = 1024;
constexpr int PER_LANE = V / 32;
constexpr int WARPS = 8;
constexpr int BISECT_ITERS = 24;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Philox4x32-10 (Salmon et al., SC'11).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float gumbel_from_bits(uint32_t bits) {
  // 23 high bits + 1/2, times 2^-23: exact in fp32 and strictly inside (0, 1)
  const float u = ((float)(bits >> 9) + 0.5f) * 1.1920928955078125e-07f;
  return -logf(-logf(u));
}

// vocab index of register slot j of this lane: lane-strided float4 groups
__device__ __forceinline__ int vocab_index(int j, int lane) {
  return ((j >> 2) * 32 + lane) * 4 + (j & 3);
}

__global__ void __launch_bounds__(WARPS * 32) sampler_kernel(
    const float* __restrict__ logits, const long long* __restrict__ keys,
    const float* __restrict__ temperature, const float* __restrict__ top_p,
    const float* __restrict__ flag, long long* __restrict__ tokens,
    float* __restrict__ probs, int b, int flat, int step, int typical,
    float typical_mass, int typical_min_tokens, int use_top_p) {
  const int lane = threadIdx.x & 31;
  const long long gpos = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (gpos >= (long long)b * flat) return;  // the whole warp leaves together
  const int row = (int)(gpos / flat);
  const int pos = (int)(gpos % flat);

  float x[PER_LANE];
  const float4* src = reinterpret_cast<const float4*>(logits + gpos * V);
#pragma unroll
  for (int i = 0; i < PER_LANE / 4; ++i) {
    const float4 f = src[i * 32 + lane];
    x[4 * i] = f.x;
    x[4 * i + 1] = f.y;
    x[4 * i + 2] = f.z;
    x[4 * i + 3] = f.w;
  }

  float p[PER_LANE];
  if (typical) {
    // log-softmax, entropy, typicality distance c = |-log p - H|
    float m = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) m = fmaxf(m, x[j]);
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) s += expf(x[j] - m);
    const float lse = logf(warp_sum(s));
    float c[PER_LANE];
    float plogp = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const float lp = (x[j] - m) - lse;
      p[j] = expf(lp);
      plogp += p[j] > 0.f ? lp * p[j] : 0.f;
      c[j] = lp;
    }
    const float entropy = -warp_sum(plogp);
    float cmax = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      float cj = fabsf(-c[j] - entropy);
      cj = isfinite(cj) ? cj : CUDART_INF_F;
      c[j] = cj;
      cmax = fmaxf(cmax, isfinite(cj) ? cj : 0.f);
    }
    float lo = 0.f, hi = warp_max(cmax);
    for (int it = 0; it < BISECT_ITERS; ++it) {
      const float mid = 0.5f * (lo + hi);
      float mass = 0.f, count = 0.f;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        if (c[j] <= mid) {
          mass += p[j];
          count += 1.f;
        }
      }
      const float mass_all = warp_sum(mass);
      const float count_all = warp_sum(count);
      const bool ok = mass_all >= typical_mass && count_all >= (float)typical_min_tokens;
      lo = ok ? lo : mid;
      hi = ok ? mid : hi;
    }
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) x[j] = c[j] > hi ? -CUDART_INF_F : x[j];
  }

  if (use_top_p) {
    // keep {p > tau}, tau bisected to the largest value whose tail mass
    // above it stays <= top_p
    float m = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) m = fmaxf(m, x[j]);
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      p[j] = expf(x[j] - m);
      s += p[j];
    }
    s = warp_sum(s);
    float pmax = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      p[j] = p[j] / s;
      pmax = fmaxf(pmax, p[j]);
    }
    const float tp = top_p[row];
    float lo = 0.f, hi = warp_max(pmax);
    for (int it = 0; it < BISECT_ITERS; ++it) {
      const float mid = 0.5f * (lo + hi);
      float mass = 0.f;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) mass += p[j] > mid ? p[j] : 0.f;
      const bool ok = warp_sum(mass) <= tp;
      lo = ok ? lo : mid;
      hi = ok ? mid : hi;
    }
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) x[j] = p[j] > lo ? x[j] : -CUDART_INF_F;
  }

  // temperature softmax (for the chosen token's probability)
  const float t = fmaxf(temperature[row], 1e-10f);
  float m = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) m = fmaxf(m, x[j] / t);
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) s += expf(x[j] / t - m);
  s = warp_sum(s);

  // argmax, first maximum wins: slots are visited in ascending vocab order
  float best = -CUDART_INF_F;
  int best_idx = V;
  if (flag[row] > 0.5f) {
    const uint32_t k0 = (uint32_t)keys[2 * row];
    const uint32_t k1 = (uint32_t)keys[2 * row + 1];
#pragma unroll
    for (int i = 0; i < PER_LANE / 4; ++i) {
      const uint4 r = philox4x32_10(
          make_uint4((uint32_t)step, (uint32_t)pos, (uint32_t)(i * 32 + lane), 0u), k0, k1);
      const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float val = x[4 * i + e] / t + gumbel_from_bits(bits[e]);
        if (val > best) {
          best = val;
          best_idx = vocab_index(4 * i + e, lane);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      if (x[j] > best) {
        best = x[j];
        best_idx = vocab_index(j, lane);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_idx, o);
    if (ob > best || (ob == best && oi < best_idx)) {
      best = ob;
      best_idx = oi;
    }
  }

  float mine = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    if (vocab_index(j, lane) == best_idx) mine = expf(x[j] / t - m) / s;
  }
  const float prob = warp_sum(mine);
  if (lane == 0) {
    tokens[gpos] = best_idx;
    probs[gpos] = prob;
  }
}

}  // namespace

extern "C" int vampnet_sampler(const void* logits, const void* keys, const void* temperature,
                               const void* top_p, const void* flag, void* tokens, void* probs,
                               int b, int flat, int vocab, int step, int typical,
                               float typical_mass, int typical_min_tokens, int use_top_p,
                               int device, void* stream) {
  if (vocab != V || b <= 0 || flat <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)b * flat;
  const unsigned blocks = (unsigned)((n + WARPS - 1) / WARPS);
  sampler_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const long long*>(keys),
      static_cast<const float*>(temperature), static_cast<const float*>(top_p),
      static_cast<const float*>(flag), static_cast<long long*>(tokens),
      static_cast<float*>(probs), b, flat, step, typical, typical_mass,
      typical_min_tokens, use_top_p);
  return (int)cudaGetLastError();
}
