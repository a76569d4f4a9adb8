// Fused MaskGIT token sampler for Hopper (sm_90a).
//
// Port of the Pallas kernel `_kernel` in vampnet_tpu/ops/sampler_kernel.py:80.
// For every (row, position) it reads the V logits once (V = 1024, VampNet's
// codebooks, or 2048, MAGNeT's; one instance each, chosen at launch) and,
// without
// writing anything back but the result:
//   1. the locally-typical filter: bisection of the typicality threshold,
//      24 steps, until the kept mass reaches typical_mass and the kept count
//      reaches typical_min_tokens (optional);
//   2. top-k (optional): the k-th largest surviving logit, ties counted,
//      and every logit below it dropped (ties at the threshold stay);
//   3. the nucleus (top-p) filter, bisection form, 24 steps (optional);
//   4. a temperature softmax;
//   5. where the row's flag is > 0.5, Gumbel noise from Philox4x32-10 keyed
//      by the row's two key words, with counter (step, position, vocab/4, 0);
//      the argmax (first maximum wins) of scaled logits + noise; else the
//      argmax of the filtered logits (greedy);
//   6. the chosen token's probability under the temperature softmax.
//
// Design: one warp per position, its V logits in registers (V / 32 a lane,
// loaded as float4), every reduction a butterfly of warp shuffles (each lane
// ends with the same, bit-identical value, so all lanes take the same
// bisection branch). Each warp owns 8 V bytes of shared memory for the
// typicality distances c and probabilities p, and later for its lists. At
// V = 1024 the kernel fits in 80 registers and six blocks of four warps
// share an SM (24 warps, three times the first design's), each a long
// dependent chain of latency the others hide. At V = 2048 a lane holds 64
// logits (and, under top-p, 64 probabilities): blocks of two warps, six to
// an SM (12 warps, up to 168 registers a thread, 16 KB of shared memory a
// warp); the Philox counter's third word runs to V / 4 = 512. The V = 1024
// instance is the same code at the same constants, so its bits are unchanged.
//  * The bisection's first FULL_STEPS steps run over all 1024 entries. Then
//    an entry with c <= lo is inside for every later midpoint, and one with
//    c > hi outside: their count (exact, an integer) and mass are carried,
//    and the undecided band (lo < c <= hi; a few dozen entries on the
//    serving logits) is compacted in place into a list (ballots and
//    popcounts). The last steps run over the band alone: the same midpoints
//    and comparisons as the full bisection, so the kept set {c <= hi_24} is
//    the same; only the order in which the mass is summed changes.
//  * A dropped token is -inf: it adds exp(-inf) = 0 to every sum and can win
//    no argmax. So the kept tokens are compacted, with their vocab indices,
//    into a list in ascending vocab order, and top-p, the temperature
//    softmax, the noise and the argmax run over it alone. Philox is counter
//    based: a kept token draws the bits it draws in the plain version, and a
//    lane reuses one draw for the neighbours of a group of four. Without the
//    typical filter the list is all 1024 entries.
//  * Top-k selects the k-th largest kept logit exactly, by a radix select
//    over the kept list: 32 passes, most significant bit first, over the
//    order-preserving uint32 image of each logit (-0.0 taken as +0.0), each
//    pass a count by ballot and popcount of the entries that match the
//    prefix so far with the next bit set. Entries below it become -inf in
//    the list, which drops them from everything that follows, as the plain
//    version's -inf does. With k at or above the list's length nothing is
//    dropped (the plain version's k-th value is then the smallest kept one,
//    or -inf).
// See ops/sampler_kernel.py for the determinism contract and the bound.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BISECT_ITERS = 24;
constexpr int FULL_STEPS = 6;  // typical-filter steps over all entries before the band list

// The constants of one vocabulary size.
template <int V_>
struct Vocab {
  static constexpr int V = V_;
  static constexpr int PER_LANE = V / 32;
  static constexpr int GROUPS = PER_LANE / 4;  // float4 groups a lane: vocab [128 i, 128 i + 128)
  static constexpr int WARPS = V <= 1024 ? 4 : 2;  // positions per block: 32 KB of lists a block
  static constexpr int BLOCKS_PER_SM = 6;  // 80 registers a thread at V = 1024, 168 at 2048
  // bit j: slot j of a lane (its PER_LANE entries)
  using Bits = typename std::conditional<(PER_LANE <= 32), uint32_t, unsigned long long>::type;
  static_assert(V % 128 == 0 && PER_LANE <= 64, "V must be a multiple of 128, at most 2048");
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
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

// The typicality distance of a logit: |-log p - H|, +inf where not finite.
// Computed the same way at each use, so its value is the same bit for bit.
__device__ __forceinline__ float typicality(float x, float m, float lse, float entropy) {
  const float c = fabsf(-((x - m) - lse) - entropy);
  return isfinite(c) ? c : CUDART_INF_F;
}

// The position in a list, in ascending vocab order, of each of this lane's
// flagged entries of one float4 group (vocab order within the group is lane
// major: lane 0's four entries, then lane 1's, ...): `base` plus the flagged
// entries before it. Returns the group's flagged count.
__device__ __forceinline__ int group_slots(const bool (&flag)[4], int base, int (&slot)[4]) {
  const uint32_t lt = (1u << (threadIdx.x & 31)) - 1u;
  uint32_t bal[4];
  int before = 0, total = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    bal[e] = __ballot_sync(0xffffffffu, flag[e]);
    before += __popc(bal[e] & lt);
    total += __popc(bal[e]);
  }
  int q = base + before;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    slot[e] = q;
    q += flag[e] ? 1 : 0;
  }
  return total;
}

// A float's order-preserving uint32 image: a < b as floats (no NaN) iff
// image(a) < image(b) as unsigned integers; -0.0 maps where +0.0 does.
__device__ __forceinline__ uint32_t ordered_bits(float x) {
  const uint32_t u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Top-k over the kept list (logits in A, nk entries): the k-th largest
// value, ties counted, by a radix select over ordered_bits; entries below it
// become -inf. Every lane ends with the same counts (ballots), so all take
// the same branch.
__device__ __forceinline__ void top_k_filter(float* A, int nk, int k, int lane) {
  uint32_t prefix = 0u, fixed = 0u;  // the bits decided so far, and which they are
  int need = k;                      // the rank still sought among the entries matching prefix
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t probe = 1u << bit;
    int count = 0;
    for (int q0 = 0; q0 < nk; q0 += 32) {
      const int q = q0 + lane;
      const bool hit = q < nk && (ordered_bits(A[q]) & (fixed | probe)) == (prefix | probe);
      count += __popc(__ballot_sync(0xffffffffu, hit));
    }
    if (count >= need) {
      prefix |= probe;
    } else {
      need -= count;
    }
    fixed |= probe;
  }
  const float kth = from_ordered_bits(prefix);
  for (int q = lane; q < nk; q += 32) {
    if (A[q] < kth) A[q] = -CUDART_INF_F;
  }
  __syncwarp();
}

// Top-p, the temperature softmax, the draw and the result over the kept
// tokens' list: logits in A, vocab indices (as float bits) in B, nk
// entries in ascending vocab order. A lane's entries, in ascending order:
// for a short list (the filtered serving logits) a run of `chunk` from
// lane * chunk; for a long one (DENSE) runs of four from 4 (lane + 32 k),
// where runs of `chunk` would put the lanes' reads on one bank, and a run
// of four is one Philox group.
template <typename VC, bool DENSE>
__device__ __forceinline__ void sample_tail(float* A, const float* B, int nk, int lane, int row,
                                            int pos, long long gpos, int step,
                                            const long long* __restrict__ keys,
                                            const float* __restrict__ temperature,
                                            const float* __restrict__ top_p,
                                            const float* __restrict__ flag,
                                            long long* __restrict__ tokens,
                                            float* __restrict__ probs, int use_top_p) {
  constexpr int V = VC::V;
  constexpr int PER_LANE = VC::PER_LANE;
  const int chunk = DENSE ? PER_LANE : (nk + 31) >> 5;
  auto slot = [&](int i) {
    return DENSE ? 4 * (lane + 32 * (i >> 2)) + (i & 3) : lane * chunk + i;
  };

  if (use_top_p) {
    // keep {p > tau}, tau bisected to the largest value whose tail mass
    // above it stays <= top_p; p of this lane's entries in registers
    float m = -CUDART_INF_F;
    for (int i = 0; i < chunk; ++i) {
      const int q = slot(i);
      if (q >= nk) break;
      m = fmaxf(m, A[q]);
    }
    m = warp_max(m);
    float p[PER_LANE];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      p[i] = i < chunk && slot(i) < nk ? expf(A[slot(i)] - m) : 0.f;
      s += p[i];
    }
    s = warp_sum(s);
    float pmax = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      p[i] = p[i] / s;
      pmax = fmaxf(pmax, p[i]);
    }
    const float tp = top_p[row];
    float lo = 0.f, hi = warp_max(pmax);
    for (int it = 0; it < BISECT_ITERS; ++it) {
      const float mid = 0.5f * (lo + hi);
      float mass = 0.f;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) mass += p[i] > mid ? p[i] : 0.f;
      const bool ok = warp_sum(mass) <= tp;
      lo = ok ? lo : mid;
      hi = ok ? mid : hi;
    }
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      if (i < chunk && slot(i) < nk && !(p[i] > lo)) A[slot(i)] = -CUDART_INF_F;
    }
  }

  // one pass: the greedy argmax of the logits, the max of the scaled logits
  // x / t (kept in A), then the temperature softmax's sum and the noisy
  // argmax over them. A lane visits its entries in ascending vocab order,
  // and lanes break ties towards the lower index: the first maximum wins.
  const float t = fmaxf(temperature[row], 1e-10f);
  const bool noisy = flag[row] > 0.5f;
  float m = -CUDART_INF_F;
  float best = -CUDART_INF_F, best_xs = -CUDART_INF_F;  // the winner's x / t
  int best_idx = V;
  for (int i = 0; i < chunk; ++i) {
    const int q = slot(i);
    if (q >= nk) break;
    const float xv = A[q];
    const float xs = xv / t;
    A[q] = xs;
    m = fmaxf(m, xs);
    if (!noisy && xv > best) {
      best = xv;
      best_idx = __float_as_int(B[q]);
      best_xs = xs;
    }
  }
  m = warp_max(m);
  const uint32_t k0 = (uint32_t)keys[2 * row];
  const uint32_t k1 = (uint32_t)keys[2 * row + 1];
  float s = 0.f;
  int drawn = -1;  // the group of four whose Philox words `r` holds
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  for (int i = 0; i < chunk; ++i) {
    const int q = slot(i);
    if (q >= nk) break;
    const float xs = A[q];
    s += expf(xs - m);
    if (noisy) {
      const int v = __float_as_int(B[q]);
      if (v >> 2 != drawn) {
        drawn = v >> 2;
        r = philox4x32_10(make_uint4((uint32_t)step, (uint32_t)pos, (uint32_t)drawn, 0u), k0, k1);
      }
      const int word = v & 3;
      const uint32_t bits = word == 0 ? r.x : word == 1 ? r.y : word == 2 ? r.z : r.w;
      const float val = xs + gumbel_from_bits(bits);
      if (val > best) {
        best = val;
        best_idx = v;
        best_xs = xs;
      }
    }
  }
  s = warp_sum(s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_idx, o);
    const float ox = __shfl_xor_sync(0xffffffffu, best_xs, o);
    if (ob > best || (ob == best && oi < best_idx)) {
      best = ob;
      best_idx = oi;
      best_xs = ox;
    }
  }
  if (lane == 0) {
    tokens[gpos] = best_idx;
    probs[gpos] = best_idx < V ? expf(best_xs - m) / s : 0.f;
  }
}

template <typename VC>
__global__ void __launch_bounds__(VC::WARPS * 32, VC::BLOCKS_PER_SM) sampler_kernel(
    const float* __restrict__ logits, const long long* __restrict__ keys,
    const float* __restrict__ temperature, const float* __restrict__ top_p,
    const float* __restrict__ flag, long long* __restrict__ tokens,
    float* __restrict__ probs, int b, int flat, int step, int typical,
    float typical_mass, int typical_min_tokens, int top_k, int use_top_p) {
  constexpr int V = VC::V;
  constexpr int PER_LANE = VC::PER_LANE;
  constexpr int GROUPS = VC::GROUPS;
  constexpr int WARPS = VC::WARPS;
  using Bits = typename VC::Bits;
  // per warp: c, then the band's c, then the kept logits (A); p, then the
  // band's p, then the kept vocab indices (B)
  __shared__ __align__(16) float lists[WARPS][2][V];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long gpos = (long long)blockIdx.x * WARPS + w;
  if (gpos >= (long long)b * flat) return;  // the whole warp leaves together
  const int row = (int)(gpos / flat);
  const int pos = (int)(gpos % flat);
  float* A = lists[w][0];
  float* B = lists[w][1];

  // slot 4 i + e of this lane is vocab entry 4 (32 i + lane) + e
  float x[PER_LANE];
  const float4* src = reinterpret_cast<const float4*>(logits + gpos * V);
#pragma unroll
  for (int i = 0; i < GROUPS; ++i) {
    const float4 f = src[i * 32 + lane];
    x[4 * i] = f.x;
    x[4 * i + 1] = f.y;
    x[4 * i + 2] = f.z;
    x[4 * i + 3] = f.w;
  }

  Bits keep = ~Bits(0);  // bit j: slot j survives the typical filter
  if (typical) {
    // log-softmax, entropy, typicality distance c = |-log p - H|
    float m = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) m = fmaxf(m, x[j]);
    m = warp_max(m);
    // exp(x - m) once, kept in B; p = exp(x - m) / sum, as a product with
    // the sum's reciprocal (within an ulp or two of exp(log p))
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) {
      float e4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        e4[e] = expf(x[4 * i + e] - m);
        s += e4[e];
      }
      reinterpret_cast<float4*>(B)[i * 32 + lane] = make_float4(e4[0], e4[1], e4[2], e4[3]);
    }
    s = warp_sum(s);
    const float lse = logf(s);
    const float inv_s = __frcp_rn(s);
    float plogp = 0.f;
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) {
      const float4 e4 = reinterpret_cast<const float4*>(B)[i * 32 + lane];
      float p4[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lp = (x[4 * i + e] - m) - lse;
        p4[e] = __fmul_rn(p4[e], inv_s);
        plogp += p4[e] > 0.f ? lp * p4[e] : 0.f;
      }
      reinterpret_cast<float4*>(B)[i * 32 + lane] = make_float4(p4[0], p4[1], p4[2], p4[3]);
    }
    const float entropy = -warp_sum(plogp);
    float cmax = 0.f;
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) {
      float c4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c4[e] = typicality(x[4 * i + e], m, lse, entropy);
        cmax = fmaxf(cmax, isfinite(c4[e]) ? c4[e] : 0.f);
      }
      reinterpret_cast<float4*>(A)[i * 32 + lane] = make_float4(c4[0], c4[1], c4[2], c4[3]);
    }
    __syncwarp();
    float lo = 0.f, hi = warp_max(cmax);
    for (int it = 0; it < FULL_STEPS; ++it) {
      const float mid = 0.5f * (lo + hi);
      float mass4[4] = {0.f, 0.f, 0.f, 0.f};  // four short chains of adds
      int count = 0;
#pragma unroll
      for (int i = 0; i < GROUPS; ++i) {
        const float4 c4 = reinterpret_cast<const float4*>(A)[i * 32 + lane];
        const float4 p4 = reinterpret_cast<const float4*>(B)[i * 32 + lane];
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (cv[e] <= mid) {
            mass4[e] += pv[e];
            count += 1;
          }
        }
      }
      const float mass_all = warp_sum((mass4[0] + mass4[1]) + (mass4[2] + mass4[3]));
      const int count_all = warp_sum(count);
      const bool ok = mass_all >= typical_mass && count_all >= typical_min_tokens;
      lo = ok ? lo : mid;
      hi = ok ? mid : hi;
    }

    // carry what is decided, list the undecided band (in place: a list
    // entry lands at or below its vocab index, which every lane has read)
    float mass_in = 0.f;
    int count_in = 0, nb = 0;
    Bits in_bits = 0, band_bits = 0;  // bit j: slot j decided inside, in the band
#pragma unroll 1
    for (int i = 0; i < GROUPS; ++i) {
      const float4 c4 = reinterpret_cast<const float4*>(A)[i * 32 + lane];
      const float4 p4 = reinterpret_cast<const float4*>(B)[i * 32 + lane];
      __syncwarp();
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      bool band[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = cv[e] <= lo;
        mass_in += in ? pv[e] : 0.f;
        count_in += in ? 1 : 0;
        band[e] = lo < cv[e] && cv[e] <= hi;
        in_bits |= (Bits)in << (4 * i + e);
        band_bits |= (Bits)band[e] << (4 * i + e);
      }
      int slot[4];
      const int added = group_slots(band, nb, slot);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (band[e]) {
          A[slot[e]] = cv[e];
          B[slot[e]] = pv[e];
        }
      }
      nb += added;
    }
    mass_in = warp_sum(mass_in);
    count_in = warp_sum(count_in);
    __syncwarp();
    if (nb <= 64) {
      // a band of up to two entries a lane, held in registers for the steps
      const float c0 = lane < nb ? A[lane] : CUDART_INF_F;
      const float c1 = lane + 32 < nb ? A[lane + 32] : CUDART_INF_F;
      const float p0 = lane < nb ? B[lane] : 0.f;
      const float p1 = lane + 32 < nb ? B[lane + 32] : 0.f;
      for (int it = FULL_STEPS; it < BISECT_ITERS; ++it) {
        const float mid = 0.5f * (lo + hi);
        const bool in0 = c0 <= mid, in1 = c1 <= mid;
        const float mass = (in0 ? p0 : 0.f) + (in1 ? p1 : 0.f);
        const int count = count_in + __popc(__ballot_sync(0xffffffffu, in0)) +
                          __popc(__ballot_sync(0xffffffffu, in1));
        const bool ok = mass_in + warp_sum(mass) >= typical_mass && count >= typical_min_tokens;
        lo = ok ? lo : mid;
        hi = ok ? mid : hi;
      }
    } else {
      for (int it = FULL_STEPS; it < BISECT_ITERS; ++it) {
        const float mid = 0.5f * (lo + hi);
        float mass = 0.f;
        int count = count_in;
        for (int q0 = 0; q0 < nb; q0 += 32) {
          const int q = q0 + lane;
          const bool in = q < nb && A[q] <= mid;
          mass += in ? B[q] : 0.f;
          count += __popc(__ballot_sync(0xffffffffu, in));
        }
        const bool ok = mass_in + warp_sum(mass) >= typical_mass && count >= typical_min_tokens;
        lo = ok ? lo : mid;
        hi = ok ? mid : hi;
      }
    }
    // kept: the decided entries and the band's entries with c <= hi (c
    // computed again, bit for bit, for the band's slots alone)
    keep = in_bits;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      if ((band_bits >> j) & 1u && typicality(x[j], m, lse, entropy) <= hi) keep |= Bits(1) << j;
    }
    __syncwarp();  // every lane is done with the band before the lists reuse A and B
  }

  // the kept tokens, ascending vocab order: logits into A, vocab indices
  // (as float bits) into B
  int nk = 0;
#pragma unroll
  for (int i = 0; i < GROUPS; ++i) {
    bool kept[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) kept[e] = (keep >> (4 * i + e)) & 1u;
    int slot[4];
    const int added = group_slots(kept, nk, slot);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kept[e]) {
        A[slot[e]] = x[4 * i + e];
        B[slot[e]] = __int_as_float(4 * (32 * i + lane) + e);
      }
    }
    nk += added;
  }
  __syncwarp();
  if (top_k > 0 && top_k < nk) top_k_filter(A, nk, top_k, lane);
  if (nk > 128) {
    sample_tail<VC, true>(A, B, nk, lane, row, pos, gpos, step, keys, temperature, top_p, flag,
                          tokens, probs, use_top_p);
  } else {
    sample_tail<VC, false>(A, B, nk, lane, row, pos, gpos, step, keys, temperature, top_p, flag,
                           tokens, probs, use_top_p);
  }
}

template <typename VC>
int launch_sampler(const void* logits, const void* keys, const void* temperature,
                   const void* top_p, const void* flag, void* tokens, void* probs, int b,
                   int flat, int step, int typical, float typical_mass, int typical_min_tokens,
                   int top_k, int use_top_p, int device, void* stream) {
  // Host threads may launch concurrently (the serving engine's dispatcher
  // beside the web app's handlers). The flag only skips a repeat of the
  // call below, which sets one constant attribute and is idempotent, so
  // threads that race past an unset flag each set the same value.
  static bool carveout_set[64] = {};  // per device
  if (device >= 64 || !carveout_set[device]) {
    // as much of the SM's memory as shared memory as the blocks need
    cudaError_t err = cudaFuncSetAttribute(sampler_kernel<VC>,
                                           cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) carveout_set[device] = true;
  }
  const long long n = (long long)b * flat;
  const unsigned blocks = (unsigned)((n + VC::WARPS - 1) / VC::WARPS);
  sampler_kernel<VC><<<blocks, VC::WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const long long*>(keys),
      static_cast<const float*>(temperature), static_cast<const float*>(top_p),
      static_cast<const float*>(flag), static_cast<long long*>(tokens),
      static_cast<float*>(probs), b, flat, step, typical, typical_mass,
      typical_min_tokens, top_k, use_top_p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vampnet_sampler(const void* logits, const void* keys, const void* temperature,
                               const void* top_p, const void* flag, void* tokens, void* probs,
                               int b, int flat, int vocab, int step, int typical,
                               float typical_mass, int typical_min_tokens, int top_k,
                               int use_top_p, int device, void* stream) {
  if ((vocab != 1024 && vocab != 2048) || b <= 0 || flat <= 0 || top_k < 0 || top_k > vocab) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (vocab == 1024) {
    return launch_sampler<Vocab<1024>>(logits, keys, temperature, top_p, flag, tokens, probs, b,
                                       flat, step, typical, typical_mass, typical_min_tokens,
                                       top_k, use_top_p, device, stream);
  }
  return launch_sampler<Vocab<2048>>(logits, keys, temperature, top_p, flag, tokens, probs, b,
                                     flat, step, typical, typical_mass, typical_min_tokens,
                                     top_k, use_top_p, device, stream);
}
