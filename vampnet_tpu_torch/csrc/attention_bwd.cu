// Attention backward with a head-shared additive bias, for Hopper (sm_90a).
//
// Port of the Pallas training backward: the split pair
// `_attn_kernel_bwd_dkdv` (vampnet_tpu/ops/flash_attention.py:336) and
// `_attn_kernel_bwd_dq_dbias` (:381), which between them compute the function
// of the one-pass `_attn_kernel_bwd_wholeseq` (:428). With
//   q_s = bf16(q * q_scale), b_2 = bias * log2(e)   (the forward's prefolds)
//   s   = q_s k^T + b_2,  p = exp2(s - lse),  dp = do v^T,
//   ds  = p * (dp - delta) * ln(2),   delta = rowsum(do * out) (given),
// the kernels write
//   dk = ds^T q_s, dv = p^T do                     (attention_bwd_dkdv_kernel)
//   dq = (ds k) * q_scale, dbias = sum_b ds * log2(e)  (attention_bwd_dq_dbias_kernel)
// where the last factors are the prefolds' chain rule. P and dS enter their
// products as bf16, all products accumulate in fp32 (mma.sync m16n8k16).
//
// With a (b, t, t) byte mask (0 = blocked) the same two kernels port the
// masked backward `_attn_kernel_bwd` (:279), which the JAX VJP takes for the
// per-(b*h) bias it folds the mask into and which writes one dbias per
// (b*h), summed over the batch by the chain rule through the broadcast. Here
// the bias stays head-shared: a blocked score is the constant -1e9, so its
// dS is 0 (the chain rule through JAX's `where`) and it adds nothing to dq,
// dk or dbias. Its P is 0 where the row has an open key; in a row with none
// (lse = -1e9, see mma_bf16.cuh) the forward averaged v, so P is 1/t there
// and dv gets do / t, the gradient of the JAX XLA path.
//
// Layout: q, k, v, do, dk, dv are (b, t, h, D) bf16, the kernels instantiated
// for D = 64 and D = 128 (the wrapper zero-pads a smaller head dim); bias and
// dbias are (h, t, t), both bf16 or both fp32; lse and delta are (b*h, t)
// fp32; dq_acc is (b, t, h, D) fp32, zeroed by the caller, and summed into
// with atomics. Tiles sit in dynamic shared memory (dk/dv 36 KB at D = 64,
// 52 KB at 128; dq/dbias 36 KB and 68 KB). At D = 128 the dk/dv kernel's
// K, V fragments and dK, dV accumulators alone take 192 registers a thread.
//
// The mask is read beside the bias: the dk/dv kernel marks a blocked entry
// of its shared bias tile with -inf, the dq/dbias kernel reads the batch
// row's mask bytes as it forms each score fragment.
//
// Design (see ops/flash_attention.py for the bound):
//  * dkdv: one block of 4 warps per (64-key tile, batch*head); each warp owns
//    16 keys and walks every 64-row query tile, computing S^T = K Q_s^T so
//    that P^T and dS^T sit in registers as the A operand of dV += P^T dO and
//    dK += dS^T Q_s. dK and dV stay in registers and are written once.
//  * dq_dbias: one block per (64-key tile, 64-query tile, head); each warp owns
//    16 queries and the block loops over the batch, so the (64, 64) tile of
//    the head's bias is read once and its gradient summed over the batch in
//    registers and written once. dQ's partial sum over this key tile is added
//    into the fp32 accumulator with atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace vampnet;

constexpr int BT = 64;       // rows per tile, queries and keys alike (4 warps x 16)
constexpr int SBS = BT + 4;  // bias tile row stride (fp32): conflict-free transposed reads
constexpr int THREADS = 128;
constexpr float LN2_F = 0.6931471805599453f;

// A fragments (16 rows x D) of rows [r0, r0 + 16) of a shared tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t a[D / 16][4], const __nv_bfloat16* tile, int r0,
                                       int g, int tg) {
  constexpr int LDS = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = tile + (r0 + g) * LDS + kk * 16 + tg * 2;
    a[kk][0] = ld_u32(p);
    a[kk][1] = ld_u32(p + 8 * LDS);
    a[kk][2] = ld_u32(p + 8);
    a[kk][3] = ld_u32(p + 8 * LDS + 8);
  }
}

// c[j] = A (16 x D) times rows [8j, 8j + 8) of `tile` transposed: 16 x 64.
template <int D>
__device__ __forceinline__ void mm_abt(float c[BT / 8][4], const uint32_t a[D / 16][4],
                                       const __nv_bfloat16* tile, int g, int tg) {
  constexpr int LDS = D + 8;
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
    const __nv_bfloat16* bp = tile + (j * 8 + g) * LDS + tg * 2;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) mma_bf16(c[j], a[kk], ld_u32(bp + kk * 16), ld_u32(bp + kk * 16 + 8));
  }
}

// acc += X (16 x 64, the fp32 fragments x rounded to bf16) times `tile` (64 x D).
template <int D>
__device__ __forceinline__ void mm_xb(float acc[D / 8][4], const float x[BT / 8][4],
                                      const __nv_bfloat16* tile, int g, int tg) {
  constexpr int LDS = D + 8;
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    uint32_t ax[4];
    ax[0] = pack_bf16x2(x[2 * kk][0], x[2 * kk][1]);
    ax[1] = pack_bf16x2(x[2 * kk][2], x[2 * kk][3]);
    ax[2] = pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    ax[3] = pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const __nv_bfloat16* bp = tile + (kk * 16 + tg * 2) * LDS + g;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) mma_bf16(acc[j], ax, ld_col_pair<LDS>(bp + j * 8), ld_col_pair<LDS>(bp + 8 * LDS + j * 8));
  }
}

template <int D, bool BIAS_BF16, bool MASKED>
__global__ void __launch_bounds__(THREADS) attention_bwd_dkdv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const void* __restrict__ bias,
    const uint8_t* __restrict__ mask, const float* __restrict__ lse,
    const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int t, int h, float q_scale) {
  constexpr int LDS = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);  // q_s tile (K tile at the start)
  __nv_bfloat16* sdo = sq + BT * LDS;                          // dO tile (V tile at the start)
  float* sb = reinterpret_cast<float*>(sdo + BT * LDS);        // b_2 tile, [query][key], -inf where blocked
  float* slse = sb + BT * SBS;
  float* sdelta = slse + BT;

  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hi = bh % h;
  const int k0 = blockIdx.x * BT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int wr = warp * 16;

  const size_t row_stride = (size_t)h * D;
  const size_t base = (size_t)bi * t * row_stride + (size_t)hi * D;
  const size_t bias_h = (size_t)hi * t * t;
  const size_t mask_b = (size_t)bi * t * t;
  const float inv_t = 1.f / (float)t;

  // this warp's 16 keys of K and V as A fragments, kept for the whole loop
  uint32_t ak[D / 16][4], av[D / 16][4];
  load_tile<D, false>(sq, k + base, row_stride, k0, t, 1.f, THREADS);
  load_tile<D, false>(sdo, v + base, row_stride, k0, t, 1.f, THREADS);
  __syncthreads();
  load_a<D>(ak, sq, wr, g, tg);
  load_a<D>(av, sdo, wr, g, tg);

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
  }

  for (int q0 = 0; q0 < t; q0 += BT) {
    __syncthreads();  // every warp is done with the previous tiles
    load_tile<D, true>(sq, q + base, row_stride, q0, t, q_scale, THREADS);
    load_tile<D, false>(sdo, dout + base, row_stride, q0, t, 1.f, THREADS);
    for (int c = threadIdx.x; c < BT * (BT / 4); c += THREADS) {
      const int r = c / (BT / 4);
      const int col = (c % (BT / 4)) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < t) {
        const size_t src = bias_h + (size_t)(q0 + r) * t + k0 + col;
        // t need not be a multiple of 4, so rows are not 16-byte aligned
        if (k0 + col + 0 < t) val.x = load_bias<BIAS_BF16>(bias, src + 0);
        if (k0 + col + 1 < t) val.y = load_bias<BIAS_BF16>(bias, src + 1);
        if (k0 + col + 2 < t) val.z = load_bias<BIAS_BF16>(bias, src + 2);
        if (k0 + col + 3 < t) val.w = load_bias<BIAS_BF16>(bias, src + 3);
        if (MASKED) {
          const uint8_t* mr = mask + mask_b + (size_t)(q0 + r) * t + k0 + col;
          if (k0 + col + 0 < t && !mr[0]) val.x = -CUDART_INF_F;
          if (k0 + col + 1 < t && !mr[1]) val.y = -CUDART_INF_F;
          if (k0 + col + 2 < t && !mr[2]) val.z = -CUDART_INF_F;
          if (k0 + col + 3 < t && !mr[3]) val.w = -CUDART_INF_F;
        }
      }
      *reinterpret_cast<float4*>(sb + r * SBS + col) = val;
    }
    if (threadIdx.x < BT) {
      const int r = q0 + threadIdx.x;
      slse[threadIdx.x] = r < t ? lse[(size_t)bh * t + r] : 0.f;
      sdelta[threadIdx.x] = r < t ? delta[(size_t)bh * t + r] : 0.f;
    }
    __syncthreads();

    // S^T (16 keys x 64 queries) = K Q_s^T, then P^T = exp2(S^T + b_2^T - lse);
    // a blocked entry's P is 0, or 1/t in a row with no open key
    float s[BT / 8][4];
    mm_abt<D>(s, ak, sq, g, tg);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + tg * 2 + (e & 1);
        const int kr = wr + g + (e >> 1) * 8;
        const float bb = sb[qc * SBS + kr];
        float p = 0.f;
        if (q0 + qc < t) {
          if (MASKED && bb == -CUDART_INF_F) {
            p = slse[qc] < FULLY_BLOCKED_LSE ? inv_t : 0.f;
          } else {
            p = exp2f(s[j][e] + bb - slse[qc]);
          }
        }
        s[j][e] = p;
      }
    }
    // dV += P^T dO
    mm_xb<D>(acc_dv, s, sdo, g, tg);
    // dP^T = V dO^T; dS^T = P^T (dP^T - delta) ln 2
    float dp[BT / 8][4];
    mm_abt<D>(dp, av, sdo, g, tg);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + tg * 2 + (e & 1);
        const bool blocked = MASKED && sb[qc * SBS + wr + g + (e >> 1) * 8] == -CUDART_INF_F;
        s[j][e] = blocked ? 0.f : s[j][e] * (dp[j][e] - sdelta[qc]) * LN2_F;
      }
    }
    // dK += dS^T Q_s
    mm_xb<D>(acc_dk, s, sq, g, tg);
  }

  const int r_lo = k0 + wr + g;
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + tg * 2;
    if (r_lo < t) {
      const size_t o = base + (size_t)r_lo * row_stride + col;
      *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16x2(acc_dk[j][0], acc_dk[j][1]);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16x2(acc_dv[j][0], acc_dv[j][1]);
    }
    if (r_hi < t) {
      const size_t o = base + (size_t)r_hi * row_stride + col;
      *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16x2(acc_dk[j][2], acc_dk[j][3]);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16x2(acc_dv[j][2], acc_dv[j][3]);
    }
  }
}

template <int D, bool BIAS_BF16, bool MASKED>
__global__ void __launch_bounds__(THREADS) attention_bwd_dq_dbias_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const void* __restrict__ bias,
    const uint8_t* __restrict__ mask, const float* __restrict__ lse,
    const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ delta, float* __restrict__ dq_acc,
    void* __restrict__ dbias, int b, int t, int h, float q_scale) {
  constexpr int LDS = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdo = sq + BT * LDS;
  __nv_bfloat16* sk = sdo + BT * LDS;
  __nv_bfloat16* sv = sk + BT * LDS;

  const int k0 = blockIdx.x * BT;
  const int q0 = blockIdx.y * BT;
  const int hi = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int wr = warp * 16;
  const int r_lo = q0 + wr + g;
  const int r_hi = r_lo + 8;
  const size_t row_stride = (size_t)h * D;

  // this thread's b_2 entries and their gradient, summed over the batch
  const size_t bias_h = (size_t)hi * t * t;
  float b2[BT / 8][4], db[BT / 8][4];
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (e < 2) ? r_lo : r_hi;
      const int col = k0 + j * 8 + tg * 2 + (e & 1);
      b2[j][e] = (r < t && col < t) ? load_bias<BIAS_BF16>(bias, bias_h + (size_t)r * t + col) : 0.f;
      db[j][e] = 0.f;
    }
  }

  for (int bi = 0; bi < b; ++bi) {
    const size_t base = (size_t)bi * t * row_stride + (size_t)hi * D;
    const size_t row_lse = (size_t)(bi * h + hi) * t;
    __syncthreads();  // every warp is done with the previous batch row's tiles
    load_tile<D, true>(sq, q + base, row_stride, q0, t, q_scale, THREADS);
    load_tile<D, false>(sdo, dout + base, row_stride, q0, t, 1.f, THREADS);
    load_tile<D, false>(sk, k + base, row_stride, k0, t, 1.f, THREADS);
    load_tile<D, false>(sv, v + base, row_stride, k0, t, 1.f, THREADS);
    __syncthreads();
    const float lse_r[2] = {r_lo < t ? lse[row_lse + r_lo] : 0.f,
                            r_hi < t ? lse[row_lse + r_hi] : 0.f};
    const float delta_r[2] = {r_lo < t ? delta[row_lse + r_lo] : 0.f,
                              r_hi < t ? delta[row_lse + r_hi] : 0.f};

    // S = Q_s K^T + b_2, P = exp2(S - lse); a blocked entry's P (and so its
    // dS) is 0 here: only dv, in the other kernel, needs its P
    uint32_t a[D / 16][4];
    float s[BT / 8][4];
    load_a<D>(a, sq, wr, g, tg);
    mm_abt<D>(s, a, sk, g, tg);
    const size_t mask_b = (size_t)bi * t * t;
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (e < 2) ? r_lo : r_hi;
        const int col = k0 + j * 8 + tg * 2 + (e & 1);
        const bool open = r < t && col < t && (!MASKED || mask[mask_b + (size_t)r * t + col]);
        s[j][e] = open ? exp2f(s[j][e] + b2[j][e] - lse_r[e >> 1]) : 0.f;
      }
    }
    // dP = dO V^T; dS = P (dP - delta) ln 2, summed into dbias
    float dp[BT / 8][4];
    load_a<D>(a, sdo, wr, g, tg);
    mm_abt<D>(dp, a, sv, g, tg);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = s[j][e] * (dp[j][e] - delta_r[e >> 1]) * LN2_F;
        db[j][e] += s[j][e];
      }
    }
    // dQ (this key tile's part) = dS K, scaled by the q prefold's factor
    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    mm_xb<D>(acc, s, sk, g, tg);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + tg * 2;
      if (r_lo < t) {
        float* o = dq_acc + base + (size_t)r_lo * row_stride + col;
        atomicAdd(o, acc[j][0] * q_scale);
        atomicAdd(o + 1, acc[j][1] * q_scale);
      }
      if (r_hi < t) {
        float* o = dq_acc + base + (size_t)r_hi * row_stride + col;
        atomicAdd(o, acc[j][2] * q_scale);
        atomicAdd(o + 1, acc[j][3] * q_scale);
      }
    }
  }

  // dbias = (sum over the batch of dS) * log2(e), the bias prefold's chain
  // rule. A bf16 bias takes the JAX VJP's two roundings: the prefolded
  // bias's gradient is cast to bf16, then scaled in fp32 and cast again.
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (e < 2) ? r_lo : r_hi;
      const int col = k0 + j * 8 + tg * 2 + (e & 1);
      if (r < t && col < t) {
        const size_t o = bias_h + (size_t)r * t + col;
        if (BIAS_BF16) {
          const float g2 = __bfloat162float(__float2bfloat16_rn(db[j][e]));
          static_cast<__nv_bfloat16*>(dbias)[o] = __float2bfloat16_rn(g2 * LOG2E_F);
        } else {
          static_cast<float*>(dbias)[o] = db[j][e] * LOG2E_F;
        }
      }
    }
  }
}

template <int D, bool BIAS_BF16, bool MASKED>
cudaError_t launch_dkdv(dim3 grid, cudaStream_t s, const void* q, const void* k, const void* v,
                        const void* bias, const void* mask, const void* lse, const void* dout,
                        const void* delta, void* dk, void* dv, int t, int h, float q_scale) {
  const size_t smem = (size_t)2 * BT * (D + 8) * 2 + (size_t)BT * SBS * 4 + 2 * BT * 4;
  return launch(attention_bwd_dkdv_kernel<D, BIAS_BF16, MASKED>, grid, THREADS, smem, s,
                static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                static_cast<const __nv_bfloat16*>(v), bias, static_cast<const uint8_t*>(mask),
                static_cast<const float*>(lse),
                static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(delta),
                static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), t, h, q_scale);
}

template <int D, bool BIAS_BF16, bool MASKED>
cudaError_t launch_dq_dbias(dim3 grid, cudaStream_t s, const void* q, const void* k,
                            const void* v, const void* bias, const void* mask, const void* lse,
                            const void* dout, const void* delta, void* dq_acc, void* dbias, int b,
                            int t, int h, float q_scale) {
  const size_t smem = (size_t)4 * BT * (D + 8) * 2;
  return launch(attention_bwd_dq_dbias_kernel<D, BIAS_BF16, MASKED>, grid, THREADS, smem, s,
                static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                static_cast<const __nv_bfloat16*>(v), bias, static_cast<const uint8_t*>(mask),
                static_cast<const float*>(lse),
                static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(delta),
                static_cast<float*>(dq_acc), dbias, b, t, h, q_scale);
}

// The instantiation for (head dim, bias dtype, mask or none).
template <template <int, bool, bool> class Launch, typename... Args>
cudaError_t dispatch(int d, int bias_is_bf16, bool masked, Args... args) {
  if (d == 64) {
    if (bias_is_bf16) return masked ? Launch<64, true, true>::run(args...) : Launch<64, true, false>::run(args...);
    return masked ? Launch<64, false, true>::run(args...) : Launch<64, false, false>::run(args...);
  }
  if (bias_is_bf16) return masked ? Launch<128, true, true>::run(args...) : Launch<128, true, false>::run(args...);
  return masked ? Launch<128, false, true>::run(args...) : Launch<128, false, false>::run(args...);
}

template <int D, bool BIAS_BF16, bool MASKED>
struct DkDv {
  template <typename... Args>
  static cudaError_t run(Args... args) { return launch_dkdv<D, BIAS_BF16, MASKED>(args...); }
};

template <int D, bool BIAS_BF16, bool MASKED>
struct DqDbias {
  template <typename... Args>
  static cudaError_t run(Args... args) { return launch_dq_dbias<D, BIAS_BF16, MASKED>(args...); }
};

}  // namespace

// Both entry points take a head dim d of 64 or 128 (the wrapper zero-pads
// q, k, v and do up to one of them and passes q_scale for the unpadded d), a
// bf16 or fp32 bias, and a mask that is null or (b, t, t) bytes, 0 = blocked;
// dbias is written in the bias's dtype.
extern "C" int vampnet_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                                          const void* bias, int bias_is_bf16, const void* mask,
                                          const void* lse, const void* dout, const void* delta,
                                          void* dk, void* dv, int b, int t, int h, int d,
                                          float q_scale, int device, void* stream) {
  if (b <= 0 || t <= 0 || h <= 0 || (d != 64 && d != 128)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + BT - 1) / BT, b * h);
  return (int)dispatch<DkDv>(d, bias_is_bf16, mask != nullptr, grid,
                             static_cast<cudaStream_t>(stream), q, k, v, bias, mask, lse, dout,
                             delta, dk, dv, t, h, q_scale);
}

extern "C" int vampnet_attention_bwd_dq_dbias(const void* q, const void* k, const void* v,
                                              const void* bias, int bias_is_bf16,
                                              const void* mask, const void* lse,
                                              const void* dout, const void* delta, void* dq_acc,
                                              void* dbias, int b, int t, int h, int d,
                                              float q_scale, int device, void* stream) {
  if (b <= 0 || t <= 0 || h <= 0 || (d != 64 && d != 128)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int nt = (t + BT - 1) / BT;
  const dim3 grid(nt, nt, h);
  return (int)dispatch<DqDbias>(d, bias_is_bf16, mask != nullptr, grid,
                                static_cast<cudaStream_t>(stream), q, k, v, bias, mask, lse,
                                dout, delta, dq_acc, dbias, b, t, h, q_scale);
}
