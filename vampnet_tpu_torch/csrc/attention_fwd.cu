// Attention forward with a head-shared additive bias, for Hopper (sm_90a).
//
// Port of the Pallas inference kernel `_attn_kernel_dt`
// (vampnet_tpu/ops/flash_attention.py:120) and, through the second entry
// point, of the training forward `_attn_kernel_fwd_lse` (:254) and its
// (d,t)-major twin `_attn_kernel_fwd_lse_dt` (:153). With a mask it also
// ports `_attn_kernel` (:93), the forward over the per-(b*h) bias that the
// JAX wrapper folds a (b, t, t) mask into, and at t > 1024 the blocked
// online-softmax forward `_attn_kernel_blocked` (:47): the key loop below
// has no upper t, so one kernel serves every length. It computes
//   out = softmax_2(q_s k^T + b_2) v
// with q_s = bf16(q * q_scale) (q_scale = log2(e) / sqrt(d), product in fp32),
// b_2 = bias * log2(e) rounded back to the bias dtype, keys past t excluded,
// fp32 accumulation of both products, P rounded to bf16 for the PV product,
// and the division by the row sum after PV. Where the mask is 0 the score is
// -1e9 (the JAX wrapper's fill, in the prefolded base-2 units): such a key
// gets no weight in a row that has an open key, and a row with no open key
// averages v over the t keys, as the JAX XLA path does. The training entry
// point also writes lse = m + log2(l), the base-2 log-sum-exp of each query
// row, in fp32, (b*h, t), which the backward (attention_bwd.cu) recomputes P
// from.
//
// Layout: q, k, v, out are (b, t, h, D) bf16, the kernel instantiated for
// D = 64 and D = 128 (the wrapper zero-pads a smaller head dim up to one of
// them); bias is (h, t, t), bf16 or fp32, shared by every batch row. The
// three tiles sit in dynamic shared memory: 27 KB at D = 64, 51 KB at 128.
// The mask, where there is one, is (b, t, t) bytes (0 = blocked), read as the
// bias is: the head-shared bias and the batch row's mask are combined as the
// score fragment is formed, so no (b*h, t, t) bias is ever written.
//
// Design: one block of 4 warps per (64-row query tile, batch*head). Each warp
// owns 16 query rows. Keys stream through shared memory in tiles of 64; the
// softmax runs online in base 2, with the running max and row sum kept in
// registers. Products are mma.sync.m16n8k16 (bf16 in, fp32 accumulate). The
// bias is read from device memory straight into the score fragments and
// prefolded there. See ops/flash_attention.py for the bound and the plan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace vampnet;

constexpr int BQ = 64;       // query rows per block (4 warps x 16)
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 128;

template <int D, bool BIAS_BF16, bool WITH_LSE, bool MASKED>
__global__ void __launch_bounds__(THREADS) attention_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const void* __restrict__ bias,
    const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    int t, int h, float q_scale) {
  constexpr int LDS = D + 8;  // shared-memory row stride (bf16), padded against bank conflicts
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = sq + BQ * LDS;
  __nv_bfloat16* sv = sk + BK * LDS;

  const int bh = blockIdx.y;
  const int bi = bh / h;
  const int hi = bh % h;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // thread in group

  const size_t row_stride = (size_t)h * D;
  const size_t base = (size_t)bi * t * row_stride + (size_t)hi * D;

  load_tile<D, true>(sq, q + base, row_stride, q0, t, q_scale, THREADS);
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16-wide slice of d
  const int wr = warp * 16;
  uint32_t aq[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = sq + (wr + g) * LDS + kk * 16 + tg * 2;
    aq[kk][0] = ld_u32(p);
    aq[kk][1] = ld_u32(p + 8 * LDS);
    aq[kk][2] = ld_u32(p + 8);
    aq[kk][3] = ld_u32(p + 8 * LDS + 8);
  }

  // rows owned by this thread: r_lo = q0 + wr + g, r_hi = r_lo + 8
  const int r_lo = q0 + wr + g;
  const int r_hi = r_lo + 8;
  const size_t bias_lo = ((size_t)hi * t + (r_lo < t ? r_lo : 0)) * t;
  const size_t bias_hi = ((size_t)hi * t + (r_hi < t ? r_hi : 0)) * t;
  const size_t mask_lo = ((size_t)bi * t + (r_lo < t ? r_lo : 0)) * t;
  const size_t mask_hi = ((size_t)bi * t + (r_hi < t ? r_hi : 0)) * t;

  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int key0 = 0; key0 < t; key0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D, false>(sk, k + base, row_stride, key0, t, 1.f, THREADS);
    load_tile<D, false>(sv, v + base, row_stride, key0, t, 1.f, THREADS);
    __syncthreads();

    // S = Q_s K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kp = sk + (j * 8 + g) * LDS + tg * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(s[j], aq[kk], ld_u32(kp + kk * 16), ld_u32(kp + kk * 16 + 8));
      }
    }

    // + prefolded bias, or the fill where the mask blocks; keys past t drop
    // out of the softmax
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = key0 + j * 8 + tg * 2 + (e & 1);
        float val = -CUDART_INF_F;
        if (col < t) {
          // the bias is loaded whatever the mask says, so that the two
          // loads are in flight together
          const size_t row_off = (e < 2) ? bias_lo : bias_hi;
          val = s[j][e] + load_bias<BIAS_BF16>(bias, row_off + col);
          if (MASKED && !mask[((e < 2) ? mask_lo : mask_hi) + col]) val = MASKED_SCORE;
        }
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    // the first tile always holds key 0, so mx is finite from here on (a
    // blocked key counts as -1e9; a later open key resets the row by alpha = 0)
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - mx[e >> 1]);
        s[j][e] = p;
        l_run[e >> 1] += p;
      }
    }

    // O += P V: P from the score fragments (bf16), V column pairs from smem
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ap[4];
      ap[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      ap[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      ap[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      ap[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vp = sv + (kk * 16 + tg * 2) * LDS + g;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        mma_bf16(o[j], ap, ld_col_pair<LDS>(vp + j * 8), ld_col_pair<LDS>(vp + 8 * LDS + j * 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  if (WITH_LSE && tg == 0) {
    // m_run and l_run are the same in the four threads of a row group
    if (r_lo < t) lse[(size_t)bh * t + r_lo] = m_run[0] + log2f(l_run[0]);
    if (r_hi < t) lse[(size_t)bh * t + r_hi] = m_run[1] + log2f(l_run[1]);
  }
  const float inv_lo = 1.f / l_run[0];
  const float inv_hi = 1.f / l_run[1];
  __nv_bfloat16* ob = out + base;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + tg * 2;
    if (r_lo < t) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)r_lo * row_stride + col) =
          pack_bf16x2(o[j][0] * inv_lo, o[j][1] * inv_lo);
    }
    if (r_hi < t) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)r_hi * row_stride + col) =
          pack_bf16x2(o[j][2] * inv_hi, o[j][3] * inv_hi);
    }
  }
}

template <bool BIAS_BF16, bool WITH_LSE, bool MASKED>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias, const void* mask,
               void* out, void* lse, int b, int t, int h, int d, float q_scale, int device,
               void* stream) {
  if (b <= 0 || t <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + BQ - 1) / BQ, b * h);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  auto* ll = static_cast<float*>(lse);
  const auto* mm = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) {
    return (int)launch(attention_fwd_kernel<64, BIAS_BF16, WITH_LSE, MASKED>, grid, THREADS,
                       (size_t)(BQ + 2 * BK) * (64 + 8) * 2, s, qq, kk, vv, bias, mm, oo, ll, t,
                       h, q_scale);
  }
  if (d == 128) {
    return (int)launch(attention_fwd_kernel<128, BIAS_BF16, WITH_LSE, MASKED>, grid, THREADS,
                       (size_t)(BQ + 2 * BK) * (128 + 8) * 2, s, qq, kk, vv, bias, mm, oo, ll, t,
                       h, q_scale);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool WITH_LSE>
int dispatch_fwd(const void* q, const void* k, const void* v, const void* bias, int bias_is_bf16,
                 const void* mask, void* out, void* lse, int b, int t, int h, int d,
                 float q_scale, int device, void* stream) {
  if (mask != nullptr) {
    return bias_is_bf16 ? launch_fwd<true, WITH_LSE, true>(q, k, v, bias, mask, out, lse, b, t,
                                                           h, d, q_scale, device, stream)
                        : launch_fwd<false, WITH_LSE, true>(q, k, v, bias, mask, out, lse, b,
                                                            t, h, d, q_scale, device, stream);
  }
  return bias_is_bf16 ? launch_fwd<true, WITH_LSE, false>(q, k, v, bias, mask, out, lse, b, t, h,
                                                          d, q_scale, device, stream)
                      : launch_fwd<false, WITH_LSE, false>(q, k, v, bias, mask, out, lse, b, t,
                                                           h, d, q_scale, device, stream);
}

}  // namespace

// The kernels take a head dim d of 64 or 128; the wrapper zero-pads q, k, v
// up to one of them and passes q_scale for the unpadded d. `mask` is null or
// (b, t, t) bytes, 0 = blocked.
extern "C" int vampnet_attention_fwd(const void* q, const void* k, const void* v,
                                     const void* bias, int bias_is_bf16, const void* mask,
                                     void* out, int b, int t, int h, int d, float q_scale,
                                     int device, void* stream) {
  return dispatch_fwd<false>(q, k, v, bias, bias_is_bf16, mask, out, nullptr, b, t, h, d,
                             q_scale, device, stream);
}

// The training forward: the same kernel, also writing the fp32 lse rows,
// (b*h, t). The bias is bf16 (the serving LMs' bf16 T5 table) or fp32.
extern "C" int vampnet_attention_fwd_lse(const void* q, const void* k, const void* v,
                                         const void* bias, int bias_is_bf16, const void* mask,
                                         void* out, void* lse, int b, int t, int h, int d,
                                         float q_scale, int device, void* stream) {
  return dispatch_fwd<true>(q, k, v, bias, bias_is_bf16, mask, out, lse, b, t, h, d, q_scale,
                            device, stream);
}
