// Attention forward with a head-shared additive bias, for Hopper (sm_90a).
//
// One kernel carries five Pallas bodies of vampnet_tpu/ops/flash_attention.py:
// the inference kernel `_attn_kernel_dt` (:120, K1), the training forward
// `_attn_kernel_fwd_lse` (:254, K4) and its (d,t)-major twin
// `_attn_kernel_fwd_lse_dt` (:153, K2) through the lse entry point, with a
// mask `_attn_kernel` (:93, K3: the forward over the per-(b*h) bias that the
// JAX wrapper folds a (b, t, t) mask into), and past t = 1024 the blocked
// online-softmax forward `_attn_kernel_blocked` (:47, K9): the key loop has no
// upper t, so one kernel serves every length. It computes
//   out = softmax_2(q_s k^T + b_2) v
// with q_s = bf16(q * q_scale) (q_scale = log2(e) / sqrt(d), product in fp32),
// b_2 = bias * log2(e) rounded back to the bias dtype, keys past t excluded,
// fp32 accumulation of both products, P rounded to bf16 against the running
// max for the PV product, and the division by the row sum after PV. Where the
// mask is 0 the score is -1e9 (the JAX wrapper's fill, in the prefolded
// base-2 units): such a key gets no weight in a row that has an open key, and
// a row with no open key averages v over the t keys, as the JAX XLA path
// does. The lse entry point also writes lse = m + log2(l), the base-2
// log-sum-exp of each query row, in fp32, (b*h, t), which the backward
// (attention_bwd.cu) recomputes P from.
//
// Layout: q, k, v, out are (b, t, h, D) bf16, D = 64 or 128 (the wrapper
// zero-pads a smaller head dim up to one of them); bias is (h, t, t), bf16 or
// fp32, shared by every batch row; the mask, where there is one, (b, t, t)
// bytes, 0 = blocked.
//
// What bounds it: bytes. At the coarse serving shape (b=2, t=862, h=20, d=64,
// bf16 bias) q, k, v and o are 4.41 MB each and the bias 29.7 MB: 47.4 MB,
// 14 us at 3.35 TB/s, against 7.6 GFLOP, 8 us at 989 TFLOP/s; the bias is the
// largest term at every shape the port runs, so it must be read once per head,
// not once per batch row, and its read must overlap the products.
//
// Design (warp specialised, one block of three warpgroups per 128 query rows
// of one (batch row, head)):
//  * A producer warpgroup keeps a ring of STAGES key tiles in flight, each
//    stage with a full barrier (transaction bytes and arrivals) and an empty
//    one (one arrival per consumer warpgroup). Thread 0 loads K and V
//    (64 keys x D) by TMA from 4-D tensor maps over (d, h, t, b), so rows
//    past t arrive as zeros.
//  * The bias tile (128 rows x 64 keys) and the mask tile come by TMA too
//    where a row of t elements is a multiple of 16 bytes (t % 8 == 0 in
//    bf16, % 4 in fp32, % 16 for the mask's bytes), landing with the 128-
//    (64-) byte swizzle, so the consumers read them free of bank conflicts.
//    TMA cannot take other row strides (a stride, and a box's start in the
//    row, must be 16-byte aligned). There each producer thread copies one
//    bias row's window from the 16-byte boundary below it by one bulk copy
//    (the TMA engine takes some 20 cycles a request: 128 a tile bound the
//    kernel at t = 862), the mask by 16-byte cp.async, and the consumers
//    skip each window's offset.
//  * Two consumer warpgroups own 64 query rows each. Q arrives by TMA once;
//    each warpgroup prefolds its rows in place. The accumulator starts from
//    the prefolded bias, so S = b_2 + Q K^T is one wgmma chain (m64n64k16,
//    both operands K-major from shared memory); the mask and the online
//    softmax run on the accumulator fragments; P is packed to bf16 in
//    registers (the accumulator's layout is the register A fragment's) and
//    O += P V is wgmma m64nDk16 with V read MN-major.
//  * Blocks are ordered (head, query tile) outermost and batch row innermost,
//    so the b blocks that read one bias strip run together and L2 serves all
//    but the first: the bias comes from device memory about once per head.
//  * setmaxnreg hands the producer's registers to the consumers.
// See ops/flash_attention.py for the routes and PERF.md for the times.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace vampnet;

constexpr int BK = 64;   // keys per tile
constexpr int WG = 128;  // threads per warpgroup
constexpr int SMEM_LIMIT = 232448;

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Shared-memory plan, byte offsets from a 1,024-byte aligned base: Q (each
// consumer warpgroup's 64 x D as D/64 slabs of 64 rows x 128 bytes), then per
// stage K and V (the same slabs), the bias tile (BQ rows of BIAS_ROW bytes:
// the 16-byte chunks that cover a row's 64-key window, or the TMA tile) and
// the mask tile, then the barriers; as many stages as fit, up to 4. Two
// consumer warpgroups (NC) own 64 query rows each.
template <int D, bool BIAS_BF16, bool MASKED>
struct Plan {
  static constexpr int NC = 2;
  static constexpr int BQ = 64 * NC;
  static constexpr int THREADS = (NC + 1) * WG;
  static constexpr int ES = BIAS_BF16 ? 2 : 4;
  static constexpr int BIAS_ROW = (15 + BK * ES + 15) / 16 * 16;          // 144 or 272
  static constexpr int MASK_ROW = MASKED ? (15 + BK + 15) / 16 * 16 : 0;  // 80
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one tile of K or of V
  static constexpr int FIT =
      (SMEM_LIMIT - (1024 + Q_BYTES + 80)) / (2 * KV_BYTES + BQ * (BIAS_ROW + MASK_ROW));
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BIAS_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int MASK_OFF = BIAS_OFF + STAGES * BQ * BIAS_ROW;
  static constexpr int BAR_OFF = MASK_OFF + STAGES * BQ * MASK_ROW;
  static constexpr int SMEM = 1024 + BAR_OFF + (2 * STAGES + 1) * 8;
  // the producer's registers go to the consumers (setmaxnreg); the totals
  // fill the SM's 65,536
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  static_assert(STAGES >= 2 && SMEM <= SMEM_LIMIT, "shared memory plan too large");
  static_assert(BQ == WG, "one bias row per producer thread");
  static_assert(WG * PRODUCER_REGS + NC * WG * CONSUMER_REGS <= 65536, "register plan");
};

// Byte offset of the k16 step kk in a K-major tile of D/64 slabs.
__device__ __forceinline__ uint32_t kmajor_step(int kk) {
  return (kk >> 2) * (64 * 128) + (kk & 3) * 32;
}

// Two neighbouring bias elements in shared memory, prefolded: b * log2(e),
// rounded back to the bias dtype. A bf16 pair is rounded by one F2FP (the
// ALU pipe); rounding one value (F2F) would take the conversion pipe that
// exp2 needs. smem_bias2_aligned reads the pair at `at` (4- or 8-byte
// aligned: the TMA tile); smem_bias2 columns c and c + 1 of a row window
// that starts at `row`, of any alignment.
template <bool BIAS_BF16>
__device__ __forceinline__ float2 smem_bias2_aligned(const unsigned char* at) {
  if (BIAS_BF16) {
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(at);
    const __nv_bfloat162 r =
        __floats2bfloat162_rn(__low2float(b) * LOG2E_F, __high2float(b) * LOG2E_F);
    return make_float2(__low2float(r), __high2float(r));
  } else {
    const float2 b = *reinterpret_cast<const float2*>(at);
    return make_float2(b.x * LOG2E_F, b.y * LOG2E_F);
  }
}

template <bool BIAS_BF16>
__device__ __forceinline__ float2 smem_bias2(const unsigned char* row, int c) {
  if (BIAS_BF16) {
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(row) + c;
    const __nv_bfloat162 r =
        __floats2bfloat162_rn(__bfloat162float(b[0]) * LOG2E_F, __bfloat162float(b[1]) * LOG2E_F);
    return make_float2(__low2float(r), __high2float(r));
  } else {
    const float* b = reinterpret_cast<const float*>(row) + c;
    return make_float2(b[0] * LOG2E_F, b[1] * LOG2E_F);
  }
}

template <int D, bool BIAS_BF16, bool WITH_LSE, bool MASKED>
__global__ void __launch_bounds__(Plan<D, BIAS_BF16, MASKED>::THREADS, 1) attention_fwd_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_bias,
    const __grid_constant__ CUtensorMap tm_mask, const void* __restrict__ bias,
    const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    int b, int t, int h, float q_scale, int bias_tma, int mask_tma) {
  using P = Plan<D, BIAS_BF16, MASKED>;
  constexpr int ST = P::STAGES;
  constexpr int NC = P::NC;
  constexpr int BQ = P::BQ;
  constexpr int SLABS = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar0 = sbase + P::BAR_OFF;  // full[ST], empty[ST], q
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (ST + s); };
  const uint32_t qbar = bar0 + 8 * 2 * ST;

  // block -> (head, query tile, batch row), the batch row innermost
  const int n_qt = (t + BQ - 1) / BQ;
  int idx = blockIdx.x;
  const int bi = idx % b;
  idx /= b;
  const int q0 = (idx % n_qt) * BQ;
  const int hi = idx / n_qt;
  const int n_kt = (t + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      // thread 0's arrival with the TMA bytes, one per producer warp with
      // its bulk copies' bytes, and with a mask one per producer thread
      // once its cp.async copies have landed
      mbar_init(full(s), 1 + WG / 32 + (MASKED ? WG : 0));
      mbar_init(empty(s), NC);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const uintptr_t bias_addr = reinterpret_cast<uintptr_t>(bias);
  const uintptr_t mask_addr = reinterpret_cast<uintptr_t>(mask);

  if (threadIdx.x < WG) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<P::PRODUCER_REGS>();
    const int pt = threadIdx.x;
    if (pt == 0) {
      mbar_arrive_expect_tx(qbar, P::Q_BYTES);
      for (int w = 0; w < NC; ++w) {
        for (int sl = 0; sl < SLABS; ++sl) {
          tma_load_4d(sbase + (w * SLABS + sl) * 8192, &tm_q, qbar, sl * 64, hi, q0 + 64 * w, bi);
        }
      }
    }
    const int rows_valid = min(BQ, t - q0);
    const uintptr_t bias_end = bias_addr + (size_t)h * t * t * P::ES;
    const uintptr_t mask_end = mask_addr + (size_t)b * t * t;
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % ST;
      mbar_wait(empty(s), ((j / ST) & 1) ^ 1);
      const int key0 = j * BK;
      if (pt == 0) {
        mbar_arrive_expect_tx(full(s), 2 * P::KV_BYTES + (bias_tma ? BQ * BK * P::ES : 0) +
                                           (MASKED && mask_tma ? BQ * BK : 0));
        for (int sl = 0; sl < SLABS; ++sl) {
          tma_load_4d(sbase + P::K_OFF + s * P::KV_BYTES + sl * 8192, &tm_k, full(s), sl * 64, hi,
                      key0, bi);
          tma_load_4d(sbase + P::V_OFF + s * P::KV_BYTES + sl * 8192, &tm_v, full(s), sl * 64, hi,
                      key0, bi);
        }
        // where rows of t elements are 16-byte aligned, the bias tile (in
        // halves of 32 for fp32) and the mask tile come as TMA boxes too
        for (int half = 0; bias_tma && half < P::ES / 2; ++half) {
          tma_load_2d(sbase + P::BIAS_OFF + s * BQ * P::BIAS_ROW + half * BQ * 128, &tm_bias,
                      full(s), key0 + 32 * half, hi * t + q0);
        }
        if (MASKED && mask_tma) {
          tma_load_2d(sbase + P::MASK_OFF + s * BQ * P::MASK_ROW, &tm_mask, full(s), key0,
                      bi * t + q0);
        }
      }
      // otherwise one bias row per thread, a bulk copy each (the cp.async
      // path measured slower); each warp's bytes are added to the stage's
      // transactions by one arrival, before its copies are issued
      {
        const int lr = pt;
        uintptr_t src = 0;
        uint32_t bytes = 0;
        if (!bias_tma && lr < rows_valid) {
          bytes = row_window<P::BIAS_ROW>(
              smem + P::BIAS_OFF + (s * BQ + lr) * P::BIAS_ROW,
              bias_addr + (((size_t)hi * t + q0 + lr) * t + key0) * P::ES, bias_end, src);
        }
        const uint32_t warp_bytes = __reduce_add_sync(0xffffffffu, bytes);
        __syncwarp();  // orders the plain stores before the arrival
        if ((pt & 31) == 0) mbar_arrive_expect_tx(full(s), warp_bytes);
        __syncwarp();
        if (bytes) {
          bulk_load(sbase + P::BIAS_OFF + (s * BQ + lr) * P::BIAS_ROW,
                    reinterpret_cast<const void*>(src), bytes, full(s));
        }
      }
      // the mask tile by 16-byte cp.async (a bulk copy per 64-byte row is
      // slower), neighbouring threads on neighbouring chunks of a row
      if constexpr (MASKED) {
        constexpr int CH = P::MASK_ROW / 16;
        for (int id = pt; !mask_tma && id < BQ * CH; id += WG) {
          const int lr = id / CH;
          const int ch = id - lr * CH;
          if (lr < rows_valid) {
            const uintptr_t src =
                ((mask_addr + ((size_t)bi * t + q0 + lr) * t + key0) & ~uintptr_t(15)) + ch * 16;
            const int n = src + 16 <= mask_end ? 16 : (src < mask_end ? (int)(mask_end - src) : 0);
            cp_async_16(sbase + P::MASK_OFF + (s * BQ + lr) * P::MASK_ROW + ch * 16,
                        reinterpret_cast<const void*>(n ? src : (mask_addr & ~uintptr_t(15))), n);
          }
        }
        cp_async_mbar_arrive(full(s));
      }
    }
    // stay until the consumers have released every stage
    for (int j = n_kt; j < n_kt + ST; ++j) mbar_wait(empty(j % ST), ((j / ST) & 1) ^ 1);
  } else {
    // ------------------------------------------------------------ consumers
    setmaxnreg_inc<P::CONSUMER_REGS>();
    const int cw = threadIdx.x / WG - 1;  // consumer warpgroup: query rows 64 cw ..
    const int ct = threadIdx.x % WG;
    const int warp = ct >> 5;
    const int lane = ct & 31;
    const int g = lane >> 2;  // fragment row group
    const int tg = lane & 3;  // thread in group
    const int lr_lo = 64 * cw + 16 * warp + g;
    const int lr_hi = lr_lo + 8;
    const int r_lo = q0 + lr_lo;
    const int r_hi = q0 + lr_hi;
    // each row's offset into its shared window: where the 64 keys begin
    // past the 16-byte boundary below them (the same for every key tile)
    const int rc_lo = r_lo < t ? r_lo : 0;
    const int rc_hi = r_hi < t ? r_hi : 0;
    const int bias_lo = lr_lo * P::BIAS_ROW +
                        (int)((bias_addr + ((size_t)hi * t + rc_lo) * t * P::ES) & 15);
    const int bias_hi = lr_hi * P::BIAS_ROW +
                        (int)((bias_addr + ((size_t)hi * t + rc_hi) * t * P::ES) & 15);
    const int mask_lo = lr_lo * P::MASK_ROW + (int)((mask_addr + ((size_t)bi * t + rc_lo) * t) & 15);
    const int mask_hi = lr_hi * P::MASK_ROW + (int)((mask_addr + ((size_t)bi * t + rc_hi) * t) & 15);

    // the q prefold, in place on this warpgroup's 64 rows, then made visible
    // to wgmma (the async proxy)
    unsigned char* sq = smem + cw * 64 * D * 2;
    mbar_wait(qbar, 0);
    for (int c = ct; c < 64 * D / 8; c += WG) {
      uint4 v = reinterpret_cast<uint4*>(sq)[c];
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        e[i] = __floats2bfloat162_rn(__low2float(e[i]) * q_scale, __high2float(e[i]) * q_scale);
      }
      reinterpret_cast<uint4*>(sq)[c] = v;
    }
    fence_proxy_async();
    named_bar_sync(1 + cw, WG);

    const uint64_t desc_q = gmma_desc(smem_u32(sq), 16, 1024);
    const uint64_t desc_k = gmma_desc(sbase + P::K_OFF, 16, 1024);
    const uint64_t desc_v = gmma_desc(sbase + P::V_OFF, 64 * 128, 1024);

    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l_run[2] = {0.f, 0.f};
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    // S = b_2 + Q_s K^T of the tile in stage s, 64 rows x 64 keys: the
    // accumulator starts from the prefolded bias (bias_init)
    auto issue_s = [&](int s, float(&sc)[32]) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_m64n64k16_ss(sc, desc_q + (kmajor_step(kk) >> 4),
                           desc_k + ((s * P::KV_BYTES + kmajor_step(kk)) >> 4), 1);
      }
      wgmma_commit();
    };
    // O += P V of the tile in stage s
    auto issue_pv = [&](int s, uint32_t(&pa)[BK / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = desc_v + ((s * P::KV_BYTES + kk * 16 * 128) >> 4);
        if constexpr (D == 64) {
          wgmma_m64n64k16_rs(o, pa[kk], dv, 1);
        } else {
          wgmma_m64n128k16_rs(o, pa[kk], dv, 1);
        }
      }
      wgmma_commit();
    };
    // The prefolded bias of the tile in stage s, in the accumulator's layout:
    // sc[4 jn + e] is row (e < 2 ? lo : hi), column 8 jn + 2 tg + (e & 1).
    auto bias_init = [&](int s, float(&sc)[32]) {
      const unsigned char* bstage = smem + P::BIAS_OFF + s * BQ * P::BIAS_ROW;
#pragma unroll
      for (int jn = 0; jn < BK / 8; ++jn) {
        float2 lo, hi;
        if (bias_tma) {
          // the TMA tile: row lr of 128 bytes (fp32: two halves of 32
          // elements), 16-byte chunks swizzled by lr % 8
          const int byte = BIAS_BF16 ? 16 * jn + 4 * tg : 32 * (jn & 3) + 8 * tg;
          const int half = BIAS_BF16 ? 0 : (jn >> 2) * BQ * 128;
          const int sw_lo = half + lr_lo * 128 + ((((byte >> 4) ^ lr_lo) & 7) << 4) + (byte & 15);
          const int sw_hi = half + lr_hi * 128 + ((((byte >> 4) ^ lr_hi) & 7) << 4) + (byte & 15);
          lo = smem_bias2_aligned<BIAS_BF16>(bstage + sw_lo);
          hi = smem_bias2_aligned<BIAS_BF16>(bstage + sw_hi);
        } else {
          lo = smem_bias2<BIAS_BF16>(bstage + bias_lo, jn * 8 + tg * 2);
          hi = smem_bias2<BIAS_BF16>(bstage + bias_hi, jn * 8 + tg * 2);
        }
        sc[4 * jn + 0] = lo.x;
        sc[4 * jn + 1] = lo.y;
        sc[4 * jn + 2] = hi.x;
        sc[4 * jn + 3] = hi.y;
      }
    };
    // The scores of the tile in stage s (keys from key0) from S: the fill
    // where the mask blocks; on the last tile (edge) keys past t drop out of
    // the softmax. Then the new row maxima, the factor alpha that rescales
    // what was summed before, and P = exp2(s - m) in bf16 as the register A
    // fragments of PV's four k16 steps; l takes the new terms.
    auto softmax = [&](auto edge, int s, int key0, float(&sc)[32], float(&alpha)[2],
                       uint32_t(&pa)[BK / 16][4]) {
      const unsigned char* mstage = smem + P::MASK_OFF + s * BQ * P::MASK_ROW;
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int jn = 0; jn < BK / 8; ++jn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = jn * 8 + tg * 2 + (e & 1);
          float val = sc[4 * jn + e];
          if constexpr (MASKED) {
            int at;
            if (mask_tma) {  // 64-byte rows, chunks swizzled by (lr / 2) % 4
              const int lr = e < 2 ? lr_lo : lr_hi;
              at = lr * 64 + ((((c >> 4) ^ (lr >> 1)) & 3) << 4) + (c & 15);
            } else {
              at = (e < 2 ? mask_lo : mask_hi) + c;
            }
            if (!mstage[at]) val = MASKED_SCORE;
          }
          if (decltype(edge)::value && key0 + c >= t) val = -CUDART_INF_F;
          sc[4 * jn + e] = val;
          mx[e >> 1] = fmaxf(mx[e >> 1], val);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // the first tile always holds key 0, so mx is finite from here on
        // (a blocked key counts as -1e9; a later open key resets the row by
        // alpha = 0)
        alpha[r] = exp2_ftz(m_run[r] - mx[r]);
        m_run[r] = mx[r];
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        float p[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          p[i] = exp2_ftz(sc[8 * kk + i] - mx[(i >> 1) & 1]);
          l_run[(i >> 1) & 1] += p[i];
        }
        pa[kk][0] = pack_bf16x2(p[0], p[1]);
        pa[kk][1] = pack_bf16x2(p[2], p[3]);
        pa[kk][2] = pack_bf16x2(p[4], p[5]);
        pa[kk][3] = pack_bf16x2(p[6], p[7]);
      }
    };
    // O *= alpha, skipped where no row of the warp moved its maximum (a
    // product with 1 would change nothing)
    auto rescale = [&](const float(&alpha)[2]) {
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int jd = 0; jd < D / 8; ++jd) {
          o[4 * jd + 0] *= alpha[0];
          o[4 * jd + 1] *= alpha[0];
          o[4 * jd + 2] *= alpha[1];
          o[4 * jd + 3] *= alpha[1];
        }
      }
    };
    auto softmax_tile = [&](int j, float(&sc)[32], float(&alpha)[2], uint32_t(&pa)[BK / 16][4]) {
      if (j == n_kt - 1) {
        softmax(Flag<true>{}, j % ST, j * BK, sc, alpha, pa);
      } else {
        softmax(Flag<false>{}, j % ST, j * BK, sc, alpha, pa);
      }
    };

    // Per key tile: S, the softmax, then PV. The operand fences keep the
    // compiler from writing a wgmma's registers between wgmma.fence and the
    // wgmma, or touching them while it is in flight.
    uint32_t pa[BK / 16][4];
    float alpha[2];
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % ST;
      float sc[32];
      mbar_wait(full(s), (j / ST) & 1);
      bias_init(s, sc);
      fence_regs(sc);
      wgmma_fence();
      issue_s(s, sc);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile(j, sc, alpha, pa);
      rescale(alpha);
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
      wgmma_fence();
      issue_pv(s, pa);
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
      // every thread of the warpgroup read its bias and mask before the PV
      // product that just retired could start: the stage is free
      if (ct == 0) mbar_arrive(empty(s));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    const size_t bh = (size_t)bi * h + hi;
    if (WITH_LSE && tg == 0) {
      // m_run and l_run are the same in the four threads of a row group
      if (r_lo < t) lse[bh * t + r_lo] = m_run[0] + log2f(l_run[0]);
      if (r_hi < t) lse[bh * t + r_hi] = m_run[1] + log2f(l_run[1]);
    }
    const float inv_lo = 1.f / l_run[0];
    const float inv_hi = 1.f / l_run[1];
    const size_t row_stride = (size_t)h * D;
    __nv_bfloat16* ob = out + (size_t)bi * t * row_stride + (size_t)hi * D;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      const int col = jd * 8 + tg * 2;
      if (r_lo < t) {
        *reinterpret_cast<uint32_t*>(ob + (size_t)r_lo * row_stride + col) =
            pack_bf16x2(o[4 * jd + 0] * inv_lo, o[4 * jd + 1] * inv_lo);
      }
      if (r_hi < t) {
        *reinterpret_cast<uint32_t*>(ob + (size_t)r_hi * row_stride + col) =
            pack_bf16x2(o[4 * jd + 2] * inv_hi, o[4 * jd + 3] * inv_hi);
      }
    }
  }
}

template <int D, bool BIAS_BF16, bool WITH_LSE, bool MASKED>
int launch_fwd_d(const void* q, const void* k, const void* v, const void* bias, const void* mask,
                 void* out, void* lse, int b, int t, int h, float q_scale, cudaStream_t s) {
  using P = Plan<D, BIAS_BF16, MASKED>;
  CUtensorMap tq, tk, tv, tb = {}, tm = {};
  if (!encode_bthd_map(&tq, q, b, t, h, D) || !encode_bthd_map(&tk, k, b, t, h, D) ||
      !encode_bthd_map(&tv, v, b, t, h, D)) {
    return (int)cudaErrorInvalidValue;
  }
  // TMA takes the bias and mask rows (t elements apart) where t elements
  // make a multiple of 16 bytes; else the kernel copies them row by row
  const bool bias_tma =
      reinterpret_cast<uintptr_t>(bias) % 16 == 0 && (long long)t * P::ES % 16 == 0;
  if (bias_tma) {
    const cuuint64_t dims[2] = {(cuuint64_t)t, (cuuint64_t)h * t};
    const cuuint64_t strides[1] = {(cuuint64_t)t * P::ES};
    const cuuint32_t box[2] = {(cuuint32_t)(128 / P::ES), (cuuint32_t)P::BQ};
    if (!encode_map(&tb, BIAS_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                    2, bias, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const bool mask_tma = MASKED && reinterpret_cast<uintptr_t>(mask) % 16 == 0 && t % 16 == 0;
  if (mask_tma) {
    const cuuint64_t dims[2] = {(cuuint64_t)t, (cuuint64_t)b * t};
    const cuuint64_t strides[1] = {(cuuint64_t)t};
    const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)P::BQ};
    if (!encode_map(&tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, mask, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_64B)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const long long blocks = (long long)h * ((t + P::BQ - 1) / P::BQ) * b;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  return (int)launch(attention_fwd_kernel<D, BIAS_BF16, WITH_LSE, MASKED>, dim3((unsigned)blocks),
                     P::THREADS, (size_t)P::SMEM, s, tq, tk, tv, tb, tm, bias,
                     static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(out),
                     static_cast<float*>(lse), b, t, h, q_scale, bias_tma ? 1 : 0,
                     mask_tma ? 1 : 0);
}

template <bool BIAS_BF16, bool WITH_LSE, bool MASKED>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias, const void* mask,
               void* out, void* lse, int b, int t, int h, int d, float q_scale, int device,
               void* stream) {
  if (b <= 0 || t <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) {
    return launch_fwd_d<64, BIAS_BF16, WITH_LSE, MASKED>(q, k, v, bias, mask, out, lse, b, t, h,
                                                         q_scale, s);
  }
  if (d == 128) {
    return launch_fwd_d<128, BIAS_BF16, WITH_LSE, MASKED>(q, k, v, bias, mask, out, lse, b, t, h,
                                                          q_scale, s);
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
// up to one of them and passes q_scale for the unpadded d. q, k, v and out
// are 16-byte aligned. `mask` is null or (b, t, t) bytes, 0 = blocked.
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
