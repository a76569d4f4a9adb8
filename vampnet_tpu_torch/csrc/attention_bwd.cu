// Attention backward with a head-shared additive bias, for Hopper (sm_90a).
//
// One kernel carries the four Pallas training backward bodies of
// vampnet_tpu/ops/flash_attention.py: the one-pass `_attn_kernel_bwd_wholeseq`
// (:428, K8) in its own form, and so the split pair `_attn_kernel_bwd_dkdv`
// (:336, K6) and `_attn_kernel_bwd_dq_dbias` (:381, K7) whose function it is;
// with a (b, t, t) byte mask (0 = blocked) the masked `_attn_kernel_bwd`
// (:279, K5). With
//   q_s = bf16(q * q_scale), b_2 = bias * log2(e)   (the forward's prefolds,
//         recomputed bit for bit; b_2 rounded back to the bias dtype)
//   s   = q_s k^T + b_2,  p = exp2(s - lse),  dp = do v^T,
//   ds  = p * (dp - delta) * ln(2),   delta = rowsum(do * out) (given),
// it writes
//   dv = p^T do, dk = ds^T q_s, dq = (ds k) * q_scale,
//   dbias = (sum over the batch of ds) * log2(e),
// the last factors the prefolds' chain rule. P and dS enter their products
// as bf16, every product accumulates in fp32, and the batch sum of dbias is
// taken in fp32 from unrounded ds. A bf16 bias takes the JAX VJP's two
// roundings: the sum is cast to bf16, then scaled in fp32 and cast again.
// With a mask, JAX folds it into a per-(b*h) bias and sums that bias's
// gradient over the batch by the chain rule; here the bias stays
// head-shared: a blocked score is the constant -1e9, so its dS is 0 (the
// chain rule through JAX's `where`) and it adds nothing to dq, dk or dbias.
// Its P is 0 where the row has an open key; in a row with none (lse = -1e9,
// see mma_bf16.cuh) the forward averaged v, so P is 1/t there and dv gets
// do / t, the gradient of the JAX XLA path.
//
// Layout: q, k, v, do, dk, dv are (b, t, h, D) bf16, D = 64 or 128 (the
// wrapper zero-pads a smaller head dim); bias and dbias are (h, t, t), both
// bf16 or both fp32; `rows` holds each 64-row query tile's lse and delta rows
// side by side, (b*h, T/64, 2, 64) fp32 with T = t rounded up to 64, zeros
// past t; dq_acc is (b, t, h, D) fp32, zeroed by the caller; `part` is a
// scratch of (h, T, T) fp32 for the running batch sums of dbias followed by
// (h, T, T) in the bias dtype for the cached prefolded bias (unused at b = 1).
//
// What bounds it: operations, just. At the coarse training shape (b=8,
// t=862, h=20, d=64, fp32 bias) the five score-sized products are 76.1 GFLOP,
// 77 us at 989 TFLOP/s; q, k, v, do, dq, dk, dv (123.6 MB), the bias read and
// dbias written (118.9 MB) and lse and delta (1.1 MB) move 243.6 MB, 73 us at
// 3.35 TB/s. At b=1, t=2,048 the bias's 671 MB bound it by bytes. So the
// design computes each of the 5 products once, on `wgmma`, and moves the
// bias and the batch sums of dbias in whole tiles.
//
// Design (warp specialised, one block of three warpgroups per 64-key tile of
// one head; the block walks the batch rows and, in each, the query tiles):
//  * A producer warpgroup loads K and V of the batch row by TMA (4-D tensor
//    maps over (d, h, t, b), rows past t zero) and keeps a ring of query
//    tiles in flight: Q and dO by TMA, the tile's lse and delta rows by one
//    bulk copy, the bias and the mask tiles by TMA where a row of t elements
//    is a multiple of 16 bytes, else (the first batch row) one bulk copy per
//    bias row and 16-byte cp.async for the mask, as in the forward. The
//    consumers of the first batch row keep each prefolded bias tile in a
//    cache, so later rows bring it by one bulk copy: the producer's issue
//    rate of row copies bounded the kernel. Each stage has a full barrier
//    (transaction bytes and arrivals) and an empty one.
//  * Two consumer warpgroups take the query tiles in turn (even, odd), each
//    from its own half of the ring. With the keys as the 64 M rows, a
//    consumer prefolds Q in place and computes S^T = b_2^T + K Q_s^T (the
//    accumulator seeded with the prefolded bias) and dP^T = V dO^T as two
//    wgmma chains; P^T and dS^T stay in registers as the A operands of
//    dV += P^T dO and dK += dS^T Q_s (Q and dO read MN-major); dS^T also goes
//    to shared memory as bf16, the MN-major A operand of this tile's dQ part,
//    dS K. dK and dV stay in registers for the batch row; at its end the two
//    consumers exchange halves through shared memory, consumer 0 writes dK
//    and consumer 1 dV.
//  * dQ's part (scaled by q_scale) goes to an fp32 staging tile in the
//    128-byte swizzle and is added into dq_acc by one TMA reduce-add per 32
//    columns: no scalar atomics. Different key tiles add to one dq row in no
//    fixed order, so dq's last bits may differ from run to run; dk, dv and
//    dbias are summed in a fixed order and are bitwise reproducible.
//  * dbias: every (query, key) entry of one head belongs to one block, and
//    within it to one thread (a query tile always goes to the same
//    consumer). A batch row's dS tile goes, in fp32 and the consumers'
//    fragment order, through the staging tile into the running sums in
//    `part`: stored by the first row, added by one bulk reduce-add (at L2)
//    by later ones, each after the previous row's add has landed, so the
//    adds apply in batch order. The last row fetches the sums into the
//    staging tile while its first two products run and writes dbias in the
//    bias's dtype. The sums go to L2 with evict_last and the bias (or its
//    cache) comes with evict_first: the sums are what the next batch row
//    comes back to.
//  * Past the products, the time goes to moving the bias and the sums once
//    per batch row (PERF.md): the block's strips of both (220 and 229 KB at
//    t = 862) times the blocks in flight exceed L2.
//  * setmaxnreg hands the producer's registers to the consumers.
// See ops/flash_attention.py for the routes and PERF.md for the times.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace vampnet;

constexpr int BT = 64;   // rows per tile, keys and queries alike
constexpr int WG = 128;  // threads per warpgroup
constexpr int NC = 2;    // consumer warpgroups
constexpr int SMEM_LIMIT = 232448;
constexpr float LN2_F = 0.6931471805599453f;

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Shared-memory plan, byte offsets from a 1,024-byte aligned base: K and V
// (64 keys x D each, D/64 slabs of 64 rows x 128 bytes), each consumer's dS^T
// tile (64 keys x 64 queries bf16) and fp32 staging tile (64 x D), then the
// ring: per stage Q and dO (as K and V), the bias tile (64 query rows of
// BIAS_ROW bytes: the 16-byte chunks that cover a row's 64-key window; or the
// TMA tile; or a cached tile), the mask tile and the lse and delta rows; as
// many stages as fit,
// an even number up to 4 (consumer c owns stages c, c + 2), then the barriers.
template <int D, bool BIAS_BF16, bool MASKED>
struct Plan {
  static constexpr int THREADS = (NC + 1) * WG;
  static constexpr int ES = BIAS_BF16 ? 2 : 4;
  static constexpr int BIAS_ROW = (15 + BT * ES + 15) / 16 * 16;          // 144 or 272
  static constexpr int MASK_ROW = MASKED ? (15 + BT + 15) / 16 * 16 : 0;  // 80
  static constexpr int TILE = BT * D * 2;       // one bf16 tile: K, V, Q or dO
  static constexpr int DS_BYTES = BT * BT * 2;  // one consumer's dS^T tile
  static constexpr int STG_BYTES = BT * D * 4;  // one consumer's staging tile
  static constexpr int DS_OFF = 2 * TILE;
  static constexpr int STG_OFF = DS_OFF + NC * DS_BYTES;
  static constexpr int RING_OFF = STG_OFF + NC * STG_BYTES;
  static constexpr int BIAS_OFF = 2 * TILE;  // within a stage
  static constexpr int MASK_OFF = BIAS_OFF + BT * BIAS_ROW;
  static constexpr int LSE_OFF = MASK_OFF + BT * MASK_ROW;  // lse, then delta
  static constexpr int STAGE = (LSE_OFF + 2 * BT * 4 + 1023) / 1024 * 1024;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - RING_OFF - 256) / STAGE;
  static constexpr int STAGES = (FIT < 4 ? FIT : 4) & ~1;
  static constexpr int HS = STAGES / 2;  // stages per consumer
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE;
  static constexpr int SMEM = 1024 + BAR_OFF + (2 * STAGES + 2) * 8;
  // the producer's registers go to the consumers (setmaxnreg); the totals
  // fill the block's 168 x 384 = 64,512 (a larger sum never comes free)
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  static_assert(STAGES >= 2 && SMEM <= SMEM_LIMIT, "shared memory plan too large");
  static_assert(MASK_OFF % 1024 == 0 && STG_OFF % 1024 == 0, "TMA tiles start 1,024-byte aligned");
  static_assert(WG * PRODUCER_REGS + NC * WG * CONSUMER_REGS <= 64512, "register plan");
};

// Byte offset of the k16 step kk in a K-major tile of D/64 slabs.
__device__ __forceinline__ uint32_t kmajor_step(int kk) {
  return (kk >> 2) * (64 * 128) + (kk & 3) * 32;
}

// The prefolded bias of two entries (two query rows at one key): b * log2(e),
// rounded back to the bias dtype, a bf16 pair by one F2FP as the forward
// rounds it.
template <bool BIAS_BF16>
__device__ __forceinline__ float2 prefold2(const unsigned char* a, const unsigned char* b) {
  if (BIAS_BF16) {
    const __nv_bfloat162 r = __floats2bfloat162_rn(
        __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(a)) * LOG2E_F,
        __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(b)) * LOG2E_F);
    return make_float2(__low2float(r), __high2float(r));
  } else {
    return make_float2(*reinterpret_cast<const float*>(a) * LOG2E_F,
                       *reinterpret_cast<const float*>(b) * LOG2E_F);
  }
}

// dbias from the batch sum g of one entry, with the prefold's chain rule.
template <bool BIAS_BF16>
__device__ __forceinline__ void store_dbias(void* dbias, size_t at, float g) {
  if (BIAS_BF16) {
    const float g2 = __bfloat162float(__float2bfloat16_rn(g));
    static_cast<__nv_bfloat16*>(dbias)[at] = __float2bfloat16_rn(g2 * LOG2E_F);
  } else {
    static_cast<float*>(dbias)[at] = g * LOG2E_F;
  }
}


template <int D, bool BIAS_BF16, bool MASKED>
__global__ void __launch_bounds__(Plan<D, BIAS_BF16, MASKED>::THREADS, 1) attention_bwd_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_dq, const __grid_constant__ CUtensorMap tm_bias,
    const __grid_constant__ CUtensorMap tm_mask, const void* __restrict__ bias,
    const uint8_t* __restrict__ mask, const float* __restrict__ rows,
    __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, void* __restrict__ dbias, float* __restrict__ part, int b,
    int t, int h, float q_scale, int bias_tma, int mask_tma) {
  using P = Plan<D, BIAS_BF16, MASKED>;
  constexpr int HS = P::HS;
  constexpr int SLABS = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar0 = sbase + P::BAR_OFF;  // full[ST], empty[ST], kv full, kv empty
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (P::STAGES + s); };
  const uint32_t kv_full = bar0 + 16 * P::STAGES;
  const uint32_t kv_empty = kv_full + 8;

  // block -> (head, key tile), the key tile innermost: the blocks of one head
  // read the same Q and dO tiles at about the same time
  const int n_t = (t + BT - 1) / BT;
  const int hi = blockIdx.x / n_t;
  const int kt = blockIdx.x % n_t;
  const int k0 = kt * BT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      // thread 0's arrival with the TMA and row bytes, one per producer
      // warp with its bulk copies' bytes, and with a mask one per producer
      // thread once its cp.async copies have landed
      mbar_init(full(s), 1 + WG / 32 + (MASKED ? WG : 0));
      mbar_init(empty(s), 1);
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, NC);
    fence_barrier_init();
  }
  __syncthreads();

  const uintptr_t bias_addr = reinterpret_cast<uintptr_t>(bias);
  const uintptr_t mask_addr = reinterpret_cast<uintptr_t>(mask);
  // Where the bias rows are not TMA rows, the first batch row copies them row
  // by row and its consumers keep each tile's prefolded b_2 in the bias
  // dtype, in fragment order, in a cache after the running sums; later rows
  // bring a tile back with one bulk copy. The order is safe where every
  // consumer has at least HS tiles a row (its release of a later tile's stage
  // follows its cache writes).
  const bool cache_b2 = b > 1 && !bias_tma && n_t >= 2 * HS;
  const unsigned char* b2_cache = reinterpret_cast<const unsigned char*>(
      part + (size_t)h * n_t * n_t * BT * BT);
  auto b2_tile = [&](int j) {
    return b2_cache + ((size_t)(hi * n_t + kt) * n_t + j) * BT * BT * P::ES;
  };

  if (threadIdx.x < WG) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<P::PRODUCER_REGS>();
    const int pt = threadIdx.x;
    const uintptr_t bias_end = bias_addr + (size_t)h * t * t * P::ES;
    const uintptr_t mask_end = mask_addr + (size_t)b * t * t;
    int filled0 = 0, filled1 = 0;  // query tiles handed to each consumer
    for (int bi = 0; bi < b; ++bi) {
      if (pt == 0) {
        if (bi > 0) mbar_wait(kv_empty, (bi - 1) & 1);
        mbar_arrive_expect_tx(kv_full, 2 * P::TILE);
        for (int sl = 0; sl < SLABS; ++sl) {
          tma_load_4d(sbase + sl * 8192, &tm_k, kv_full, sl * 64, hi, k0, bi);
          tma_load_4d(sbase + P::TILE + sl * 8192, &tm_v, kv_full, sl * 64, hi, k0, bi);
        }
      }
      for (int j = 0; j < n_t; ++j) {
        const int mm = (j & 1) ? filled1++ : filled0++;
        const int s = (j & 1) + 2 * (mm % HS);
        mbar_wait(empty(s), ((mm / HS) & 1) ^ 1);
        const int q0 = j * BT;
        const uint32_t sst = sbase + P::RING_OFF + s * P::STAGE;
        unsigned char* st = smem + P::RING_OFF + s * P::STAGE;
        const bool from_cache = cache_b2 && bi > 0;
        if (pt == 0) {
          mbar_arrive_expect_tx(full(s), 2 * P::TILE + 2 * BT * 4 +
                                             (bias_tma || from_cache ? BT * BT * P::ES : 0) +
                                             (MASKED && mask_tma ? BT * BT : 0));
          for (int sl = 0; sl < SLABS; ++sl) {
            tma_load_4d(sst + sl * 8192, &tm_q, full(s), sl * 64, hi, q0, bi);
            tma_load_4d(sst + P::TILE + sl * 8192, &tm_do, full(s), sl * 64, hi, q0, bi);
          }
          // the tile's lse and delta rows, 512 contiguous bytes
          bulk_load(sst + P::LSE_OFF, rows + (((size_t)bi * h + hi) * n_t + j) * 2 * BT, 2 * BT * 4,
                    full(s));
          // where rows of t elements are 16-byte aligned, the bias tile (in
          // halves of 32 keys for fp32) and the mask tile come as TMA boxes
          for (int half = 0; bias_tma && half < P::ES / 2; ++half) {
            tma_load_2d(sst + P::BIAS_OFF + half * BT * 128, &tm_bias, full(s), k0 + 32 * half,
                        hi * t + q0);
          }
          if (MASKED && mask_tma) {
            tma_load_2d(sst + P::MASK_OFF, &tm_mask, full(s), k0, bi * t + q0);
          }
          if (from_cache) {
            bulk_load_hint(sst + P::BIAS_OFF, b2_tile(j), BT * BT * P::ES, full(s),
                           policy_evict_first());
          }
        }
        // otherwise one bias row per thread (0..63), a bulk copy each; each
        // warp's bytes are added to the stage's transactions by one arrival,
        // before its copies are issued
        {
          uintptr_t src = 0;
          uint32_t bytes = 0;
          if (!bias_tma && !from_cache && pt < BT && q0 + pt < t) {
            bytes = row_window<P::BIAS_ROW>(
                st + P::BIAS_OFF + pt * P::BIAS_ROW,
                bias_addr + (((size_t)hi * t + q0 + pt) * t + k0) * P::ES, bias_end, src);
          }
          const uint32_t warp_bytes = __reduce_add_sync(0xffffffffu, bytes);
          __syncwarp();  // orders the plain stores before the arrival
          if ((pt & 31) == 0) mbar_arrive_expect_tx(full(s), warp_bytes);
          __syncwarp();
          if (bytes) {
            bulk_load_hint(sst + P::BIAS_OFF + pt * P::BIAS_ROW, reinterpret_cast<const void*>(src),
                           bytes, full(s), policy_evict_first());
          }
        }
        // the mask tile by 16-byte cp.async, neighbouring threads on
        // neighbouring chunks of a row
        if constexpr (MASKED) {
          constexpr int CH = P::MASK_ROW / 16;
          for (int id = pt; !mask_tma && id < BT * CH; id += WG) {
            const int lr = id / CH;
            const int ch = id - lr * CH;
            if (q0 + lr < t) {
              const uintptr_t src =
                  ((mask_addr + ((size_t)bi * t + q0 + lr) * t + k0) & ~uintptr_t(15)) + ch * 16;
              const int n =
                  src + 16 <= mask_end ? 16 : (src < mask_end ? (int)(mask_end - src) : 0);
              cp_async_16(sst + P::MASK_OFF + lr * P::MASK_ROW + ch * 16,
                          reinterpret_cast<const void*>(n ? src : (mask_addr & ~uintptr_t(15))),
                          n);
            }
          }
          cp_async_mbar_arrive(full(s));
        }
      }
    }
    // stay until the consumers have released every stage
    for (int i = 0; i < HS; ++i) {
      mbar_wait(empty(2 * ((filled0 + i) % HS)), (((filled0 + i) / HS) & 1) ^ 1);
      mbar_wait(empty(1 + 2 * ((filled1 + i) % HS)), (((filled1 + i) / HS) & 1) ^ 1);
    }
  } else {
    // ------------------------------------------------------------ consumers
    setmaxnreg_inc<P::CONSUMER_REGS>();
    const int cw = threadIdx.x / WG - 1;  // consumer: query tiles cw, cw + 2, ...
    const int ct = threadIdx.x % WG;
    const int warp = ct >> 5;
    const int lane = ct & 31;
    const int g = lane >> 2;  // fragment row group
    const int tg = lane & 3;  // thread in group
    // this thread's two accumulator rows: keys of S^T, dK, dV; queries of dQ
    const int kr[2] = {16 * warp + g, 16 * warp + g + 8};
    const bool key_ok[2] = {k0 + kr[0] < t, k0 + kr[1] < t};
    const float inv_t = 1.f / (float)t;
    // this block's running dbias sums: one tile of 64 x 64 per query tile,
    // in fragment order (float2 2 jn + r of thread ct at (2 jn + r) * WG + ct)
    float* strip = part + (size_t)(hi * n_t + kt) * n_t * BT * BT;
    // query tiles per batch row of this consumer, and the bulk groups it
    // commits per tile (the dbias sums, dQ): a tile's sums of the previous
    // batch row were committed in the group 2 nw back
    const int nw = (n_t - cw + 1) / 2;
    unsigned char* sds = smem + P::DS_OFF + cw * P::DS_BYTES;
    unsigned char* stg = smem + P::STG_OFF + cw * P::STG_BYTES;
    const uint32_t stg_u = smem_u32(stg);
    const uint64_t desc_k = gmma_desc(sbase, 16, 1024);
    const uint64_t desc_v = gmma_desc(sbase + P::TILE, 16, 1024);
    const uint64_t desc_k_mn = gmma_desc(sbase, 64 * 128, 1024);
    const uint64_t desc_ds = gmma_desc(smem_u32(sds), 64 * 128, 1024);
    // where a query row's 64 keys begin past the 16-byte boundary below them
    // in its bias window: (bias_skew + row * row_skew) % 16 for row 0..63 of
    // any query tile
    const uint32_t bias_skew = (uint32_t)((bias_addr + ((size_t)hi * t * t + k0) * P::ES) & 15);
    const uint32_t row_skew = (uint32_t)(((size_t)t * P::ES) & 15);

    float dk_acc[D / 2], dv_acc[D / 2];

    // One query tile (rows q0.., stage s, this consumer's mm-th) of batch row bi.
    auto tile = [&](auto edge, int bi, int q0, int s, int mm) {
      unsigned char* st = smem + P::RING_OFF + s * P::STAGE;
      const uint32_t sst = sbase + P::RING_OFF + s * P::STAGE;
      mbar_wait(full(s), (mm / HS) & 1);
      // the q prefold, in place, then made visible to wgmma (the async proxy)
      for (int c = ct; c < BT * D / 8; c += WG) {
        uint4 v = reinterpret_cast<uint4*>(st)[c];
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          e[i] = __floats2bfloat162_rn(__low2float(e[i]) * q_scale, __high2float(e[i]) * q_scale);
        }
        reinterpret_cast<uint4*>(st)[c] = v;
      }
      fence_proxy_async();
      if (ct == 0) {
        // the staging tile is free (every reduce has read it), and this
        // tile's dbias sums of the previous batch row have landed: the
        // reduce-adds of one entry apply in batch order
        if (nw >= 2) {
          bulk_wait<2, false>();
        } else {
          bulk_wait<0, false>();
        }
        bulk_wait<0, true>();
        fence_proxy_async_global();
      }
      named_bar_sync(1 + cw, WG);
      // the last batch row fetches the running dbias sums into the staging
      // tile while the products run: float2 2 jn + r of thread ct holds
      // query columns 8 jn + 2 tg, + 1 of key row kr[r]
      const float2* prev = reinterpret_cast<const float2*>(stg);
      float* sums = strip + (size_t)(q0 / BT) * BT * BT;
      const bool last = bi == b - 1;
      if (last && bi > 0) {
        const uint64_t once = policy_evict_first();
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          cp_async_8(stg_u + (i * WG + ct) * 8, sums + 2 * (i * WG + ct), once);
        }
      }
      const uint64_t desc_q = gmma_desc(sst, 16, 1024);
      const uint64_t desc_do = gmma_desc(sst + P::TILE, 16, 1024);
      const uint64_t desc_q_mn = gmma_desc(sst, 64 * 128, 1024);
      const uint64_t desc_do_mn = gmma_desc(sst + P::TILE, 64 * 128, 1024);

      // S^T = b_2^T + K Q_s^T and dP^T = V dO^T, 64 keys x 64 queries:
      // sc[4 jn + e] is key row kr[e >> 1], query column 8 jn + 2 tg + (e & 1)
      float sc[32], dp[32];
      const unsigned char* bst = st + P::BIAS_OFF;
      auto seed = [&](int jn, int r, float2 b2) {
        sc[4 * jn + 2 * r] = b2.x;
        sc[4 * jn + 2 * r + 1] = b2.y;
        dp[4 * jn + 2 * r] = 0.f;
        dp[4 * jn + 2 * r + 1] = 0.f;
      };
      if (cache_b2 && bi > 0) {
        // the cached tile, in fragment order: entry 2 jn + r of thread ct
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const unsigned char* at = bst + (i * WG + ct) * 2 * P::ES;
          seed(i >> 1, i & 1,
               BIAS_BF16 ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at))
                         : *reinterpret_cast<const float2*>(at));
        }
      } else if (bias_tma) {
        // the TMA tile: rows of 128 bytes (fp32: two halves of 32 keys),
        // 16-byte chunks swizzled by row % 8
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int qa = 8 * (i >> 1) + 2 * tg;
          const int kc = kr[i & 1];
          const int byte = BIAS_BF16 ? 2 * kc : 4 * (kc & 31);
          const int half = BIAS_BF16 ? 0 : (kc >> 5) * BT * 128;
          const int oa = half + qa * 128 + ((((byte >> 4) ^ qa) & 7) << 4) + (byte & 15);
          const int ob = half + (qa + 1) * 128 + ((((byte >> 4) ^ (qa + 1)) & 7) << 4) + (byte & 15);
          seed(i >> 1, i & 1, prefold2<BIAS_BF16>(bst + oa, bst + ob));
        }
      } else {
        // the row windows; the first batch row also fills the cache
        unsigned char* cache = const_cast<unsigned char*>(b2_tile(q0 / BT));
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int qa = 8 * (i >> 1) + 2 * tg;
          const int kc = kr[i & 1];
          const int oa = qa * P::BIAS_ROW + ((bias_skew + qa * row_skew) & 15) + kc * P::ES;
          const int ob = (qa + 1) * P::BIAS_ROW + ((bias_skew + (qa + 1) * row_skew) & 15) + kc * P::ES;
          const float2 b2 = prefold2<BIAS_BF16>(bst + oa, bst + ob);
          seed(i >> 1, i & 1, b2);
          if (cache_b2) {
            unsigned char* c = cache + (i * WG + ct) * 2 * P::ES;
            if (BIAS_BF16) {
              *reinterpret_cast<__nv_bfloat162*>(c) = __floats2bfloat162_rn(b2.x, b2.y);
            } else {
              *reinterpret_cast<float2*>(c) = b2;
            }
          }
        }
      }
      // the cache writes, ordered before the bulk copies that read them back
      // (after this consumer's release of a later stage)
      if (cache_b2 && bi == 0) fence_proxy_async_global();
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_m64n64k16_ss(sc, desc_k + (kmajor_step(kk) >> 4), desc_q + (kmajor_step(kk) >> 4), 1);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_m64n64k16_ss(dp, desc_v + (kmajor_step(kk) >> 4), desc_do + (kmajor_step(kk) >> 4),
                           1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // Per 8 query columns: P^T = exp2(S^T - lse) and dS^T = P^T (dP^T -
      // delta) ln 2; where the mask blocks, dS is 0 and P is 0, or 1/t in a
      // row with no open key; on an edge tile entries past t are 0. Both go
      // to bf16 A fragments (k16 step jn / 2), dS^T also to shared memory
      // (key rows of 64 queries, 128 bytes, 16-byte chunks swizzled by
      // row % 8 = g: the MN-major A operand of dQ), and dS into the running
      // dbias sums in fp32; the last batch row writes dbias itself.
      const float* slse = reinterpret_cast<const float*>(st + P::LSE_OFF);
      const unsigned char* mst = st + P::MASK_OFF;
      const uint32_t mask_skew =
          MASKED ? (uint32_t)((mask_addr + (size_t)bi * t * t + k0) & 15) : 0u;
      if (last && bi > 0) cp_async_wait_all();
      uint32_t pa[BT / 16][4], da[BT / 16][4];
#pragma unroll
      for (int jn = 0; jn < BT / 8; ++jn) {
        const int qa = 8 * jn + 2 * tg;
        const float2 l2 = *reinterpret_cast<const float2*>(slse + qa);
        const float2 d2 = *reinterpret_cast<const float2*>(slse + BT + qa);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = qa + (e & 1);
          const int r = e >> 1;
          const float lq = (e & 1) ? l2.y : l2.x;
          const float dq = (e & 1) ? d2.y : d2.x;
          p[e] = exp2_ftz(sc[4 * jn + e] - lq);
          ds[e] = p[e] * (dp[4 * jn + e] - dq) * LN2_F;
          if constexpr (MASKED) {
            const int at =
                mask_tma ? qc * 64 + ((((kr[r] >> 4) ^ (qc >> 1)) & 3) << 4) + (kr[r] & 15)
                         : qc * P::MASK_ROW + (int)((mask_skew + (uint32_t)qc * (uint32_t)t) & 15) +
                               kr[r];
            if (!mst[at]) {
              p[e] = lq < FULLY_BLOCKED_LSE ? inv_t : 0.f;
              ds[e] = 0.f;
            }
          }
          if (decltype(edge)::value && !(q0 + qc < t && key_ok[r])) {
            p[e] = 0.f;
            ds[e] = 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          pa[jn >> 1][2 * (jn & 1) + r] = pack_bf16x2(p[2 * r], p[2 * r + 1]);
          da[jn >> 1][2 * (jn & 1) + r] = pack_bf16x2(ds[2 * r], ds[2 * r + 1]);
          *reinterpret_cast<uint32_t*>(sds + kr[r] * 128 + (((jn ^ g) & 7) << 4) + 4 * tg) =
              da[jn >> 1][2 * (jn & 1) + r];
          // dS of this batch row to the staging tile, for the reduce-add
          // into the running sums; the last row adds the sums and writes dbias
          if (!last) {
            reinterpret_cast<float2*>(stg)[(2 * jn + r) * WG + ct] = make_float2(ds[2 * r], ds[2 * r + 1]);
          } else if (key_ok[r]) {
            float gx = ds[2 * r];
            float gy = ds[2 * r + 1];
            if (bi > 0) {
              const float2 pv = prev[(2 * jn + r) * WG + ct];
              gx = pv.x + gx;
              gy = pv.y + gy;
            }
            const size_t row = ((size_t)hi * t + q0 + qa) * t + k0 + kr[r];
            if (!decltype(edge)::value || q0 + qa < t) store_dbias<BIAS_BF16>(dbias, row, gx);
            if (!decltype(edge)::value || q0 + qa + 1 < t) {
              store_dbias<BIAS_BF16>(dbias, row + t, gy);
            }
          }
        }
      }

      // dV += P^T dO and dK += dS^T Q_s, Q and dO read MN-major
      fence_proxy_async();  // the dS^T tile, for the dQ product
      fence_regs(dk_acc);
      fence_regs(dv_acc);
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        if constexpr (D == 64) {
          wgmma_m64n64k16_rs(dv_acc, pa[kk], desc_do_mn + ((kk * 2048) >> 4), 1);
        } else {
          wgmma_m64n128k16_rs(dv_acc, pa[kk], desc_do_mn + ((kk * 2048) >> 4), 1);
        }
      }
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        if constexpr (D == 64) {
          wgmma_m64n64k16_rs(dk_acc, da[kk], desc_q_mn + ((kk * 2048) >> 4), 1);
        } else {
          wgmma_m64n128k16_rs(dk_acc, da[kk], desc_q_mn + ((kk * 2048) >> 4), 1);
        }
      }
      wgmma_commit();
      // the dS^T tile is whole, and so is this row's dS in the staging tile
      // (the last row: every thread has read its running sums from it)
      named_bar_sync(1 + cw, WG);
      const bool add_sums = !last;
      if (add_sums && ct == 0) {
        // the first batch row stores its dS, later ones add theirs
        if (bi == 0) {
          bulk_store(sums, stg_u, BT * BT * 4, policy_evict_last());
        } else {
          bulk_reduce_add_f32(sums, stg_u, BT * BT * 4, policy_evict_last());
        }
        bulk_commit();
      }

      // dQ's part = dS K (both MN-major), 64 columns at a time, scaled by the
      // q prefold's factor into the staging tile: boxes of 32 columns, rows
      // of 128 bytes, 16-byte chunks swizzled by row % 8 (= g)
#pragma unroll
      for (int half = 0; half < D / 64; ++half) {
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk) {
          wgmma_m64n64k16_ss_mn(acc, desc_ds + ((kk * 2048) >> 4),
                                desc_k_mn + ((half * 8192 + kk * 2048) >> 4), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        if (half == 0 && add_sums) {
          if (ct == 0) bulk_wait<0, true>();  // the sums' copy has read the staging tile
          named_bar_sync(1 + cw, WG);
        }
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const int c = 8 * jn + 2 * tg;
          const int byte = (c & 31) * 4;
          const int box = half * 2 + (c >> 5);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            *reinterpret_cast<float2*>(stg + box * BT * 128 + kr[r] * 128 +
                                       ((((byte >> 4) ^ g) & 7) << 4) + (byte & 15)) =
                make_float2(acc[4 * jn + 2 * r] * q_scale, acc[4 * jn + 2 * r + 1] * q_scale);
          }
        }
      }
      fence_regs(dk_acc);
      fence_regs(dv_acc);
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
      fence_proxy_async();
      named_bar_sync(1 + cw, WG);
      if (ct == 0) {
        // every warp's part of every product that read the stage has
        // retired: it is free
        mbar_arrive(empty(s));
        for (int box = 0; box < D / 32; ++box) {
          tma_reduce_add_4d(&tm_dq, stg_u + box * BT * 128, box * 32, hi, q0, bi);
        }
        bulk_commit();
      }
    };

    // The batch row's dK or dV, from the accumulators, rows past t dropped.
    auto store_rows = [&](const float(&acc)[D / 2], __nv_bfloat16* out) {
      const size_t row_stride = (size_t)h * D;
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) {
        const int col = jd * 8 + tg * 2;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (key_ok[r]) {
            *reinterpret_cast<uint32_t*>(out + (size_t)(k0 + kr[r]) * row_stride + col) =
                pack_bf16x2(acc[4 * jd + 2 * r], acc[4 * jd + 2 * r + 1]);
          }
        }
      }
    };

    int mm = 0;
    for (int bi = 0; bi < b; ++bi) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      mbar_wait(kv_full, bi & 1);
      for (int j = cw; j < n_t; j += NC, ++mm) {
        const int s = cw + 2 * (mm % HS);
        const int q0 = j * BT;
        if (k0 + BT > t || q0 + BT > t) {
          tile(Flag<true>{}, bi, q0, s, mm);
        } else {
          tile(Flag<false>{}, bi, q0, s, mm);
        }
      }
      // every product of the batch row has retired: K and V are free
      if (ct == 0) mbar_arrive(kv_empty);
      // dK and dV are each the sum of the two consumers' parts: consumer 0
      // hands its dV to consumer 1 and finishes dK, consumer 1 the reverse,
      // through the staging tiles (register-major, conflict-free)
      if (ct == 0) bulk_wait<0, true>();
      named_bar_sync(3, NC * WG);
      float* mine = reinterpret_cast<float*>(stg);
      const float* theirs = reinterpret_cast<const float*>(smem + P::STG_OFF +
                                                           (1 - cw) * P::STG_BYTES);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) mine[i * WG + ct] = cw == 0 ? dv_acc[i] : dk_acc[i];
      named_bar_sync(3, NC * WG);
      if (cw == 0) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dk_acc[i] += theirs[i * WG + ct];
      } else {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dv_acc[i] += theirs[i * WG + ct];
      }
      named_bar_sync(3, NC * WG);  // both are done with the staging tiles
      const size_t base = (size_t)bi * t * h * D + (size_t)hi * D;
      if (cw == 0) {
        store_rows(dk_acc, dk + base);
      } else {
        store_rows(dv_acc, dv + base);
      }
    }
    if (ct == 0) bulk_wait<0, false>();  // the last reduce-adds have landed
  }
}

template <int D, bool BIAS_BF16, bool MASKED>
int launch_bwd_d(const void* q, const void* k, const void* v, const void* dout, const void* bias,
                 const void* mask, const void* rows, void* dq_acc, void* dk,
                 void* dv, void* dbias, void* part, int b, int t, int h, float q_scale,
                 cudaStream_t s) {
  using P = Plan<D, BIAS_BF16, MASKED>;
  CUtensorMap tq, tk, tv, tdo, tdq, tb = {}, tm = {};
  if (!encode_bthd_map(&tq, q, b, t, h, D) || !encode_bthd_map(&tk, k, b, t, h, D) ||
      !encode_bthd_map(&tv, v, b, t, h, D) || !encode_bthd_map(&tdo, dout, b, t, h, D)) {
    return (int)cudaErrorInvalidValue;
  }
  {
    // dq_acc (b, t, h, D) fp32 as (d, h, t, b): boxes of 32 columns x 64 rows
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)h, (cuuint64_t)t, (cuuint64_t)b};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 4, (cuuint64_t)h * D * 4,
                                   (cuuint64_t)t * h * D * 4};
    const cuuint32_t box[4] = {32, 1, BT, 1};
    if (!encode_map(&tdq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dq_acc, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  // TMA takes the bias and mask rows (t elements apart) where t elements
  // make a multiple of 16 bytes; else the kernel copies them row by row
  const bool bias_tma =
      reinterpret_cast<uintptr_t>(bias) % 16 == 0 && (long long)t * P::ES % 16 == 0;
  if (bias_tma) {
    const cuuint64_t dims[2] = {(cuuint64_t)t, (cuuint64_t)h * t};
    const cuuint64_t strides[1] = {(cuuint64_t)t * P::ES};
    const cuuint32_t box[2] = {(cuuint32_t)(128 / P::ES), (cuuint32_t)BT};
    if (!encode_map(&tb, BIAS_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                    2, bias, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const bool mask_tma = MASKED && reinterpret_cast<uintptr_t>(mask) % 16 == 0 && t % 16 == 0;
  if (mask_tma) {
    const cuuint64_t dims[2] = {(cuuint64_t)t, (cuuint64_t)b * t};
    const cuuint64_t strides[1] = {(cuuint64_t)t};
    const cuuint32_t box[2] = {(cuuint32_t)BT, (cuuint32_t)BT};
    if (!encode_map(&tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, mask, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_64B)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const long long blocks = (long long)h * ((t + BT - 1) / BT);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  return (int)launch(attention_bwd_kernel<D, BIAS_BF16, MASKED>, dim3((unsigned)blocks),
                     P::THREADS, (size_t)P::SMEM, s, tq, tk, tv, tdo, tdq, tb, tm, bias,
                     static_cast<const uint8_t*>(mask), static_cast<const float*>(rows),
                     static_cast<__nv_bfloat16*>(dk),
                     static_cast<__nv_bfloat16*>(dv), dbias, static_cast<float*>(part), b, t, h,
                     q_scale, bias_tma ? 1 : 0, mask_tma ? 1 : 0);
}

template <bool BIAS_BF16, bool MASKED>
int launch_bwd(int d, const void* q, const void* k, const void* v, const void* dout,
               const void* bias, const void* mask, const void* rows,
               void* dq_acc, void* dk, void* dv, void* dbias, void* part, int b, int t, int h,
               float q_scale, cudaStream_t s) {
  if (d == 64) {
    return launch_bwd_d<64, BIAS_BF16, MASKED>(q, k, v, dout, bias, mask, rows, dq_acc, dk,
                                               dv, dbias, part, b, t, h, q_scale, s);
  }
  return launch_bwd_d<128, BIAS_BF16, MASKED>(q, k, v, dout, bias, mask, rows, dq_acc, dk,
                                              dv, dbias, part, b, t, h, q_scale, s);
}

}  // namespace

// The one backward entry point: a head dim d of 64 or 128 (the wrapper
// zero-pads q, k, v and do up to one of them and passes q_scale for the
// unpadded d), a bf16 or fp32 bias, a mask that is null or (b, t, t) bytes,
// 0 = blocked; dbias is written in the bias's dtype. q, k, v, do and dq_acc
// are 16-byte aligned; `part` is an fp32 scratch of (h, T, T), T = t rounded
// up to 64, and may be null at b = 1.
extern "C" int vampnet_attention_bwd(const void* q, const void* k, const void* v,
                                     const void* bias, int bias_is_bf16, const void* mask,
                                     const void* rows, const void* dout, void* dq_acc, void* dk,
                                     void* dv, void* dbias, void* part, int b, int t, int h,
                                     int d, float q_scale, int device, void* stream) {
  if (b <= 0 || t <= 0 || h <= 0 || (d != 64 && d != 128) || (b > 1 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask != nullptr) {
    return bias_is_bf16 ? launch_bwd<true, true>(d, q, k, v, dout, bias, mask, rows, dq_acc, dk,
                                                 dv, dbias, part, b, t, h, q_scale, s)
                        : launch_bwd<false, true>(d, q, k, v, dout, bias, mask, rows, dq_acc, dk,
                                                  dv, dbias, part, b, t, h, q_scale, s);
  }
  return bias_is_bf16 ? launch_bwd<true, false>(d, q, k, v, dout, bias, mask, rows, dq_acc, dk,
                                                dv, dbias, part, b, t, h, q_scale, s)
                      : launch_bwd<false, false>(d, q, k, v, dout, bias, mask, rows, dq_acc, dk,
                                                 dv, dbias, part, b, t, h, q_scale, s);
}


