// Fused RMSNorm + GEGLU feed-forward + residual for Hopper (sm_90a).
//
// Port of the Pallas kernel `_ffn_kernel` in vampnet_tpu/ops/ffn_kernel.py:44
// (`fused_geglu_ffn` :73). For x (m, d) bf16, the RMSNorm scale nw (d,) fp32,
// w1 (2f, d) and w2 (d, f) bf16 in the port's (out, in) layout, f hidden
// units (f = 2d for a whole layer):
//   y   = bf16(x * rsqrt(mean(x^2) + eps) * nw)        (fp32 statistics)
//   p1  = y w1[0:f]^T,  p2 = y w1[f:2f]^T              (fp32 accumulation)
//   g   = bf16(p1 * gelu_tanh(p2))                     (fp32, tanhf)
//   out = bf16(x + g w2^T)                             (fp32 accumulation and add)
// The first half of w1's rows is the value and the second the gate, as
// jnp.split of the JAX (d, 4d) kernel's columns. A tensor-parallel shard
// holds f = 2d / tp units (its block of each half) and w2's matching
// columns; its output is a partial sum, and without add_x the residual is
// left out (out = bf16(g w2^T)), so that one shard of the sum adds it.
//
// What bounds it: 2 m d 6d operations, 34 us at the coarse serving shape
// (m = 1,724, d = 1,280) at 989 TFLOP/s, 41 us at c2f (m = 2,072); the
// bytes (x, out and the 19.7 MB of weights) take 7 us.
//
// Design. The TPU kernel keeps a (rows, d) fp32 accumulator across the whole
// hidden sweep in VMEM; at d = 1280 that is 320 KB for 64 rows, more than an
// SM holds, and a block that owns a few rows and sweeps every weight reads
// all 19.7 MB of them from L2 for those rows alone. So the function is three
// kernels on one stream, each tile of the two products reading its weight
// tile once for 128 rows:
//  * rms_norm_kernel: one warp per row writes y (m, d) bf16 to scratch;
//  * ffn_gemm_kernel<BN, true> (the up-projection): a persistent,
//    warp-specialised GEMM over 128 x BN tiles of the hidden width. A
//    producer warp keeps a ring of stages in flight, each 64 columns of k of
//    y (128 rows) and of the value rows [f0, f0 + BN) and the gate rows
//    [f + f0, f + f0 + BN) of w1, brought by TMA with the 128-byte
//    swizzle (both operands K-major, as the (out, in) layout has them). Two
//    consumer warpgroups of 64 rows each hold two accumulators of one
//    layout, so each thread holds p1 and p2 of the same (row, unit) pairs;
//    the epilogue forms g there and stores it through shared memory to
//    scratch g (m, f) bf16 with the L2 evict_last policy (8.8-10.6 MB at
//    the serving shapes, well inside the 50 MB L2). The fp32 pre-activation
//    never leaves registers;
//  * ffn_gemm_kernel<BN, false> (the down-projection): the same GEMM over
//    g and w2 (both K-major), whose epilogue adds the residual in fp32 and
//    stores bf16 through shared memory, 16 bytes a thread.
// The two GEMMs start by programmatic dependent launch: each fetches its
// first weight tiles while the kernel before it finishes. BN is chosen per
// (m, n) so that the tiles fill whole waves of SMs (`vampnet_geglu_ffn_
// block_n` reports it). Rows past m and columns past n arrive as zeros and
// are never stored. No atomics: the output is deterministic. ops/ffn_kernel.py
// has the wrapper.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace vampnet;

constexpr int NORM_ROWS = 8;    // rows per RMSNorm block, one warp each
constexpr int NORM_CHUNKS = 8;  // 16-byte chunks of a row a lane holds at once
constexpr int BM = 128;       // rows per tile: two consumer warpgroups of 64
constexpr int BK = 64;        // bf16 of k per stage (the 128-byte swizzle's row)
constexpr int ROW_BYTES = 2 * BK;
constexpr int WG = 128;  // threads per warpgroup
constexpr int THREADS = 3 * WG;
constexpr int SMEM_LIMIT = 232448;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(WG * PRODUCER_REGS + 2 * WG * CONSUMER_REGS <= 65536, "register plan");

// tanh-form GELU in fp32, each step rounded as written (no contraction to FMA).
__device__ __forceinline__ float gelu_tanh(float v) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float inner = __fmul_rn(c, __fadd_rn(v, __fmul_rn(0.044715f, __fmul_rn(__fmul_rn(v, v), v))));
  return __fmul_rn(v, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

// Eight consecutive norm weights, widened to fp32 (bf16 widens exactly);
// the eight are 16-byte (bf16) or 32-byte (fp32) aligned.
__device__ __forceinline__ void load8(const float* p, float f[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float f[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(e[i]);
}

// One warp per row, 16 bytes a lane: y = bf16(x * rsqrt(mean(x^2) + eps) * nw),
// nw read in its stored type (bf16 or fp32). A lane holds up to NORM_CHUNKS
// of its 16-byte chunks at once, all loads in flight together (the whole
// row up to d = 2,048); wider rows go in batches, read again for the scaling.
template <typename W>
__global__ void __launch_bounds__(NORM_ROWS * 32) rms_norm_kernel(
    const __nv_bfloat16* __restrict__ x, const W* __restrict__ nw,
    __nv_bfloat16* __restrict__ y, int m, int d, float eps) {
  // the up-projection may start its set-up now; it waits for this grid
  // before it reads y
  griddep_launch_dependents();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * NORM_ROWS + (threadIdx.x >> 5);
  if (row >= m) return;
  const __nv_bfloat16* xr = x + (size_t)row * d;
  __nv_bfloat16* yr = y + (size_t)row * d;
  constexpr int BATCH = 256 * NORM_CHUNKS;  // elements of a row a warp holds
  uint4 u[NORM_CHUNKS];
  float ss = 0.f;
  for (int base = 0; base < d; base += BATCH) {
#pragma unroll
    for (int k = 0; k < NORM_CHUNKS; ++k) {
      const int c = base + lane * 8 + 256 * k;
      if (c < d) u[k] = *reinterpret_cast<const uint4*>(xr + c);
    }
#pragma unroll
    for (int k = 0; k < NORM_CHUNKS; ++k) {
      if (base + lane * 8 + 256 * k < d) {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u[k]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float f = __bfloat162float(e[i]);
          ss += f * f;
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float rs = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)d), eps));
  for (int base = 0; base < d; base += BATCH) {
#pragma unroll
    for (int k = 0; k < NORM_CHUNKS; ++k) {
      const int c = base + lane * 8 + 256 * k;
      if (c < d) {
        if (d > BATCH) u[k] = *reinterpret_cast<const uint4*>(xr + c);
        float w[8];
        load8(nw + c, w);
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&u[k]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          e[i] = __float2bfloat16_rn(__fmul_rn(__fmul_rn(__bfloat162float(e[i]), rs), w[i]));
        }
        *reinterpret_cast<uint4*>(yr + c) = u[k];
      }
    }
  }
}

// Shared-memory plan, byte offsets from a 1,024-byte aligned base: per stage
// the A tile (128 rows x 128 bytes) and NB weight tiles (BN rows x 128 bytes),
// all as 8-row swizzle atoms of 1,024 bytes; then each consumer warpgroup's
// output buffer (64 rows of BN bf16, 16 bytes of padding a row so that the
// accumulators' rows land in different banks); then the barriers. As many
// stages as fit, up to 6.
template <int BN, bool UP>
struct Plan {
  static constexpr int NB = UP ? 2 : 1;  // weight tiles per stage: value and gate, or w2
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int B_BYTES = BN * ROW_BYTES;
  static constexpr int STAGE = A_BYTES + NB * B_BYTES;
  static constexpr int OUT_ROW = 2 * BN + 16;
  static constexpr int OUT_BYTES = BM * OUT_ROW;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - OUT_BYTES - 2 * 6 * 8) / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int OUT_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = OUT_OFF + OUT_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 2 * STAGES * 8;
  static_assert(BN % 16 == 0 && BN <= 256, "tile widths a multiple of 16 up to 256");
  static_assert(NB * BN / 2 + 64 <= CONSUMER_REGS, "accumulators past the consumers' registers");
  static_assert(STAGES >= 3 && SMEM <= SMEM_LIMIT, "shared memory plan too large");
};

// UP: A = y (m, d), B = w1 (2f, d), out = g (m, f): n = f, k = d.
// Down: A = g (m, f), B = w2 (d, f), out (m, d) = bf16(x + g w2^T) (add_x) or
// bf16(g w2^T): n = d, k = f.
template <int BN, bool UP>
__global__ void __launch_bounds__(THREADS, 1) ffn_gemm_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out, int m, int d, int f,
    int add_x) {
  using P = Plan<BN, UP>;
  constexpr int ST = P::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar0 = sbase + P::BAR_OFF;  // full[ST], empty[ST]
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (ST + s); };

  const int n = UP ? f : d;
  const int k = UP ? d : f;
  // tiles in column-major order: consecutive blocks share a weight tile
  const int n_rt = (m + BM - 1) / BM;
  const int tiles = n_rt * ((n + BN - 1) / BN);
  const int nk = k / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);   // the producer's arrival with the stage's bytes
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();
  // the next kernel on the stream may start its set-up once every block of
  // this one runs (the grid is at most one block per SM)
  griddep_launch_dependents();

  if (threadIdx.x < WG) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != 0) return;
    const int total = ((tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * nk;
    // stage `it` of this block's walk: its tile's row and column and its k
    auto coords = [&](int it, int& row0, int& col0, int& k0) {
      const int tile = blockIdx.x + (it / nk) * gridDim.x;
      row0 = (tile % n_rt) * BM;
      col0 = (tile / n_rt) * BN;
      k0 = (it % nk) * BK;
    };
    auto load_a = [&](int it) {
      int row0, col0, k0;
      coords(it, row0, col0, k0);
      tma_load_2d(sbase + (it % ST) * P::STAGE, &tm_a, full(it % ST), k0, row0);
    };
    auto load_b = [&](int it) {
      int row0, col0, k0;
      coords(it, row0, col0, k0);
      const uint32_t dst = sbase + (it % ST) * P::STAGE + P::A_BYTES;
      tma_load_2d(dst, &tm_b, full(it % ST), k0, col0);
      // the gate rows sit f = n rows further down w1
      if constexpr (UP) tma_load_2d(dst + P::B_BYTES, &tm_b, full(it % ST), k0, n + col0);
    };
    // the weights do not depend on the kernel before: the first ring's
    // weight tiles are requested before the wait for it, the A tiles after
    const int pre = total < ST ? total : ST;
    for (int it = 0; it < pre; ++it) {
      mbar_arrive_expect_tx(full(it), P::STAGE);
      load_b(it);
    }
    griddep_wait();
    for (int it = 0; it < pre; ++it) load_a(it);
    for (int it = pre; it < total; ++it) {
      const int s = it % ST;
      mbar_wait(empty(s), ((it / ST) & 1) ^ 1);
      mbar_arrive_expect_tx(full(s), P::STAGE);
      load_b(it);
      load_a(it);
    }
  } else {
    // ------------------------------------------------------------ consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    griddep_wait();
    const int cw = threadIdx.x / WG - 1;  // consumer warpgroup: tile rows 64 cw ..
    const int ct = threadIdx.x % WG;
    const int warp = ct >> 5;
    const int lane = ct & 31;
    const int g = lane >> 2;
    const int tg = lane & 3;
    const uint64_t keep = policy_evict_last();
    float acc[P::NB][BN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int s = it % ST;
        mbar_wait(full(s), (it / ST) & 1);
        const uint32_t stage = sbase + s * P::STAGE;
        const uint64_t da = gmma_desc(stage + cw * 64 * ROW_BYTES, 16, 1024);
        const uint64_t db = gmma_desc(stage + P::A_BYTES, 16, 1024);
#pragma unroll
        for (int b = 0; b < P::NB; ++b) fence_regs(acc[b]);
        wgmma_fence();
        // four k16 steps: 32 bytes further along the swizzled rows each
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int b = 0; b < P::NB; ++b) {
            WgmmaBf16<BN>::mma(acc[b], da + 2 * kk, db + (b * P::B_BYTES >> 4) + 2 * kk,
                               (ks | kk) != 0);
          }
        }
        wgmma_commit();
        // the previous stage's products have read their tiles: release it
        wgmma_wait<1>();
        if (ks > 0 && ct == 0) mbar_arrive(empty((it - 1) % ST));
      }
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < P::NB; ++b) fence_regs(acc[b]);
      if (ct == 0) mbar_arrive(empty((it - 1) % ST));

      // epilogue: the tile's bf16 values into this warpgroup's buffer, then
      // its rows out 16 bytes a thread, neighbouring threads on neighbouring
      // bytes; rows past m and columns past n are not stored (n is a
      // multiple of 64, so a 16-byte chunk lies wholly inside or outside)
      unsigned char* buf = smem + P::OUT_OFF + cw * 64 * P::OUT_ROW;
      const int row0 = (tile % n_rt) * BM + 64 * cw;
      const int col_t = (tile / n_rt) * BN;
      const int lr_lo = 16 * warp + g;
      const int lr_hi = lr_lo + 8;
      named_bar_sync(1 + cw, WG);  // the buffer's last contents have gone out
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * tg;  // column in the tile
        uint32_t lo, hi;
        if constexpr (UP) {
          // g = bf16(p1 * gelu_tanh(p2)), value and gate of the same unit
          lo = pack_bf16x2(__fmul_rn(acc[0][4 * j + 0], gelu_tanh(acc[1][4 * j + 0])),
                           __fmul_rn(acc[0][4 * j + 1], gelu_tanh(acc[1][4 * j + 1])));
          hi = pack_bf16x2(__fmul_rn(acc[0][4 * j + 2], gelu_tanh(acc[1][4 * j + 2])),
                           __fmul_rn(acc[0][4 * j + 3], gelu_tanh(acc[1][4 * j + 3])));
        } else {
          // out = bf16(x + acc), the add in fp32
          const int col = col_t + c;
          float2 xlo = make_float2(0.f, 0.f), xhi = make_float2(0.f, 0.f);
          if (add_x && col < n) {
            if (row0 + lr_lo < m) {
              xlo = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)(row0 + lr_lo) * n + col));
            }
            if (row0 + lr_hi < m) {
              xhi = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)(row0 + lr_hi) * n + col));
            }
          }
          lo = pack_bf16x2(__fadd_rn(xlo.x, acc[0][4 * j + 0]), __fadd_rn(xlo.y, acc[0][4 * j + 1]));
          hi = pack_bf16x2(__fadd_rn(xhi.x, acc[0][4 * j + 2]), __fadd_rn(xhi.y, acc[0][4 * j + 3]));
        }
        *reinterpret_cast<uint32_t*>(buf + lr_lo * P::OUT_ROW + 2 * c) = lo;
        *reinterpret_cast<uint32_t*>(buf + lr_hi * P::OUT_ROW + 2 * c) = hi;
      }
      named_bar_sync(1 + cw, WG);
      for (int idx = ct; idx < 64 * (BN / 8); idx += WG) {
        const int r = idx / (BN / 8);
        const int ch = idx - r * (BN / 8);
        const int row = row0 + r;
        const int col = col_t + ch * 8;
        if (row < m && col < n) {
          const uint4 v = *reinterpret_cast<const uint4*>(buf + r * P::OUT_ROW + ch * 16);
          __nv_bfloat16* dst = out + (size_t)row * n + col;
          if constexpr (UP) {
            st_global_16_hint(dst, v, keep);  // g is read again by the next kernel
          } else {
            *reinterpret_cast<uint4*>(dst) = v;
          }
        }
      }
    }
  }
}

int sm_count(int device) {
  static int cached[64] = {};
  if (device < 0 || device >= 64) return 0;
  if (cached[device] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
      return 0;
    }
    cached[device] = sms;
  }
  return cached[device];
}

// The tile widths of each GEMM: the up-projection's two accumulators take
// BN fp32 registers a thread, so it stops at 160.
constexpr int UP_BNS[] = {112, 128, 160};
constexpr int DOWN_BNS[] = {128, 144, 192};

// The tile width whose waves of 128 x BN tiles over the SMs take least time,
// a tile's time taken as BN + 32 (its products, plus the epilogue and the
// ring's turn to the next tile).
template <int N>
int choose_block_n(const int (&bns)[N], int m, int n, int sms) {
  int best = bns[0];
  long long best_cost = -1;
  for (int bn : bns) {
    const long long tiles = (long long)((m + BM - 1) / BM) * ((n + bn - 1) / bn);
    const long long cost = (tiles + sms - 1) / sms * (bn + 32);
    if (best_cost < 0 || cost < best_cost) best = bn, best_cost = cost;
  }
  return best;
}

bool bf16_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  return swizzled_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, rows, cols, box_rows);
}

template <int BN, bool UP>
int launch_gemm(const void* a, const void* w, const __nv_bfloat16* x, __nv_bfloat16* out, int m,
                int d, int f, int add_x, int sms, int device, cudaStream_t s) {
  using P = Plan<BN, UP>;
  const int n = UP ? f : d;
  const int k = UP ? d : f;
  CUtensorMap ta, tw;
  if (!bf16_map(&ta, a, m, k, BM) || !bf16_map(&tw, w, UP ? 2 * f : d, k, BN)) {
    return (int)cudaErrorInvalidValue;
  }
  // Host threads may launch concurrently (the serving engine's dispatcher
  // beside the web app's handlers). The flag only skips a repeat of the
  // call below, which sets one constant attribute and is idempotent, so
  // threads that race past an unset flag each set the same value.
  static bool smem_set[64] = {};  // per device
  if (device >= 64 || !smem_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        ffn_gemm_kernel<BN, UP>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) smem_set[device] = true;
  }
  const long long tiles = (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles < sms ? tiles : sms));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = P::SMEM;
  cfg.stream = s;
  // programmatic dependent launch: the GEMM may begin while the kernel
  // before it on the stream finishes (griddepcontrol.wait in the kernel
  // orders the reads of its outputs)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, ffn_gemm_kernel<BN, UP>, ta, tw, x, out, m, d, f, add_x);
}

}  // namespace

// The tile width of the up-projection (up != 0) or the down-projection at
// (m, d, f) on `device`, or 0 for a device that cannot be read.
extern "C" int vampnet_geglu_ffn_block_n(int m, int d, int f, int up, int device) {
  const int sms = sm_count(device);
  if (sms <= 0 || m <= 0 || d <= 0 || f <= 0) return 0;
  return up ? choose_block_n(UP_BNS, m, f, sms) : choose_block_n(DOWN_BNS, m, d, sms);
}

// x (m, d) bf16, norm_weight (d,) bf16 (nw_is_bf16) or fp32, w1 (2f, d) and
// w2 (d, f) bf16; y (m, d) and g (m, f) bf16 are scratch the caller
// allocates; out (m, d) bf16, x added where add_x. d must be a multiple of
// 128 and f of 64; x, w1, w2, y and g 16-byte aligned.
extern "C" int vampnet_geglu_ffn(const void* x, const void* norm_weight, int nw_is_bf16,
                                 const void* w1, const void* w2, void* y, void* g, void* out,
                                 int m, int d, int f, int add_x, float eps, int device,
                                 void* stream) {
  if (m <= 0 || d <= 0 || d % 128 || f <= 0 || f % 64) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count(device);
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* gb = static_cast<__nv_bfloat16*>(g);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const int norm_blocks = (m + NORM_ROWS - 1) / NORM_ROWS;
  if (nw_is_bf16) {
    rms_norm_kernel<__nv_bfloat16><<<norm_blocks, NORM_ROWS * 32, 0, s>>>(
        xb, static_cast<const __nv_bfloat16*>(norm_weight), yb, m, d, eps);
  } else {
    rms_norm_kernel<float><<<norm_blocks, NORM_ROWS * 32, 0, s>>>(
        xb, static_cast<const float*>(norm_weight), yb, m, d, eps);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int rc;
  switch (choose_block_n(UP_BNS, m, f, sms)) {
    case 112: rc = launch_gemm<112, true>(yb, w1, xb, gb, m, d, f, 1, sms, device, s); break;
    case 128: rc = launch_gemm<128, true>(yb, w1, xb, gb, m, d, f, 1, sms, device, s); break;
    default: rc = launch_gemm<160, true>(yb, w1, xb, gb, m, d, f, 1, sms, device, s); break;
  }
  if (rc != 0) return rc;
  switch (choose_block_n(DOWN_BNS, m, d, sms)) {
    case 128: return launch_gemm<128, false>(gb, w2, xb, ob, m, d, f, add_x, sms, device, s);
    case 144: return launch_gemm<144, false>(gb, w2, xb, ob, m, d, f, add_x, sms, device, s);
    default: return launch_gemm<192, false>(gb, w2, xb, ob, m, d, f, add_x, sms, device, s);
  }
}
