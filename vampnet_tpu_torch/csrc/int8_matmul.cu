// w8a8 matmul for Hopper (sm_90a): dynamic per-row activation quantization,
// an int8 x int8 product with exact int32 accumulation, and the dequant
// epilogue.
//
// Port of the Pallas kernel `_kernel` in vampnet_tpu/ops/int8_matmul.py:36
// (`w8a8_matmul` :52). It computes, for x (m, k) bf16 or fp32, w_q (n, k)
// int8 and w_scale (n,) fp32,
//   a_scale[r] = max(max_c |x[r, c]|, 1e-8) * fp32(1/127)
//   xq[r, c]   = clamp(rint(x[r, c] / a_scale[r]), -127, 127) (IEEE division,
//                round half to even)
//   y[r, j]    = out(((float)sum_c xq[r, c] w_q[j, c] * a_scale[r]) * w_scale[j])
// with every step in that order, so the result is bit for bit the JAX
// function's (XLA and Pallas alike, where XLA turns the source's division by
// 127 into a product with its fp32 reciprocal) and the plain version's. The
// integer sum is exact (|sum| < 127^2 * 2560 < 2^31), so the order in which
// the tensor cores add it changes nothing.
//
// What bounds it: at the LM's shapes (m = 1,724 or 2,072 rows; k x n =
// 1280 x 1280, 1280 x 5120, 2560 x 1280) the operations, 5.6-27 G int-ops,
// 3-14 us at 1,979 TOP/s, against 10-28 MB of x, w_q and y (3-8 us at
// 3.35 TB/s). At that size the kernel's own costs come close to both: the
// quant pass (its per-element arithmetic), the launch, the ring's fill and
// the epilogue of a one-wave grid, and the operand tiles read again from
// L2 by every tile (86 MB at k = 2,560, the bound of the longest products).
//
// Design. The TPU kernel holds a row block's whole k in VMEM for the absmax;
// 128 rows x 2560 bf16 (640 KB) is more than an SM's 227 KB. So the function
// is two kernels on one stream:
//  * row_quant_kernel: one warp per row reads the row twice, 16 bytes a
//    lane (absmax, then quantize), and writes xq (m, k) int8 and a_scale
//    (m,) fp32: 2-5 MB. The quotient is the IEEE division's, computed on
//    the FMA pipe (quant_code). It lets the GEMM launch at once
//    (programmatic dependent launch), so the GEMM's set-up and its first
//    w_q tiles overlap the quant's tail.
//  * w8a8_wgmma_kernel: a persistent, warp-specialised GEMM, one block per
//    SM walking 128 x BN output tiles. A producer warp keeps a ring of 3-5
//    stages in flight, each 128 bytes of k of xq (128 rows) and of w_q (BN
//    rows), brought by TMA with the 128-byte swizzle; both operands are
//    K-major, as wgmma wants 8-bit operands, so neither is transposed. Rows
//    past m or n and bytes past k arrive as zeros. Two consumer warpgroups
//    of 64 rows each run wgmma m64nBNk32 s8 x s8 -> s32 from shared memory,
//    then apply the dequant to the accumulators, stage the tile in shared
//    memory and store it 16 bytes a thread; the producer meanwhile fills the
//    ring with the next tile's stages.
//  * BN is chosen per (m, n) from 128, 144, 192 and 224 so that the
//    tiles fill the SMs' waves: at n = 1,280, 144 columns make one wave of
//    126 tiles at m = 1,724 (128 would make 140: two waves on 132 SMs).
// w_q is (n, k) row-major: the port's (out, in) weight layout. ops/int8_matmul.py
// has the wrapper.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace vampnet;

constexpr int QUANT_ROWS = 8;  // rows per row-quant block, one warp each
constexpr int BM = 128;        // output rows per tile: two consumer warpgroups of 64
constexpr int BK = 128;        // bytes of k per stage (the 128-byte swizzle's row)
constexpr int WG = 128;        // threads per warpgroup
constexpr int THREADS = 3 * WG;
constexpr int SMEM_LIMIT = 232448;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(WG * PRODUCER_REGS + 2 * WG * CONSUMER_REGS <= 65536, "register plan");

// Eight consecutive elements of a row, as floats (k is a multiple of 16, so
// every 8-element chunk is 16-byte aligned).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float f[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ void load8(const float* p, float f[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// The int8 code of v / scale, for the row's r = RN(1/scale): the quotient
// RN(v / scale) by two Newton corrections of v r (Markstein: with r
// correctly rounded, the second correction gives the correctly rounded
// quotient; exact where it matters, since every value that decides a code
// is a normal float), clamped to [-127, 127], then rounded half to even by
// adding 1.5 * 2^23, whose low byte is then the code in two's complement.
// Only the FMA pipe: the IEEE division, rint and the conversion each take
// the SM's slower pipes. The result is the division's bit for bit, NaN
// (to -127) included; a row holding an infinity (scale infinite) takes the
// division itself.
__device__ __forceinline__ uint32_t quant_code(float v, float scale, float r) {
  float y = __fmul_rn(v, r);
  y = __fmaf_rn(__fmaf_rn(-scale, y, v), r, y);
  y = __fmaf_rn(__fmaf_rn(-scale, y, v), r, y);
  y = fminf(fmaxf(y, -127.f), 127.f);
  return __float_as_uint(__fadd_rn(y, 12582912.0f));
}

// One warp per row, which it reads twice, 16 bytes a lane: the absmax, then
// the quantization (the second read hits L1). Variants measured no faster
// (PERF.md): the row kept in registers, more lanes per row.
template <typename T>
__global__ void __launch_bounds__(QUANT_ROWS * 32) row_quant_kernel(
    const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ a_scale, int m, int k) {
  // the GEMM may start its set-up now; it waits for this grid before it
  // reads xq or a_scale
  griddep_launch_dependents();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * QUANT_ROWS + (threadIdx.x >> 5);
  if (row >= m) return;
  const T* xr = x + (size_t)row * k;
  float f[8];
  float amax = 0.f;
  for (int c = lane * 8; c < k; c += 256) {
    load8(xr + c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(f[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
  const float r = __frcp_rn(scale);
  const bool inf_row = isinf(scale);
  int8_t* qr = xq + (size_t)row * k;
  for (int c = lane * 8; c < k; c += 256) {
    load8(xr + c, f);
    uint32_t b[8];
    if (!inf_row) {
#pragma unroll
      for (int i = 0; i < 8; ++i) b[i] = quant_code(f[i], scale, r);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float q = fminf(fmaxf(rintf(__fdiv_rn(f[i], scale)), -127.f), 127.f);
        b[i] = (uint32_t)(uint8_t)(int8_t)q;
      }
    }
    // the low bytes of the eight words, in order
    const uint32_t lo = __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040),
                                    0x5410);
    const uint32_t hi = __byte_perm(__byte_perm(b[4], b[5], 0x0040), __byte_perm(b[6], b[7], 0x0040),
                                    0x5410);
    *reinterpret_cast<uint2*>(qr + c) = make_uint2(lo, hi);
  }
  if (lane == 0) a_scale[row] = scale;
}

// ------------------------------------------------------------ s8 wgmma
//
// d (64 x N, s32) = (scale_d ? d : 0) + A B, A (64 x 32) and B (32 x N) s8
// in shared memory, both K-major. The accumulator layout is the f32 one's:
// d[4 j + e] is row 16 warp + lane / 4 (+ 8 for e >= 2), column
// 8 j + 2 (lane % 4) + (e & 1).

#define VN_U8(d, i)                                                                   \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),         \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define VN_U16(d, i) VN_U8(d, i), VN_U8(d, i + 8)
#define VN_U32(d, i) VN_U16(d, i), VN_U16(d, i + 16)
#define VN_U64(d, i) VN_U32(d, i), VN_U32(d, i + 32)

template <int N>
struct Wgmma;

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(uint32_t (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
        : VN_U64(d, 0)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<144> {
  static __device__ __forceinline__ void mma(uint32_t (&d)[72], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71}, %72, %73, p;\n}\n"
        : VN_U64(d, 0), VN_U8(d, 64)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void mma(uint32_t (&d)[96], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p;\n}\n"
        : VN_U64(d, 0), VN_U32(d, 64)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<224> {
  static __device__ __forceinline__ void mma(uint32_t (&d)[112], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n224k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111}, %112, %113, p;\n}\n"
        : VN_U64(d, 0), VN_U32(d, 64), VN_U16(d, 96)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};


#undef VN_U8
#undef VN_U16
#undef VN_U32
#undef VN_U64

// Shared-memory plan, byte offsets from a 1,024-byte aligned base: per stage
// the xq tile (128 rows x 128 bytes) and the w_q tile (BN rows x 128 bytes),
// both as 8-row swizzle atoms of 1,024 bytes; then each consumer
// warpgroup's output buffer (64 rows of BN bf16 or BN / 2 fp32, 16 bytes of
// padding a row so that the accumulators' rows land in different banks);
// then the barriers. As many stages as fit, up to 6.
template <int BN>
struct Plan {
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int OUT_ROW = 2 * BN + 16;
  static constexpr int OUT_BYTES = 2 * 64 * OUT_ROW;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - OUT_BYTES - 2 * 6 * 8) / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int OUT_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = OUT_OFF + OUT_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 2 * STAGES * 8;
  static_assert(BN % 16 == 0 && BN <= 256, "wgmma takes N a multiple of 16 up to 256");
  static_assert(STAGES >= 3 && SMEM <= SMEM_LIMIT, "shared memory plan too large");
};

template <int BN>
__global__ void __launch_bounds__(THREADS, 1) w8a8_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
    const float* __restrict__ a_scale, const float* __restrict__ w_scale, void* __restrict__ out,
    int out_bf16, int m, int n, int k) {
  using P = Plan<BN>;
  constexpr int ST = P::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar0 = sbase + P::BAR_OFF;  // full[ST], empty[ST]
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (ST + s); };

  // tiles in column-major order: consecutive blocks share a w_q tile
  const int n_rt = (m + BM - 1) / BM;
  const int tiles = n_rt * ((n + BN - 1) / BN);
  const int nk = (k + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);   // the producer's arrival with the stage's bytes
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

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
      tma_load_2d(sbase + (it % ST) * P::STAGE, &tm_x, full(it % ST), k0, row0);
    };
    auto load_b = [&](int it) {
      int row0, col0, k0;
      coords(it, row0, col0, k0);
      tma_load_2d(sbase + (it % ST) * P::STAGE + P::A_BYTES, &tm_w, full(it % ST), k0, col0);
    };
    // the weights do not depend on the quant kernel: the first ring's w_q
    // tiles are requested before the wait for it, the xq tiles after
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
    griddep_wait();  // a_scale is the quant kernel's
    const int cw = threadIdx.x / WG - 1;  // consumer warpgroup: tile rows 64 cw ..
    const int ct = threadIdx.x % WG;
    const int warp = ct >> 5;
    const int lane = ct & 31;
    const int g = lane >> 2;
    const int tg = lane & 3;
    uint32_t acc[BN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int s = it % ST;
        mbar_wait(full(s), (it / ST) & 1);
        const uint32_t stage = sbase + s * P::STAGE;
        const uint64_t da = gmma_desc(stage + cw * 64 * BK, 16, 1024);
        const uint64_t db = gmma_desc(stage + P::A_BYTES, 16, 1024);
        fence_regs(acc);
        wgmma_fence();
        // four k32 steps: 32 bytes further along the swizzled rows each
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk, (ks | kk) != 0);
        }
        wgmma_commit();
        // the previous stage's products have read their tiles: release it
        wgmma_wait<1>();
        if (ks > 0 && ct == 0) mbar_arrive(empty((it - 1) % ST));
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (ct == 0) mbar_arrive(empty((it - 1) % ST));

      // dequant: ((float)acc * a_scale[row]) * w_scale[col], then the
      // output type, into this warpgroup's buffer; then the buffer's rows
      // go out 16 bytes a thread, neighbouring threads on neighbouring
      // bytes. fp32 goes in two halves of BN / 2 columns. Rows past m and
      // columns past n are not stored (n is a multiple of 8, so a 16-byte
      // chunk lies wholly inside or outside).
      unsigned char* buf = smem + P::OUT_OFF + cw * 64 * P::OUT_ROW;
      const int row0 = (tile % n_rt) * BM + 64 * cw;
      const int col_t = (tile / n_rt) * BN;
      const int lr_lo = 16 * warp + g;
      const int lr_hi = lr_lo + 8;
      const float as_lo = row0 + lr_lo < m ? a_scale[row0 + lr_lo] : 0.f;
      const float as_hi = row0 + lr_hi < m ? a_scale[row0 + lr_hi] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && out_bf16) break;
        named_bar_sync(1 + cw, WG);  // the buffer's last contents have gone out
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          if (!out_bf16 && j / (BN / 16) != h) continue;
          const int c = 8 * j + 2 * tg;  // column in the tile
          const float ws0 = col_t + c < n ? w_scale[col_t + c] : 0.f;
          const float ws1 = col_t + c < n ? w_scale[col_t + c + 1] : 0.f;
          const float y0 = __fmul_rn(__fmul_rn(__int2float_rn((int)acc[4 * j + 0]), as_lo), ws0);
          const float y1 = __fmul_rn(__fmul_rn(__int2float_rn((int)acc[4 * j + 1]), as_lo), ws1);
          const float y2 = __fmul_rn(__fmul_rn(__int2float_rn((int)acc[4 * j + 2]), as_hi), ws0);
          const float y3 = __fmul_rn(__fmul_rn(__int2float_rn((int)acc[4 * j + 3]), as_hi), ws1);
          if (out_bf16) {
            *reinterpret_cast<__nv_bfloat162*>(buf + lr_lo * P::OUT_ROW + 2 * c) =
                __floats2bfloat162_rn(y0, y1);
            *reinterpret_cast<__nv_bfloat162*>(buf + lr_hi * P::OUT_ROW + 2 * c) =
                __floats2bfloat162_rn(y2, y3);
          } else {
            const int cb = 4 * (c - h * (BN / 2));
            *reinterpret_cast<float2*>(buf + lr_lo * P::OUT_ROW + cb) = make_float2(y0, y1);
            *reinterpret_cast<float2*>(buf + lr_hi * P::OUT_ROW + cb) = make_float2(y2, y3);
          }
        }
        named_bar_sync(1 + cw, WG);
        // BN / 8 chunks a row: 8 bf16 or 4 fp32 each
        const int per_chunk = out_bf16 ? 8 : 4;
        const int esize = out_bf16 ? 2 : 4;
        const int col_h = col_t + h * (BN / 2);
        for (int idx = ct; idx < 64 * (BN / 8); idx += WG) {
          const int r = idx / (BN / 8);
          const int ch = idx - r * (BN / 8);
          const int row = row0 + r;
          const int col = col_h + ch * per_chunk;
          if (row < m && col < n) {
            *reinterpret_cast<uint4*>(static_cast<unsigned char*>(out) +
                                      ((size_t)row * n + col) * esize) =
                *reinterpret_cast<const uint4*>(buf + r * P::OUT_ROW + ch * 16);
          }
        }
      }
    }
  }
}

constexpr int BLOCK_NS[] = {128, 144, 192, 224};

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

long long tile_count(int m, int n, int bn) {
  return (long long)((m + BM - 1) / BM) * ((n + bn - 1) / bn);
}

// The tile width whose waves of 128 x BN tiles over the SMs take least time,
// a tile's time taken as BN + 32 (its products, plus the epilogue and the
// ring's turn to the next tile).
int choose_block_n(int m, int n, int sms) {
  int best = BLOCK_NS[0];
  long long best_cost = -1;
  for (int bn : BLOCK_NS) {
    const long long cost = (tile_count(m, n, bn) + sms - 1) / sms * (bn + 32);
    if (best_cost < 0 || cost < best_cost) best = bn, best_cost = cost;
  }
  return best;
}

// The TMA map over a (rows, k) int8 matrix: boxes of box_rows rows x 128
// bytes, 128-byte swizzle, kept per host thread (swizzled_map_2d).
bool s8_map(CUtensorMap* map, const void* ptr, int rows, int k, int box_rows) {
  return swizzled_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ptr, rows, k, box_rows);
}

template <int BN>
int launch_gemm(const void* xq, const float* a_scale, const void* w_q, const float* w_scale,
                void* out, int out_bf16, int m, int n, int k, int sms, cudaStream_t s) {
  using P = Plan<BN>;
  CUtensorMap tx, tw;
  if (!s8_map(&tx, xq, m, k, BM) || !s8_map(&tw, w_q, n, k, BN)) {
    return (int)cudaErrorInvalidValue;
  }
  // Host threads may launch concurrently (the serving engine's dispatcher
  // beside the web app's handlers). The flag only skips a repeat of the
  // call below, which sets one constant attribute and is idempotent, so
  // threads that race past an unset flag each set the same value.
  static bool smem_set[64] = {};  // per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64 || !smem_set[device]) {
    err = cudaFuncSetAttribute(w8a8_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               P::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) smem_set[device] = true;
  }
  const long long tiles = tile_count(m, n, BN);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles < sms ? tiles : sms));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = P::SMEM;
  cfg.stream = s;
  // programmatic dependent launch: the GEMM may begin while the quant
  // kernel before it on the stream finishes (griddepcontrol.wait in the
  // kernel orders the reads of its outputs)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, w8a8_wgmma_kernel<BN>, tx, tw, a_scale, w_scale, out,
                                 out_bf16, m, n, k);
}

}  // namespace

// The tile width the GEMM takes at (m, n) on `device`, or 0 for a device
// that cannot be read.
extern "C" int vampnet_w8a8_block_n(int m, int n, int device) {
  const int sms = sm_count(device);
  return sms > 0 && m > 0 && n > 0 ? choose_block_n(m, n, sms) : 0;
}

// x (m, k) bf16 (x_is_bf16) or fp32; w_q (n, k) int8; w_scale (n,) fp32;
// xq (m, k) int8 and a_scale (m,) fp32 are scratch the caller allocates; out
// (m, n) bf16 (out_is_bf16) or fp32. k must be a multiple of 16 and n of 8;
// x, w_q, xq and out 16-byte aligned.
extern "C" int vampnet_w8a8_matmul(const void* x, int x_is_bf16, const void* w_q,
                                   const void* w_scale, void* xq, void* a_scale, void* out,
                                   int out_is_bf16, int m, int n, int k, int device,
                                   void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 || n % 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count(device);
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int quant_blocks = (m + QUANT_ROWS - 1) / QUANT_ROWS;
  auto* q8 = static_cast<int8_t*>(xq);
  auto* sc = static_cast<float*>(a_scale);
  if (x_is_bf16) {
    row_quant_kernel<__nv_bfloat16><<<quant_blocks, QUANT_ROWS * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), q8, sc, m, k);
  } else {
    row_quant_kernel<float><<<quant_blocks, QUANT_ROWS * 32, 0, s>>>(
        static_cast<const float*>(x), q8, sc, m, k);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const auto* ws = static_cast<const float*>(w_scale);
  switch (choose_block_n(m, n, sms)) {
    case 128: return launch_gemm<128>(q8, sc, w_q, ws, out, out_is_bf16, m, n, k, sms, s);
    case 144: return launch_gemm<144>(q8, sc, w_q, ws, out, out_is_bf16, m, n, k, sms, s);
    case 192: return launch_gemm<192>(q8, sc, w_q, ws, out, out_is_bf16, m, n, k, sms, s);
    default: return launch_gemm<224>(q8, sc, w_q, ws, out, out_is_bf16, m, n, k, sms, s);
  }
}
