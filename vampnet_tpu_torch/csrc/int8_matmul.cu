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
// integer sum is exact: |sum| < 127^2 * 2560 < 2^31.
//
// Design. The TPU kernel holds a row block's whole k in VMEM for the absmax;
// 64 rows x 2560 bf16 (320 KB) is more than an SM's 227 KB. So the function
// is split in two kernels launched back to back on one stream:
//  * row_quant_kernel: one warp per row reads the row twice, 16 bytes a
//    lane (absmax, then quantize), and writes xq (m, k) int8 and a_scale
//    (m,) fp32. At the LM's shapes that is 2-5 MB, a few microseconds at the
//    memory rate.
//  * w8a8_gemm_kernel: 128 x 128 output tiles, 8 warps of 64 x 32, k in
//    steps of 64 bytes through a two-stage cp.async ring in shared memory,
//    mma.sync.m16n8k32 s8 x s8 -> s32, and the dequant epilogue on the int32
//    accumulators. Rows past m and columns past n are zero-filled on load and
//    never stored.
// w_q is (n, k) row-major: the `.col` B operand of mma.sync, and the port's
// (out, in) weight layout. The bound at the serving shapes is worked out in
// ops/int8_matmul.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QUANT_ROWS = 8;  // rows per row-quant block, one warp each
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;         // bytes of k per stage
constexpr int LDT = BK + 16;   // smem row stride (bytes): conflict-free fragment reads
constexpr int THREADS = 256;

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

template <typename T>
__global__ void __launch_bounds__(QUANT_ROWS * 32) row_quant_kernel(
    const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ a_scale, int m, int k) {
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
  int8_t* qr = xq + (size_t)row * k;
  for (int c = lane * 8; c < k; c += 256) {
    load8(xr + c, f);  // the second read of the row hits L1
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(f[i], scale)), -127.f), 127.f);
      packed[i >> 2] |= (uint32_t)(uint8_t)(int8_t)q << (8 * (i & 3));
    }
    *reinterpret_cast<uint2*>(qr + c) = make_uint2(packed[0], packed[1]);
  }
  if (lane == 0) a_scale[row] = scale;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a * b, m16n8k32, A row-major s8, B column-major s8, s32 accumulators.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies a 128-row x 64-byte tile (rows [row0, row0 + 128), bytes [k0, k0 + 64)
// of a (rows, k) int8 matrix) into shared memory, zero-filling out of range.
__device__ __forceinline__ void load_stage(int8_t* dst, const int8_t* src, int rows, int k,
                                           int row0, int k0) {
#pragma unroll
  for (int i = 0; i < (128 * BK / 16) / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / (BK / 16);
    const int col = (c % (BK / 16)) * 16;
    const bool valid = row0 + r < rows && k0 + col < k;
    const int8_t* g = valid ? src + (size_t)(row0 + r) * k + k0 + col : src;
    cp_async16(dst + r * LDT + col, g, valid);
  }
}

template <bool OUT_BF16>
__global__ void __launch_bounds__(THREADS) w8a8_gemm_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ a_scale,
    const int8_t* __restrict__ w_q, const float* __restrict__ w_scale, void* __restrict__ out,
    int m, int n, int k) {
  __shared__ __align__(16) int8_t sa[2][BM * LDT];
  __shared__ __align__(16) int8_t sb[2][BN * LDT];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int wm = (warp >> 2) * 64;  // this warp's 64 rows of the tile
  const int wn = (warp & 3) * 32;   // and its 32 columns

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int nk = (k + BK - 1) / BK;
  load_stage(sa[0], xq, m, k, m0, 0);
  load_stage(sb[0], w_q, n, k, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage(sa[(kt + 1) & 1], xq, m, k, m0, (kt + 1) * BK);
      load_stage(sb[(kt + 1) & 1], w_q, n, k, n0, (kt + 1) * BK);
    }
    cp_async_commit();
    cp_async_wait<1>();  // stage kt has landed
    __syncthreads();
    const int8_t* ta = sa[kt & 1];
    const int8_t* tb = sb[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = ta + (wm + i * 16 + g) * LDT + kk + tg * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDT);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDT + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = tb + (wn + j * 8 + g) * LDT + kk + tg * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();  // every warp is done with stage kt before it is refilled
  }

  // dequant: ((float)acc * a_scale[row]) * w_scale[col], then the output type
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + i * 16 + g + half * 8;
      if (row >= m) continue;
      const float as = a_scale[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + j * 8 + tg * 2;  // n is a multiple of 8: col + 1 < n too
        if (col >= n) continue;
        const float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * half]), as), w_scale[col]);
        const float y1 =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * half + 1]), as), w_scale[col + 1]);
        const size_t o = (size_t)row * n + col;
        if (OUT_BF16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
              __floats2bfloat162_rn(y0, y1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(y0, y1);
        }
      }
    }
  }
}

}  // namespace

// x (m, k) bf16 (x_is_bf16) or fp32; w_q (n, k) int8; w_scale (n,) fp32;
// xq (m, k) int8 and a_scale (m,) fp32 are scratch the caller allocates; out
// (m, n) bf16 (out_is_bf16) or fp32. k must be a multiple of 16 and n of 8.
extern "C" int vampnet_w8a8_matmul(const void* x, int x_is_bf16, const void* w_q,
                                   const void* w_scale, void* xq, void* a_scale, void* out,
                                   int out_is_bf16, int m, int n, int k, int device,
                                   void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 || n % 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
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
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const auto* wq = static_cast<const int8_t*>(w_q);
  const auto* ws = static_cast<const float*>(w_scale);
  if (out_is_bf16) {
    w8a8_gemm_kernel<true><<<grid, THREADS, 0, s>>>(q8, sc, wq, ws, out, m, n, k);
  } else {
    w8a8_gemm_kernel<false><<<grid, THREADS, 0, s>>>(q8, sc, wq, ws, out, m, n, k);
  }
  return (int)cudaGetLastError();
}
