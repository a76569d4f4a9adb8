// Shared helpers of the bf16 tensor-core kernels (attention_fwd.cu,
// attention_bwd.cu, ffn.cu): fragment packing, the m16n8k16 mma.sync, the
// bias prefold and the mask's fill, and the 64-row tile copy into padded
// shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vampnet {

constexpr float LOG2E_F = 1.4426950408889634f;
// The score of a key the mask blocks: the JAX wrapper's -1e9 fill, in the
// prefolded base-2 units. A row whose every key is blocked has max -1e9 and
// lse = -1e9 + log2(t), which rounds to -1e9 in fp32; the backward reads an
// lse below FULLY_BLOCKED_LSE as such a row.
constexpr float MASKED_SCORE = -1e9f;
constexpr float FULLY_BLOCKED_LSE = -5e8f;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 from two rows (LDS elements apart) of one column, packed low = first.
template <int LDS>
__device__ __forceinline__ uint32_t ld_col_pair(const __nv_bfloat16* p) {
  uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  uint32_t hi = *reinterpret_cast<const uint16_t*>(p + LDS);
  return lo | (hi << 16);
}

// c += a * b, m16n8k16, A row-major bf16, B column-major bf16, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bias prefold b_2 = bias * log2(e): the product in fp32, rounded back
// to the bias dtype (bf16 or fp32), as the JAX wrapper folds it.
template <bool BIAS_BF16>
__device__ __forceinline__ float load_bias(const void* bias, size_t idx) {
  if (BIAS_BF16) {
    float b = __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[idx]);
    return __bfloat162float(__float2bfloat16_rn(b * LOG2E_F));
  } else {
    return static_cast<const float*>(bias)[idx] * LOG2E_F;
  }
}

// Copies rows [row0, row0 + 64) of one (batch, head) slice of a (b, t, h, D)
// bf16 tensor into shared memory (row stride D + 8), zero-filling rows at or
// past t, with `threads` threads. With PREFOLD the values are multiplied by
// `scale` in fp32 and rounded back to bf16 (the q prefold).
template <int D, bool PREFOLD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t row_stride, int row0, int t, float scale,
                                          int threads) {
  constexpr int LDS = D + 8;
  for (int c = threadIdx.x; c < 64 * (D / 8); c += threads) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * row_stride + col);
      if (PREFOLD) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LDS + col) = val;
  }
}

// Launches `kernel` with `smem` bytes of dynamic shared memory, raising the
// kernel's limit first where it exceeds the default 48 KB.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace vampnet
