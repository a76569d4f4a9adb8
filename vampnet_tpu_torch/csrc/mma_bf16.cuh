// Shared helpers of the bf16 tensor-core kernels (attention_fwd.cu,
// attention_bwd.cu, ffn.cu): fragment packing, the m16n8k16 mma.sync (ffn.cu),
// the bias prefold's factor, the mask's fill, and the launch.
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

// c += a * b, m16n8k16, A row-major bf16, B column-major bf16, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
