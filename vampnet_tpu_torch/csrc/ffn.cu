// Fused RMSNorm + GEGLU feed-forward + residual for Hopper (sm_90a).
//
// Port of the Pallas kernel `_ffn_kernel` in vampnet_tpu/ops/ffn_kernel.py:44
// (`fused_geglu_ffn` :73). For x (m, d) bf16, the RMSNorm scale nw (d,) fp32,
// w1 (4d, d) and w2 (d, 2d) bf16 in the port's (out, in) layout:
//   y   = bf16(x * rsqrt(mean(x^2) + eps) * nw)        (fp32 statistics)
//   p1  = y w1[0:2d]^T,  p2 = y w1[2d:4d]^T            (fp32 accumulation)
//   g   = bf16(p1 * gelu_tanh(p2))                     (fp32, tanhf)
//   out = bf16(x + g w2^T)                             (fp32 accumulation and add)
// The first half of w1's rows is the value and the second the gate, as
// jnp.split of the JAX (d, 4d) kernel's columns.
//
// Design. The TPU kernel keeps a (rows, d) fp32 accumulator across the whole
// hidden sweep; at d = 1280 that is 320 KB for 64 rows, more than an SM holds.
// Here one block of 8 warps owns 16 rows and all d output columns:
//  * the normalised rows y (16 x d bf16, 41 KB at d = 1280) sit in shared
//    memory for the whole sweep;
//  * the hidden width 2d is swept 64 units at a time: warp w computes the
//    value and gate columns [8w, 8w + 8) of the step from y and w1 (16 x 8
//    each, over all of d), applies the GEGLU and writes its 16 x 8 piece of
//    g to shared memory. Each block starts the sweep at its own step, so the
//    grid's reads of one weight row do not all land on one L2 slice at once;
//    the summation order over the hidden width then depends on the block,
//    and the output is still deterministic;
//  * then warp w adds g (16 x 64) times its own d/8 columns of w2 into an
//    fp32 accumulator that stays in its registers (16 x 160 at d = 1280, 80
//    registers a thread) from the first step to the last;
//  * the epilogue adds the residual and writes each output element once.
// No atomics: the output is deterministic. Weight operands are read straight
// from device memory (through L2) into mma.sync m16n8k16 B fragments, 16
// bytes a thread: the contraction index is permuted within each 32-wide
// chunk (thread tg takes elements [8 tg, 8 tg + 8) and splits them over two
// mma steps), the same permutation for the A operand read from shared
// memory, so each product is unchanged. Every block reads all of w1 and w2
// (19.7 MB at d = 1280) from L2: that, not the bound, decides the time.
// The bound at the serving shapes is worked out in ops/ffn_kernel.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace vampnet;

constexpr int BM = 16;        // rows per block
constexpr int BF = 64;        // hidden units per step: 8 warps x 8
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_NT = 20;    // output column tiles of 8 per warp: d <= 8 * 8 * 20 = 1280
constexpr int PAD = 32;       // bf16 row padding: 16-byte fragment reads free of bank conflicts
constexpr int LDG = BF + PAD;

__device__ __forceinline__ uint4 ld_weights(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// tanh-form GELU in fp32, each step rounded as written (no contraction to FMA).
__device__ __forceinline__ float gelu_tanh(float v) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float inner = __fmul_rn(c, __fadd_rn(v, __fmul_rn(0.044715f, __fmul_rn(__fmul_rn(v, v), v))));
  return __fmul_rn(v, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

__global__ void __launch_bounds__(THREADS) geglu_ffn_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ nw,
    const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ w2,
    __nv_bfloat16* __restrict__ out, int m, int d, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldy = d + PAD;
  __nv_bfloat16* sy = reinterpret_cast<__nv_bfloat16*>(smem);  // BM x ldy: the normalised rows
  __nv_bfloat16* sg = sy + BM * ldy;                           // BM x LDG: one step's g

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int hidden = 2 * d;

  // 1. RMSNorm, two rows per warp; rows past m are zeros
  for (int rr = 0; rr < BM / WARPS; ++rr) {
    const int r = warp * (BM / WARPS) + rr;
    const int row = m0 + r;
    float ss = 0.f;
    if (row < m) {
      for (int c = lane * 8; c < d; c += 256) {
        const uint4 u = *reinterpret_cast<const uint4*>(x + (size_t)row * d + c);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float f = __bfloat162float(e[i]);
          ss += f * f;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float rs = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)d), eps));
    for (int c = lane * 8; c < d; c += 256) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (row < m) {
        u = *reinterpret_cast<const uint4*>(x + (size_t)row * d + c);
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          e[i] = __float2bfloat16_rn(__fmul_rn(__fmul_rn(__bfloat162float(e[i]), rs), nw[c + i]));
        }
      }
      *reinterpret_cast<uint4*>(sy + r * ldy + c) = u;
    }
  }
  __syncthreads();

  const int nt = d / 64;           // this warp's output column tiles
  const int col0 = warp * nt * 8;  // and its first output column
  float acc[MAX_NT][4];
#pragma unroll
  for (int j = 0; j < MAX_NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // Blocks start their hidden sweep at different steps, so that at any time
  // the grid reads the weights from many L2 slices rather than all from one.
  const int n_steps = hidden / BF;
  const int first = blockIdx.x % n_steps;
  for (int step = 0; step < n_steps; ++step) {
    const int f0 = ((first + step) % n_steps) * BF;
    // 2. value and gate columns f0 + 8 warp + [0, 8): y w1^T over all of d, in
    //    chunks of 4 x 32; the next chunk's weights load while this one's
    //    products run
    float h1[4] = {0.f, 0.f, 0.f, 0.f}, h2[4] = {0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat16* wa = w1 + (size_t)(f0 + warp * 8 + g) * d + tg * 8;
    const __nv_bfloat16* wb = w1 + (size_t)(hidden + f0 + warp * 8 + g) * d + tg * 8;
    const __nv_bfloat16* ya = sy + g * ldy + tg * 8;
    uint4 ba[4], bb[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      ba[s] = ld_weights(wa + 32 * s);
      bb[s] = ld_weights(wb + 32 * s);
    }
#pragma unroll 1
    for (int k0 = 0; k0 < d; k0 += 128) {
      uint4 ca[4], cb[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        ca[s] = ba[s];
        cb[s] = bb[s];
      }
      if (k0 + 128 < d) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          ba[s] = ld_weights(wa + k0 + 128 + 32 * s);
          bb[s] = ld_weights(wb + k0 + 128 + 32 * s);
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint4 lo = *reinterpret_cast<const uint4*>(ya + k0 + 32 * s);            // row g
        const uint4 hi = *reinterpret_cast<const uint4*>(ya + 8 * ldy + k0 + 32 * s);  // row g + 8
        const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y};  // elements [8 tg, 8 tg + 4)
        const uint32_t a1[4] = {lo.z, hi.z, lo.w, hi.w};  // elements [8 tg + 4, 8 tg + 8)
        mma_bf16(h1, a0, ca[s].x, ca[s].y);
        mma_bf16(h1, a1, ca[s].z, ca[s].w);
        mma_bf16(h2, a0, cb[s].x, cb[s].y);
        mma_bf16(h2, a1, cb[s].z, cb[s].w);
      }
    }
    // 3. g = bf16(p1 * gelu(p2)): rows g and g + 8, hidden columns 8 warp + 2 tg + {0, 1}
    const int gc = warp * 8 + tg * 2;
    *reinterpret_cast<uint32_t*>(sg + g * LDG + gc) =
        pack_bf16x2(__fmul_rn(h1[0], gelu_tanh(h2[0])), __fmul_rn(h1[1], gelu_tanh(h2[1])));
    *reinterpret_cast<uint32_t*>(sg + (g + 8) * LDG + gc) =
        pack_bf16x2(__fmul_rn(h1[2], gelu_tanh(h2[2])), __fmul_rn(h1[3], gelu_tanh(h2[3])));
    __syncthreads();

    // 4. acc += g (16 x 64) w2[cols, f0:f0+64]^T for this warp's columns,
    //    ten column tiles' weights loaded before their products
#pragma unroll
    for (int kc = 0; kc < BF; kc += 32) {
      const uint4 lo = *reinterpret_cast<const uint4*>(sg + g * LDG + kc + tg * 8);
      const uint4 hi = *reinterpret_cast<const uint4*>(sg + (g + 8) * LDG + kc + tg * 8);
      const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y};
      const uint32_t a1[4] = {lo.z, hi.z, lo.w, hi.w};
      const __nv_bfloat16* wr = w2 + (size_t)(col0 + g) * hidden + f0 + kc + tg * 8;
#pragma unroll
      for (int j0 = 0; j0 < MAX_NT; j0 += MAX_NT / 2) {
        uint4 bw[MAX_NT / 2];
#pragma unroll
        for (int j = 0; j < MAX_NT / 2; ++j) {
          if (j0 + j < nt) bw[j] = ld_weights(wr + (size_t)(j0 + j) * 8 * hidden);
        }
#pragma unroll
        for (int j = 0; j < MAX_NT / 2; ++j) {
          if (j0 + j < nt) {
            mma_bf16(acc[j0 + j], a0, bw[j].x, bw[j].y);
            mma_bf16(acc[j0 + j], a1, bw[j].z, bw[j].w);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with g before the next step writes it
  }

  // 5. out = bf16(x + acc), fp32 addition
#pragma unroll
  for (int j = 0; j < MAX_NT; ++j) {
    if (j < nt) {
      const int col = col0 + j * 8 + tg * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + g + half * 8;
        if (row < m) {
          const size_t o = (size_t)row * d + col;
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + o);
          *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(
              __fadd_rn(__bfloat162float(xv.x), acc[j][2 * half]),
              __fadd_rn(__bfloat162float(xv.y), acc[j][2 * half + 1]));
        }
      }
    }
  }
}

}  // namespace

// x (m, d) bf16, norm_weight (d,) fp32, w1 (4d, d) and w2 (d, 2d) bf16, out
// (m, d) bf16. d must be a multiple of 128 and at most 1280.
extern "C" int vampnet_geglu_ffn(const void* x, const void* norm_weight, const void* w1,
                                 const void* w2, void* out, int m, int d, float eps, int device,
                                 void* stream) {
  if (m <= 0 || d <= 0 || d % 128 || d > WARPS * MAX_NT * 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)BM * (d + PAD) * 2 + (size_t)BM * LDG * 2;
  return (int)launch(geglu_ffn_kernel, dim3((m + BM - 1) / BM), THREADS, smem,
                     static_cast<cudaStream_t>(stream), static_cast<const __nv_bfloat16*>(x),
                     static_cast<const float*>(norm_weight),
                     static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(w2),
                     static_cast<__nv_bfloat16*>(out), m, d, eps);
}
