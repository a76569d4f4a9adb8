// The LAC codec's snake activation, with the bias of the convolution before
// it and the residual add folded in, for Hopper (sm_90a).
//
// Per element of a contiguous (b, c, t) fp32 tensor y, a convolution's
// output without its bias:
//   x = res + (y + bias[c])     (x = y + bias[c] where there is no residual)
//   s = x + (1 / (alpha[c] + 1e-9)) * sin(alpha[c] x)^2
// written to `out`, and x to `sum` where a later residual add needs it.
// Replaces no TPU kernel: the JAX package leaves the snake to XLA, which
// fuses it (vampnet_tpu/modules/activations.py:27). Eager PyTorch runs the
// same chain as the convolution's separate bias add, the residual add and
// eight launches for the snake (alpha + 1e-9, reciprocal, times 1.0,
// alpha x, sin, square, times, plus), five of them passes over the whole
// activation.
//
// Bits. The result is the eager chain's, bit for bit: each step rounds once
// in fp32, as its own PyTorch kernel does (`__fadd_rn` and `__fmul_rn`,
// which the compiler never contracts into an FMA); the reciprocal is
// `__frcp_rn`, correctly rounded as PyTorch's 1.0f / a is; the times 1.0
// is exact and left out; the sine is the precise `sinf` that PyTorch's sin
// kernel calls (no fast math in this build).
//
// What bounds it: bytes. One read of y (and of res) and one write of out
// (and of sum). At the encoder's first stage for b = 8 x 10 s, (8, 64,
// 441,344) fp32 read and written is 1.81 GB, 0.54 ms at 3.35 TB/s; sinf's
// fast path is a few dozen instructions an element, well under that.
//
// Design. A block takes a stretch of one (b, c) row, so that bias[c],
// alpha[c] and the reciprocal are loaded and computed once; its threads
// move 16-byte vectors, UNROLL of them in flight each. A row starts on a
// 16-byte boundary only where t % 4 == 0: the row's elements before its
// first boundary (the head) are done one at a time by the row's first
// block, those after its last whole vector (the tail) by its last block.
// Where the tensors' addresses differ mod 16 (a view at an odd offset) no
// vector is aligned in all of them, and every element is done one at a
// time.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int VECS = THREADS * UNROLL;  // 16-byte vectors a block
constexpr int ELEMS = 4 * VECS;         // elements a block

__device__ __forceinline__ float snake_of(float x, float alpha, float inv) {
  const float s = sinf(__fmul_rn(alpha, x));
  return __fadd_rn(x, __fmul_rn(inv, __fmul_rn(s, s)));
}

template <bool RES>
__device__ __forceinline__ float sum_of(float y, float bias, float r) {
  const float x = __fadd_rn(y, bias);
  return RES ? __fadd_rn(r, x) : x;
}

template <bool RES, bool SUM>
__device__ __forceinline__ void one(const float* __restrict__ y, const float* __restrict__ res,
                                    float* __restrict__ sum, float* __restrict__ out,
                                    long long i, float bias, float alpha, float inv) {
  const float x = sum_of<RES>(y[i], bias, RES ? res[i] : 0.f);
  if (SUM) sum[i] = x;
  out[i] = snake_of(x, alpha, inv);
}

template <bool RES>
__device__ __forceinline__ float4 sum4(const float4& y, float bias, const float4& r) {
  return make_float4(sum_of<RES>(y.x, bias, r.x), sum_of<RES>(y.y, bias, r.y),
                     sum_of<RES>(y.z, bias, r.z), sum_of<RES>(y.w, bias, r.w));
}

__device__ __forceinline__ float4 snake4(const float4& x, float alpha, float inv) {
  return make_float4(snake_of(x.x, alpha, inv), snake_of(x.y, alpha, inv),
                     snake_of(x.z, alpha, inv), snake_of(x.w, alpha, inv));
}

template <bool RES, bool SUM>
__global__ void __launch_bounds__(THREADS)
snake_kernel(const float* __restrict__ y, const float* __restrict__ bias,
             const float* __restrict__ alpha, const float* __restrict__ res,
             float* __restrict__ sum, float* __restrict__ out, int channels, int t,
             int blocks_per_row, int vec) {
  const long long row = blockIdx.x / blocks_per_row;
  const int part = blockIdx.x % blocks_per_row;
  const int c = (int)(row % channels);
  const float b = bias[c], a = alpha[c];
  const float inv = __frcp_rn(__fadd_rn(a, (float)1e-9));
  const long long base = row * t;
  if (!vec) {
    const int end = min(t, (part + 1) * ELEMS);
    for (int j = part * ELEMS + threadIdx.x; j < end; j += THREADS) {
      one<RES, SUM>(y, res, sum, out, base + j, b, a, inv);
    }
    return;
  }
  // the row's elements before its first 16-byte boundary, and after its
  // last whole vector
  const int head = min(t, (int)((4 - ((reinterpret_cast<uintptr_t>(y + base) >> 2) & 3)) & 3));
  const int nv = (t - head) / 4;
  const int tail = head + 4 * nv;
  if (part == 0 && (int)threadIdx.x < head) {
    one<RES, SUM>(y, res, sum, out, base + threadIdx.x, b, a, inv);
  }
  if (part == blocks_per_row - 1 && (int)threadIdx.x < t - tail) {
    one<RES, SUM>(y, res, sum, out, base + tail + threadIdx.x, b, a, inv);
  }
  const long long first = base + head;
  const float4* yv = reinterpret_cast<const float4*>(y + first);
  const float4* rv = reinterpret_cast<const float4*>(RES ? res + first : y + first);
  float4* sv = reinterpret_cast<float4*>(SUM ? sum + first : out + first);
  float4* ov = reinterpret_cast<float4*>(out + first);
  const int v0 = part * VECS + threadIdx.x;
  float4 ry[UNROLL], rr[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int v = v0 + u * THREADS;
    ry[u] = rr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (v < nv) {
      ry[u] = yv[v];
      if (RES) rr[u] = rv[v];
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int v = v0 + u * THREADS;
    if (v < nv) {
      const float4 x = sum4<RES>(ry[u], b, rr[u]);
      if (SUM) sv[v] = x;
      ov[v] = snake4(x, a, inv);
    }
  }
}

template <bool RES, bool SUM>
cudaError_t launch(const float* y, const float* bias, const float* alpha, const float* res,
                   float* sum, float* out, int rows, int channels, int t, int blocks_per_row,
                   int vec, cudaStream_t stream) {
  snake_kernel<RES, SUM><<<rows * blocks_per_row, THREADS, 0, stream>>>(
      y, bias, alpha, res, sum, out, channels, t, blocks_per_row, vec);
  return cudaGetLastError();
}

}  // namespace

// y (rows, t) fp32, rows = b * channels, contiguous; bias and alpha
// (channels,) fp32; res (rows, t) fp32 or null; sum (rows, t) fp32 or null
// (x written there); out (rows, t) fp32
extern "C" int vampnet_snake(const void* y, const void* bias, const void* alpha,
                             const void* res, void* sum, void* out, int rows, int channels,
                             int t, int device, void* stream) {
  if (rows <= 0 || channels <= 0 || t <= 0 || rows % channels != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks_per_row = ((long long)t + ELEMS - 1) / ELEMS;
  if ((long long)rows * blocks_per_row > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // vectors only where every tensor is at the same place mod 16 bytes
  const uintptr_t m = reinterpret_cast<uintptr_t>(y) & 15;
  const int vec = (reinterpret_cast<uintptr_t>(out) & 15) == m &&
                  (!res || (reinterpret_cast<uintptr_t>(res) & 15) == m) &&
                  (!sum || (reinterpret_cast<uintptr_t>(sum) & 15) == m);
  const float* yf = static_cast<const float*>(y);
  const float* bf = static_cast<const float*>(bias);
  const float* af = static_cast<const float*>(alpha);
  const float* rf = static_cast<const float*>(res);
  float* sf = static_cast<float*>(sum);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bpr = (int)blocks_per_row;
  if (res && sum) {
    err = launch<true, true>(yf, bf, af, rf, sf, of, rows, channels, t, bpr, vec, s);
  } else if (res) {
    err = launch<true, false>(yf, bf, af, rf, sf, of, rows, channels, t, bpr, vec, s);
  } else if (sum) {
    err = launch<false, true>(yf, bf, af, rf, sf, of, rows, channels, t, bpr, vec, s);
  } else {
    err = launch<false, false>(yf, bf, af, rf, sf, of, rows, channels, t, bpr, vec, s);
  }
  return (int)err;
}
