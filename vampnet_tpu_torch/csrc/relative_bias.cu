// Gradient of the T5 relative-position bias with respect to its bucket
// table, for Hopper (sm_90a).
//
// The forward gathers a (num_buckets, h) table into an (h, t_q, t_k) bias,
// bias[h, i, j] = table[bucket(j - i), h]. Its gradient is
//   dtable[b, h] = sum over (i, j) with bucket(j - i) == b of dbias[h, i, j].
// Replaces no TPU kernel: in the JAX package XLA's scatter-add takes the
// gather's gradient (`position_bias_from_params`,
// vampnet_tpu/modules/transformer.py:119-136). The port had left it to
// autograd's index backward, which sorts the t_q t_k indices and sums each
// bucket's duplicates one after another in a single warp: the two far
// buckets each hold about 40% of the positions at t = 862.
//
// What bounds it: one read of dbias (20 x 862 x 862 fp32 = 59 MB, 18 us at
// 3.35 TB/s); the table and the bucket vector are a few KB.
//
// Design. The bucket depends on j - i alone and, for the T5 function, is
// monotone in it on each side of the diagonal, so along a row every bucket
// is one contiguous run of columns. A block owns one head and ROWS rows; a
// warp walks a row with 16-byte loads, 32 lanes side by side (the row is
// read through the flat tensor, so a row that starts off a 16-byte boundary
// loads its neighbours' elements and drops them), UNROLL loads a lane in
// flight. A lane adds its elements in a register while their bucket stays
// the same (away from the diagonal, its whole share of a far bucket's run)
// and, when the bucket changes or the row ends, adds the run's sum to its
// own column of the warp's (bucket, lane) sums in shared memory, whose rows
// are padded to 33 so that a bucket's 32 lanes hit 32 banks. The buckets of
// the tile's offsets sit beside them, one byte each. At the end each lane
// adds up one bucket's 32 columns in lane order, the block adds its warps in
// warp order into one partial per (head, row tile, bucket), and a second
// launch adds the partials over the row tiles in a fixed order. No
// floating-point atomics and no order that depends on timing: the same
// input gives the same bits.
//
// Any bucket vector gives the right sums (the runs only save additions);
// buckets outside [0, num_buckets) are skipped, and num_buckets must be
// under 255.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 16;   // rows of one head per block, ROWS / WARPS a warp
constexpr int UNROLL = 4;  // windows whose loads a lane keeps in flight
constexpr int LANE_PAD = 33;  // a bucket's 32 lane sums, padded: no bank conflicts
constexpr int NO_BUCKET = 255;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static float lo(unsigned w) { return __uint_as_float(w << 16); }
  __device__ static float hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
  __device__ static void unpack(const uint4& r, float (&v)[8]) {
    v[0] = lo(r.x); v[1] = hi(r.x); v[2] = lo(r.y); v[3] = hi(r.y);
    v[4] = lo(r.z); v[5] = hi(r.z); v[6] = lo(r.w); v[7] = hi(r.w);
  }
};

// vector v of the flat tensor (total elements), zeros past its end
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ x, long long v, long long total) {
  constexpr int N = Vec<T>::N;
  if ((v + 1) * N <= total) {
    return __ldg(reinterpret_cast<const uint4*>(x) + v);
  }
  alignas(16) T part[N];
  for (int k = 0; k < N; ++k) {
    long long e = v * N + k;
    part[k] = e < total ? x[e] : T(0.f);
  }
  return *reinterpret_cast<const uint4*>(part);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
relative_bias_partials_kernel(const T* __restrict__ dbias, const int* __restrict__ buckets,
                              float* __restrict__ partial, int t_q, int t_k, int nb) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float smem[];
  float* cols = smem;                                  // [WARPS][nb][LANE_PAD]
  float* wsum = cols + WARPS * nb * LANE_PAD;          // [WARPS][nb]
  unsigned char* sb = reinterpret_cast<unsigned char*>(wsum + WARPS * nb);
  const int tile = blockIdx.x, hh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = tile * ROWS;
  const int i_hi = min(i0 + ROWS, t_q) - 1;
  // sb[s] is the bucket of offset s - i_hi (NO_BUCKET outside [0, nb)): the
  // tile's rows see offsets -i_hi .. t_k - 1 - i0
  const int n_sb = t_k + i_hi - i0;
  for (int s = threadIdx.x; s < n_sb; s += THREADS) {
    const int b = buckets[s - i_hi + t_q - 1];
    sb[s] = (b >= 0 && b < nb) ? (unsigned char)b : NO_BUCKET;
  }
  for (int s = threadIdx.x; s < WARPS * nb * LANE_PAD; s += THREADS) cols[s] = 0.f;
  __syncthreads();

  // this lane's column: its sum of each bucket, at mine[b * LANE_PAD]
  float* mine = cols + warp * nb * LANE_PAD + lane;
  const long long total = (long long)gridDim.y * t_q * t_k;
  for (int i = i0 + warp; i <= i_hi; i += WARPS) {
    const long long row0 = ((long long)hh * t_q + i) * t_k;
    const long long v_begin = row0 / N;
    const long long v_end = (row0 + t_k + N - 1) / N;
    const unsigned char* row_sb = sb + (i_hi - i);  // the bucket of column j at row_sb[j]
    int cur = NO_BUCKET;  // the bucket of the run this lane is adding up
    float run = 0.f;
    for (long long v0 = v_begin; v0 < v_end; v0 += 32 * UNROLL) {
      uint4 raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long v = v0 + u * 32 + lane;
        raw[u] = v < v_end ? load_vec(dbias, v, total) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long v = v0 + u * 32 + lane;
        if (v >= v_end) break;
        const int j0 = (int)(v * N - row0);  // column of the vector's first element
        float x[N];
        Vec<T>::unpack(raw[u], x);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int j = j0 + k;
          const int b = (j >= 0 && j < t_k) ? row_sb[j] : NO_BUCKET;
          if (b != cur) {
            if (cur != NO_BUCKET) mine[cur * LANE_PAD] += run;
            cur = b;
            run = 0.f;
          }
          run += x[k];
        }
      }
    }
    if (cur != NO_BUCKET) mine[cur * LANE_PAD] += run;
  }
  __syncwarp();
  // the warp's 32 columns into one sum per bucket, in lane order
  for (int b = lane; b < nb; b += 32) {
    const float* r = cols + (warp * nb + b) * LANE_PAD;
    float s = 0.f;
    for (int l = 0; l < 32; ++l) s += r[l];
    wsum[warp * nb + b] = s;
  }
  __syncthreads();
  float* out = partial + ((long long)hh * gridDim.x + tile) * nb;
  for (int b = threadIdx.x; b < nb; b += THREADS) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += wsum[w * nb + b];
    out[b] = s;
  }
}

// out[b, h] = the sum of partial[h, :, b] over the row tiles, one warp an
// output: lane l adds tiles l, l + 32, ... in order, then a butterfly of
// shuffles (the same order on every call) adds the lanes
__global__ void relative_bias_sum_kernel(const float* __restrict__ partial, void* out,
                                         int out_is_bf16, int h, int tiles, int nb) {
  const int idx = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (idx >= nb * h) return;  // the same for the whole warp
  const int b = idx / h, hh = idx % h;
  const float* p = partial + (long long)hh * tiles * nb + b;
  float s = 0.f;
  for (int tile = lane; tile < tiles; tile += 32) s += p[(long long)tile * nb];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane != 0) return;
  if (out_is_bf16) {
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16(s);
  } else {
    static_cast<float*>(out)[idx] = s;
  }
}

int tiles_of(int t_q) { return (t_q + ROWS - 1) / ROWS; }

size_t smem_bytes(int t_k, int nb) {
  return sizeof(float) * WARPS * nb * (LANE_PAD + 1) + (size_t)(t_k + ROWS - 1);
}

template <typename T>
cudaError_t launch_partials(const void* dbias, const void* buckets, float* partial, int h,
                            int t_q, int t_k, int nb, cudaStream_t stream) {
  const size_t smem = smem_bytes(t_k, nb);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(relative_bias_partials_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  relative_bias_partials_kernel<T><<<dim3(tiles_of(t_q), h), THREADS, smem, stream>>>(
      static_cast<const T*>(dbias), static_cast<const int*>(buckets), partial, t_q, t_k, nb);
  return cudaGetLastError();
}

}  // namespace

// fp32 floats of scratch the gradient needs: one partial per (head, row
// tile, bucket)
extern "C" int vampnet_relative_bias_partials(int h, int t_q, int num_buckets) {
  return h * tiles_of(t_q) * num_buckets;
}

// dbias (h, t_q, t_k) fp32 or bf16, contiguous, 16-byte aligned; buckets
// (t_q + t_k - 1) int32, the bucket of offset j - i at j - i + t_q - 1;
// partial: vampnet_relative_bias_partials() fp32; out (num_buckets, h) fp32
// or bf16
extern "C" int vampnet_relative_bias_grad(const void* dbias, int dbias_is_bf16,
                                          const void* buckets, void* partial, void* out,
                                          int out_is_bf16, int h, int t_q, int t_k,
                                          int num_buckets, int device, void* stream) {
  if (h <= 0 || t_q <= 0 || t_k <= 0 || num_buckets <= 0 || num_buckets >= NO_BUCKET ||
      h > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  err = dbias_is_bf16
            ? launch_partials<__nv_bfloat16>(dbias, buckets, part, h, t_q, t_k, num_buckets, s)
            : launch_partials<float>(dbias, buckets, part, h, t_q, t_k, num_buckets, s);
  if (err != cudaSuccess) return (int)err;
  const int n = num_buckets * h;  // outputs, one warp each
  relative_bias_sum_kernel<<<(n + WARPS - 1) / WARPS, THREADS, 0, s>>>(
      part, out, out_is_bf16, h, tiles_of(t_q), num_buckets);
  return (int)cudaGetLastError();
}
