// Hopper (sm_90a) building blocks in raw PTX, for the warp-specialised
// kernels (attention_fwd.cu, attention_bwd.cu, int8_matmul.cu, ffn.cu):
// mbarriers, TMA tile loads and reduce-adds, bulk copies of unaligned rows,
// cp.async copies that arrive on an mbarrier, programmatic dependent launch,
// wgmma with its shared-memory matrix descriptors, register hand-over between
// warpgroups (setmaxnreg), and the host-side encoding of TMA tensor maps.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vampnet {

// ------------------------------------------------------------ shared memory

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase with the given parity has completed. A
// wait that outlasts any sound one (2^32 cycles, about 2.5 s) traps, so that
// a broken pipeline ends the kernel with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  for (uint32_t polls = 1;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((polls & 1023) == 0) {
      const long long now = clock64();
      if (start == 0) {
        start = now;
      } else if (now - start > (1ll << 32)) {
        __trap();
      }
    }
  }
}

// ----------------------------------------------------------------- copies

// TMA: one tile of a 4-D tensor map into shared memory; completion is
// counted in bytes on `bar`. Out-of-bounds elements are filled with zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A bulk copy of `bytes` (a multiple of 16) global -> shared, both addresses
// 16-byte aligned; completion is counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// TMA: one tile of a 2-D tensor map into shared memory.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 16 bytes global -> shared, of which the first `src_bytes` (0..16) are read
// and the rest zero-filled. Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Waits until every cp.async this thread issued has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The producer's copy of one row window into shared memory: ROW bytes from
// the 16-byte boundary at or below `addr`, to be brought by one bulk copy
// (returned, in bytes, for the caller to count on the stage's barrier
// first). Nothing at or past `end` is read: where the window reaches it, the
// bulk copy stops at the last 16-byte boundary before it, and the tensor's
// last few bytes are copied here with plain loads and stores (the caller's
// arrival on the barrier publishes them).
template <int ROW>
__device__ __forceinline__ uint32_t row_window(unsigned char* dst, uintptr_t addr, uintptr_t end,
                                               uintptr_t& src) {
  src = addr & ~uintptr_t(15);
  const uintptr_t end16 = end & ~uintptr_t(15);
  if (src + ROW <= end16) return ROW;
  if (end > end16 && end16 >= src && end16 < src + ROW) {
    for (uintptr_t a = end16; a < end; ++a) dst[a - src] = *reinterpret_cast<const uint8_t*>(a);
  }
  return end16 > src ? (uint32_t)(end16 - src) : 0u;
}

// TMA: adds a tile of fp32 in shared memory into a 4-D tensor map's box in
// global memory (the add is done at L2; elements out of bounds are skipped).
// Completion is tracked by bulk groups: commit, then wait before the tile is
// written again.
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map, uint32_t src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Orders this thread's async-proxy accesses to global memory (bulk copies,
// reduce-adds that have completed) before its later generic-proxy ones.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Programmatic dependent launch: a kernel launched with the
// programmatic-serialization attribute may start before the kernel ahead of
// it on the stream ends; griddep_wait blocks until that kernel has finished
// and its writes are visible, and griddep_launch_dependents lets the next
// kernel start early.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// L2 eviction policies for the cache hints below: evict_last for data a
// kernel comes back to, evict_first for data read once.
__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// 16 bytes register -> global (16-byte aligned), with an L2 cache policy.
__device__ __forceinline__ void st_global_16_hint(void* dst, uint4 v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(policy)
               : "memory");
}

// As bulk_load, with an L2 cache policy.
__device__ __forceinline__ void bulk_load_hint(uint32_t dst, const void* src, uint32_t bytes,
                                               uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// A bulk copy of `bytes` (a multiple of 16) shared -> global, both addresses
// 16-byte aligned, with an L2 cache policy, tracked by bulk groups.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes,
                                           uint64_t policy) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n" ::
                   "l"(dst),
               "r"(src), "r"(bytes), "l"(policy)
               : "memory");
}

// As bulk_store, adding fp32 values into global memory (the add is done at
// L2).
__device__ __forceinline__ void bulk_reduce_add_f32(void* dst, uint32_t src, uint32_t bytes,
                                                    uint64_t policy) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.L2::cache_hint.add.f32 [%0], [%1], %2, "
      "%3;\n" ::"l"(dst),
      "r"(src), "r"(bytes), "l"(policy)
      : "memory");
}

// 8 bytes global -> shared, both addresses 8-byte aligned, with an L2 cache
// policy.
__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src, uint64_t policy) {
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "l"(policy)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk groups are pending: with READ,
// only until their shared-memory sources have been read.
template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ) {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
  }
}

// An arrival on `bar` once every cp.async this thread issued so far has
// landed; it counts as one of the arrivals the barrier was initialised with.
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------------------- wgmma
//
// A shared-memory matrix descriptor for the 128-byte swizzle that a TMA load
// with CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 64 bf16 (128 bytes), 8 rows
// (1,024 bytes, the swizzle atom) apart by SBO. K-major (the reduction runs
// along the row): a k16 step advances the start by 32 bytes, the next 64
// columns sit in the next slab. MN-major (the reduction runs down the rows):
// a k16 step advances by 16 rows (2,048 bytes), and LBO is the distance to
// the next 64 columns of N. Tiles start 1,024-byte aligned.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// 2^x, flushing a subnormal result to zero (one MUFU.EX2).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers so that the compiler neither reads nor moves
// them while a wgmma that writes them is in flight.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define VN_ACC8(d, i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define VN_ACC32(d) VN_ACC8(d, 0), VN_ACC8(d, 8), VN_ACC8(d, 16), VN_ACC8(d, 24)
#define VN_ACC64(d) VN_ACC32(d), VN_ACC8(d, 32), VN_ACC8(d, 40), VN_ACC8(d, 48), VN_ACC8(d, 56)

#define VN_R32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define VN_R64                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 64, fp32) = (scale_d ? d : 0) + A B, A (64 x 16) and B (16 x 64)
// bf16 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VN_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : VN_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// As wgmma_m64n64k16_ss with both A and B MN-major: A (64 x 16) is stored
// as 16 rows of its 64 M values, B (16 x 64) as 16 rows of its 64 N values.
__device__ __forceinline__ void wgmma_m64n64k16_ss_mn(float (&d)[32], uint64_t da, uint64_t db,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VN_R32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : VN_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, fp32) = (scale_d ? d : 0) + A B, A (64 x 16) bf16 in
// registers (the m16n8k16 A fragment of each warp's 16 rows), B (16 x 64) in
// shared memory, MN-major.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VN_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : VN_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// As wgmma_m64n64k16_rs with N = 128.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VN_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : VN_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x N, fp32) = (scale_d ? d : 0) + A B, A (64 x 16) and B (16 x N)
// bf16 in shared memory, both K-major: the widths of the fused FFN's GEMMs
// (ffn.cu). d[4 j + e] is row 16 warp + lane / 4 (+ 8 for e >= 2), column
// 8 j + 2 (lane % 4) + (e & 1).
template <int N>
struct WgmmaBf16;

template <>
struct WgmmaBf16<112> {
  static __device__ __forceinline__ void mma(float (&d)[56], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
        "%47, %48, %49, %50, %51, %52, %53, %54, %55}, %56, %57, p, 1, 1, 0, 0;\n}\n"
        : VN_ACC32(d), VN_ACC8(d, 32), VN_ACC8(d, 40), VN_ACC8(d, 48)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
        "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
        "%62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : VN_ACC64(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16<144> {
  static __device__ __forceinline__ void mma(float (&d)[72], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
        "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71}, %72, %73, p, 1, 1, 0, 0;\n}\n"
        : VN_ACC64(d), VN_ACC8(d, 64)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16<160> {
  static __device__ __forceinline__ void mma(float (&d)[80], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
        "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76,"
        "%77, %78, %79}, %80, %81, p, 1, 1, 0, 0;\n}\n"
        : VN_ACC64(d), VN_ACC8(d, 64), VN_ACC8(d, 72)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16<192> {
  static __device__ __forceinline__ void mma(float (&d)[96], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
        "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76,"
        "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91,"
        "%92, %93, %94, %95}, %96, %97, p, 1, 1, 0, 0;\n}\n"
        : VN_ACC64(d), VN_ACC8(d, 64), VN_ACC8(d, 72), VN_ACC8(d, 80), VN_ACC8(d, 88)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

#undef VN_ACC8
#undef VN_ACC32
#undef VN_ACC64
#undef VN_R32
#undef VN_R64

// --------------------------------------------------------------------- host

// Encodes a TMA tensor map (cuTensorMapEncodeTiled, taken from the driver
// through the runtime, so the library needs no -lcuda): `rank` dims
// innermost first, the byte strides of dims 1 .. rank-1, the box, the
// swizzle; out-of-bounds elements read as zeros. Returns false where the
// driver refuses.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType dtype, int rank, const void* ptr,
                       const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr) return false;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  return encode(map, dtype, rank, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The TMA map over a row-major (rows, cols) matrix of `elem_bytes`-byte
// elements: boxes of box_rows rows x 128 bytes, 128-byte swizzle; rows past
// `rows` and columns past `cols` read as zeros. Encoding one costs more host
// time than the rest of a GEMM call, so maps are kept per host thread by
// (address, type, rows, cols, box): a map is a function of those alone, so a
// kept one is the one encoding would give, whatever tensor lives at the
// address now.
inline bool swizzled_map_2d(CUtensorMap* map, CUtensorMapDataType dtype, int elem_bytes,
                            const void* ptr, int rows, int cols, int box_rows) {
  struct Entry {
    const void* ptr;
    int dtype, rows, cols, box_rows;
    CUtensorMap map;
  };
  thread_local Entry kept[256] = {};
  const uintptr_t a = reinterpret_cast<uintptr_t>(ptr);
  Entry& e = kept[((a >> 8) ^ (a >> 16) ^ (uintptr_t)rows * 31u ^ (uintptr_t)box_rows ^
                   (uintptr_t)cols * 7u) &
                  255];
  if (e.ptr == ptr && e.dtype == (int)dtype && e.rows == rows && e.cols == cols &&
      e.box_rows == box_rows) {
    *map = e.map;
    return true;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)box_rows};
  if (!encode_map(map, dtype, 2, ptr, dims, stride, box, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return false;
  }
  e.ptr = ptr, e.dtype = (int)dtype, e.rows = rows, e.cols = cols, e.box_rows = box_rows;
  e.map = *map;
  return true;
}

// A tensor map over a contiguous (b, t, h, d) bf16 tensor, d a multiple of
// 64, as the 4-D (d, h, t, b) array: one box is 64 rows of t by 64 columns
// of d of one (batch row, head), landing as 64 rows of 128 bytes with the
// 128-byte swizzle. Rows past t read as zeros, so a tile never runs into the
// next batch row.
inline bool encode_bthd_map(CUtensorMap* map, const void* ptr, int b, int t, int h, int d) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)t, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)h * d * 2,
                                 (cuuint64_t)t * h * d * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace vampnet
