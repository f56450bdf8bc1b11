// Hopper's own building blocks, for kernels built as a producer/consumer
// pipeline (sm_90a only): tensor maps and TMA tile loads, mbarriers,
// warpgroup register hand-over (setmaxnreg) and the warpgroup products
// (wgmma) with B read from shared memory through a matrix descriptor and A
// from registers.
//
// The shape every user follows: one producer thread issues TMA loads of 2-D
// tiles into a ring of shared-memory stages, each stage guarded by an
// mbarrier that the loads complete by their byte count; consumer warpgroups
// wait on it, run wgmma on the stage and arrive on the stage's "empty"
// barrier so that the producer may load it again. A tile loaded with the
// 128-byte (or 64-byte) swizzle is read by wgmma through a descriptor of the
// same swizzle, which is what makes the two agree; a plane written by
// threads in that layout (a converted copy of a stage) has to be fenced
// with fence_proxy_async before wgmma, which reads through the async proxy,
// sees it.
//
// Users: the CE forward and the merged CE backward (fused_ce.cu: 2-D maps,
// K-major tf32 and bf16 B tiles, A in registers; the backward also adds
// its dx into device memory with TMA reduce-adds and meets its two
// consumer warpgroups at named barriers) and the bf16 blockwise attention
// forward, dq and dk/dv (attention_blockwise.cu: rank-4 maps over (head
// column, head, row, batch), both operands of the score products (S = Q
// K^T, dP = dO V^T, and transposed in dk/dv, at N = 128 or 64) from shared
// memory, and the products that take P or dS (O += P V, dQ += dS K, dV +=
// P^T dO, dK += dS^T Q) with them in registers and their B read MN-major,
// transposed by the product itself). The two-pass CE backward is meant to
// take the same pieces (ROADMAP.md, Queue 2).

#pragma once

#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's declaration (no link to libcuda)

#include "common.cuh"

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// one arrival, and `bytes` more transaction bytes for the phase to wait for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` has completed (a fresh barrier is in
// phase 0: waiting on parity 1 passes at once)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ TMA

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// the box of `map` at (c0 inner, c1 outer) into shared memory at dst,
// completing `bytes` (the whole box, zero-filled past the tensor's edge) on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// the box of a rank-1 map at c0, as tma_load_2d
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}
// the box of a rank-4 map at (c0 innermost, c1, c2, c3), as tma_load_2d
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// orders this thread's generic-proxy shared-memory writes before later
// async-proxy accesses (wgmma's operand reads, TMA's writes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the box of `map` at (c0 inner, c1 outer) added element by element (f32
// atomic adds in L2) from shared memory at src, laid out as tma_load_2d
// writes it; one bulk group per commit_bulk. The writers of src fence
// with fence_proxy_async and meet at a barrier before one thread issues it.
__device__ __forceinline__ void tma_reduce_add_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void commit_bulk() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void wait_bulk_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// until this thread's bulk groups have completed (their writes done)
__device__ __forceinline__ void wait_bulk() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// a barrier of `count` threads (a multiple of 32) on named barrier `id`
// (1-15; 0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// -------------------------------------------------- warpgroup registers

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- wgmma

enum Swizzle : int { kSwizzle128 = 1, kSwizzle64 = 2, kSwizzle32 = 3 };  // the descriptor's layout field

// the swizzle that rows of `row_bytes` (128, 64 or 32) take, in TMA's and
// in the descriptor's terms
template <int ROW_BYTES>
constexpr Swizzle swizzle_of() {
  static_assert(ROW_BYTES == 128 || ROW_BYTES == 64 || ROW_BYTES == 32, "a swizzled row is 32, 64 or 128 bytes");
  return ROW_BYTES == 128 ? kSwizzle128 : ROW_BYTES == 64 ? kSwizzle64 : kSwizzle32;
}
template <int ROW_BYTES>
constexpr CUtensorMapSwizzle tma_swizzle_of() {
  return ROW_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : ROW_BYTES == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

// The descriptor of a K-major operand tile in shared memory: rows of 128
// (kSwizzle128), 64 (kSwizzle64) or 32 (kSwizzle32) bytes, as TMA writes them with the same
// swizzle, 8-row groups `group_bytes` apart; the tile must start on a
// 1,024-byte boundary (the swizzle is a function of the address bits). A
// k-step further along the row adds its byte offset / 16 to the descriptor.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, Swizzle swizzle, uint32_t group_bytes) {
  uint64_t desc = (addr & 0x3FFFF) >> 4;             // start address
  desc |= static_cast<uint64_t>(1) << 16;             // leading offset: unused for swizzled K-major
  desc |= static_cast<uint64_t>(group_bytes >> 4) << 32;  // stride between 8-row groups
  desc |= static_cast<uint64_t>(swizzle) << 62;
  return desc;
}

// The descriptor of an MN-major operand tile (B of O += P V: V as it lies,
// [key][head column], the product's N running along the rows): groups of 8
// K-rows of `row_bytes` (128, 64 or 32, as TMA writes them with that
// swizzle; one row holds 64, 32 or 16 bf16 of N), `k_group_bytes` apart;
// N beyond one row's width continues in the next column box,
// `mn_group_bytes` further. The wgmma that reads it sets its transpose bit
// for B. A k-step of 16 K-rows further adds 16 row_bytes / 16.
__device__ __forceinline__ uint64_t make_desc_mn(uint32_t addr, Swizzle swizzle, uint32_t mn_group_bytes,
                                                 uint32_t k_group_bytes) {
  uint64_t desc = (addr & 0x3FFFF) >> 4;                      // start address
  desc |= static_cast<uint64_t>(mn_group_bytes >> 4) << 16;  // leading offset: the next N group
  desc |= static_cast<uint64_t>(k_group_bytes >> 4) << 32;   // stride: the next 8 K-rows
  desc |= static_cast<uint64_t>(swizzle) << 62;
  return desc;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products that own them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define B4CP_ACC8(i)                                                                                \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define B4CP_OUT8(i)                                                                                \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]), "=f"(d[i + 4]), "=f"(d[i + 5]), \
      "=f"(d[i + 6]), "=f"(d[i + 7])
#define B4CP_OUT32 B4CP_OUT8(0), B4CP_OUT8(8), B4CP_OUT8(16), B4CP_OUT8(24)
#define B4CP_OUT64 \
  B4CP_OUT8(0), B4CP_OUT8(8), B4CP_OUT8(16), B4CP_OUT8(24), B4CP_OUT8(32), B4CP_OUT8(40), B4CP_OUT8(48), B4CP_OUT8(56)
#define B4CP_ACC16 B4CP_ACC8(0), B4CP_ACC8(8)
#define B4CP_ACC32 B4CP_ACC16, B4CP_ACC8(16), B4CP_ACC8(24)
#define B4CP_ACC64 \
  B4CP_ACC8(0), B4CP_ACC8(8), B4CP_ACC8(16), B4CP_ACC8(24), B4CP_ACC8(32), B4CP_ACC8(40), B4CP_ACC8(48), B4CP_ACC8(56)
#define B4CP_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define B4CP_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define B4CP_D32                                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define B4CP_D64                                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "   \
  "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "   \
  "%62, %63}"

// d (64 x 128, f32) = d * (scale_d != 0) + A (64 x 8 tf32, registers) . B^T
// (B: 128 rows x 8, K-major, through desc_b). The warpgroup's thread of
// warp w and lane 4g + t holds A's rows 16w + g (a0, a2) and 16w + g + 8
// (a1, a3) at columns t (a0, a1) and t + 4 (a2, a3), and d's rows 16w + g
// (d[4j], d[4j + 1]) and 16w + g + 8 (d[4j + 2], d[4j + 3]) at columns 8j +
// 2t and 8j + 2t + 1.
__device__ __forceinline__ void wgmma_tf32_m64n128k8(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                                     int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " B4CP_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : B4CP_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// the same with bf16 operands, k = 16: A's registers hold column pairs 2t,
// 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2, a3) of the same rows
__device__ __forceinline__ void wgmma_bf16_m64n128k16(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " B4CP_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : B4CP_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128, f32) += A (64 x 16 bf16) . B^T with both operands in
// shared memory, K-major (desc_a: 64 rows; desc_b: 128 rows), as make_desc
// describes them
__device__ __forceinline__ void wgmma_bf16_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " B4CP_D64 ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : B4CP_ACC64
      : "l"(desc_a), "l"(desc_b));
}

// d = A . B^T, the same with d written, not read: the first k-step of a
// product, so that no instruction that writes d before it counts as
// defining one of its inputs while an earlier product is in flight
__device__ __forceinline__ void wgmma_bf16_m64n128k16_ss_first(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " B4CP_D64 ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : B4CP_OUT64
      : "l"(desc_a), "l"(desc_b));
}

// the same two at N = 64 (d: 32 values a thread)
__device__ __forceinline__ void wgmma_bf16_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " B4CP_D32 ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : B4CP_ACC32
      : "l"(desc_a), "l"(desc_b));
}
__device__ __forceinline__ void wgmma_bf16_m64n64k16_ss_first(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " B4CP_D32 ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : B4CP_OUT32
      : "l"(desc_a), "l"(desc_b));
}

// d (64 x N) (+)= A . B^T with both operands K-major in shared memory, N =
// 64 or 128; FIRST: d written, not read (a product's first k-step)
template <int N, bool FIRST>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b) {
  static_assert(N == 64 || N == 128, "N is 64 or 128");
  if constexpr (N == 64 && FIRST) wgmma_bf16_m64n64k16_ss_first(d, desc_a, desc_b);
  if constexpr (N == 64 && !FIRST) wgmma_bf16_m64n64k16_ss(d, desc_a, desc_b);
  if constexpr (N == 128 && FIRST) wgmma_bf16_m64n128k16_ss_first(d, desc_a, desc_b);
  if constexpr (N == 128 && !FIRST) wgmma_bf16_m64n128k16_ss(d, desc_a, desc_b);
}

// d (64 x N, f32) = d * (scale_d != 0) + A (64 x 16 bf16, registers, laid
// out as for wgmma_bf16_m64n128k16) . B, B (16 x N) MN-major through desc_b
// (make_desc_mn): the transpose bit set. N = 16, 32, 64 or 128; d holds
// N / 2 values a thread in the layout of the other products.
#define B4CP_WGMMA_TB(N, ACC, DLIST, A0, A1, A2, A3, DESC, SCALE)                                          \
  __device__ __forceinline__ void wgmma_bf16_m64n##N##k16_tb(float (&d)[N / 2], const uint32_t (&a)[4],    \
                                                             uint64_t desc_b, int scale_d) {             \
    asm volatile(                                                                                        \
        "{\n"                                                                                            \
        ".reg .pred p;\n"                                                                                \
        "setp.ne.b32 p, %" #SCALE ", 0;\n"                                                               \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " DLIST ", {%" #A0 ", %" #A1 ", %" #A2  \
        ", %" #A3 "}, %" #DESC ", p, 1, 1, 1;\n"                                                          \
        "}\n"                                                                                            \
        : ACC                                                                                            \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));                        \
  }
B4CP_WGMMA_TB(16, B4CP_ACC8(0), B4CP_D8, 8, 9, 10, 11, 12, 13)
B4CP_WGMMA_TB(32, B4CP_ACC16, B4CP_D16, 16, 17, 18, 19, 20, 21)
B4CP_WGMMA_TB(64, B4CP_ACC32, B4CP_D32, 32, 33, 34, 35, 36, 37)
B4CP_WGMMA_TB(128, B4CP_ACC64, B4CP_D64, 64, 65, 66, 67, 68, 69)
#undef B4CP_WGMMA_TB

// d (64 x N, f32) = d * (scale_d != 0) + A (registers) . B^T, B (N rows)
// K-major through desc_b: tf32 (k = 8, A laid out as for
// wgmma_tf32_m64n128k8) or bf16 (k = 16, as for wgmma_bf16_m64n128k16),
// N = 16 (tf32), 32 or 64; d holds N / 2 values a thread in the same layout
#define B4CP_WGMMA_RS(TYPE, K, N, ACC, DLIST, A0, A1, A2, A3, DESC, SCALE, TAIL)                             \
  __device__ __forceinline__ void wgmma_##TYPE##_m64n##N##k##K(float (&d)[N / 2], const uint32_t (&a)[4],    \
                                                              uint64_t desc_b, int scale_d) {              \
    asm volatile(                                                                                          \
        "{\n"                                                                                              \
        ".reg .pred p;\n"                                                                                  \
        "setp.ne.b32 p, %" #SCALE ", 0;\n"                                                                 \
        "wgmma.mma_async.sync.aligned.m64n" #N "k" #K ".f32." #TYPE "." #TYPE " " DLIST ", {%" #A0         \
        ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DESC ", p, 1, 1" TAIL ";\n"                                  \
        "}\n"                                                                                              \
        : ACC                                                                                              \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));                          \
  }
B4CP_WGMMA_RS(tf32, 8, 16, B4CP_ACC8(0), B4CP_D8, 8, 9, 10, 11, 12, 13, "")
B4CP_WGMMA_RS(tf32, 8, 32, B4CP_ACC16, B4CP_D16, 16, 17, 18, 19, 20, 21, "")
B4CP_WGMMA_RS(tf32, 8, 64, B4CP_ACC32, B4CP_D32, 32, 33, 34, 35, 36, 37, "")
B4CP_WGMMA_RS(bf16, 16, 32, B4CP_ACC16, B4CP_D16, 16, 17, 18, 19, 20, 21, ", 0")
B4CP_WGMMA_RS(bf16, 16, 64, B4CP_ACC32, B4CP_D32, 32, 33, 34, 35, 36, 37, ", 0")
#undef B4CP_WGMMA_RS

// the same by N, for either type (bf16: N = 32 or 64)
template <int N, bool BF16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  static_assert(N == 32 || N == 64 || (N == 16 && !BF16), "N is 16 (tf32), 32 or 64");
  if constexpr (!BF16 && N == 16) wgmma_tf32_m64n16k8(d, a, desc_b, scale_d);
  if constexpr (!BF16 && N == 32) wgmma_tf32_m64n32k8(d, a, desc_b, scale_d);
  if constexpr (!BF16 && N == 64) wgmma_tf32_m64n64k8(d, a, desc_b, scale_d);
  if constexpr (BF16 && N == 32) wgmma_bf16_m64n32k16(d, a, desc_b, scale_d);
  if constexpr (BF16 && N == 64) wgmma_bf16_m64n64k16(d, a, desc_b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_bf16_tb(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b,
                                              int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "N is 16, 32, 64 or 128");
  if constexpr (N == 16) wgmma_bf16_m64n16k16_tb(d, a, desc_b, scale_d);
  if constexpr (N == 32) wgmma_bf16_m64n32k16_tb(d, a, desc_b, scale_d);
  if constexpr (N == 64) wgmma_bf16_m64n64k16_tb(d, a, desc_b, scale_d);
  if constexpr (N == 128) wgmma_bf16_m64n128k16_tb(d, a, desc_b, scale_d);
}

#undef B4CP_D64
#undef B4CP_D32
#undef B4CP_D16
#undef B4CP_D8
#undef B4CP_ACC64
#undef B4CP_ACC32
#undef B4CP_ACC16
#undef B4CP_ACC8
#undef B4CP_OUT64
#undef B4CP_OUT32
#undef B4CP_OUT8

// The part of an f32 (as its bits) below its tf32 truncation, as an f32. A
// wgmma reads a .tf32 operand's top 19 bits and ignores the other 13, so
// raw f32 in shared memory serves as the hi term of a split as it is, and
// this, exact in f32, is its lo term (of which the product again reads 11
// bits: x = hi + lo to ~2^-22 of x).
__device__ __forceinline__ uint32_t tf32_rest(uint32_t bits) {
  return __float_as_uint(__uint_as_float(bits) - __uint_as_float(bits & 0xFFFFE000u));
}

// byte offset of (row, byte `col_byte` of the row) in a tile whose rows are
// 128 (kSwizzle128) or 64 (kSwizzle64) bytes, as TMA writes it with that
// swizzle from a 1,024-byte boundary: the 16-byte chunk index is XORed with
// address bits 7-9 (128) or 7-8 (64)
template <Swizzle S>
__host__ __device__ __forceinline__ int swizzled(int row, int col_byte) {
  if constexpr (S == kSwizzle128) {
    return row * 128 + ((((col_byte >> 4) ^ row) & 7) << 4) + (col_byte & 15);
  } else {
    return row * 64 + ((((col_byte >> 4) ^ (row >> 1)) & 3) << 4) + (col_byte & 15);
  }
}

// ----------------------------------------------------------- host side

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library needs no link to libcuda; null where the driver lacks it
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr)
                                                                       : nullptr;
  }();
  return fn;
}

// The map of a row-major (rows, cols) matrix of `type` at base (16-byte
// aligned, rows `row_bytes` apart, a multiple of 16), cut into boxes of
// box_rows x box_cols, loaded with `swizzle`; zero past its edges.
inline cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t rows,
                             uint64_t cols, uint64_t row_bytes, uint32_t box_rows, uint32_t box_cols,
                             CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of a vector of dims[0] elements of `type` at base (16-byte
// aligned), boxes of box[0] (any start), unswizzled; zero past its end.
inline cudaError_t encode_1d(CUtensorMap* map, CUtensorMapDataType type, const void* base, const uint64_t (&dims)[1],
                             const uint32_t (&box)[1]) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t d[1] = {dims[0]};
  const cuuint64_t unused[1] = {16};  // a rank-1 map has no stride
  const cuuint32_t b[1] = {box[0]};
  const cuuint32_t elem[1] = {1};
  const CUresult res = encode(map, type, 1, const_cast<void*>(base), d, unused, b, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of a rank-4 tensor of `type` at base (16-byte aligned): dims[0]
// innermost and contiguous, dims[i] `strides[i - 1]` bytes apart (each a
// multiple of 16), cut into boxes of box[0] x ... x box[3], loaded with
// `swizzle`; zero past every edge (a box may be wider than its dimension).
inline cudaError_t encode_4d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                             const uint64_t (&dims)[4], const uint64_t (&strides)[3], const uint32_t (&box)[4],
                             CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t s[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t b[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, type, 4, const_cast<void*>(base), d, s, b, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
