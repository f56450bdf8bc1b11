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
// First used by the CE forward (fused_ce.cu); the CE backward kernels are
// meant to take the same mainloop (ROADMAP.md, Queue 2).

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
// orders this thread's generic-proxy shared-memory writes before later
// async-proxy accesses (wgmma's operand reads, TMA's writes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

enum Swizzle : int { kSwizzle128 = 1, kSwizzle64 = 2 };  // the descriptor's layout field

// The descriptor of a K-major operand tile in shared memory: rows of 128
// (kSwizzle128) or 64 (kSwizzle64) bytes, as TMA writes them with the same
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
#define B4CP_ACC64 \
  B4CP_ACC8(0), B4CP_ACC8(8), B4CP_ACC8(16), B4CP_ACC8(24), B4CP_ACC8(32), B4CP_ACC8(40), B4CP_ACC8(48), B4CP_ACC8(56)
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

#undef B4CP_D64
#undef B4CP_ACC64
#undef B4CP_ACC8

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

}  // namespace hopper
