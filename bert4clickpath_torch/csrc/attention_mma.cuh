// Building blocks of the attention kernels that run their products on the
// tensor cores: bf16 tiles in shared memory filled by asynchronous 16-byte
// copies, fragments read with ldmatrix, and mma.sync.m16n8k16 (bf16 x bf16,
// f32 sums) products of a warp's 16 rows against a tile.
//
// A tile is ROWS x DHP bf16, row-major, with a row stride of DHP + kSkew
// elements: the 16 bytes of skew put the eight 16-byte rows of every 8 x 8
// matrix that ldmatrix reads into eight different groups of four banks, for
// every DHP in {16, 32, 64, 128}, so no fragment load has a bank conflict.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16)  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16 x 8)   b0 (k 2t..2t+1, n g)              b1 (k 2t+8.., n g)
//   C (16 x 8)   c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// so two neighbouring n8 accumulator tiles 2m and 2m+1, rounded to bf16 and
// packed in pairs, are the A fragment of k-step m of the next product
// (pack_bf16 below; c0,c1 -> a0, c2,c3 -> a1 of tile 2m; a2, a3 of 2m+1):
// a chained product never goes through shared memory.

#pragma once

#include "common.cuh"

namespace tc {

constexpr int kSkew = 8;  // bf16 elements of padding per shared-memory row

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; where !valid the
// 16 bytes are zero-filled and src is not read
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(shared_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + ROWS) x columns [0, dh) of src (row stride in
// elements) into a tile; zero past seq_len and dh. vec: dh, the strides and
// the base address allow 16-byte asynchronous copies (the caller commits and
// waits); else plain element loads fill the same tile.
template <int ROWS, int DHP, int THREADS>
__device__ __forceinline__ void fill_tile(__nv_bfloat16* __restrict__ dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          long long row_stride, int row0, int seq_len,
                                          int dh, bool vec) {
  constexpr int RS = DHP + kSkew;
  if (vec) {
    constexpr int CPR = DHP / 8;  // 16-byte chunks per row
#pragma unroll 4
    for (int idx = threadIdx.x; idx < ROWS * CPR; idx += THREADS) {
      const int r = idx / CPR;
      const int c = (idx % CPR) * 8;
      const bool valid = row0 + r < seq_len && c < dh;
      const __nv_bfloat16* from = valid ? src + (row0 + r) * row_stride + c : src;
      cp_async_16(dst + r * RS + c, from, valid);
    }
  } else {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < ROWS * DHP; idx += THREADS) {
      const int r = idx / DHP;
      const int c = idx % DHP;
      const bool valid = row0 + r < seq_len && c < dh;
      dst[r * RS + c] = valid ? src[(row0 + r) * row_stride + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// dst[i] = src[(row0 + i) * stride] for i < n (asynchronous 4-byte copies),
// `past` where row0 + i >= seq_len
template <int THREADS>
__device__ __forceinline__ void fill_rows_f32(float* __restrict__ dst,
                                              const float* __restrict__ src,
                                              long long stride, int row0, int n,
                                              int seq_len, float past) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    if (row0 + i < seq_len) {
      cp_async_4(dst + i, src + (row0 + i) * stride);
    } else {
      dst[i] = past;
    }
  }
}

// Four 8 x 8 bf16 matrices, one ldmatrix: lanes 8 i .. 8 i + 7 give the row
// addresses of matrix i, and every lane receives elements (g, 2t..2t+1) of
// each matrix (.trans: (2t..2t+1, g)).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The lane's element offset inside a 16 x 16 block of a tile, for the two
// orders in which one ldmatrix.x4 can fetch the block's four 8 x 8 matrices:
//   rows first  (rows 0-7, cols 0-7) (8-15, 0-7) (0-7, 8-15) (8-15, 8-15):
//               an A fragment; with .trans, of a [k][n] tile, b0 and b1 of
//               the n8 tile at cols 0-7, then of the one at cols 8-15
//   cols first  (0-7, 0-7) (0-7, 8-15) (8-15, 0-7) (8-15, 8-15): of a [n][k]
//               tile, b0 and b1 of the n8 tile at rows 0-7, then rows 8-15
template <int RS>
__device__ __forceinline__ int lane_offset_rows_first(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8;
}
template <int RS>
__device__ __forceinline__ int lane_offset_cols_first(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * RS + ((lane >> 3) & 1) * 8;
}

// d (16 x 8, f32) += a (16 x 16 bf16) . b (16 x 8 bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two f32 as two bf16 terms each, hi = round(x) and lo = round(x - hi)
// (~16 bits of x kept), packed like pack_bf16: a product that takes hi and
// lo in turn into the same f32 sums sees x all but unrounded
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// max / sum over the four lanes (t = 0..3) that share an accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The A fragments of a warp's 16 x DHP rows of a tile, one per k-step.
// a_addr: shared address of the rows' first element + the lane's
// rows-first offset (bytes).
template <int DHP>
__device__ __forceinline__ void load_a(uint32_t (&frag)[DHP / 16][4], uint32_t a_addr) {
#pragma unroll
  for (int ks = 0; ks < DHP / 16; ++ks) ldmatrix_x4(frag[ks], a_addr + ks * 32);
}

// One k-step of acc (16 x 8 NT) += A . B^T: B is a [8 NT][DHP] tile (its
// rows are the product's columns); b_addr: the tile's shared address + the
// lane's cols-first offset.
template <int DHP, int NT>
__device__ __forceinline__ void abt_step(float (&acc)[NT][4], const uint32_t (&a)[4],
                                         uint32_t b_addr, int ks) {
  constexpr int RS = DHP + kSkew;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t b[4];
    ldmatrix_x4(b, b_addr + (np * 16 * RS + ks * 16) * 2);
    mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// acc (16 x 8 NT) += A (16 x DHP) . B^T with A's fragments in registers ...
template <int DHP, int NT>
__device__ __forceinline__ void product_abt(float (&acc)[NT][4],
                                            const uint32_t (&a)[DHP / 16][4],
                                            uint32_t b_addr) {
#pragma unroll
  for (int ks = 0; ks < DHP / 16; ++ks) abt_step<DHP, NT>(acc, a[ks], b_addr, ks);
}
// ... or read from shared memory k-step by k-step (a_addr as for load_a)
template <int DHP, int NT>
__device__ __forceinline__ void product_abt(float (&acc)[NT][4], uint32_t a_addr,
                                            uint32_t b_addr) {
#pragma unroll
  for (int ks = 0; ks < DHP / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, a_addr + ks * 32);
    abt_step<DHP, NT>(acc, a, b_addr, ks);
  }
}

// acc (16 x DHP) += A (16 x 16 KT, fragments in registers) . B: B is a
// [16 KT][DHP] tile read down its rows (ldmatrix .trans); b_addr: the tile's
// shared address + the lane's rows-first offset.
template <int DHP, int KT>
__device__ __forceinline__ void product_ab(float (&acc)[DHP / 8][4],
                                           const uint32_t (&a)[KT][4], uint32_t b_addr) {
  constexpr int RS = DHP + kSkew;
#pragma unroll
  for (int ks = 0; ks < KT; ++ks) {
#pragma unroll
    for (int np = 0; np < DHP / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_addr + (ks * 16 * RS + np * 16) * 2);
      mma_bf16(acc[2 * np], a[ks], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[ks], b[2], b[3]);
    }
  }
}

// A warp's 16 x DHP accumulators, rounded once to bf16, into a (rows, d)
// row-major tensor at dst (row 0, the head's first column): rows
// row0 + g and row0 + g + 8 below seq_len, columns below dh. paired: dh is
// even and dst 4-byte aligned, so two neighbouring columns go in one store.
template <int DHP>
__device__ __forceinline__ void store_acc(__nv_bfloat16* __restrict__ dst,
                                          const float (&acc)[DHP / 8][4], int row0,
                                          int seq_len, int d, int dh, int lane,
                                          bool paired) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= seq_len) continue;
    __nv_bfloat16* out = dst + static_cast<long long>(row) * d;
#pragma unroll
    for (int nt = 0; nt < DHP / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      const float lo = acc[nt][2 * half];
      const float hi = acc[nt][2 * half + 1];
      if (paired) {
        if (col < dh) *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(lo, hi);
      } else {
        if (col < dh) out[col] = __float2bfloat16_rn(lo);
        if (col + 1 < dh) out[col + 1] = __float2bfloat16_rn(hi);
      }
    }
  }
}

}  // namespace tc
