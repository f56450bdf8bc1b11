// Tensor-core building blocks of the fused-CE kernels (the forward of
// fused_ce.cu, the dx pass of fused_ce_two_pass.cu and the kernel below),
// and the kernel that owns table rows: the dW pass of fused_ce_two_pass.cu
// and the merged backward of fused_ce.cu are one template
// (ce_bwd_dw_mma_kernel, the merged backward with DX = true).
//
// Every product runs on the tensor cores with f32 sums:
//
//   kDxTf32x3   f32 x: x, W and A each as hi + lo tf32, three mma.m16n8k8
//               products (hi hi, hi lo, lo hi): kDxNumerics;
//   kDxBf16     bf16 x: W rounded to bf16 as the JAX kernel's
//               w.astype(x.dtype), A rounded once, one m16n8k16 product.
//
// kDxTf32 (one tf32 product) and kDxBf16x3 (hi + lo bf16, three products)
// are the other values of kDxNumerics that the numerics decision measured
// (PERF.md): tune_blockwise_bwd.py --kernel ce_dx --variant
// tf32:kDxNumerics=kDxTf32 builds one. Only kDxNumerics and kDxBf16 are
// compiled.
//
// Tiles are 64 rows of x by 64 table rows, worked by 8 warps: four row
// groups of 16 rows, kDxColWarps side by side over a 64-column chunk. An
// operand that streams passes through cp.async stages of raw elements, 64
// rows x 64 columns, each converted once into the numerics' planes (hi and
// lo terms) that every warp reads with ldmatrix; a block's resident operand
// stays raw f32 (tf32: fragments split it as they are read) or in bf16
// planes. Every kDxFlush k-steps the products go into fresh registers and
// join the running f32 sums with adds that round to nearest (kstep_sum).

#pragma once

#include <type_traits>

#include "attention_mma.cuh"

namespace {

constexpr int kTile = 64;  // rows of x, and rows of the table, per tile
constexpr float kNegBig = -1e30f;  // the blinding of rows outside the window
// the most dynamic shared memory one block can have on sm_90
constexpr size_t kMaxSmem = 232448;
constexpr int kOutChunks = 6;  // 64-column chunks of output a block owns
constexpr int kOutCols = kTile * kOutChunks;

__device__ __forceinline__ bool in_window(int col, int row_offset, int num_valid) {
  return col >= row_offset && col < row_offset + num_valid;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

enum DxNumerics : int { kDxTf32 = 0, kDxTf32x3 = 1, kDxBf16x3 = 2, kDxBf16 = 3 };
// f32 x: the fastest numerics that holds every f32 tolerance (PERF.md)
constexpr int kDxNumerics = kDxTf32x3;

// warps side by side over a chunk's 64 columns (of s, and of each dx
// chunk); four row groups of 16 rows each
constexpr int kDxColWarps = 2;
constexpr int kDxWarps = 4 * kDxColWarps;
constexpr int kDxThreads = kDxWarps * 32;
constexpr int kDxNT = 64 / kDxColWarps / 8;  // n8 tiles of a warp's columns
constexpr int kDxRows = 64;   // rows of x a block owns
constexpr int kDxVocab = 64;  // table rows per vocab tile
constexpr int kDxChunk = 64;  // columns of a streamed chunk
constexpr int kDxOutChunks = kOutCols / kDxChunk;
constexpr int kDxFlush = 4;   // k-steps whose products share fresh sums (kstep_sum), at most a chunk's
constexpr int kDxStageRow = (kDxChunk + 4) * 4;  // bytes of a row of a raw stage (64 f32, or 64 bf16 of x)
constexpr int kDxStage = kDxVocab * kDxStageRow;

// The names below are the dx pass's: x is the operand a block keeps
// resident, W the one it streams. The dW pass and the merged backward swap
// the roles (the table resident, x streamed) and use the same planes.
template <int MODE>
struct DxMode {
  static constexpr bool kBf16 = MODE == kDxBf16x3 || MODE == kDxBf16;  // bf16 planes, m16n8k16
  static constexpr bool kSplit = MODE == kDxBf16x3 || MODE == kDxTf32x3;
  static constexpr int kPlanes = kSplit ? 2 : 1;  // hi (and lo) terms of W and A
  // x: bf16 terms, or raw f32 that each fragment rounds or splits as it is
  // read (it is reused over 4 n8 tiles and every term, so that is cheap, and
  // one f32 plane is what lets x stay resident at D = 384 in tf32 x3)
  static constexpr int kXPlanes = kBf16 ? kPlanes : 1;
  static constexpr int kElem = kBf16 ? 2 : 4;  // bytes of an operand element
  static constexpr int kSkew = 16 / kElem;     // 16 bytes of row padding: no ldmatrix bank conflict
  static constexpr int kChunkRow = (kDxChunk + kSkew) * kElem;  // bytes of a chunk plane's row
  static constexpr int kChunkPlane = kDxRows * kChunkRow;
  // the table's chunk for the second product: tf32 fragments of W read
  // down its rows come element by element (ldmatrix cannot transpose 32-bit
  // elements), conflict-free at a row of 72 floats; bf16 reads it with
  // ldmatrix.trans at the plane's own row
  static constexpr int kOutRow = kBf16 ? kChunkRow : (kDxChunk + 8) * 4;
  static constexpr int kWPlane = kDxVocab * (kOutRow > kChunkRow ? kOutRow : kChunkRow);
  static constexpr int kKsteps = kDxChunk * kElem / 32;  // of a 64-wide chunk: 4 (bf16) or 8 (tf32)
  using X = typename std::conditional<MODE == kDxBf16, __nv_bfloat16, float>::type;
};

// byte offsets of the dynamic shared memory: `stages` raw stages of the
// streamed operand, its converted chunk, the resident operand's planes (all
// of D, or one chunk), A's planes
template <int MODE>
struct DxSmem {
  using M = DxMode<MODE>;
  int res_row, res_plane;
  int chunk_at, res_at, a_at;
  size_t total;
  __host__ __device__ DxSmem(int d, bool resident, int stages) {
    const int dpad = (d + kDxChunk - 1) / kDxChunk * kDxChunk;
    res_row = resident ? (dpad + M::kSkew) * M::kElem : M::kChunkRow;
    res_plane = kDxRows * res_row;
    chunk_at = stages * kDxStage;
    res_at = chunk_at + M::kPlanes * M::kWPlane;
    a_at = res_at + M::kXPlanes * res_plane;
    total = static_cast<size_t>(a_at) + M::kPlanes * M::kChunkPlane;
  }
};

// a raw f32 fragment element as the numerics' tf32 terms: hi (and lo)
template <int MODE>
__device__ __forceinline__ void raw_terms(uint32_t& hi, uint32_t& lo) {
  if constexpr (DxMode<MODE>::kSplit) {
    tc::split_tf32(hi, hi, lo);
  } else {
    hi = tc::to_tf32(hi);
  }
}

// two neighbouring values, as the numerics' terms, into the planes at row
// (byte pointer), column col
template <int MODE>
__device__ __forceinline__ void put_pair(unsigned char* row, int plane_bytes, int col, float a,
                                         float b) {
  if constexpr (MODE == kDxBf16x3) {
    uint32_t hi, lo;
    tc::split_bf16(a, b, hi, lo);
    *reinterpret_cast<uint32_t*>(row + col * 2) = hi;
    *reinterpret_cast<uint32_t*>(row + plane_bytes + col * 2) = lo;
  } else if constexpr (MODE == kDxBf16) {
    *reinterpret_cast<uint32_t*>(row + col * 2) = tc::pack_bf16(a, b);
  } else if constexpr (MODE == kDxTf32x3) {
    uint32_t hi[2], lo[2];
    tc::split_tf32(__float_as_uint(a), hi[0], lo[0]);
    tc::split_tf32(__float_as_uint(b), hi[1], lo[1]);
    *reinterpret_cast<uint2*>(row + col * 4) = make_uint2(hi[0], hi[1]);
    *reinterpret_cast<uint2*>(row + plane_bytes + col * 4) = make_uint2(lo[0], lo[1]);
  } else {
    *reinterpret_cast<uint2*>(row + col * 4) =
        make_uint2(tc::to_tf32(__float_as_uint(a)), tc::to_tf32(__float_as_uint(b)));
  }
}
// one value into the resident operand's planes (bf16 terms, or raw f32)
template <int MODE>
__device__ __forceinline__ void put_one(unsigned char* row, int plane_bytes, int col, float a) {
  if constexpr (DxMode<MODE>::kBf16) {
    const __nv_bfloat16 hi = __float2bfloat16_rn(a);
    reinterpret_cast<__nv_bfloat16*>(row)[col] = hi;
    if constexpr (MODE == kDxBf16x3)
      reinterpret_cast<__nv_bfloat16*>(row + plane_bytes)[col] = __float2bfloat16_rn(a - __bfloat162float(hi));
  } else {
    reinterpret_cast<float*>(row)[col] = a;  // raw f32: see kXPlanes
  }
}
// one value, as the numerics' terms, into the planes at row, column col
template <int MODE>
__device__ __forceinline__ void put_terms(unsigned char* row, int plane_bytes, int col, float a) {
  if constexpr (DxMode<MODE>::kBf16) {
    put_one<MODE>(row, plane_bytes, col, a);
  } else {
    uint32_t hi = __float_as_uint(a), lo;
    raw_terms<MODE>(hi, lo);
    reinterpret_cast<uint32_t*>(row)[col] = hi;
    if constexpr (DxMode<MODE>::kSplit) reinterpret_cast<uint32_t*>(row + plane_bytes)[col] = lo;
  }
}

// columns [c0, c0 + ncols) of rows row0 .. row0 + 64 of a (rows, d) matrix
// into a resident operand's planes (rows `row` bytes apart, terms `plane`
// bytes apart): bf16 terms, or raw f32; zero past `rows` and d
template <int MODE, typename S>
__device__ __forceinline__ void load_rows(unsigned char* planes, int row, int plane, const S* __restrict__ src,
                                          int row0, int rows, int d, int c0, int ncols) {
  for (int idx = threadIdx.x; idx < kDxRows * ncols; idx += kDxThreads) {
    const int r = idx / ncols;
    const int c = idx - r * ncols;
    const bool ok = row0 + r < rows && c0 + c < d;
    const float val = ok ? to_f(src[static_cast<long long>(row0 + r) * d + c0 + c]) : 0.f;
    put_one<MODE>(planes + r * row, plane, c, val);
  }
}

// all of D (zero-padded to dpad columns) of rows row0 .. row0 + 64 of x
// into a resident operand's plane (rows `row` bytes apart) by 16-byte
// cp.async copies, the caller committing and waiting: for planes that hold
// x's elements as they are (raw f32, or bf16 x in a bf16 plane), d a
// multiple of a copy's elements and x 16-byte aligned; zero past n and d
template <int MODE>
__device__ __forceinline__ void copy_rows(unsigned char* plane, int row, const typename DxMode<MODE>::X* __restrict__ x,
                                          int row0, int n, int d, int dpad) {
  using X = typename DxMode<MODE>::X;
  static_assert(DxMode<MODE>::kXPlanes == 1 && sizeof(X) == DxMode<MODE>::kElem, "the plane holds x as it is");
  constexpr int kVec = 16 / static_cast<int>(sizeof(X));
  const int per_row = dpad / kVec;
  for (int idx = threadIdx.x; idx < kDxRows * per_row; idx += kDxThreads) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * kVec;
    const bool ok = row0 + r < n && c < d;
    const X* src = ok ? x + static_cast<long long>(row0 + r) * d + c : x;
    tc::cp_async_16(plane + r * row + c * static_cast<int>(sizeof(X)), src, ok);
  }
}

// the table's chunk of rows vrow0 .. vrow0 + 64, columns col .. col + 64,
// into a raw f32 stage, zero past v and d: 16-byte cp.async copies where
// w_vec (d % 4 == 0, w 16-byte aligned; the caller commits), else element
// by element
__device__ __forceinline__ void copy_table_chunk(float* dst, const float* __restrict__ w, int vrow0, int col,
                                                 int v, int d, int w_vec) {
  if (w_vec) {
    for (int idx = threadIdx.x; idx < kDxVocab * kDxChunk / 4; idx += kDxThreads) {
      const int rr = idx / (kDxChunk / 4);
      const int c = (idx % (kDxChunk / 4)) * 4;
      const bool ok = vrow0 + rr < v && col + c < d;
      const float* src = ok ? w + static_cast<long long>(vrow0 + rr) * d + col + c : w;
      tc::cp_async_16(dst + rr * (kDxChunk + 4) + c, src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kDxVocab * kDxChunk; idx += kDxThreads) {
      const int rr = idx / kDxChunk;
      const int c = idx % kDxChunk;
      const bool ok = vrow0 + rr < v && col + c < d;
      dst[rr * (kDxChunk + 4) + c] = ok ? w[static_cast<long long>(vrow0 + rr) * d + col + c] : 0.f;
    }
  }
}

// a raw f32 stage of the table converted once into the numerics' planes
// (rows w_row bytes apart, terms kWPlane apart)
template <int MODE>
__device__ __forceinline__ void convert_table_chunk(unsigned char* planes, const float* src, int w_row) {
  for (int idx = threadIdx.x; idx < kDxVocab * kDxChunk / 2; idx += kDxThreads) {
    const int rr = idx / (kDxChunk / 2);
    const int c = (idx % (kDxChunk / 2)) * 2;
    const float2 val = *reinterpret_cast<const float2*>(src + rr * (kDxChunk + 4) + c);
    put_pair<MODE>(planes + rr * w_row, DxMode<MODE>::kWPlane, c, val.x, val.y);
  }
}

template <int MODE>
__device__ __forceinline__ void dx_mma(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  if constexpr (DxMode<MODE>::kBf16) {
    tc::mma_bf16(acc, a, b0, b1);
  } else {
    tc::mma_tf32(acc, a, b0, b1);
  }
}

// acc += ks with f32 adds that round to nearest. The tensor cores add a
// product into their accumulator without rounding it to nearest: a k-step
// chained onto a running sum many times its size loses the bits below the
// sum's last place, and over a row of D / 8 k-steps (tf32) that bias grew
// to 1.8e-4 of the largest |dx| at logits of ~13 (PERF.md, "the dx numerics
// decision"). So each k-step's products go into fresh registers, whose size
// is one k-step's, and join the running sums here.
__device__ __forceinline__ void kstep_sum(float (&acc)[kDxNT][4], const float (&ks)[kDxNT][4]) {
#pragma unroll
  for (int nt = 0; nt < kDxNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = __fadd_rn(acc[nt][e], ks[nt][e]);
}

// s (16 x 8 kDxNT) += x (16 rows x 64 columns of the chunk) . W^T (the
// warp's 8 kDxNT table rows x the same 64 columns). xa, wa: shared addresses of the warp's first row
// plus the lane's rows-first (x) and cols-first (W) ldmatrix offsets. The
// products go into fresh sums every FLUSH k-steps (at most a chunk's).
template <int MODE, int FLUSH = kDxFlush>
__device__ __forceinline__ void dx_scores(float (&s)[kDxNT][4], uint32_t xa, int x_row, int x_plane,
                                          uint32_t wa, int w_row, int w_plane) {
  using M = DxMode<MODE>;
  constexpr int NP = kDxNT / 2;
  constexpr int F = FLUSH < M::kKsteps ? FLUSH : M::kKsteps;
  static_assert(M::kKsteps % F == 0, "a flush period divides the k-steps of a chunk");
  float ks[kDxNT][4];
#pragma unroll
  for (int kb = 0; kb < M::kKsteps; ++kb) {
    uint32_t a[2][4], b[2][NP][4];
    tc::ldmatrix_x4(a[0], xa + kb * 32);
    if constexpr (M::kXPlanes == 2) {
      tc::ldmatrix_x4(a[1], xa + x_plane + kb * 32);
    } else if constexpr (!M::kBf16) {
#pragma unroll
      for (int i = 0; i < 4; ++i) raw_terms<MODE>(a[0][i], a[1][i]);
    }
#pragma unroll
    for (int p = 0; p < M::kPlanes; ++p) {
#pragma unroll
      for (int np = 0; np < NP; ++np) tc::ldmatrix_x4(b[p][np], wa + p * w_plane + np * 16 * w_row + kb * 32);
    }
    // the k-step's terms (the small ones first, then hi . hi) into fresh
    // sums, added to s with round-to-nearest adds every FLUSH k-steps: see
    // kstep_sum
    if (kb % F == 0) {
#pragma unroll
      for (int nt = 0; nt < kDxNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) ks[nt][e] = 0.f;
    }
    if constexpr (M::kSplit) {
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        dx_mma<MODE>(ks[2 * np], a[1], b[0][np][0], b[0][np][1]);
        dx_mma<MODE>(ks[2 * np + 1], a[1], b[0][np][2], b[0][np][3]);
      }
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        dx_mma<MODE>(ks[2 * np], a[0], b[1][np][0], b[1][np][1]);
        dx_mma<MODE>(ks[2 * np + 1], a[0], b[1][np][2], b[1][np][3]);
      }
    }
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      dx_mma<MODE>(ks[2 * np], a[0], b[0][np][0], b[0][np][1]);
      dx_mma<MODE>(ks[2 * np + 1], a[0], b[0][np][2], b[0][np][3]);
    }
    if ((kb + 1) % F == 0) kstep_sum(s, ks);
  }
}

// acc (16 x 8 kDxNT) += A (16 rows x 64 vocab) . W (64 vocab x the warp's
// 8 kDxNT columns of the chunk). aa: the warp's first row of A plus the lane's
// rows-first offset; wt: the converted chunk's shared address (its rows
// kOutRow bytes apart), wp: the same as a generic pointer; col: the warp's
// first column in it. FLUSH as for dx_scores.
template <int MODE, int FLUSH = kDxFlush>
__device__ __forceinline__ void dx_product(float (&acc)[kDxNT][4], uint32_t aa, uint32_t wt,
                                           const unsigned char* wp, int col, int lane) {
  using M = DxMode<MODE>;
  constexpr int w_row = M::kOutRow;
  constexpr int NP = kDxNT / 2;
  constexpr int F = FLUSH < M::kKsteps ? FLUSH : M::kKsteps;
  float ks[kDxNT][4];
  const int rf_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int rf_col = (lane >> 4) * 16;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int kb = 0; kb < M::kKsteps; ++kb) {
    uint32_t a[2][4], b[2][kDxNT][2];  // b: [term][n8 tile][b0, b1]
#pragma unroll
    for (int p = 0; p < M::kPlanes; ++p) {
      tc::ldmatrix_x4(a[p], aa + p * M::kChunkPlane + kb * 32);
      if constexpr (M::kBf16) {
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          uint32_t r[4];
          tc::ldmatrix_x4_trans(
              r, wt + p * M::kWPlane + (kb * 16 + rf_row) * w_row + (col + np * 16) * 2 + rf_col);
          b[p][2 * np][0] = r[0];
          b[p][2 * np][1] = r[1];
          b[p][2 * np + 1][0] = r[2];
          b[p][2 * np + 1][1] = r[3];
        }
      } else {
        // B (k t, n g) and (k t + 4, n g) of each n8 tile, element by element
        const uint32_t* plane = reinterpret_cast<const uint32_t*>(wp + p * M::kWPlane);
#pragma unroll
        for (int nt = 0; nt < kDxNT; ++nt) {
          const int c = col + nt * 8 + g;
          b[p][nt][0] = plane[(kb * 8 + t) * (w_row / 4) + c];
          b[p][nt][1] = plane[(kb * 8 + t + 4) * (w_row / 4) + c];
        }
      }
    }
    if (kb % F == 0) {
#pragma unroll
      for (int nt = 0; nt < kDxNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) ks[nt][e] = 0.f;
    }
    if constexpr (M::kSplit) {
#pragma unroll
      for (int nt = 0; nt < kDxNT; ++nt) dx_mma<MODE>(ks[nt], a[1], b[0][nt][0], b[0][nt][1]);
#pragma unroll
      for (int nt = 0; nt < kDxNT; ++nt) dx_mma<MODE>(ks[nt], a[0], b[1][nt][0], b[1][nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < kDxNT; ++nt) dx_mma<MODE>(ks[nt], a[0], b[0][nt][0], b[0][nt][1]);
    if ((kb + 1) % F == 0) kstep_sum(acc, ks);
  }
}

// The merged backward's third product: acc (2 m16 tiles x 2 n8 tiles: 32
// rows x 16 columns) = A (32 rows of x x the 64 table rows) . W_tile (64
// table rows x 16 columns of D). aa: the warp's first row of A's planes
// (rows kChunkRow bytes apart, terms kChunkPlane apart) plus the lane's
// rows-first offset. W is the resident table (rows kRow bytes apart): raw
// f32 read element by element down its rows and split into the numerics'
// terms here, or bf16 planes (kRow, kPlane) read with ldmatrix.trans; col:
// the warp's first column. A warp takes 32 x 16 rather than the other
// products' 16 x 32 so that each table element it splits feeds two m16
// tiles. The 64 table rows are one flush period (8 tf32 k-steps): the
// products go into acc, zero on entry, and leave in one piece.
template <int MODE, int kRow, int kPlane>
__device__ __forceinline__ void mrg_dx_product(float (&acc)[2][2][4], uint32_t aa, uint32_t wt,
                                               const unsigned char* wp, int col, int lane) {
  using M = DxMode<MODE>;
  const int rf_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int rf_col = (lane >> 4) * 16;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int kb = 0; kb < M::kKsteps; ++kb) {
    uint32_t a[2][2][4], b[2][2][2];  // a: [m16 tile][term]; b: [term][n8 tile][b0, b1]
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int p = 0; p < M::kPlanes; ++p) tc::ldmatrix_x4(a[m][p], aa + m * 16 * M::kChunkRow + p * M::kChunkPlane + kb * 32);
    if constexpr (M::kBf16) {
#pragma unroll
      for (int p = 0; p < M::kPlanes; ++p) {
        uint32_t r[4];
        tc::ldmatrix_x4_trans(r, wt + p * kPlane + (kb * 16 + rf_row) * kRow + col * 2 + rf_col);
        b[p][0][0] = r[0];
        b[p][0][1] = r[1];
        b[p][1][0] = r[2];
        b[p][1][1] = r[3];
      }
    } else {
      const uint32_t* plane = reinterpret_cast<const uint32_t*>(wp);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        b[0][n][0] = plane[(kb * 8 + t) * (kRow / 4) + col + n * 8 + g];
        b[0][n][1] = plane[(kb * 8 + t + 4) * (kRow / 4) + col + n * 8 + g];
#pragma unroll
        for (int e = 0; e < 2; ++e) raw_terms<MODE>(b[0][n][e], b[1][n][e]);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if constexpr (M::kSplit) {
          dx_mma<MODE>(acc[m][n], a[m][1], b[0][n][0], b[0][n][1]);
          dx_mma<MODE>(acc[m][n], a[m][0], b[1][n][0], b[1][n][1]);
        }
        dx_mma<MODE>(acc[m][n], a[m][0], b[0][n][0], b[0][n][1]);
      }
  }
}

// ------------------------------------------- dW (and the merged backward)
//
// The dW pass is the dx pass mirrored: a block of 8 warps owns 64 table rows
// and walks every row tile of x. Per tile of 64 rows of x it computes the
// scores transposed, s^T = W_tile . x_tile^T (M = the 64 table rows, N = the
// 64 rows of x, K = D), so that in s^T's accumulator fragments the rows
// (g, g + 8) are table rows and the columns (2t, 2t + 1) rows of x; from
// them A^T = dnll (exp(s^T (+ b) - logz) - onehot) (logz, dnll and the label
// by column, the bias and the window by row), then dW += A^T . x (K = the
// tile's 64 rows of x). A^T is the A operand of that product as it stands
// (ldmatrix cannot transpose 32-bit elements; nothing needs transposing),
// so both products are dx_scores and dx_product with the operands swapped,
// in the same numerics (kDxNumerics; bf16 x: W rounded to bf16, A^T rounded
// once, one product).
//
// The block's table rows stay in shared memory for its life as raw f32 that
// tf32 fragments split as they are read (bf16 x: rounded to bf16) where they
// fit (D <= 384 in tf32 x3, with kDwResident); wider rows load the table's
// chunk beside each of x's. x streams in chunks of 64 rows x 64 columns
// through kDwStages cp.async stages of raw elements, each converted once
// into the numerics' planes: D/64 chunks for the score product, then the
// block's output columns again, 64 at a time, for A^T x. A warp sums 16 table
// rows x 32 columns of every 64-column output chunk: 96 f32 accumulators for
// the block's 384 columns; wider rows split D over blockIdx.y (each such
// block recomputes the scores). A row tile whose A^T is all zero skips its
// second product. db is summed from the unrounded f32 A^T in registers, in
// a fixed order: by each thread over its columns and the row tiles, across a
// quad's lanes by shuffles, across the column warps through shared memory in
// warp order; the blocks of the first D split write it. Every block writes
// its dW rows once: no atomics, two runs give the same bits.
//
// The merged backward (DX, D <= 256: the whole table row resident, its rows
// 256 + 4 floats apart whatever D, 64 dW accumulators a thread) adds a third
// product from the same A, and walks only the rows of x whose dnll is
// nonzero:
// * A row with dnll = 0 (a LABEL_PAD row) has A = 0 and adds nothing. The
//   launcher first lists the other rows (ce_live_rows_kernel, one block);
//   the kernel reads their count and walks them in tiles of 64 (a fifth
//   fewer at the flagship's inputs). The source rows of the two tiles in
//   flight sit in shared memory (`ring`), each thread's copy rows in
//   registers, read once a tile: looked up on the path of every copy they
//   cost 10% (PERF.md, the merged backward's tune).
// * The epilogue also writes A itself (rows of x by table rows) in the
//   numerics' terms, beside A^T's planes, and per output chunk, after dW's,
//   each warp computes 32 rows of x x 16 columns of dx = A . W_tile from
//   those planes and the resident table (mrg_dx_product: the table read
//   down its rows element by element and split there, each split feeding
//   two m16 tiles; bf16 by ldmatrix.trans).
// * It adds them into the f32 (N, D) dx at dx32 with 16-byte atomic adds
//   (red.global.add.v4.f32: lanes t and t ^ 1 trade halves so each holds
//   four neighbouring columns). dx sums over every vocab tile and no block
//   sees more than one, so the atomics are the reduction across blocks,
//   2.6 MB of scratch that stays in L2; their order varies from run to
//   run, so dx repeats to rounding, dW and db bit for bit. Blocks start
//   their walk at different row tiles (blockIdx.x mod the tile count), and
//   blocks that start at the same one take dx's column chunks in another
//   turn, so that the blocks in flight add into different parts of dx.
//   kMrgDxReduce = false (the product kept, the atomics dropped) is a tune
//   variant that prices the reduction: 0.24 of 6.08 ms (4%) on an H100.
//   They are kept on purpose: a fixed-order reduction (per-split partials
//   and a combine, as the dx pass has) would cost at least that, for bits
//   that no tolerance needs. Two runs of dx are held within 1e-5 of the
//   largest |dx| of each other (2.3e-7 measured; tests/test_torch_cuda.py
//   and chip_smoke.py's CE_DX_REPEAT), a tenth of dx's tolerance against
//   its plain version.
//
// What bounds it: as the dx pass, the mma.sync issue rate (the same 318 M
// m16n8k8 instructions at N = 2,560, V = 55,296, D = 384; the merged
// backward's three products at D = 256 as many, 256 M over the rows with a
// label). Its grid is ceil(V / 64) x ceil(D / 384) blocks, one per SM: 864
// at that shape, 6.5 waves of 132. The constants (kDwStages, kDwFlush,
// kDwResident) were timed with examples/long_context/tune_blockwise_bwd.py
// --kernel ce_dw, and the merged backward's with --kernel ce_bwd (PERF.md).

constexpr int kDwStages = 3;        // cp.async stages of x: two chunks in flight
constexpr int kDwFlush = 8;         // k-steps whose products share fresh sums (kstep_sum): a chunk's
constexpr bool kDwResident = true;  // false: stream the table rows beside x's at every D
constexpr int kMrgOutChunks = 4;    // the merged backward's 64-column chunks: D <= 256
constexpr bool kMrgDxReduce = true; // false (tune only): dx's atomics dropped, its product kept

// two neighbouring elements of a stage as f32
__device__ __forceinline__ float2 pair_at(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 pair_at(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The layout of the kernel's dynamic shared memory: DxSmem, at D = 256 for
// the merged backward (its table rows a fixed stride apart), then its A
// planes and the source rows of two row tiles; and their bytes.
template <int MODE>
__host__ __device__ DxSmem<MODE> dw_layout(int d, bool resident, bool with_dx) {
  return DxSmem<MODE>(with_dx ? kDxChunk * kMrgOutChunks : d, resident, kDwStages);
}
template <int MODE>
size_t dw_smem(int d, bool resident, bool with_dx) {
  using M = DxMode<MODE>;
  return dw_layout<MODE>(d, resident, with_dx).total +
         (with_dx ? M::kPlanes * M::kChunkPlane + 2 * kDxRows * sizeof(int32_t) : 0);
}

// a warp's 16 rows x 8 NT columns of a dx chunk (accumulator fragments at
// rows row0 + g, + 8 of a tile whose first n rows are rows[0 .. n) of dx,
// and columns col + nt * 8 + 2t, + 1) added into the f32 dx; vec: d % 4 ==
// 0 (and dx 16-byte aligned), four columns per add
template <int NT>
__device__ __forceinline__ void add_dx(float* __restrict__ dx32, const int32_t* rows,
                                       const float (&acc)[NT][4], int row0, int col, int n, int d,
                                       int lane, bool vec) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = col + nt * 8 + 2 * t;
    if (vec) {
      // lane t even keeps row g and takes its neighbour's two columns of it;
      // lane t odd keeps row g + 8 and takes its neighbour's two of that
      const bool odd = t & 1;
      const float s0 = __shfl_xor_sync(0xffffffffu, odd ? acc[nt][0] : acc[nt][2], 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, odd ? acc[nt][1] : acc[nt][3], 1);
      const int row = row0 + g + (odd ? 8 : 0);
      const int c4 = odd ? c - 2 : c;
      const float4 val = odd ? make_float4(s0, s1, acc[nt][2], acc[nt][3])
                             : make_float4(acc[nt][0], acc[nt][1], s0, s1);
      if (row < n && c4 < d) {
        float4* at = reinterpret_cast<float4*>(dx32 + static_cast<long long>(rows[row]) * d + c4);
        if constexpr (kMrgDxReduce) {
          atomicAdd(at, val);  // sm_90: red.global.add.v4.f32
        } else if (__float_as_uint(val.x) == 0x7fc00001u) {  // never: keeps the product alive
          *at = val;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + 8 * (e >> 1);
        const int cc = c + (e & 1);
        if (row < n && cc < d) {
          float* at = dx32 + static_cast<long long>(rows[row]) * d + cc;
          if constexpr (kMrgDxReduce) {
            atomicAdd(at, acc[nt][e]);
          } else if (__float_as_uint(acc[nt][e]) == 0x7fc00001u) {
            *at = acc[nt][e];
          }
        }
      }
    }
  }
}

template <int MODE, bool WRES, bool DX>
__global__ void __launch_bounds__(kDxThreads, 1)
    ce_bwd_dw_mma_kernel(const typename DxMode<MODE>::X* __restrict__ x,
                         const float* __restrict__ w, const float* __restrict__ bias,
                         const int32_t* __restrict__ lab, const float* __restrict__ logz,
                         const float* __restrict__ dnll, const int32_t* __restrict__ listed,
                         float* __restrict__ dw, float* __restrict__ db, float* __restrict__ dx32,
                         int n_all, int v, int d, int row_offset, int num_valid, int x_vec) {
  using M = DxMode<MODE>;
  using X = typename M::X;
  static_assert(!DX || WRES, "the merged backward keeps its table rows resident");
  // DX walks the rows of x in `listed` (their count, then the rows: those
  // with a nonzero dnll, in order); the dW pass walks them all
  const int n = DX ? __ldg(listed) : n_all;
  auto src_row = [&](int i) { return DX ? __ldg(listed + 1 + i) : i; };
  constexpr int kOut = DX ? kMrgOutChunks : kDxOutChunks;  // 64-column output chunks in registers
  constexpr int kVec = 16 / static_cast<int>(sizeof(X));                // elements of one 16-byte copy
  constexpr int kStageRow = kDxStageRow / static_cast<int>(sizeof(X));  // elements of a stage row
  extern __shared__ __align__(16) unsigned char smem_dw[];
  const DxSmem<MODE> L = dw_layout<MODE>(d, WRES, DX);
  const int a2_at = static_cast<int>(L.total);  // DX: A's planes, rows of x by table rows
  const int vrow0 = blockIdx.x * kDxVocab;
  const int d_lo = blockIdx.y * kOutCols;
  const int d_hi = min(d, d_lo + kOutCols);
  const int n_rtiles = (n + kDxRows - 1) / kDxRows;
  const int start = DX && n_rtiles > 0 ? blockIdx.x % n_rtiles : 0;  // the first row tile walked
  // DX: the first of dx's output chunks taken, so that blocks whose walks
  // start together add into different columns
  const int turn = DX && n_rtiles > 0 ? blockIdx.x / n_rtiles : 0;
  const int nk = (d + kDxChunk - 1) / kDxChunk;            // chunks of the score product
  const int no = (d_hi - d_lo + kDxChunk - 1) / kDxChunk;  // and of the block's output columns
  const int steps = nk + no;                               // chunks of x per row tile
  const int total = n_rtiles * steps;
  const bool dx_vec = d % 4 == 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rg = (warp & 3) * 16;            // the warp's 16 table rows (of s^T and of dW)
  const int cg = (warp >> 2) * (8 * kDxNT);  // its first row of x in s^T, and column of each dW chunk
  const int rf_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int rf_col = (lane >> 4) * 16;
  const int cf_row = (lane & 7) + (lane >> 4) * 8;
  const int cf_col = ((lane >> 3) & 1) * 16;
  const uint32_t base = tc::shared_addr(smem_dw);
  const uint32_t x_addr = base + L.chunk_at;  // x's converted chunk
  // the first row of x of the walk's tile-th row tile
  auto tile_row0 = [&](int tile) {
    const int r = start + tile;
    return (r < n_rtiles ? r : r - n_rtiles) * kDxRows;
  };

  // columns [c0, c0 + ncols) of the block's table rows into their planes
  auto load_w = [&](int c0, int ncols) {
    load_rows<MODE>(smem_dw + L.res_at, L.res_row, L.res_plane, w, vrow0, v, d, c0, ncols);
  };
  // the chunk of x of step `step` (row tile, then its columns) into its stage
  // DX: the source rows of the two row tiles in flight (the one whose chunks
  // are being copied and the one being computed), tile by tile of the walk,
  // and those of this thread's copies of the tile being copied. Read once a
  // tile, off the path of each copy: with this much shared memory the L1
  // cache is small, and a lookup of `listed` on that path goes to L2.
  int32_t* ring = reinterpret_cast<int32_t*>(smem_dw + a2_at + M::kPlanes * M::kChunkPlane);
  constexpr int kCopies = kDxRows * kDxChunk / kVec / kDxThreads;  // 16-byte copies a thread issues per chunk
  int copy_row[kCopies];
  auto issue = [&](int step) {
    const int tile = step / steps;
    const int r = step - tile * steps;
    const int col = r < nk ? r * kDxChunk : d_lo + (r - nk) * kDxChunk;
    const int xrow0 = tile_row0(tile);
    X* dst = reinterpret_cast<X*>(smem_dw + (step % kDwStages) * kDxStage);
    if constexpr (DX) {
      if (r == 0) {  // the first chunk of a tile: its rows
        const int i = xrow0 + threadIdx.x;
        if (threadIdx.x < kDxRows) ring[(tile & 1) * kDxRows + threadIdx.x] = i < n ? src_row(i) : 0;
#pragma unroll
        for (int k = 0; k < kCopies; ++k) {
          const int rr = (threadIdx.x + k * kDxThreads) / (kDxChunk / kVec);
          copy_row[k] = xrow0 + rr < n ? src_row(xrow0 + rr) : 0;
        }
      }
    }
    if (x_vec) {
#pragma unroll
      for (int k = 0; k < kCopies; ++k) {
        const int idx = threadIdx.x + k * kDxThreads;
        const int rr = idx / (kDxChunk / kVec);
        const int c = (idx % (kDxChunk / kVec)) * kVec;
        const bool ok = xrow0 + rr < n && col + c < d;
        const long long row = DX ? copy_row[k] : xrow0 + rr;
        const X* src = ok ? x + row * d + col + c : x;
        tc::cp_async_16(dst + rr * kStageRow + c, src, ok);
      }
    } else {
      for (int idx = threadIdx.x; idx < kDxRows * kDxChunk; idx += kDxThreads) {
        const int rr = idx / kDxChunk;
        const int c = idx % kDxChunk;
        const bool ok = xrow0 + rr < n && col + c < d;
        dst[rr * kStageRow + c] = ok ? x[static_cast<long long>(src_row(xrow0 + rr)) * d + col + c] : from_f<X>(0.f);
      }
    }
  };

  if (WRES) load_w(0, (d + kDxChunk - 1) / kDxChunk * kDxChunk);
  int q = 0;
  for (int step = 0; step < kDwStages - 1; ++step) {  // one commit group per step, empty past the end
    if (step < total) issue(step);
    tc::cp_async_commit();
  }
  // Step q: wait for its chunk of x, convert it once into the numerics'
  // planes (at the row of the product it feeds: x_row) and, without the
  // resident table, load the table's chunk w_col (-1: none); start the copy
  // of step q + kDwStages - 1 into the stage step q - 1 used. The first
  // barrier also ends every read of the previous step's stage and planes.
  auto advance = [&](int w_col, int x_row) {
    tc::cp_async_wait<kDwStages - 2>();
    __syncthreads();
    const X* src = reinterpret_cast<const X*>(smem_dw + (q % kDwStages) * kDxStage);
    for (int idx = threadIdx.x; idx < kDxRows * kDxChunk / 2; idx += kDxThreads) {
      const int rr = idx / (kDxChunk / 2);
      const int c = (idx % (kDxChunk / 2)) * 2;
      const float2 val = pair_at(src + rr * kStageRow + c);
      put_pair<MODE>(smem_dw + L.chunk_at + rr * x_row, M::kWPlane, c, val.x, val.y);
    }
    if (!WRES && w_col >= 0) load_w(w_col, kDxChunk);
    if (q + kDwStages - 1 < total) issue(q + kDwStages - 1);
    tc::cp_async_commit();
    __syncthreads();
    ++q;
  };

  float acc[kOut][kDxNT][4];
#pragma unroll
  for (int o = 0; o < kOut; ++o)
#pragma unroll
    for (int nt = 0; nt < kDxNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[o][nt][e] = 0.f;

  // the thread's two table rows, rg + g and rg + g + 8, for the block's
  // life: whether they exist, their bias, whether they are in the window;
  // and their share of db
  bool live[2], inside[2];
  float b_row[2], db_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = vrow0 + rg + g + 8 * half;
    live[half] = row < v;
    inside[half] = in_window(row, row_offset, num_valid);
    b_row[half] = bias != nullptr && live[half] ? bias[row] : 0.f;
  }

  const uint32_t a_at = base + L.a_at + (rg + rf_row) * M::kChunkRow + rf_col;
  // DX: the warp's 32 rows of x and 16 columns of each dx chunk
  const int xr = (warp & 1) * 32;
  const int xc = (warp >> 1) * 16;
  const uint32_t a2_addr = base + a2_at + (xr + rf_row) * M::kChunkRow + rf_col;
  for (int it = 0; it < n_rtiles; ++it) {
    float s[kDxNT][4];
#pragma unroll
    for (int nt = 0; nt < kDxNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    for (int c = 0; c < nk; ++c) {
      advance(c * kDxChunk, M::kChunkRow);
      const uint32_t wa = base + L.res_at + (WRES ? c * kDxChunk * M::kElem : 0) + (rg + rf_row) * L.res_row + rf_col;
      const uint32_t xa = x_addr + (cg + cf_row) * M::kChunkRow + cf_col;
      dx_scores<MODE, kDwFlush>(s, wa, L.res_row, L.res_plane, xa, M::kChunkRow, M::kWPlane);
    }

    // A^T = dnll (exp(s^T (+ b) - logz) - onehot), blinded outside the
    // window; 0 past n and v. Its columns are rows of x: logz, dnll, label.
    const int row0 = tile_row0(it);
    const int32_t* tile_rows = ring + (it & 1) * kDxRows;  // DX: the tile's source rows
    float lz[kDxNT][2], gr[kDxNT][2];
    int lb[kDxNT][2];
#pragma unroll
    for (int nt = 0; nt < kDxNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + cg + nt * 8 + 2 * t + e;
        const bool ok = row < n;
        const int src = !ok ? 0 : DX ? tile_rows[row - row0] : row;
        lz[nt][e] = ok ? logz[src] : 0.f;
        gr[nt][e] = ok ? dnll[src] : 0.f;
        lb[nt][e] = ok ? lab[src] : -1;
      }
    int nonzero = 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rg + g + 8 * half;
      const int vrow = vrow0 + r;
#pragma unroll
      for (int nt = 0; nt < kDxNT; ++nt) {
        const int cl = cg + nt * 8 + 2 * t;
        float a[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          a[e] = 0.f;
          if (live[half] && row0 + cl + e < n) {
            float val = s[nt][2 * half + e];
            if (bias != nullptr) val = __fadd_rn(val, b_row[half]);
            if (!inside[half]) val = kNegBig;
            a[e] = gr[nt][e] * (expf(val - lz[nt][e]) - (vrow == lb[nt][e] ? 1.f : 0.f));  // blinded: exactly 0
          }
          nonzero |= a[e] != 0.f;
          db_sum[half] += a[e];
          if constexpr (DX) put_terms<MODE>(smem_dw + a2_at + (cl + e) * M::kChunkRow, M::kChunkPlane, r, a[e]);
        }
        put_pair<MODE>(smem_dw + L.a_at + r * M::kChunkRow, M::kChunkPlane, cl, a[0], a[1]);
      }
    }
    nonzero = __syncthreads_or(nonzero);

#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      if (o < no) {  // the same for every thread of the block
        advance(-1, M::kOutRow);
        if (nonzero) {
          dx_product<MODE, kDwFlush>(acc[o], a_at, x_addr, smem_dw + L.chunk_at, cg, lane);
          if constexpr (DX) {
            // dx (the warp's 32 rows of x, 16 columns of chunk o) = A . W_tile
            constexpr int kRow = (kDxChunk * kMrgOutChunks + M::kSkew) * M::kElem;  // = L.res_row
            float dxa[2][2][4];
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int nn = 0; nn < 2; ++nn)
#pragma unroll
                for (int e = 0; e < 4; ++e) dxa[m][nn][e] = 0.f;
            const int col = (o + turn) % no * kDxChunk + xc;
            mrg_dx_product<MODE, kRow, kDxRows * kRow>(dxa, a2_addr, base + L.res_at, smem_dw + L.res_at, col,
                                                          lane);
#pragma unroll
            for (int m = 0; m < 2; ++m) add_dx(dx32, tile_rows, dxa[m], xr + 16 * m, col, n - row0, d, lane, dx_vec);
          }
        }
      }
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int o = 0; o < kOut; ++o) {
#pragma unroll
    for (int nt = 0; nt < kDxNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = vrow0 + rg + g + 8 * (e >> 1);
        const int col = d_lo + o * kDxChunk + cg + nt * 8 + 2 * t + (e & 1);
        if (o < no && row < v && col < d_hi) dw[static_cast<long long>(row) * d + col] = acc[o][nt][e];
      }
    }
  }

  if (db != nullptr && blockIdx.y == 0) {  // the same for every thread of the block
#pragma unroll
    for (int half = 0; half < 2; ++half) db_sum[half] = tc::quad_sum(db_sum[half]);
    __syncthreads();  // every copy has landed and every stage been read: stage 0 is free
    float* part = reinterpret_cast<float*>(smem_dw);  // (kDxColWarps, 64): each column warp's sums
    if (t == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) part[(warp >> 2) * kDxVocab + rg + g + 8 * half] = db_sum[half];
    }
    __syncthreads();
    const int r = threadIdx.x;
    if (r < kDxVocab && vrow0 + r < v) {
      float sum = 0.f;
      for (int cw = 0; cw < kDxColWarps; ++cw) sum += part[cw * kDxVocab + r];
      db[vrow0 + r] = sum;
    }
  }
}

// The merged backward's list of the rows it walks: live[0] = how many rows
// have a nonzero dnll, live[1 ..] = those rows in order. A row whose dnll is
// 0 (a LABEL_PAD row) has A = 0: it adds nothing to dW or db, and its dx
// row is 0, which the zeroed dx scratch already holds. One block, the rows
// in turns of kLiveThreads: a ballot and the warps' counts place each row.
constexpr int kLiveThreads = 1024;
__global__ void __launch_bounds__(kLiveThreads)
    ce_live_rows_kernel(const float* __restrict__ dnll, int n, int32_t* __restrict__ live) {
  __shared__ int counts[kLiveThreads / 32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int base = 0;
  for (int i0 = 0; i0 < n; i0 += kLiveThreads) {
    const int i = i0 + threadIdx.x;
    const bool keep = i < n && dnll[i] != 0.f;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) counts[warp] = __popc(ballot);
    __syncthreads();
    int before = base, total = base;
    for (int w = 0; w < kLiveThreads / 32; ++w) {
      before += w < warp ? counts[w] : 0;
      total += counts[w];
    }
    if (keep) live[1 + before + __popc(ballot & ((1u << lane) - 1u))] = i;
    base = total;
    __syncthreads();  // counts is rewritten by the next turn
  }
  if (threadIdx.x == 0) live[0] = base;
}

// bias and db may be null; without DX live and dx32 too. DX: live is
// (n + 1) int32 scratch, dx32 (n, d) f32 is added into.
template <int MODE, bool WRES, bool DX>
cudaError_t launch_dw_mma(const void* x, const void* w, const void* bias, const void* lab,
                          const void* logz, const void* dnll, void* live, void* dw, void* db,
                          void* dx32, int n, int v, int d, int row_offset, int num_valid,
                          cudaStream_t stream) {
  using X = typename DxMode<MODE>::X;
  auto kernel = ce_bwd_dw_mma_kernel<MODE, WRES, DX>;
  const size_t smem = dw_smem<MODE>(d, WRES, DX);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (DX) {
    ce_live_rows_kernel<<<1, kLiveThreads, 0, stream>>>(static_cast<const float*>(dnll), n,
                                                         static_cast<int32_t*>(live));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int x_vec = d % (16 / sizeof(X)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((v + kDxVocab - 1) / kDxVocab, (d + kOutCols - 1) / kOutCols);
  kernel<<<grid, kDxThreads, smem, stream>>>(
      static_cast<const X*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const int32_t*>(lab), static_cast<const float*>(logz),
      static_cast<const float*>(dnll), static_cast<const int32_t*>(live), static_cast<float*>(dw),
      static_cast<float*>(db), static_cast<float*>(dx32), n, v, d, row_offset, num_valid, x_vec);
  return cudaGetLastError();
}

}  // namespace
