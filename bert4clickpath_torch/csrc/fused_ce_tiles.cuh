// Tile helpers shared by the fused-CE kernels (fused_ce.cu, the forward and
// the merged backward; fused_ce_two_pass.cu, the two-pass backward): 64 x 64
// tiles of s = x . W^T worked by 256 threads, each owning a 4 x 4 register
// tile (rows ty + 16r, columns tx + 16c), the operands in shared memory as
// f32 with rows padded by one float so lanes reading different rows hit
// different banks.

#pragma once

#include "common.cuh"

namespace ce_tiles {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // rows of x, and rows of the table, per tile
constexpr float kNegBig = -1e30f;
// the most dynamic shared memory one block can have on sm_90
constexpr size_t kMaxSmem = 232448;

// four consecutive elements as f32: one 16-byte (f32) or 8-byte (bf16) load
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T, bool kRound, typename S>
__device__ __forceinline__ float cvt(S v) {
  const float f = to_f(v);
  return kRound ? round_to<T>(f) : f;
}

// columns [c0, c0 + ncols) of rows [r0, r0 + kTile) of a (rows, d) matrix
// into shared memory as f32, dst[r * stride + (c - c0)], each value rounded
// to T when kRound (the table's `.astype(x.dtype)`); rows and columns past
// the matrix are zero. With d, c0 and ncols multiples of 4 and aligned
// rows, each thread keeps kLoadBatch vector loads in flight before storing
// them: an element-by-element loop leaves one load in flight per thread,
// and the tile's load then costs more than its products.
constexpr int kLoadBatch = 8;

template <typename T, bool kRound, typename S>
__device__ void load_tile(float* dst, const S* __restrict__ src, int r0,
                          int rows, int d, int c0, int ncols, int stride) {
  const bool vec = ((d | c0 | ncols) & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(src) % (4 * sizeof(S))) == 0;
  if (!vec) {
    for (int idx = threadIdx.x; idx < kTile * ncols; idx += kThreads) {
      const int r = idx / ncols;
      const int c = idx - r * ncols;
      const int g = r0 + r;
      dst[r * stride + c] =
          (g < rows && c0 + c < d)
              ? cvt<T, kRound>(src[static_cast<long long>(g) * d + c0 + c])
              : 0.f;
    }
    return;
  }
  const int n4 = ncols >> 2;
  const int total = kTile * n4;
  for (int base = threadIdx.x; base < total; base += kThreads * kLoadBatch) {
    float4 v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = base + u * kThreads;
      const int r = idx / n4;
      const int g = r0 + r;
      const int c = c0 + 4 * (idx - r * n4);
      v[u] = (idx < total && g < rows && c < d)
                 ? load4(src + static_cast<long long>(g) * d + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = base + u * kThreads;
      if (idx < total) {
        const int r = idx / n4;
        float* o = dst + r * stride + 4 * (idx - r * n4);
        o[0] = cvt<T, kRound>(v[u].x);
        o[1] = cvt<T, kRound>(v[u].y);
        o[2] = cvt<T, kRound>(v[u].z);
        o[3] = cvt<T, kRound>(v[u].w);
      }
    }
  }
}

// x rows as f32; table rows rounded to x's type
template <typename T>
__device__ void load_x_tile(float* dst, const T* __restrict__ src, int r0,
                            int rows, int d, int c0, int ncols, int stride) {
  load_tile<T, false>(dst, src, r0, rows, d, c0, ncols, stride);
}
template <typename T>
__device__ void load_w_tile(float* dst, const float* __restrict__ w, int r0,
                            int rows, int d, int c0, int ncols, int stride) {
  load_tile<T, true>(dst, w, r0, rows, d, c0, ncols, stride);
}

// acc[r][c] += xr[16 r xstride + k] * wr[16 c wstride + k] over k < kw, with
// xr the caller's row ty of the x tile and wr its row tx of the table tile
// (both already at the first of the kw columns)
__device__ __forceinline__ void score_add(const float* xr, int xstride,
                                          const float* wr, int wstride,
                                          int kw, float acc[4][4]) {
  for (int k = 0; k < kw; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = xr[16 * r * xstride + k];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = wr[16 * c * wstride + k];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero_tile(float acc[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// acc[r][c] = x_tile[ty + 16r] . w_tile[tx + 16c], both tiles whole (d wide)
__device__ __forceinline__ void score_tile(const float* xs, const float* ws,
                                           int d, int stride,
                                           float acc[4][4]) {
  zero_tile(acc);
  score_add(xs + (threadIdx.x / 16) * stride, stride,
            ws + (threadIdx.x % 16) * stride, stride, d, acc);
}

// reductions over the 16 lanes that share a row (lanes differ in tx)
__device__ __forceinline__ float half_warp_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool in_window(int col, int row_offset,
                                          int num_valid) {
  return col >= row_offset && col < row_offset + num_valid;
}

// A = dnll * (exp(s - logz) - onehot(label)) for the caller's 4 x 4 entries
// of the tile at (row0, col0), written into `as` (kTile x astride, f32,
// unrounded). s is the raw product: the bias is added here, before the
// blinding of columns outside the window, as in the forward. Entries past n
// or v are 0. Returns whether any of the caller's entries is non-zero.
__device__ __forceinline__ int adjoint_tile(
    const float s[4][4], float* as, int astride,
    const float* __restrict__ bias, const int32_t* __restrict__ lab,
    const float* __restrict__ logz, const float* __restrict__ dnll, int row0,
    int col0, int n, int v, int row_offset, int num_valid) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  float bias_c[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = col0 + tx + 16 * c;
    bias_c[c] = (bias != nullptr && col < v) ? bias[col] : 0.f;
  }
  int nonzero = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty + 16 * r;
    const bool valid_row = row < n;
    const float lz = valid_row ? logz[row] : 0.f;
    const float g = valid_row ? dnll[row] : 0.f;
    const int lb = valid_row ? lab[row] : -1;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col0 + tx + 16 * c;
      float a = 0.f;
      if (valid_row && col < v) {
        float val = s[r][c];
        if (bias != nullptr) val = __fadd_rn(val, bias_c[c]);
        if (!in_window(col, row_offset, num_valid)) val = kNegBig;
        const float p = expf(val - lz);  // blinded rows: exactly 0
        const float onehot = col == lb ? 1.f : 0.f;
        a = g * (p - onehot);
      }
      nonzero |= a != 0.f;
      as[(ty + 16 * r) * astride + tx + 16 * c] = a;
    }
  }
  return nonzero;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace ce_tiles
