// The two-pass backward of the fused softmax cross-entropy: a dx kernel and
// a dW kernel that each recompute the scores once, for rows wider than the
// merged backward's register tile holds (fused_ce.cu: D <= 256).
//
// Replaces two Pallas kernels of bert4clickpath_tpu/ops/pallas/fused_ce.py,
// _bwd_dx_kernel and _bwd_dw_kernel (launched by _bwd):
//
//   s[n, v] = x[n] . round_to_x(W[v]) (+ bias[v]);  -1e30 where v is outside
//             [row_offset, row_offset + num_valid)
//   A[n, v] = dnll[n] * (exp(s[n, v] - logz[n]) - [v == label_row[n]])   f32
//   dx kernel:  dx = round_to_x(A) . round_to_x(W)     (N, D), in x's type
//   dW kernel:  dW = round_to_x(A)^T . x               (V, D), f32
//               db = sum_n A[n, v]                     (V,),   f32, unrounded A
//
// x is f32 or bf16; W and the bias are f32; a null bias pointer selects the
// variant without a bias (and without db). The JAX dx kernel adds each vocab
// tile's product into an output of x's type, so with bf16 x it rounds once
// per vocab tile; here dx sums in f32 over all of the vocabulary and rounds
// once (f32 x is unaffected).
//
// What bounds them on the H100: arithmetic. Each kernel is two products of
// 2*N*V*D operations (the recompute and its own), against a table and
// activations of tens of MB: at N = 2,560, V = 55,296, D = 384 that is 217
// GFLOP per kernel, 3.2 ms in f32 FMA at 67 TFLOP/s.
//
// Design (simple first, f32 FMA from shared memory, no tensor cores), on the
// 64 x 64 tiles of fused_ce_tiles.cuh:
// * The operand a block keeps for its whole life sits whole in shared
//   memory: the block's 64 rows of x in the dx kernel, its 64 table rows in
//   the dW kernel. The other operand streams through a 64 x 128 chunk
//   buffer: once over all of D for the scores (the 4 x 4 register tiles sum
//   across the chunks), then once more over the block's output columns, 64
//   at a time, for the kernel's own product. So no tile needs D registers or
//   2 x 64 x D floats of shared memory, and D is limited only by the one
//   whole tile: 64 * (D + 1) + 64 * 129 + 64 * 65 floats <= 227 KB, D <= 713.
// * A block owns up to kOutCols = 384 columns of its output, 16 rows x 6
//   columns per thread in registers, summed over the block's whole loop and
//   written once: no atomics, a fixed order, the same bits every run. Wider
//   rows split D over blockIdx.z (each such block recomputes the scores).
// * dx: a block per 64-row tile of x walks vocab tiles. Row tiles alone (40
//   at N = 2,560) would not fill 132 SMs, so the vocabulary is split across
//   blockIdx.y into f32 partials (splits, N, D) that a small second kernel
//   sums in split order and rounds to x's type, as the forward's combine
//   kernel does for (m, l).
// * dW: a block per 64-row vocab tile loops over all row tiles; db comes
//   from the blocks of the first D split only.
// * A tile whose A is all zero (blinded, no label in it) skips its product.
// Any N and V work, with the ragged edges masked.

#include "fused_ce_tiles.cuh"

namespace {

using namespace ce_tiles;

constexpr int kChunk = 128;    // columns of the streamed operand per load
constexpr int kOutChunks = 6;  // 64-column chunks of output a block owns
constexpr int kOutCols = kTile * kOutChunks;
constexpr int kCStride = kChunk + 1;
constexpr int kAStride = kTile + 1;

size_t two_pass_smem(int d) {
  return sizeof(float) * (kTile * (d + 1) + kTile * kCStride + kTile * kAStride);
}

// ---------------------------------------------------------------------- dx

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const int32_t* __restrict__ lab,
                     const float* __restrict__ logz,
                     const float* __restrict__ dnll, float* __restrict__ part,
                     int n, int v, int d, int row_offset, int num_valid,
                     int tiles_per_split) {
  extern __shared__ float smem[];
  const int stride = d + 1;
  float* xs = smem;                    // this block's rows of x, kTile x d
  float* cs = xs + kTile * stride;     // the streamed chunk of the table
  float* as = cs + kTile * kCStride;   // A for (row tile, vocab tile), f32
  const int row0 = blockIdx.x * kTile;
  const int split = blockIdx.y;
  const int d_lo = blockIdx.z * kOutCols;
  const int d_hi = min(d, d_lo + kOutCols);
  const int n_vtiles = (v + kTile - 1) / kTile;
  const int j0 = split * tiles_per_split;
  const int j1 = min(n_vtiles, j0 + tiles_per_split);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  // dx register tile: rows grp + 4r (16 of them), columns d_lo + dcol + 64c
  const int grp = threadIdx.x / 64;
  const int dcol = threadIdx.x % 64;

  load_x_tile<T>(xs, x, row0, n, d, 0, d, stride);
  float acc[16][kOutChunks];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int c = 0; c < kOutChunks; ++c) acc[r][c] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int col0 = j * kTile;
    float s[4][4];
    zero_tile(s);
    for (int kc = 0; kc < d; kc += kChunk) {
      __syncthreads();  // the readers of cs (and of as) are done
      load_w_tile<T>(cs, w, col0, v, d, kc, kChunk, kCStride);
      __syncthreads();
      score_add(xs + ty * stride + kc, stride, cs + tx * kCStride, kCStride,
                min(kChunk, d - kc), s);
    }
    const int nonzero = adjoint_tile(s, as, kAStride, bias, lab, logz, dnll,
                                     row0, col0, n, v, row_offset, num_valid);
    if (!__syncthreads_or(nonzero)) continue;  // A == 0: nothing to add

    // dx[grp + 4r, dc0 + dcol] += sum_vv A[grp + 4r, vv] * W[vv, dc0 + dcol]
#pragma unroll
    for (int c = 0; c < kOutChunks; ++c) {
      const int dc0 = d_lo + kTile * c;
      if (dc0 >= d_hi) break;  // the same for every thread of the block
      __syncthreads();         // the readers of cs are done
      load_w_tile<T>(cs, w, col0, v, d, dc0, kTile, kCStride);
      __syncthreads();
      for (int vv = 0; vv < kTile; ++vv) {
        const float wv = cs[vv * kCStride + dcol];
#pragma unroll
        for (int r = 0; r < 16; ++r)
          acc[r][c] = fmaf(round_to<T>(as[(grp + 4 * r) * kAStride + vv]), wv,
                           acc[r][c]);
      }
    }
  }
  float* out = part + static_cast<long long>(split) * n * d;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + grp + 4 * r;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < kOutChunks; ++c) {
      const int dc = d_lo + kTile * c + dcol;
      if (dc < d_hi) out[static_cast<long long>(row) * d + dc] = acc[r][c];
    }
  }
}

// dx = round_to_x(sum over the splits, in split order)
template <typename T>
__global__ void ce_bwd_dx_combine_kernel(const float* __restrict__ part,
                                         T* __restrict__ dx, long long total,
                                         int splits) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += part[s * total + i];
  dx[i] = from_f<T>(sum);
}

// ---------------------------------------------------------------------- dW

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_dw_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const int32_t* __restrict__ lab,
                     const float* __restrict__ logz,
                     const float* __restrict__ dnll, float* __restrict__ dw,
                     float* __restrict__ db, int n, int v, int d,
                     int row_offset, int num_valid) {
  extern __shared__ float smem[];
  const int stride = d + 1;
  float* ws = smem;                    // this block's table rows, kTile x d
  float* cs = ws + kTile * stride;     // the streamed chunk of x
  float* as = cs + kTile * kCStride;   // A for (row tile, vocab tile), f32
  const int col0 = blockIdx.x * kTile;
  const int d_lo = blockIdx.y * kOutCols;
  const int d_hi = min(d, d_lo + kOutCols);
  const int n_rtiles = (n + kTile - 1) / kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  // dW register tile: table rows grp + 4r, columns d_lo + dcol + 64c
  const int grp = threadIdx.x / 64;
  const int dcol = threadIdx.x % 64;
  const bool sums_db = db != nullptr && blockIdx.y == 0 && threadIdx.x < kTile;

  load_w_tile<T>(ws, w, col0, v, d, 0, d, stride);
  float acc[16][kOutChunks];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int c = 0; c < kOutChunks; ++c) acc[r][c] = 0.f;
  float acc_db = 0.f;

  for (int it = 0; it < n_rtiles; ++it) {
    const int row0 = it * kTile;
    float s[4][4];
    zero_tile(s);
    for (int kc = 0; kc < d; kc += kChunk) {
      __syncthreads();  // the readers of cs (and of as) are done
      load_x_tile<T>(cs, x, row0, n, d, kc, kChunk, kCStride);
      __syncthreads();
      score_add(cs + ty * kCStride, kCStride, ws + tx * stride + kc, stride,
                min(kChunk, d - kc), s);
    }
    const int nonzero = adjoint_tile(s, as, kAStride, bias, lab, logz, dnll,
                                     row0, col0, n, v, row_offset, num_valid);
    if (!__syncthreads_or(nonzero)) continue;  // A == 0: nothing to add

    if (sums_db) {
      for (int rr = 0; rr < kTile; ++rr) acc_db += as[rr * kAStride + threadIdx.x];
    }
    // dW[grp + 4r, dc0 + dcol] += sum_rr A[rr, grp + 4r] * x[rr, dc0 + dcol]
#pragma unroll
    for (int c = 0; c < kOutChunks; ++c) {
      const int dc0 = d_lo + kTile * c;
      if (dc0 >= d_hi) break;  // the same for every thread of the block
      __syncthreads();         // the readers of cs are done
      load_x_tile<T>(cs, x, row0, n, d, dc0, kTile, kCStride);
      __syncthreads();
      for (int rr = 0; rr < kTile; ++rr) {
        const float xv = cs[rr * kCStride + dcol];
#pragma unroll
        for (int r = 0; r < 16; ++r)
          acc[r][c] = fmaf(round_to<T>(as[rr * kAStride + grp + 4 * r]), xv,
                           acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int col = col0 + grp + 4 * r;
    if (col >= v) continue;
#pragma unroll
    for (int c = 0; c < kOutChunks; ++c) {
      const int dc = d_lo + kTile * c + dcol;
      if (dc < d_hi) dw[static_cast<long long>(col) * d + dc] = acc[r][c];
    }
  }
  if (sums_db && col0 + threadIdx.x < v) db[col0 + threadIdx.x] = acc_db;
}

// ---------------------------------------------------------------- launchers

template <typename T>
cudaError_t launch_dx(const void* x, const void* w, const void* bias,
                      const void* lab, const void* logz, const void* dnll,
                      void* part, void* dx, int n, int v, int d,
                      int row_offset, int num_valid, int splits,
                      int tiles_per_split, cudaStream_t stream) {
  const size_t smem = two_pass_smem(d);
  cudaError_t err = allow_smem(ce_bwd_dx_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, splits,
                  (d + kOutCols - 1) / kOutCols);
  ce_bwd_dx_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const int32_t*>(lab),
      static_cast<const float*>(logz), static_cast<const float*>(dnll),
      static_cast<float*>(part), n, v, d, row_offset, num_valid,
      tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(n) * d;
  ce_bwd_dx_combine_kernel<T>
      <<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
          static_cast<const float*>(part), static_cast<T*>(dx), total, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* w, const void* bias,
                      const void* lab, const void* logz, const void* dnll,
                      void* dw, void* db, int n, int v, int d, int row_offset,
                      int num_valid, cudaStream_t stream) {
  const size_t smem = two_pass_smem(d);
  const cudaError_t err = allow_smem(ce_bwd_dw_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((v + kTile - 1) / kTile, (d + kOutCols - 1) / kOutCols);
  ce_bwd_dw_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const int32_t*>(lab),
      static_cast<const float*>(logz), static_cast<const float*>(dnll),
      static_cast<float*>(dw), static_cast<float*>(db), n, v, d, row_offset,
      num_valid);
  return cudaGetLastError();
}

}  // namespace

// bias may be null. part is (splits, n, d) f32 scratch, written whole; dx is
// (n, d) in x's type. splits * tiles_per_split must cover the vocab tiles.
extern "C" int b4cp_ce_bwd_dx(const void* x, const void* w, const void* bias,
                              const void* lab, const void* logz,
                              const void* dnll, void* part, void* dx,
                              int is_bf16, int n, int v, int d, int row_offset,
                              int num_valid, int splits, int tiles_per_split,
                              int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's device in it
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  if (two_pass_smem(d) > kMaxSmem || splits < 1 ||
      static_cast<long long>(splits) * tiles_per_split < (v + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dx<__nv_bfloat16>(x, w, bias, lab, logz, dnll, part, dx,
                                         n, v, d, row_offset, num_valid,
                                         splits, tiles_per_split, s)
              : launch_dx<float>(x, w, bias, lab, logz, dnll, part, dx, n, v,
                                 d, row_offset, num_valid, splits,
                                 tiles_per_split, s);
  return static_cast<int>(err);
}

// bias and db may be null. dw (v, d) f32 and db (v,) f32 are written whole
// (zero when n == 0).
extern "C" int b4cp_ce_bwd_dw(const void* x, const void* w, const void* bias,
                              const void* lab, const void* logz,
                              const void* dnll, void* dw, void* db,
                              int is_bf16, int n, int v, int d, int row_offset,
                              int num_valid, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (v == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  if (two_pass_smem(d) > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dw<__nv_bfloat16>(x, w, bias, lab, logz, dnll, dw, db,
                                         n, v, d, row_offset, num_valid, s)
              : launch_dw<float>(x, w, bias, lab, logz, dnll, dw, db, n, v, d,
                                 row_offset, num_valid, s);
  return static_cast<int>(err);
}
