// Fused tied-projection softmax cross-entropy: forward statistics and the
// single-recompute backward, over a catalog table of V rows.
//
// Replaces two Pallas kernels of bert4clickpath_tpu/ops/pallas/fused_ce.py:
//
//   _fwd_kernel (via _fwd_stats / _fwd):  per row n of x (N, D),
//       s[n, v] = x[n] . round_to_x(W[v]) (+ bias[v]),   f32 accumulation
//       s[n, v] = -1e30 where v is outside [row_offset, row_offset+num_valid)
//       m[n] = max_v s[n, v],  l[n] = sum_v exp(s[n, v] - m[n])
//   _bwd_fused_kernel (via _bwd_fused / _bwd_auto): recompute s once, then
//       A[n, v] = dnll[n] * (exp(s[n, v] - logz[n]) - [v == label[n]])
//       dx = round_to_x(A) . round_to_x(W)      (N, D), stored in x's type
//       dW = round_to_x(A)^T . x                (V, D), summed in f32
//       db = sum_n A[n, v]                      (V,),   f32, unrounded A
//
// x is f32 or bf16; W and the bias are f32. "round_to_x" is the cast of
// the JAX kernel's `w.astype(x.dtype)` / `a.astype(x.dtype)`: a no-op for
// f32 x, a round to bf16 for bf16 x (then the products are exact in f32).
// The label logit is not computed here: the caller takes it outside, as a
// row gather and a row dot, as the JAX package does. The one-hot term stays
// in the backward, because the label logit carries no gradient of its own.
//
// What bounds it on the H100: arithmetic. At the flagship shape (N = 2,560
// masked positions, V = 55,296 rows, D = 256) the forward is 2*N*V*D = 72
// GFLOP and the backward three products of that size (217 GFLOP), against
// only ~60 MB of table and activations. In f32 FMA (no tensor cores, as the
// flagship's f32 x asks) the ceiling is 67 TFLOP/s, so ~1.1 ms forward and
// ~3.2 ms backward at best. What the TPU kernel kept out of HBM, and this
// one does too, is the (N, V) f32 logits (566 MB at the flagship).
//
// Design (simple first, f32 FMA from shared memory, no tensor cores):
// * Both kernels work on 64 x 64 tiles of s with 256 threads, each thread
//   owning a 4 x 4 register tile (rows ty + 16r, columns tx + 16c). The x
//   tile and the W tile sit in shared memory as f32, rows padded by one
//   float so lanes reading different rows hit different banks: the forward
//   streams both through 64 x 128 chunk buffers, so any D runs; the merged
//   backward keeps both whole (D <= 256).
// * Forward: one block owns a 64-row tile of x and a split of 32 vocab
//   tiles (2,048 table rows), keeping the online max / sum-exp per row in
//   registers (half-warp shuffles over the tile's 64 columns). One block
//   per row tile alone would give 40 blocks for 132 SMs; splitting the
//   vocabulary gives 1,080. A second small kernel combines the splits'
//   partial (m, l). Interior tiles skip the blinding.
// * Backward: one block owns a 64-row vocab tile and loops over all row
//   tiles, so its dW tile (64 x D, D <= 256) sums in registers, 64 per
//   thread, and is written once, with no atomics; db likewise. dx sums
//   across vocab tiles into an f32 (N, D) scratch with atomicAdd (the
//   wrapper zeroes it and casts it to x's type). Blocks start their row
//   loop at different row tiles, so concurrent blocks rarely add into the
//   same dx rows. A tile whose A is all zero (a blinded tile, no OOV label
//   in it) skips its products. The atomics' order varies run to run, so dx
//   agrees with the plain version to a tolerance, not bit for bit.
// The TPU tile tiers (vocab tiles up to 1024, _bwd_chunk_rows, the 4 MiB
// use_fused_backward budget) were VMEM limits and are gone: any N and V
// work, with the ragged edges masked. What limits D here: the merged
// backward's register tile holds D <= 256; wider rows take the two-pass
// backward of fused_ce_two_pass.cu, which, like the forward, takes any D. The tile helpers both files share are in
// fused_ce_tiles.cuh. wgmma / TMA pipelines are later work.

#include "fused_ce_tiles.cuh"

namespace {

using namespace ce_tiles;

constexpr int kMaxDChunks = 4;  // dW / dx register tiles cover D <= 64 * 4
constexpr int kFwdChunk = 128;  // columns of x and of the table per chunk of the forward

// ---------------------------------------------------------------- forward

// x and the table pass through 64 x kFwdChunk chunk buffers, x's chunks
// loaded again for every vocab tile (from L2), which takes any D. Whole
// 64 x (D + 1) tiles of both (the first version) held D <= 453 and were
// slower: 4.25 / 6.26 ms against 3.63 / 5.39 at D = 256 / 384, N = 2,560,
// V = 55,296 on an H100, as 66 KB of shared memory let three blocks share
// an SM (PERF.md, "the forward's route").
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ m_part,
                  float* __restrict__ l_part, int n, int v, int d,
                  int row_offset, int num_valid, int tiles_per_split) {
  extern __shared__ float smem[];
  constexpr int stride = kFwdChunk + 1;
  float* xs = smem;
  float* ws = xs + kTile * stride;
  const int row0 = blockIdx.x * kTile;
  const int split = blockIdx.y;
  const int n_vtiles = (v + kTile - 1) / kTile;
  const int j0 = split * tiles_per_split;
  const int j1 = min(n_vtiles, j0 + tiles_per_split);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  float m_run[4], l_run[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = kNegBig;  // the JAX kernel's init
    l_run[r] = 0.f;
  }
  for (int j = j0; j < j1; ++j) {
    const int col0 = j * kTile;
    float s[4][4];
    zero_tile(s);
    for (int kc = 0; kc < d; kc += kFwdChunk) {
      __syncthreads();  // the previous chunk's readers are done
      load_x_tile<T>(xs, x, row0, n, d, kc, kFwdChunk, stride);
      load_w_tile<T>(ws, w, col0, v, d, kc, kFwdChunk, stride);
      __syncthreads();
      score_add(xs + ty * stride, stride, ws + tx * stride, stride, min(kFwdChunk, d - kc), s);
    }
    const bool interior = col0 >= row_offset && col0 + kTile <= v &&
                          col0 + kTile <= row_offset + num_valid;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col0 + tx + 16 * c;
      const float bc = (bias != nullptr && col < v) ? bias[col] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float val = s[r][c];
        if (bias != nullptr) val = __fadd_rn(val, bc);  // before blinding
        if (!interior) {
          if (col >= v) {
            val = -INFINITY;  // no such row: contributes nothing
          } else if (!in_window(col, row_offset, num_valid)) {
            val = kNegBig;
          }
        }
        s[r][c] = val;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mt = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
      mt = half_warp_max(mt);
      const float m_new = fmaxf(m_run[r], mt);
      float e = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) e += expf(s[r][c] - m_new);
      e = half_warp_sum(e);
      l_run[r] = l_run[r] * expf(m_run[r] - m_new) + e;
      m_run[r] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + ty + 16 * r;
      if (row < n) {
        m_part[static_cast<long long>(split) * n + row] = m_run[r];
        l_part[static_cast<long long>(split) * n + row] = l_run[r];
      }
    }
  }
}

// (m, l) over the splits: m = max_s m_s, l = sum_s l_s * exp(m_s - m)
__global__ void ce_fwd_combine_kernel(const float* __restrict__ m_part,
                                      const float* __restrict__ l_part,
                                      float* __restrict__ m,
                                      float* __restrict__ l, int n,
                                      int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float mx = kNegBig;
  for (int s = 0; s < splits; ++s)
    mx = fmaxf(mx, m_part[static_cast<long long>(s) * n + row]);
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long long i = static_cast<long long>(s) * n + row;
    sum += l_part[i] * expf(m_part[i] - mx);
  }
  m[row] = mx;
  l[row] = sum;
}

// --------------------------------------------------------------- backward

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias,
                  const int32_t* __restrict__ lab,
                  const float* __restrict__ logz,
                  const float* __restrict__ dnll, float* __restrict__ dx32,
                  float* __restrict__ dw, float* __restrict__ db, int n, int v,
                  int d, int row_offset, int num_valid) {
  extern __shared__ float smem[];
  const int stride = d + 1;
  constexpr int astride = kTile + 1;
  float* ws = smem;                  // this block's table rows, kTile x d
  float* xs = ws + kTile * stride;   // the current row tile of x
  float* as = xs + kTile * stride;   // A for (row tile, vocab tile), f32
  const int col0 = blockIdx.x * kTile;
  const int n_rtiles = (n + kTile - 1) / kTile;
  // dW / dx register tiles: rows grp + 4r (16 of them), D columns
  // dcol + 64c (up to kMaxDChunks)
  const int grp = threadIdx.x / 64;
  const int dcol = threadIdx.x % 64;

  load_w_tile<T>(ws, w, col0, v, d, 0, d, stride);
  float acc_dw[16][kMaxDChunks];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int c = 0; c < kMaxDChunks; ++c) acc_dw[r][c] = 0.f;
  float acc_db = 0.f;
  const int start = n_rtiles > 0 ? blockIdx.x % n_rtiles : 0;
  for (int it = 0; it < n_rtiles; ++it) {
    const int row0 = ((start + it) % n_rtiles) * kTile;
    __syncthreads();  // the previous tile's readers are done with xs and as
    load_x_tile<T>(xs, x, row0, n, d, 0, d, stride);
    __syncthreads();
    float s[4][4];
    score_tile(xs, ws, d, stride, s);
    const int nonzero = adjoint_tile(s, as, astride, bias, lab, logz, dnll,
                                     row0, col0, n, v, row_offset, num_valid);
    if (!__syncthreads_or(nonzero)) continue;  // A == 0: nothing to add

    if (bias != nullptr && threadIdx.x < kTile) {
      for (int rr = 0; rr < kTile; ++rr) acc_db += as[rr * astride + threadIdx.x];
    }
    // dW[grp + 4r, dcol + 64c] += sum_rr A[rr, grp + 4r] * x[rr, dcol + 64c]
    for (int rr = 0; rr < kTile; ++rr) {
      float xv[kMaxDChunks];
#pragma unroll
      for (int c = 0; c < kMaxDChunks; ++c) {
        const int dc = dcol + 64 * c;
        xv[c] = dc < d ? xs[rr * stride + dc] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float a = round_to<T>(as[rr * astride + grp + 4 * r]);
#pragma unroll
        for (int c = 0; c < kMaxDChunks; ++c)
          acc_dw[r][c] = fmaf(a, xv[c], acc_dw[r][c]);
      }
    }
    // dx[row0 + grp + 4r, dc] += sum_vv A[grp + 4r, vv] * W[vv, dc]
#pragma unroll
    for (int c = 0; c < kMaxDChunks; ++c) {
      const int dc = dcol + 64 * c;
      if (dc >= d) break;
      float acc[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r] = 0.f;
      for (int vv = 0; vv < kTile; ++vv) {
        const float wv = ws[vv * stride + dc];
#pragma unroll
        for (int r = 0; r < 16; ++r)
          acc[r] = fmaf(round_to<T>(as[(grp + 4 * r) * astride + vv]), wv,
                        acc[r]);
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int row = row0 + grp + 4 * r;
        if (row < n) atomicAdd(dx32 + static_cast<long long>(row) * d + dc, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int col = col0 + grp + 4 * r;
    if (col >= v) continue;
#pragma unroll
    for (int c = 0; c < kMaxDChunks; ++c) {
      const int dc = dcol + 64 * c;
      if (dc < d) dw[static_cast<long long>(col) * d + dc] = acc_dw[r][c];
    }
  }
  if (db != nullptr && threadIdx.x < kTile && col0 + threadIdx.x < v) {
    db[col0 + threadIdx.x] = acc_db;
  }
}

constexpr size_t kFwdSmem = sizeof(float) * 2 * kTile * (kFwdChunk + 1);
size_t bwd_smem(int d) {
  return sizeof(float) * (2 * kTile * (d + 1) + kTile * (kTile + 1));
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, const void* bias,
                       void* m_part, void* l_part, void* m, void* l, int n,
                       int v, int d, int row_offset, int num_valid,
                       int splits, int tiles_per_split, cudaStream_t stream) {
  cudaError_t err = allow_smem(ce_fwd_kernel<T>, kFwdSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, splits);
  ce_fwd_kernel<T><<<grid, kThreads, kFwdSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(m_part),
      static_cast<float*>(l_part), n, v, d, row_offset, num_valid,
      tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_fwd_combine_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<float*>(m), static_cast<float*>(l), n, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* bias,
                       const void* lab, const void* logz, const void* dnll,
                       void* dx32, void* dw, void* db, int n, int v, int d,
                       int row_offset, int num_valid, cudaStream_t stream) {
  const size_t smem = bwd_smem(d);
  const cudaError_t err = allow_smem(ce_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((v + kTile - 1) / kTile);
  ce_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const int32_t*>(lab),
      static_cast<const float*>(logz), static_cast<const float*>(dnll),
      static_cast<float*>(dx32), static_cast<float*>(dw),
      static_cast<float*>(db), n, v, d, row_offset, num_valid);
  return cudaGetLastError();
}

}  // namespace

// bias may be null. m_part / l_part are (splits, n) f32 scratch; m, l (n,).
extern "C" int b4cp_ce_fwd(const void* x, const void* w, const void* bias,
                           void* m_part, void* l_part, void* m, void* l,
                           int is_bf16, int n, int v, int d, int row_offset,
                           int num_valid, int splits, int tiles_per_split,
                           int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's device in it
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n == 0 || v == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_fwd<__nv_bfloat16>(x, w, bias, m_part, l_part, m, l, n, v, d, row_offset,
                                          num_valid, splits, tiles_per_split, s)
              : launch_fwd<float>(x, w, bias, m_part, l_part, m, l, n, v, d, row_offset,
                                  num_valid, splits, tiles_per_split, s);
  return static_cast<int>(err);
}

// bias and db may be null. dx32 (n, d) f32 must be zero on entry; dw (v, d)
// f32 and db (v,) f32 are written whole (zero when n == 0).
extern "C" int b4cp_ce_bwd(const void* x, const void* w, const void* bias,
                           const void* lab, const void* logz,
                           const void* dnll, void* dx32, void* dw, void* db,
                           int is_bf16, int n, int v, int d, int row_offset,
                           int num_valid, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (v == 0) return static_cast<int>(cudaGetLastError());
  if (d > kTile * kMaxDChunks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_bwd<__nv_bfloat16>(x, w, bias, lab, logz, dnll, dx32,
                                          dw, db, n, v, d, row_offset,
                                          num_valid, s)
              : launch_bwd<float>(x, w, bias, lab, logz, dnll, dx32, dw, db, n,
                                  v, d, row_offset, num_valid, s);
  return static_cast<int>(err);
}
