// Fused tied-projection softmax cross-entropy: forward statistics and the
// single-recompute (merged) backward, over a catalog table of V rows.
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
// only ~60 MB of table and activations. What the TPU kernels kept out of
// HBM, and these do too, is the (N, V) f32 logits (566 MB at the flagship).
//
// The forward (f32 FMA from shared memory, no tensor cores): 64 x 64 tiles
// of s with 256 threads, each thread owning a 4 x 4 register tile (rows
// ty + 16r, columns tx + 16c); x and the table stream through 64 x 128
// chunk buffers of f32, rows padded by one float so lanes reading different
// rows hit different banks, so any D runs. One block owns a 64-row tile of x
// and a split of 32 vocab tiles (2,048 table rows), keeping the online max /
// sum-exp per row in registers (half-warp shuffles over the tile's 64
// columns). One block per row tile alone would give 40 blocks for 132 SMs;
// splitting the vocabulary gives 1,080. A second small kernel combines the
// splits' partial (m, l). Interior tiles skip the blinding.
//
// The merged backward runs its three products on the tensor cores: it is
// the dW pass's kernel (ce_bwd_dw_mma_kernel in fused_ce_mma.cuh, design
// notes there) with a third product. A block owns 64 table rows, resident
// in shared memory, and walks the row tiles of x: per tile it recomputes
// s^T = W_tile . x_tile^T once, forms A^T, adds A^T . x into its dW rows
// (held in registers for its life, 64 a thread: D <= 256) and A . W_tile
// into dx. It walks only the rows whose dnll is nonzero (listed first by a
// one-block kernel in the same entry): the others add nothing. f32 x runs
// each product as three tf32 ones (hi + lo terms, kDxNumerics), bf16 x as
// one bf16 product. dW and db are summed in a fixed order and written once
// (two runs give the same bits); dx sums over every vocab tile, across
// blocks, with 16-byte f32 atomic adds into an f32 (N, D) scratch that the
// wrapper zeroes and casts to x's type, so it agrees with the plain version
// to a tolerance, not bit for bit. A tile whose A is all zero skips the dW
// and dx products.
// The TPU tile tiers (vocab tiles up to 1024, _bwd_chunk_rows, the 4 MiB
// use_fused_backward budget) were VMEM limits and are gone: any N and V
// work, with the ragged edges masked. Wider rows than D = 256 take the
// two-pass backward of fused_ce_two_pass.cu, which, like the forward,
// takes any D. wgmma / TMA pipelines are later work.

#include "fused_ce_mma.cuh"

namespace {

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

constexpr size_t kFwdSmem = sizeof(float) * 2 * kTile * (kFwdChunk + 1);

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

// bias and db may be null. live is (n + 1) int32 scratch. dx32 (n, d) f32
// must be zero on entry and is added into; dw (v, d) f32 and db (v,) f32
// are written whole (zero when n == 0). d <= 256.
extern "C" int b4cp_ce_bwd(const void* x, const void* w, const void* bias,
                           const void* lab, const void* logz,
                           const void* dnll, void* live, void* dx32, void* dw, void* db,
                           int is_bf16, int n, int v, int d, int row_offset,
                           int num_valid, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (v == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  if (d > kDxChunk * kMrgOutChunks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto launch) {
    return launch(x, w, bias, lab, logz, dnll, live, dw, db, dx32, n, v, d, row_offset, num_valid, s);
  };
  const cudaError_t err = is_bf16 ? args(launch_dw_mma<kDxBf16, true, true>)
                                  : args(launch_dw_mma<kDxNumerics, true, true>);
  return static_cast<int>(err);
}
