// The two-pass backward of the fused softmax cross-entropy: a dx kernel and
// a dW kernel that each recompute the scores once, for rows wider than the
// merged backward takes (fused_ce.cu: D <= 256).
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
// GFLOP per kernel, 3.2 ms in f32 FMA at 67 TFLOP/s, 1.0 ms as three tf32
// products on the tensor cores (495 TFLOP/s).
//
// Both kernels run their products on the tensor cores, with one design:
// f32 x as hi + lo tf32 terms in three m16n8k8 products (kDxNumerics), the
// numerics measured in PERF.md, "the dx numerics decision"; bf16 x in one
// bf16 product. The dx kernel (ce_bwd_dx_mma_kernel) keeps 64 rows of x in
// shared memory and streams the table; the dW kernel (ce_bwd_dw_mma_kernel,
// in fused_ce_mma.cuh with its design notes, as the merged backward shares
// it) is its mirror, 64 table rows resident and x streamed. Any N, V and D
// work, with the ragged edges masked; neither uses atomics, so two runs give
// the same bits.

#include "fused_ce_mma.cuh"

namespace {

// ---------------------------------------------------------------------- dx

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

// ------------------------------------------------------- dx, tensor cores
//
// The dx pass is an attention forward with q = x, k = v = W and a softmax
// whose normaliser logz is known: per vocab tile, s = x W^T (+ b), A =
// dnll (exp(s - logz) - onehot), dx += A W, both products on the tensor
// cores in the numerics of fused_ce_mma.cuh.
//
// A block of 8 warps owns 64 rows of x and walks its split of the vocabulary
// in tiles of 64 table rows. The rows of x stay in
// shared memory for the block's life (bf16 terms, or raw f32 that tf32
// fragments round or split as they are read) where they fit (D <= 512 in
// bf16 x3, 384 in tf32 x3); wider rows load x's chunk beside each of the
// table's. The table streams in chunks of 64 rows x 64 columns through
// kDxStages cp.async stages of raw f32 (two chunks in flight behind the one
// in use), a chunk converted once into the numerics' terms (hi and lo
// planes) and read by every warp with ldmatrix (tf32's second product
// element by element): D/64 chunks for the score product, then the block's
// output columns again, 64 at a time, for A W. A warp takes 16 rows x 32
// vocab columns of s; A goes through shared memory (rounded or split once
// there), and a warp sums 16 rows x 32 columns of every 64-column output
// chunk: 96 f32 accumulators for the block's 384 columns. Wider rows split D
// over blockIdx.z (each such block recomputes the scores). A tile whose A is
// all zero skips its second product. Every kDxFlush k-steps the products go
// into fresh registers and join the running f32 sums with adds that round to
// nearest (kstep_sum). The vocabulary is split into f32 partials summed in
// split order by ce_bwd_dx_combine_kernel: no atomics, two runs give the
// same bits.
//
// What bounds it: the mma.sync issue rate. tf32 x3 is 318 M m16n8k8
// instructions at N = 2,560, V = 55,296, D = 384, ~600 k per SM sub-
// partition; at the ~16 clocks each that mma.sync sustains on this card
// (the bf16 dq and dk/dv kernels of attention_blockwise.cu reach ~240 of
// the 989 TFLOP/s) that alone is ~5.3 ms of its 7.45. The constants
// (kDxStages, kDxFlush, kDxColWarps) were timed with
// examples/long_context/tune_blockwise_bwd.py --kernel ce_dx, as was reading
// the table raw and splitting it fragment by fragment instead of converting
// it once (slower, removed); none moved it by more than 5% (PERF.md). wgmma
// is the way past this rate.

constexpr int kDxStages = 3;  // cp.async stages of the table: two chunks in flight

template <int MODE, bool XRES>
__global__ void __launch_bounds__(kDxThreads, 1)
    ce_bwd_dx_mma_kernel(const typename DxMode<MODE>::X* __restrict__ x,
                         const float* __restrict__ w, const float* __restrict__ bias,
                         const int32_t* __restrict__ lab, const float* __restrict__ logz,
                         const float* __restrict__ dnll, float* __restrict__ part, int n, int v,
                         int d, int row_offset, int num_valid, int tiles_per_split, int w_vec) {
  using M = DxMode<MODE>;
  extern __shared__ __align__(16) unsigned char smem_dx[];
  const DxSmem<MODE> L(d, XRES, kDxStages);
  const int row0 = blockIdx.x * kDxRows;
  const int split = blockIdx.y;
  const int d_lo = blockIdx.z * kOutCols;
  const int d_hi = min(d, d_lo + kOutCols);
  const int n_vtiles = (v + kDxVocab - 1) / kDxVocab;
  const int j0 = split * tiles_per_split;
  const int j1 = min(n_vtiles, j0 + tiles_per_split);
  const int nk = (d + kDxChunk - 1) / kDxChunk;            // chunks of the score product
  const int no = (d_hi - d_lo + kDxChunk - 1) / kDxChunk;  // and of the block's output columns
  const int steps = nk + no;                               // table chunks per vocab tile
  const int total = max(0, j1 - j0) * steps;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rg = (warp & 3) * 16;   // the warp's 16 rows of x and of dx
  const int cg = (warp >> 2) * (8 * kDxNT);  // its first vocab column of s, and of each dx chunk
  const int rf_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int rf_col = (lane >> 4) * 16;
  const int cf_row = (lane & 7) + (lane >> 4) * 8;
  const int cf_col = ((lane >> 3) & 1) * 16;
  const uint32_t base = tc::shared_addr(smem_dx);
  const uint32_t w_addr = base + L.chunk_at;  // the table's converted chunk

  // columns [c0, c0 + ncols) of the block's rows of x into its planes
  auto load_x = [&](int c0, int ncols) {
    load_rows<MODE>(smem_dx + L.res_at, L.res_row, L.res_plane, x, row0, n, d, c0, ncols);
  };
  // the table chunk of step `step` (vocab tile, then its columns) into its stage
  auto issue = [&](int step) {
    const int tile = step / steps;
    const int r = step - tile * steps;
    const int col = r < nk ? r * kDxChunk : d_lo + (r - nk) * kDxChunk;
    copy_table_chunk(reinterpret_cast<float*>(smem_dx + (step % kDxStages) * kDxStage), w,
                     (j0 + tile) * kDxVocab, col, v, d, w_vec);
  };

  if (XRES) load_x(0, (d + kDxChunk - 1) / kDxChunk * kDxChunk);
  int q = 0;
  for (int step = 0; step < kDxStages - 1; ++step) {  // one commit group per step, empty past the end
    if (step < total) issue(step);
    tc::cp_async_commit();
  }
  // Step q: wait for its table chunk, convert it once into the numerics'
  // planes (at the row of the product it feeds: w_row) and, without a
  // resident x, load x's chunk x_col (-1: none); start the copy of step
  // q + kDxStages - 1 into the stage step q - 1 used. The first barrier
  // also ends every read of the previous step's stage and planes.
  auto advance = [&](int x_col, int w_row) {
    tc::cp_async_wait<kDxStages - 2>();
    __syncthreads();
    convert_table_chunk<MODE>(smem_dx + L.chunk_at,
                              reinterpret_cast<const float*>(smem_dx + (q % kDxStages) * kDxStage), w_row);
    if (!XRES && x_col >= 0) load_x(x_col, kDxChunk);
    if (q + kDxStages - 1 < total) issue(q + kDxStages - 1);
    tc::cp_async_commit();
    __syncthreads();
    ++q;
  };

  float acc[kDxOutChunks][kDxNT][4];
#pragma unroll
  for (int o = 0; o < kDxOutChunks; ++o)
#pragma unroll
    for (int nt = 0; nt < kDxNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[o][nt][e] = 0.f;

  const uint32_t a_at = base + L.a_at + (rg + rf_row) * M::kChunkRow + rf_col;
  for (int j = j0; j < j1; ++j) {
    float s[kDxNT][4];
#pragma unroll
    for (int nt = 0; nt < kDxNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    for (int c = 0; c < nk; ++c) {
      advance(c * kDxChunk, M::kChunkRow);
      const uint32_t xa = base + L.res_at + (XRES ? c * kDxChunk * M::kElem : 0) + (rg + rf_row) * L.res_row + rf_col;
      const uint32_t wa = w_addr + (cg + cf_row) * M::kChunkRow + cf_col;
      dx_scores<MODE>(s, xa, L.res_row, L.res_plane, wa, M::kChunkRow, M::kWPlane);
    }

    // A = dnll (exp(s (+ b) - logz) - onehot), blinded outside the window;
    // 0 past n and v
    const int vrow0 = j * kDxVocab;
    int nonzero = 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rg + g + 8 * half;
      const int row = row0 + r;
      const bool valid_row = row < n;
      const float lz = valid_row ? logz[row] : 0.f;
      const float gr = valid_row ? dnll[row] : 0.f;
      const int lb = valid_row ? lab[row] : -1;
#pragma unroll
      for (int nt = 0; nt < kDxNT; ++nt) {
        const int cl = cg + nt * 8 + 2 * t;
        float a[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = vrow0 + cl + e;
          a[e] = 0.f;
          if (valid_row && col < v) {
            float val = s[nt][2 * half + e];
            if (bias != nullptr) val = __fadd_rn(val, bias[col]);
            if (!in_window(col, row_offset, num_valid)) val = kNegBig;
            a[e] = gr * (expf(val - lz) - (col == lb ? 1.f : 0.f));  // blinded: exactly 0
          }
          nonzero |= a[e] != 0.f;
        }
        put_pair<MODE>(smem_dx + L.a_at + r * M::kChunkRow, M::kChunkPlane, cl, a[0], a[1]);
      }
    }
    nonzero = __syncthreads_or(nonzero);

#pragma unroll
    for (int o = 0; o < kDxOutChunks; ++o) {
      if (o < no) {  // the same for every thread of the block
        advance(-1, M::kOutRow);
        if (nonzero) dx_product<MODE>(acc[o], a_at, w_addr, smem_dx + L.chunk_at, cg, lane);
      }
    }
  }
  tc::cp_async_wait<0>();

  float* out = part + static_cast<long long>(split) * n * d;
#pragma unroll
  for (int o = 0; o < kDxOutChunks; ++o) {
#pragma unroll
    for (int nt = 0; nt < kDxNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + rg + g + 8 * (e >> 1);
        const int col = d_lo + o * kDxChunk + cg + nt * 8 + 2 * t + (e & 1);
        if (o < no && row < n && col < d_hi) out[static_cast<long long>(row) * d + col] = acc[o][nt][e];
      }
    }
  }
}

// ---------------------------------------------------------------- launchers

template <typename T>
cudaError_t launch_combine(const void* part, void* dx, int n, int d, int splits,
                           cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * d;
  ce_bwd_dx_combine_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(dx), total, splits);
  return cudaGetLastError();
}

template <int MODE, bool XRES>
cudaError_t launch_dx_mma(const void* x, const void* w, const void* bias, const void* lab,
                          const void* logz, const void* dnll, void* part, int n, int v, int d,
                          int row_offset, int num_valid, int splits, int tiles_per_split,
                          cudaStream_t stream) {
  using X = typename DxMode<MODE>::X;
  auto kernel = ce_bwd_dx_mma_kernel<MODE, XRES>;
  const size_t smem = DxSmem<MODE>(d, XRES, kDxStages).total;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int w_vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((n + kDxRows - 1) / kDxRows, splits, (d + kOutCols - 1) / kOutCols);
  kernel<<<grid, kDxThreads, smem, stream>>>(
      static_cast<const X*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const int32_t*>(lab), static_cast<const float*>(logz),
      static_cast<const float*>(dnll), static_cast<float*>(part), n, v, d, row_offset, num_valid,
      tiles_per_split, w_vec);
  return cudaGetLastError();
}

// x resident where its planes fit one block with the rest
template <int MODE>
cudaError_t launch_dx_tc(const void* x, const void* w, const void* bias, const void* lab,
                         const void* logz, const void* dnll, void* part, int n, int v, int d,
                         int row_offset, int num_valid, int splits, int tiles_per_split,
                         cudaStream_t stream) {
  const bool resident = DxSmem<MODE>(d, true, kDxStages).total <= kMaxSmem;
  return resident ? launch_dx_mma<MODE, true>(x, w, bias, lab, logz, dnll, part, n, v, d, row_offset,
                                              num_valid, splits, tiles_per_split, stream)
                  : launch_dx_mma<MODE, false>(x, w, bias, lab, logz, dnll, part, n, v, d, row_offset,
                                               num_valid, splits, tiles_per_split, stream);
}

// the table rows resident where their planes fit one block with the rest
template <int MODE>
cudaError_t launch_dw_tc(const void* x, const void* w, const void* bias, const void* lab,
                         const void* logz, const void* dnll, void* dw, void* db, int n, int v,
                         int d, int row_offset, int num_valid, cudaStream_t stream) {
  const bool resident = kDwResident && dw_smem<MODE>(d, true, false) <= kMaxSmem;
  return resident ? launch_dw_mma<MODE, true, false>(x, w, bias, lab, logz, dnll, nullptr, dw, db, nullptr,
                                                     n, v, d, row_offset, num_valid, stream)
                  : launch_dw_mma<MODE, false, false>(x, w, bias, lab, logz, dnll, nullptr, dw, db, nullptr,
                                                      n, v, d, row_offset, num_valid, stream);
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
  if (splits < 1 || static_cast<long long>(splits) * tiles_per_split < (v + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto launch) {
    return launch(x, w, bias, lab, logz, dnll, part, n, v, d, row_offset, num_valid, splits,
                  tiles_per_split, s);
  };
  cudaError_t err = is_bf16 ? args(launch_dx_tc<kDxBf16>) : args(launch_dx_tc<kDxNumerics>);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = is_bf16 ? launch_combine<__nv_bfloat16>(part, dx, n, d, splits, s)
                : launch_combine<float>(part, dx, n, d, splits, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto launch) {
    return launch(x, w, bias, lab, logz, dnll, dw, db, n, v, d, row_offset, num_valid, s);
  };
  const cudaError_t err = is_bf16 ? args(launch_dw_tc<kDxBf16>) : args(launch_dw_tc<kDxNumerics>);
  return static_cast<int>(err);
}
