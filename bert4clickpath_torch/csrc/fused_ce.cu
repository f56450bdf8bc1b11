// Fused tied-projection softmax cross-entropy: forward statistics and the
// single-recompute (merged) backward, over a catalog table of V rows.
//
// Replaces two Pallas kernels of bert4clickpath_tpu/ops/pallas/fused_ce.py:
//
//   _fwd_kernel (via _fwd_stats / _fwd):  per row n of x (N, D),
//       s[n, v] = x[n] . round_to_x(W[v]) (+ bias[v]),   f32 accumulation
//       s[n, v] = -1e30 where row_start + v is outside
//                 [row_offset, row_offset+num_valid)
//       m[n] = max_v s[n, v],  l[n] = sum_v exp(s[n, v] - m[n])
//   _bwd_fused_kernel (via _bwd_fused / _bwd_auto): recompute s once, then
//       A[n, v] = dnll[n] * (exp(s[n, v] - logz[n]) - [row_start + v == label[n]])
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
// The forward (ce_fwd_mma_kernel) is the dx pass's score product alone
// (ce_bwd_dx_mma_kernel, fused_ce_two_pass.cu; its pieces in
// fused_ce_mma.cuh) with an online softmax on the accumulator fragments. A
// block of 8 warps owns 64 rows of x and walks a split of 64-row vocab tiles.
// x stays in shared memory for the block's life (raw f32 that tf32
// fragments split as they are read, or bf16; copied by 16-byte cp.async
// ahead of the table) where it fits one block with the rest: D <= 512 for
// f32 x, 1,280 for bf16 (no A planes, so more room than the dx pass's 384);
// wider rows load x's chunk beside each of the table's. The table streams
// in chunks of 64 rows x 64 columns through kCeFwdStages cp.async stages,
// each converted once into the numerics' planes, and dx_scores runs the
// product on mma.sync: f32 x in tf32 x3 (kDxNumerics, as every CE backward
// kernel: one tf32 product errs by ~|s| 2^-11, 5e-3 at logits of ~10, and
// logz is held to 1e-4), bf16 x as one bf16 product of the table rounded to
// bf16 (exact in f32), the k-steps' products joined to the sums every
// kCeFwdFlush k-steps by adds that round to nearest. Per vocab tile a warp holds 16 rows x 32 columns of
// s, a thread rows g and g + 8 and columns 2t, 2t + 1 of four n8 tiles: it
// adds the bias, blinds the tile (interior tiles skip that), takes the
// tile's max per row across its quad and updates the row's running (m, l)
// in registers. At the end the two column warps of each row are combined
// through shared memory in warp order and the block writes (m, l) for its
// split; ce_fwd_combine_kernel combines the splits, a warp a row, in a
// fixed order. Nothing is atomic: two runs give the same bits. The grid is
// (row tiles, vocab splits), the vocabulary split until the blocks reach a
// target count with at least a few tiles a split (ops/kernels/fused_ce.py,
// ce_splits), so that a short N fills the card too.
//
// What bounds the forward: the mma.sync issue rate, as for the dx pass. At
// N = 2,560, V = 55,296, D = 384 its tf32 x3 product is 159 M m16n8k8
// instructions, ~300 k per SM sub-partition: ~2.5 ms at the ~16 clocks each
// that mma.sync sustains on this card (3.5 ms measured, with the chunk
// conversions and barriers that one block per SM does not hide), against
// 0.65 ms at the TF32 peak; wgmma is the way past it. The stages, the flush
// and the blocks per SM were timed with
// examples/long_context/tune_blockwise_bwd.py --kernel ce_fwd (PERF.md).
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

constexpr int kCeFwdStages = 3;     // cp.async stages of the table: two chunks in flight
constexpr int kCeFwdFlush = 8;      // k-steps whose products share fresh sums (kstep_sum): a chunk's
constexpr int kCeFwdMinBlocks = 1;  // blocks per SM that __launch_bounds__ asks for
constexpr bool kCeFwdResident = true;  // false: stream x's chunks beside the table's at every D

// ---------------------------------------------------------------- forward

template <int MODE, bool XRES>
__global__ void __launch_bounds__(kDxThreads, kCeFwdMinBlocks)
    ce_fwd_mma_kernel(const typename DxMode<MODE>::X* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ m_part,
                      float* __restrict__ l_part, int n, int v, int d, int row_offset, int num_valid,
                      int tiles_per_split, int w_vec, int x_vec) {
  using M = DxMode<MODE>;
  using X = typename M::X;
  extern __shared__ __align__(16) unsigned char smem_fwd[];
  const DxSmem<MODE> L(d, XRES, kCeFwdStages);
  const int row0 = blockIdx.x * kDxRows;
  const int split = blockIdx.y;
  const int n_vtiles = (v + kDxVocab - 1) / kDxVocab;
  const int j0 = split * tiles_per_split;
  const int j1 = min(n_vtiles, j0 + tiles_per_split);
  const int nk = (d + kDxChunk - 1) / kDxChunk;  // table chunks per vocab tile
  const int total = max(0, j1 - j0) * nk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rg = (warp & 3) * 16;            // the warp's 16 rows of x
  const int cg = (warp >> 2) * (8 * kDxNT);  // its first column of each vocab tile
  const int rf_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int rf_col = (lane >> 4) * 16;
  const int cf_row = (lane & 7) + (lane >> 4) * 8;
  const int cf_col = ((lane >> 3) & 1) * 16;
  const uint32_t base = tc::shared_addr(smem_fwd);
  const uint32_t w_addr = base + L.chunk_at;  // the table's converted chunk

  auto load_x = [&](int c0, int ncols) {
    load_rows<MODE>(smem_fwd + L.res_at, L.res_row, L.res_plane, x, row0, n, d, c0, ncols);
  };
  // the table chunk of step `step` (vocab tile, then its columns) into its stage
  auto issue = [&](int step) {
    const int tile = step / nk;
    copy_table_chunk(reinterpret_cast<float*>(smem_fwd + (step % kCeFwdStages) * kDxStage), w,
                     (j0 + tile) * kDxVocab, (step - tile * nk) * kDxChunk, v, d, w_vec);
  };

  // resident x: 16-byte copies in a commit group of their own, ahead of the
  // table's, where its planes hold it as it is (every compiled numerics)
  // and its rows allow; else element by element
  if constexpr (XRES && M::kXPlanes == 1 && sizeof(X) == M::kElem) {
    if (x_vec) {
      copy_rows<MODE>(smem_fwd + L.res_at, L.res_row, x, row0, n, d, nk * kDxChunk);
    } else {
      load_x(0, nk * kDxChunk);
    }
  } else if (XRES) {
    load_x(0, nk * kDxChunk);
  }
  tc::cp_async_commit();
  int q = 0;
  for (int step = 0; step < kCeFwdStages - 1; ++step) {  // one commit group per step, empty past the end
    if (step < total) issue(step);
    tc::cp_async_commit();
  }
  // Step q: wait for its table chunk, convert it once into the numerics'
  // planes and, without a resident x, load x's chunk x_col; start the copy
  // of step q + kCeFwdStages - 1 into the stage step q - 1 used. The first
  // barrier also ends every read of the previous step's stage and planes.
  auto advance = [&](int x_col) {
    tc::cp_async_wait<kCeFwdStages - 2>();
    __syncthreads();
    convert_table_chunk<MODE>(smem_fwd + L.chunk_at,
                              reinterpret_cast<const float*>(smem_fwd + (q % kCeFwdStages) * kDxStage),
                              M::kChunkRow);
    if (!XRES) load_x(x_col, kDxChunk);
    if (q + kCeFwdStages - 1 < total) issue(q + kCeFwdStages - 1);
    tc::cp_async_commit();
    __syncthreads();
    ++q;
  };

  // the running max and sum-exp of the thread's rows rg + g and rg + g + 8
  float m_run[2] = {kNegBig, kNegBig};  // the JAX kernel's init
  float l_run[2] = {0.f, 0.f};
  for (int j = j0; j < j1; ++j) {
    float s[kDxNT][4];
#pragma unroll
    for (int nt = 0; nt < kDxNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    for (int c = 0; c < nk; ++c) {
      advance(c * kDxChunk);
      const uint32_t xa = base + L.res_at + (XRES ? c * kDxChunk * M::kElem : 0) + (rg + rf_row) * L.res_row + rf_col;
      const uint32_t wa = w_addr + (cg + cf_row) * M::kChunkRow + cf_col;
      dx_scores<MODE, kCeFwdFlush>(s, xa, L.res_row, L.res_plane, wa, M::kChunkRow, M::kWPlane);
    }

    // + bias, then -1e30 outside the window and -inf past v (no such row:
    // it adds nothing); the tile's max per row over the quad's 32 columns,
    // then the running (m, l)
    const int vrow0 = j * kDxVocab;
    const bool interior = vrow0 >= row_offset && vrow0 + kDxVocab <= v &&
                          vrow0 + kDxVocab <= row_offset + num_valid;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kDxNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = vrow0 + cg + nt * 8 + 2 * t + e;
        const float bc = bias != nullptr && col < v ? __ldg(bias + col) : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float val = s[nt][2 * half + e];
          if (bias != nullptr) val = __fadd_rn(val, bc);  // before blinding
          if (!interior) {
            if (col >= v) {
              val = -INFINITY;
            } else if (!in_window(col, row_offset, num_valid)) {
              val = kNegBig;
            }
          }
          s[nt][2 * half + e] = val;
          mt[half] = fmaxf(mt[half], val);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float m_new = fmaxf(m_run[half], tc::quad_max(mt[half]));
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kDxNT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) sum += expf(s[nt][2 * half + e] - m_new);
      l_run[half] = l_run[half] * expf(m_run[half] - m_new) + tc::quad_sum(sum);
      m_run[half] = m_new;
    }
  }
  tc::cp_async_wait<0>();

  // the two column warps of each row, combined in warp order: (m, l) of the
  // split's 64 rows
  __syncthreads();  // every copy has landed and every stage been read: stage 0 is free
  float* part = reinterpret_cast<float*>(smem_fwd);  // m, then l: (kDxColWarps, 64) each
  if (t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = (warp >> 2) * kDxRows + rg + g + 8 * half;
      part[r] = m_run[half];
      part[kDxColWarps * kDxRows + r] = l_run[half];
    }
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < kDxRows && row0 + r < n) {
    float mx = kNegBig;
    for (int cw = 0; cw < kDxColWarps; ++cw) mx = fmaxf(mx, part[cw * kDxRows + r]);
    float sum = 0.f;
    for (int cw = 0; cw < kDxColWarps; ++cw)
      sum += part[kDxColWarps * kDxRows + cw * kDxRows + r] * expf(part[cw * kDxRows + r] - mx);
    m_part[static_cast<long long>(split) * n + row0 + r] = mx;
    l_part[static_cast<long long>(split) * n + row0 + r] = sum;
  }
}

// (m, l) over the splits, m = max_s m_s and l = sum_s l_s exp(m_s - m),
// a warp a row: its lanes take the splits in turn and combine them in a
// fixed order (two runs give the same bits). A short N splits the
// vocabulary into hundreds of splits, which one thread a row would walk
// one dependent load at a time.
constexpr int kCombineRows = 8;  // rows (warps) per block
__global__ void __launch_bounds__(32 * kCombineRows)
    ce_fwd_combine_kernel(const float* __restrict__ m_part, const float* __restrict__ l_part,
                          float* __restrict__ m, float* __restrict__ l, int n, int splits) {
  const int row = blockIdx.x * kCombineRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;  // the whole warp
  float mx = kNegBig;
  for (int s = lane; s < splits; s += 32) mx = fmaxf(mx, m_part[static_cast<long long>(s) * n + row]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int s = lane; s < splits; s += 32) {
    const long long i = static_cast<long long>(s) * n + row;
    sum += l_part[i] * expf(m_part[i] - mx);
  }
  sum = warp_sum(sum);
  if (lane == 0) {
    m[row] = mx;
    l[row] = sum;
  }
}

template <int MODE, bool XRES>
cudaError_t launch_fwd_mma(const void* x, const void* w, const void* bias, void* m_part, void* l_part,
                           int n, int v, int d, int row_offset, int num_valid, int splits,
                           int tiles_per_split, cudaStream_t stream) {
  using X = typename DxMode<MODE>::X;
  auto kernel = ce_fwd_mma_kernel<MODE, XRES>;
  const size_t smem = DxSmem<MODE>(d, XRES, kCeFwdStages).a_at;  // no A planes
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int w_vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int x_vec = d % (16 / sizeof(X)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((n + kDxRows - 1) / kDxRows, splits);
  kernel<<<grid, kDxThreads, smem, stream>>>(
      static_cast<const X*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(m_part), static_cast<float*>(l_part), n, v, d, row_offset, num_valid,
      tiles_per_split, w_vec, x_vec);
  return cudaGetLastError();
}

// x resident where its planes fit one block with the rest (D <= 512 for
// f32 x, 1,280 for bf16); then the splits combined
template <int MODE>
cudaError_t launch_fwd(const void* x, const void* w, const void* bias, void* m_part, void* l_part,
                       void* m, void* l, int n, int v, int d, int row_offset, int num_valid,
                       int splits, int tiles_per_split, cudaStream_t stream) {
  const bool resident = kCeFwdResident && DxSmem<MODE>(d, true, kCeFwdStages).a_at <= kMaxSmem;
  cudaError_t err =
      resident ? launch_fwd_mma<MODE, true>(x, w, bias, m_part, l_part, n, v, d, row_offset, num_valid,
                                            splits, tiles_per_split, stream)
               : launch_fwd_mma<MODE, false>(x, w, bias, m_part, l_part, n, v, d, row_offset, num_valid,
                                             splits, tiles_per_split, stream);
  if (err != cudaSuccess) return err;
  ce_fwd_combine_kernel<<<(n + kCombineRows - 1) / kCombineRows, 32 * kCombineRows, 0, stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<float*>(m), static_cast<float*>(l), n, splits);
  return cudaGetLastError();
}

}  // namespace

// bias may be null. m_part / l_part are (splits, n) f32 scratch; m, l (n,).
// splits * tiles_per_split must cover the vocab tiles. row_start is the
// global row id of w's first row (0 unless w is one row shard of a larger
// table); the window [row_offset, row_offset + num_valid) is in global
// rows, and the kernels take it in w's local rows (row_offset - row_start).
extern "C" int b4cp_ce_fwd(const void* x, const void* w, const void* bias,
                           void* m_part, void* l_part, void* m, void* l,
                           int is_bf16, int n, int v, int d, int row_offset,
                           int num_valid, int row_start, int splits, int tiles_per_split,
                           int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's device in it
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n == 0 || v == 0) return static_cast<int>(cudaGetLastError());
  if (splits < 1 || static_cast<long long>(splits) * tiles_per_split < (v + kDxVocab - 1) / kDxVocab)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto launch) {
    return launch(x, w, bias, m_part, l_part, m, l, n, v, d, row_offset - row_start, num_valid,
                  splits, tiles_per_split, s);
  };
  const cudaError_t err = is_bf16 ? args(launch_fwd<kDxBf16>) : args(launch_fwd<kDxNumerics>);
  return static_cast<int>(err);
}

// bias and db may be null. live is (n + 1) int32 scratch. dx32 (n, d) f32
// must be zero on entry and is added into; dw (v, d) f32 and db (v,) f32
// are written whole (zero when n == 0). d <= 256. row_start and the window
// as for b4cp_ce_fwd; lab holds each label's row in w's local rows (the
// global row - row_start; the caller shifts it), so a row whose label lies
// on another shard matches no row here and still adds its softmax share.
extern "C" int b4cp_ce_bwd(const void* x, const void* w, const void* bias,
                           const void* lab, const void* logz,
                           const void* dnll, void* live, void* dx32, void* dw, void* db,
                           int is_bf16, int n, int v, int d, int row_offset,
                           int num_valid, int row_start, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (v == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  if (d > kDxChunk * kMrgOutChunks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto launch) {
    return launch(x, w, bias, lab, logz, dnll, live, dw, db, dx32, n, v, d, row_offset - row_start,
                  num_valid, s);
  };
  const cudaError_t err = is_bf16 ? args(launch_dw_mma<kDxBf16, true, true>)
                                  : args(launch_dw_mma<kDxNumerics, true, true>);
  return static_cast<int>(err);
}
