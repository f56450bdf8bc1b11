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
// GFLOP per kernel, 3.2 ms in f32 FMA at 67 TFLOP/s, 1.0 ms as three tf32
// products on the tensor cores (495 TFLOP/s).
//
// Both kernels run their products on the tensor cores, with one design:
// f32 x as hi + lo tf32 terms in three m16n8k8 products (kDxNumerics), the
// numerics measured in PERF.md, "the dx numerics decision"; bf16 x in one
// bf16 product. The dx kernel (ce_bwd_dx_mma_kernel) keeps 64 rows of x in
// shared memory and streams the table; the dW kernel (ce_bwd_dw_mma_kernel)
// is its mirror, 64 table rows resident and x streamed. Each has its design
// notes below. Any N, V and D work, with the ragged edges masked; neither
// uses atomics, so two runs give the same bits.

#include <type_traits>

#include "attention_mma.cuh"
#include "fused_ce_tiles.cuh"

namespace {

using namespace ce_tiles;

constexpr int kOutChunks = 6;  // 64-column chunks of output a block owns
constexpr int kOutCols = kTile * kOutChunks;

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
// dnll (exp(s - logz) - onehot), dx += A W. Both products run on the
// tensor cores with f32 sums:
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
constexpr int kDxStages = 3;  // cp.async stages of the table: two chunks in flight
constexpr int kDxFlush = 4;   // k-steps whose products share fresh sums (kstep_sum), at most a chunk's
constexpr int kDxStageRow = (kDxChunk + 4) * 4;  // bytes of a row of a raw stage (64 f32, or 64 bf16 of x)
constexpr int kDxStage = kDxVocab * kDxStageRow;

// The names below are the dx pass's: x is the operand a block keeps
// resident, W the one it streams. The dW pass swaps the roles (the table
// resident, x streamed) and uses the same planes.
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
// one value of x into its planes
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
      for (int i = 0; i < 4; ++i) {
        if constexpr (M::kSplit) {
          tc::split_tf32(a[0][i], a[0][i], a[1][i]);
        } else {
          a[0][i] = tc::to_tf32(a[0][i]);
        }
      }
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
    for (int idx = threadIdx.x; idx < kDxRows * ncols; idx += kDxThreads) {
      const int r = idx / ncols;
      const int c = idx - r * ncols;
      const bool ok = row0 + r < n && c0 + c < d;
      const float val = ok ? to_f(x[static_cast<long long>(row0 + r) * d + c0 + c]) : 0.f;
      put_one<MODE>(smem_dx + L.res_at + r * L.res_row, L.res_plane, c, val);
    }
  };
  // the table chunk of step `step` (vocab tile, then its columns) into its stage
  auto issue = [&](int step) {
    const int tile = step / steps;
    const int r = step - tile * steps;
    const int col = r < nk ? r * kDxChunk : d_lo + (r - nk) * kDxChunk;
    const int vrow0 = (j0 + tile) * kDxVocab;
    float* dst = reinterpret_cast<float*>(smem_dx + (step % kDxStages) * kDxStage);
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
    const float* src = reinterpret_cast<const float*>(smem_dx + (q % kDxStages) * kDxStage);
    for (int idx = threadIdx.x; idx < kDxVocab * kDxChunk / 2; idx += kDxThreads) {
      const int rr = idx / (kDxChunk / 2);
      const int c = (idx % (kDxChunk / 2)) * 2;
      const float2 val = *reinterpret_cast<const float2*>(src + rr * (kDxChunk + 4) + c);
      put_pair<MODE>(smem_dx + L.chunk_at + rr * w_row, M::kWPlane, c, val.x, val.y);
    }
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

// ------------------------------------------------------- dW, tensor cores
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
// What bounds it: as the dx pass, the mma.sync issue rate (the same 318 M
// m16n8k8 instructions at N = 2,560, V = 55,296, D = 384). Its grid is
// ceil(V / 64) x ceil(D / 384) blocks, one per SM: 864 at that shape, 6.5
// waves of 132. The constants (kDwStages, kDwFlush, kDwResident) were timed
// with examples/long_context/tune_blockwise_bwd.py --kernel ce_dw (PERF.md).

constexpr int kDwStages = 3;        // cp.async stages of x: two chunks in flight
constexpr int kDwFlush = 8;         // k-steps whose products share fresh sums (kstep_sum): a chunk's
constexpr bool kDwResident = true;  // false: stream the table rows beside x's at every D

// two neighbouring elements of a stage as f32
__device__ __forceinline__ float2 pair_at(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 pair_at(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <int MODE, bool WRES>
__global__ void __launch_bounds__(kDxThreads, 1)
    ce_bwd_dw_mma_kernel(const typename DxMode<MODE>::X* __restrict__ x,
                         const float* __restrict__ w, const float* __restrict__ bias,
                         const int32_t* __restrict__ lab, const float* __restrict__ logz,
                         const float* __restrict__ dnll, float* __restrict__ dw,
                         float* __restrict__ db, int n, int v, int d, int row_offset,
                         int num_valid, int x_vec) {
  using M = DxMode<MODE>;
  using X = typename M::X;
  constexpr int kVec = 16 / static_cast<int>(sizeof(X));                // elements of one 16-byte copy
  constexpr int kStageRow = kDxStageRow / static_cast<int>(sizeof(X));  // elements of a stage row
  extern __shared__ __align__(16) unsigned char smem_dw[];
  const DxSmem<MODE> L(d, WRES, kDwStages);
  const int vrow0 = blockIdx.x * kDxVocab;
  const int d_lo = blockIdx.y * kOutCols;
  const int d_hi = min(d, d_lo + kOutCols);
  const int n_rtiles = (n + kDxRows - 1) / kDxRows;
  const int nk = (d + kDxChunk - 1) / kDxChunk;            // chunks of the score product
  const int no = (d_hi - d_lo + kDxChunk - 1) / kDxChunk;  // and of the block's output columns
  const int steps = nk + no;                               // chunks of x per row tile
  const int total = n_rtiles * steps;
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

  // columns [c0, c0 + ncols) of the block's table rows into their planes
  auto load_w = [&](int c0, int ncols) {
    for (int idx = threadIdx.x; idx < kDxVocab * ncols; idx += kDxThreads) {
      const int r = idx / ncols;
      const int c = idx - r * ncols;
      const bool ok = vrow0 + r < v && c0 + c < d;
      const float val = ok ? w[static_cast<long long>(vrow0 + r) * d + c0 + c] : 0.f;
      put_one<MODE>(smem_dw + L.res_at + r * L.res_row, L.res_plane, c, val);
    }
  };
  // the chunk of x of step `step` (row tile, then its columns) into its stage
  auto issue = [&](int step) {
    const int tile = step / steps;
    const int r = step - tile * steps;
    const int col = r < nk ? r * kDxChunk : d_lo + (r - nk) * kDxChunk;
    const int xrow0 = tile * kDxRows;
    X* dst = reinterpret_cast<X*>(smem_dw + (step % kDwStages) * kDxStage);
    if (x_vec) {
      for (int idx = threadIdx.x; idx < kDxRows * kDxChunk / kVec; idx += kDxThreads) {
        const int rr = idx / (kDxChunk / kVec);
        const int c = (idx % (kDxChunk / kVec)) * kVec;
        const bool ok = xrow0 + rr < n && col + c < d;
        const X* src = ok ? x + static_cast<long long>(xrow0 + rr) * d + col + c : x;
        tc::cp_async_16(dst + rr * kStageRow + c, src, ok);
      }
    } else {
      for (int idx = threadIdx.x; idx < kDxRows * kDxChunk; idx += kDxThreads) {
        const int rr = idx / kDxChunk;
        const int c = idx % kDxChunk;
        const bool ok = xrow0 + rr < n && col + c < d;
        dst[rr * kStageRow + c] = ok ? x[static_cast<long long>(xrow0 + rr) * d + col + c] : from_f<X>(0.f);
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

  float acc[kDxOutChunks][kDxNT][4];
#pragma unroll
  for (int o = 0; o < kDxOutChunks; ++o)
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
    const int row0 = it * kDxRows;
    float lz[kDxNT][2], gr[kDxNT][2];
    int lb[kDxNT][2];
#pragma unroll
    for (int nt = 0; nt < kDxNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + cg + nt * 8 + 2 * t + e;
        const bool ok = row < n;
        lz[nt][e] = ok ? logz[row] : 0.f;
        gr[nt][e] = ok ? dnll[row] : 0.f;
        lb[nt][e] = ok ? lab[row] : -1;
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
        }
        put_pair<MODE>(smem_dw + L.a_at + r * M::kChunkRow, M::kChunkPlane, cl, a[0], a[1]);
      }
    }
    nonzero = __syncthreads_or(nonzero);

#pragma unroll
    for (int o = 0; o < kDxOutChunks; ++o) {
      if (o < no) {  // the same for every thread of the block
        advance(-1, M::kOutRow);
        if (nonzero) dx_product<MODE, kDwFlush>(acc[o], a_at, x_addr, smem_dw + L.chunk_at, cg, lane);
      }
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int o = 0; o < kDxOutChunks; ++o) {
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

template <int MODE, bool WRES>
cudaError_t launch_dw_mma(const void* x, const void* w, const void* bias, const void* lab,
                          const void* logz, const void* dnll, void* dw, void* db, int n, int v,
                          int d, int row_offset, int num_valid, cudaStream_t stream) {
  using X = typename DxMode<MODE>::X;
  auto kernel = ce_bwd_dw_mma_kernel<MODE, WRES>;
  const size_t smem = DxSmem<MODE>(d, WRES, kDwStages).total;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int x_vec = d % (16 / sizeof(X)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((v + kDxVocab - 1) / kDxVocab, (d + kOutCols - 1) / kOutCols);
  kernel<<<grid, kDxThreads, smem, stream>>>(
      static_cast<const X*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const int32_t*>(lab), static_cast<const float*>(logz),
      static_cast<const float*>(dnll), static_cast<float*>(dw), static_cast<float*>(db), n, v, d,
      row_offset, num_valid, x_vec);
  return cudaGetLastError();
}

// the table rows resident where their planes fit one block with the rest
template <int MODE>
cudaError_t launch_dw_tc(const void* x, const void* w, const void* bias, const void* lab,
                         const void* logz, const void* dnll, void* dw, void* db, int n, int v,
                         int d, int row_offset, int num_valid, cudaStream_t stream) {
  const bool resident = kDwResident && DxSmem<MODE>(d, true, kDwStages).total <= kMaxSmem;
  return resident ? launch_dw_mma<MODE, true>(x, w, bias, lab, logz, dnll, dw, db, n, v, d,
                                              row_offset, num_valid, stream)
                  : launch_dw_mma<MODE, false>(x, w, bias, lab, logz, dnll, dw, db, n, v, d,
                                               row_offset, num_valid, stream);
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
