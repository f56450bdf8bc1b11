// The two-pass backward of the fused softmax cross-entropy: a dx pass and a
// dW pass that each recompute the scores once, for rows wider than the
// merged backward takes (fused_ce.cu: D <= 256).
//
// Replaces two Pallas kernels of bert4clickpath_tpu/ops/pallas/fused_ce.py,
// _bwd_dx_kernel and _bwd_dw_kernel (launched by _bwd, over
// _softmax_adjoint):
//
//   s[n, v] = x[n] . round_to_x(W[v]) (+ bias[v]);  -1e30 where row_start + v
//             is outside [row_offset, row_offset + num_valid)
//   A[n, v] = dnll[n] * (exp(s[n, v] - logz[n]) - [row_start + v == label_row[n]])
//   dx pass:  dx = round_to_x(A) . round_to_x(W)     (N, D), in x's type
//   dW pass:  dW = round_to_x(A)^T . x               (V, D), f32
//             db = sum_n A[n, v]                     (V,),   f32, unrounded A
//
// x is f32 or bf16; W and the bias are f32; a null bias pointer selects the
// variant without a bias (and without db). The JAX dx kernel adds each vocab
// tile's product into an output of x's type, so with bf16 x it rounds once
// per vocab tile; here dx sums in f32 over all of the vocabulary and rounds
// once (f32 x is unaffected).
//
// What bounds them on the H100: arithmetic. Each pass is two products of
// 2 N_live V D operations (the recompute and its own; N_live the rows with a
// nonzero dnll), against a table and activations of tens of MB: at N =
// 2,560 (2,061 labelled), V = 55,296, D = 384, three tf32 products each
// (tf32 x3), 1.04 ms per pass at the 495 TFLOP/s TF32 rate.
//
// Both passes are one kernel, ce_bwd_two_pass_kernel<PASS, MTS, X>, built
// as the CE forward and the merged backward are (hopper.cuh): TMA loads into
// a ring of kTpStages shared-memory stages behind mbarriers, and wgmma. A
// block is two consumer warpgroups and a producer warp whose lane 0 issues
// the loads (288 threads: ptxas gives each 168 registers, as for 384). The C
// entry first lists and packs the live rows (those whose dnll is nonzero)
// once for both passes (fused_ce_common.cuh; the host never reads their
// count) and writes the table's other plane once a call into scratch
// (ce_table_aux_kernel: f32 x its tf32 lo term, hopper::tf32_rest, the
// table as it is being the hi term, which the product truncates; bf16 x the
// table rounded to bf16), so that the stages arrive as the products read
// them and nothing in the ring is converted.
//
// A unit is a stationary tile of 64 rows (the dx pass: 64 packed rows of x;
// the dW pass: 64 table rows) and a slice of at most MTS m-tiles of 64
// output columns, whose sums stay in registers (at D = 384 the whole row in
// one slice; wider rows take slices of up to 512 columns, each recomputing
// the scores); it walks streamed tiles of 64 rows (the dx pass: the table
// tiles of one vocab split; the dW pass: every tile of packed rows). Per
// streamed tile the producer loads
//
//   * ceil(D / 128 bytes) score stages: a 128-byte box of the 64 rows of x
//     and of the 64 table rows (f32 x: beside its lo plane; bf16 x: rounded);
//   * one gradient stage per m-tile of the slice: the streamed operand's 64
//     columns (the dx pass: the table's, f32 or rounded to bf16; the dW
//     pass: x's),
//
// and each consumer warpgroup w
//
//   * computes its half of the scores, S = x . W^T over table rows 32w ..
//     32w + 31 (wgmma m64n32; f32 x: x's fragments read by ldmatrix and
//     split rounded in registers, each reused by the three products of its
//     k-step; bf16 x: both operands from the stage, two stages' products in
//     flight): fresh sums per box joined by round-to-nearest adds
//     (kstep_sum);
//   * forms A = dnll (exp(s (+ b) - logz) - onehot) on the accumulators and
//     writes it into an A plane in the 128-byte swizzle the descriptors
//     read (f32 x: raw f32 as the hi term and tf32_rest as the lo term; bf16
//     x: rounded once), in the layout the product reads it K-major: a tf32
//     wgmma reads B only K-major, so both gradient products are taken
//     transposed, with M = D:
//       dx pass: dx^T += W^T . A^T, A^T as [x row][table row]; warpgroup w
//         takes x rows 32w .. 32w + 31 (N = 32) and every table row (K =
//         64), so both warpgroups' halves of A are read: they meet at one
//         named barrier a tile (the A planes alternate between two buffers);
//       dW pass: dW^T += x^T . A, A as [table row][x row]; warpgroup w takes
//         its own table rows (N = 32) and every row of x (K = 64): its own
//         half of A, a barrier of the warpgroup alone;
//     per gradient stage the m-tile's W^T (x^T) is read transposed from the
//     stage into registers (box_frags_t; f32 split rounded), one group of
//     k-steps into fresh sums joined to the unit's running sums by
//     round-to-nearest adds.
//
// Where tf32 products read both operands from shared memory (the bf16
// scores' way), each of a k-step's three products reads its A again: at N =
// 32 that is more shared-memory traffic a clock than an SM serves, and a
// build that took every f32 product that way (with the table and x
// transposed once a call for the gradients' A) was slower (PERF.md).
//
// The dx pass writes each unit's sums with plain stores into f32 partials,
// one per vocab split; ce_dx_combine_kernel adds them in split order, rounds
// once to x's type and scatters the packed rows back (zero rows for the rows
// not walked). The dW pass writes each dW row once, and db (the f32 sum of
// the unrounded A: each thread's over its rows of x, then across lanes by
// shuffles and across the warpgroup's warps in order) once. Nothing is
// atomic: two runs of either pass give the same bits. Persistent blocks, one
// an SM, walk the units (block b takes b, b + gridDim.x, ...; the dx pass's
// unit count comes from the live count on the device), the ring running on
// across units. Every D takes this one mainloop: ragged N, V and D are the
// loads' zero fill and the stores' masks, and the wrapper pads D to a
// multiple of 16 bytes (a TMA row stride).

#include <climits>
#include <type_traits>

#include "fused_ce_common.cuh"

namespace {

constexpr int kTpRows = 64;       // rows of a tile: packed rows of x, or table rows, in both passes
constexpr int kTpThreads = 288;   // two consumer warpgroups and the producer warp (its lane 0 loads)
constexpr int kTpStages = 4;      // stages in the ring (4 to 6 timed within 3%, PERF.md)
constexpr int kTpSyncAll = 1;     // named barriers: both consumer warpgroups,
constexpr int kTpSyncWg = 2;      // and warpgroup w alone (2 + w)
constexpr int kTpBox = kTpRows * 128;  // a 128-byte swizzled box of 64 rows
constexpr int kTpSliceTiles = 6;  // m-tiles of 64 output columns a slice holds (the wide instance: 8)
constexpr int kTpWideTiles = 8;
enum TpPass : int { kPassDx = 0, kPassDw = 1 };

// the shape of a call, as both passes' units read it
struct TpShape {
  int v, d, rows;              // table rows, the (padded) width, rows of the packed scratch
  int row_offset, num_valid;   // the window, in the table's local rows
  int splits, per_split;       // the dx pass's vocab splits, 64-row tiles each
  int slice_mt, slices;        // m-tiles of a slice, slices of D
};

// A unit: the stationary tile, the streamed tiles [t0, t1) it walks, and
// its slice of output columns [d0, d0 + 64 n_mt). The dx pass's unit u is
// (tile of packed rows u % n_stat, vocab split, slice): stationary tiles
// fastest, so that the blocks running side by side stream the same table
// rows through L2. The dW pass's is (slice u % slices, table tile): the
// slices of one table tile side by side, which read the same table rows
// (each unit reads its tile again for every tile of x: at D = 1,024, 132
// tiles of 512 KB with their lo planes would not stay in the 50 MB L2).
struct TpUnit {
  int tile, split, t0, t1, d0, n_mt;
};

template <int PASS>
__device__ __forceinline__ TpUnit tp_unit(int u, const TpShape& s, int n_stat, int n_vtiles, int n_xtiles,
                                          int mtiles) {
  TpUnit r;
  int slice;
  if constexpr (PASS == kPassDx) {
    r.tile = u % n_stat;
    const int rest = u / n_stat;
    r.split = rest % s.splits;
    slice = rest / s.splits;
    r.t0 = r.split * s.per_split;
    r.t1 = min(n_vtiles, r.t0 + s.per_split);
  } else {
    slice = u % s.slices;
    r.tile = u / s.slices;
    r.split = 0;
    r.t0 = 0;
    r.t1 = n_xtiles;
  }
  r.d0 = slice * s.slice_mt * 64;
  r.n_mt = min(s.slice_mt, mtiles - slice * s.slice_mt);
  return r;
}

// The producer's walk over the block's stages, in the consumers' order: per
// unit with streamed tiles, per streamed tile, nk score stages and then one
// gradient stage per m-tile of the slice.
template <int PASS>
struct TpCursor {
  TpShape s;
  int units, n_stat, n_vtiles, n_xtiles, mtiles, nk;
  int u, t, step;
  TpUnit unit;
  __device__ void enter(int from) {
    for (u = from; u < units; u += static_cast<int>(gridDim.x)) {
      unit = tp_unit<PASS>(u, s, n_stat, n_vtiles, n_xtiles, mtiles);
      if (unit.t0 < unit.t1) {
        t = unit.t0;
        step = 0;
        return;
      }
    }
  }
  __device__ bool valid() const { return u < units; }
  __device__ void next() {
    if (++step == nk + unit.n_mt) {
      step = 0;
      if (++t == unit.t1) enter(u + static_cast<int>(gridDim.x));
    }
  }
  // the first packed row of x and the first table row of the stage
  __device__ int xrow0() const { return (PASS == kPassDx ? unit.tile : t) * kTpRows; }
  __device__ int vrow0() const { return (PASS == kPassDx ? t : unit.tile) * kTpRows; }
};

// byte offsets of the shared memory of the instance for x of type X (every
// plane and box on a 1,024-byte boundary: the swizzle is a function of the
// address)
template <typename X>
struct TpLayout {
  static constexpr bool kBf16 = sizeof(X) == 2;
  static constexpr int kCols = 128 / static_cast<int>(sizeof(X));  // columns of x (and of A) in a box
  // a score stage: x's box, then the table's box as the product reads it
  // (f32 x: as loaded, its hi term, beside its tf32 lo plane; bf16 x: the
  // table rounded)
  static constexpr int kSX = 0;
  static constexpr int kSW = kTpBox;
  static constexpr int kSLo = 2 * kTpBox;  // f32 x
  static constexpr int kScoreBytes = (kBf16 ? 2 : 3) * kTpBox;
  // a gradient stage: an m-tile (64 columns) of the streamed operand, two
  // f32 boxes or one of 64 bf16 columns (the dx pass: the table's, f32 or
  // rounded; the dW pass: x's)
  static constexpr int kGradBytes = (kBf16 ? 1 : 2) * kTpBox;
  static constexpr int kSlot = kScoreBytes > kGradBytes ? kScoreBytes : kGradBytes;
  static constexpr int kRing = kTpStages * kSlot;
  // the A planes: 64 x 64 of X in boxes of kCols columns, f32 x a hi (raw)
  // and a lo (tf32_rest) term; two buffers, taken by the streamed tiles in turn
  static constexpr int kTerms = kBf16 ? 1 : 2;
  static constexpr int kPTerm = kTpRows * kTpRows * static_cast<int>(sizeof(X));
  static constexpr int kPBuf = kTerms * kPTerm;
  static constexpr int kP = kRing;
  static constexpr int kDb = kP + 2 * kPBuf;  // (4 warps, 64) f32: db across a warpgroup's warps
  static constexpr int kBars = kDb + 4 * kTpRows * 4;  // full and empty, a stage each
  static constexpr size_t kSmem = kBars + 2 * kTpStages * 8 + 1024;  // + alignment slack
  static_assert(kSmem <= kMaxSmem, "the layout fits one block's shared memory");
  static_assert(kSlot % 1024 == 0 && kPTerm % 1024 == 0, "planes on 1,024-byte boundaries");
};

// f(std::integral_constant<int, K>{}) for K = B .. E - 1 in order: an index
// the compiler sees as a constant, so that arrays indexed by it stay in
// registers
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

// acc (64 x 32) = A . B^T over one box's 4 k-steps of bf16, both operands
// K-major in shared memory (A's 64 rows at a, B's 32 rows at b)
__device__ __forceinline__ void ss_box(float (&acc)[16], uint32_t a, uint32_t b, bool first) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
    hopper::wgmma_bf16_m64n32k16_ss(acc, hopper::make_desc(a + kb * 32, hopper::kSwizzle128, 8 * 128),
                                    hopper::make_desc(b + kb * 32, hopper::kSwizzle128, 8 * 128), kb > 0 || !first);
}

template <int PASS, int MTS, typename X>
__global__ void __launch_bounds__(kTpThreads, 1)
    ce_bwd_two_pass_kernel(const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap aux_map,
                           const __grid_constant__ CUtensorMap x_map, const float* __restrict__ bias,
                           const float4* __restrict__ info, const int32_t* __restrict__ live,
                           float* __restrict__ out, float* __restrict__ db, const TpShape s) {
  using L = TpLayout<X>;
  constexpr bool kBf16 = L::kBf16;
  constexpr bool kDx = PASS == kPassDx;
  constexpr int kGB = kBf16 ? 1 : 2;  // boxes of K a gradient stage holds
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);  // TMA landed
  uint64_t* empty = full + kTpStages;                             // read by every consumer
  const int n_live = __ldg(live);
  const int n_xtiles = (n_live + kTpRows - 1) / kTpRows;
  const int n_vtiles = (s.v + kTpRows - 1) / kTpRows;
  const int mtiles = (s.d + 63) / 64;
  const int nk = (s.d + L::kCols - 1) / L::kCols;  // score stages of a streamed tile
  const int n_stat = kDx ? n_xtiles : n_vtiles;
  const int units = n_stat * (kDx ? s.splits : 1) * s.slices;
  const int wg = threadIdx.x / 128;
  const int wt = threadIdx.x & 127;
  const int warp = wt / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t base = hopper::smem_addr(smem);
  const int xr0 = warp * 16 + g;  // the thread's first row of x in the scores (and xr0 + 8)

  if (threadIdx.x == 0) {
    for (int st = 0; st < kTpStages; ++st) {
      hopper::mbar_init(full + st, 1);
      hopper::mbar_init(empty + st, 8);  // each consumer warp's lane 0 for the warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ------------------------------------------- producer warp, lane 0
    if (threadIdx.x != 256) return;
    hopper::prefetch_map(&w_map);
    hopper::prefetch_map(&aux_map);
    hopper::prefetch_map(&x_map);
    TpCursor<PASS> c{s, units, n_stat, n_vtiles, n_xtiles, mtiles, nk};
    c.enter(blockIdx.x);
    for (int j = 0; c.valid(); ++j, c.next()) {  // stage j into its slot, once the consumers gave it back
      const int st = j % kTpStages;
      hopper::mbar_wait(empty + st, ((j / kTpStages) & 1) ^ 1);
      unsigned char* slot = smem + st * L::kSlot;
      if (c.step < nk) {  // x's box and the table's
        const int col = c.step * L::kCols;
        hopper::mbar_arrive_expect_tx(full + st, L::kScoreBytes);
        hopper::tma_load_2d(slot + L::kSX, &x_map, full + st, col, c.xrow0());
        if constexpr (kBf16) {
          hopper::tma_load_2d(slot + L::kSW, &aux_map, full + st, col, c.vrow0());
        } else {
          hopper::tma_load_2d(slot + L::kSW, &w_map, full + st, col, c.vrow0());
          hopper::tma_load_2d(slot + L::kSLo, &aux_map, full + st, col, c.vrow0());
        }
      } else {
        const int col = c.unit.d0 + (c.step - nk) * 64;
        if constexpr (kBf16) {  // one box of 64 bf16 columns: the table's rounded, or x's
          hopper::mbar_arrive_expect_tx(full + st, kTpBox);
          if constexpr (kDx) {
            hopper::tma_load_2d(slot, &aux_map, full + st, col, c.vrow0());
          } else {
            hopper::tma_load_2d(slot, &x_map, full + st, col, c.xrow0());
          }
        } else {  // two f32 boxes, the second where it holds a column
          const int nb = col + 32 < s.d ? 2 : 1;
          hopper::mbar_arrive_expect_tx(full + st, nb * kTpBox);
          for (int b = 0; b < nb; ++b) {
            if constexpr (kDx) {
              hopper::tma_load_2d(slot + b * kTpBox, &w_map, full + st, col + 32 * b, c.vrow0());
            } else {
              hopper::tma_load_2d(slot + b * kTpBox, &x_map, full + st, col + 32 * b, c.xrow0());
            }
          }
        }
      }
    }
    return;
  }

  // --------------------------------------------------- consumer warpgroups
  // stage i's slot, once its loads landed
  auto acquire = [&](int i) {
    hopper::mbar_wait(full + i % kTpStages, (i / kTpStages) & 1);
    return i % kTpStages;
  };
  // stage i given back: every read of the warp done (its products waited for)
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + i % kTpStages);
  };

  int i = 0;   // the block's stages so far
  int nt = 0;  // the block's streamed tiles so far: which buffer of A planes
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const TpUnit unit = tp_unit<PASS>(u, s, n_stat, n_vtiles, n_xtiles, mtiles);
    float db_run[4][2];  // the dW pass: the thread's share of db of its table rows
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) db_run[jj][e] = 0.f;
    float acc[MTS][16];  // the slice's sums: dx^T (dW^T), its m-tiles x the warpgroup's 32 rows
#pragma unroll
    for (int mt = 0; mt < MTS; ++mt)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[mt][e] = 0.f;

    for (int tile = unit.t0; tile < unit.t1; ++tile, ++nt) {
      const int xrow0 = (kDx ? unit.tile : tile) * kTpRows;
      const int vrow0 = (kDx ? tile : unit.tile) * kTpRows;
      // S = x . W^T over the warpgroup's 32 table rows, a box of columns a
      // stage into fresh sums, joined to s by round-to-nearest adds. bf16 x:
      // both operands from the stage, two stages' products in flight; f32
      // x: x's fragments read from the stage by ldmatrix and split rounded
      // (each reused by the three products of its k-step), one stage's
      // products in flight (the registers)
      float sc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) sc[e] = 0.f;
      if constexpr (kBf16) {
        float ks0[16], ks1[16];
        auto issue = [&](int c, float (&ks)[16]) {
          const uint32_t slot = base + acquire(i + c) * L::kSlot;
          hopper::fence_regs(ks);
          hopper::wgmma_fence();
          ss_box(ks, slot + L::kSX, slot + L::kSW + wg * 32 * 128, true);
          hopper::wgmma_commit();
        };
        auto retire = [&](int c, float (&ks)[16]) {  // once stage c's products completed
          hopper::fence_regs(ks);
          release(i + c);
          kstep_sum(sc, ks);
        };
        issue(0, ks0);
        for (int c = 0; c < nk; c += 2) {
          if (c + 1 < nk) {
            issue(c + 1, ks1);
            hopper::wgmma_wait<1>();
          } else {
            hopper::wgmma_wait<0>();
          }
          retire(c, ks0);
          if (c + 1 < nk) {
            if (c + 2 < nk) {
              issue(c + 2, ks0);
              hopper::wgmma_wait<1>();
            } else {
              hopper::wgmma_wait<0>();
            }
            retire(c + 1, ks1);
          }
        }
      } else {
        for (int c = 0; c < nk; ++c) {
          const uint32_t slot = base + acquire(i + c) * L::kSlot;
          uint32_t hi[4][4], lo[4][4];
          box_frags_ldsm<false>(hi, lo, slot + L::kSX, warp, lane);
          float ks[16];
          hopper::fence_regs(ks);
          hopper::wgmma_fence();
          box_product<32, false>(ks, hi, lo, slot + L::kSW + wg * 32 * 128, L::kSLo - L::kSW, true);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(ks);
          release(i + c);
          kstep_sum(sc, ks);
        }
      }
      i += nk;

      // A = dnll (exp(s (+ b) - logz) - onehot) on the accumulators: rows
      // xr0 + 8h of x ((logz, dnll, label, -) from the packed info), table
      // rows 32 wg + 8 jj + 2t + e (past v: 0; blinded outside the window)
      float4 ri[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = xrow0 + xr0 + 8 * h;
        ri[h] = k < n_live ? __ldg(info + k) : make_float4(0.f, 0.f, __int_as_float(-1), 0.f);
      }
      float a[4][2][2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = vrow0 + wg * 32 + 8 * jj + 2 * t + e;
          const bool ok = row < s.v;
          const bool inside = in_window(row, s.row_offset, s.num_valid);
          const float bc = bias != nullptr && ok ? __ldg(bias + row) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float val = 0.f;
            if (ok && xrow0 + xr0 + 8 * h < n_live) {
              float sv = sc[4 * jj + 2 * h + e];
              if (bias != nullptr) sv = __fadd_rn(sv, bc);  // before blinding
              if (!inside) sv = kNegBig;
              val = ri[h].y * (expf(sv - ri[h].x) - (row == __float_as_int(ri[h].z) ? 1.f : 0.f));
            }
            a[jj][h][e] = val;
            db_run[jj][e] += val;
          }
        }
      // A into this tile's buffer of planes, K-major for the gradient
      // product: dx [x row][table row], dW [table row][x row]; f32 x raw f32
      // (the hi term) and its tf32_rest lo term, bf16 x rounded once. The
      // buffer was last read two tiles ago, before the barrier of the tile
      // between
      unsigned char* plane = smem + L::kP + (nt & 1) * L::kPBuf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tl = wg * 32 + 8 * jj + 2 * t;
          const int xr = xr0 + 8 * h;
          if constexpr (kDx) {
            const int p = boxed<kTpRows, X>(xr, tl);
            if constexpr (kBf16) {
              *reinterpret_cast<uint32_t*>(plane + p) = tc::pack_bf16(a[jj][h][0], a[jj][h][1]);
            } else {
              const uint32_t h0 = __float_as_uint(a[jj][h][0]), h1 = __float_as_uint(a[jj][h][1]);
              *reinterpret_cast<uint2*>(plane + p) = make_uint2(h0, h1);
              *reinterpret_cast<uint2*>(plane + p + L::kPTerm) =
                  make_uint2(hopper::tf32_rest(h0), hopper::tf32_rest(h1));
            }
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int p = boxed<kTpRows, X>(tl + e, xr);
              if constexpr (kBf16) {
                *reinterpret_cast<__nv_bfloat16*>(plane + p) = __float2bfloat16_rn(a[jj][h][e]);
              } else {
                const uint32_t hb = __float_as_uint(a[jj][h][e]);
                *reinterpret_cast<uint32_t*>(plane + p) = hb;
                *reinterpret_cast<uint32_t*>(plane + p + L::kPTerm) = hopper::tf32_rest(hb);
              }
            }
          }
        }
      hopper::fence_proxy_async();
      if constexpr (kDx) {
        hopper::named_sync(kTpSyncAll, 256);  // both halves of A^T written
      } else {
        hopper::named_sync(kTpSyncWg + wg, 128);  // the warpgroup's half of A written
      }

      // per m-tile of the slice: dx^T += W^T . A^T (dW^T += x^T . A), the
      // m-tile's W^T (x^T) read transposed from the stage into registers
      // (box_frags_t: f32 split rounded), B = the planes' rows 32 wg .. 32 wg
      // + 31, K = 64; one group of k-steps into fresh sums, joined to the
      // running sums
      {
        const uint32_t p_at = base + L::kP + (nt & 1) * L::kPBuf + wg * 32 * 128;
        uint32_t hi[4][4], lo[4][4];
        float gk[16];
        static_for<0, MTS * kGB>([&](auto q_c) {
          constexpr int q = decltype(q_c)::value, mt = q / kGB, b = q % kGB;
          if (mt < unit.n_mt) {
            const int st = b == 0 ? acquire(i + mt) : (i + mt) % kTpStages;
            box_frags_t<kTpRows, X>(hi, lo, smem + st * L::kSlot, xr0, 32 * b, t);
            if (b == 0) hopper::fence_regs(gk);
            hopper::wgmma_fence();
            box_product<32, kBf16>(gk, hi, lo, p_at + b * kTpBox, L::kPTerm, b == 0);
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            if (b == kGB - 1) {
              hopper::fence_regs(gk);
              release(i + mt);
              kstep_sum(acc[mt], gk);
            }
          }
        });
        i += unit.n_mt;
      }
    }

    // the slice's sums: D column d0 + 64 mt + xr0 + 8h, row 32 wg + 8 jj +
    // 2t + e of the stationary tile (dx: a packed row of x, into the
    // split's partial; dW: a table row); written once
    static_for<0, MTS>([&](auto mt_c) {
      constexpr int mt = decltype(mt_c)::value;
      if (mt < unit.n_mt) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = unit.d0 + mt * 64 + xr0 + 8 * h;
              const int row = unit.tile * kTpRows + wg * 32 + 8 * jj + 2 * t + e;
              if (col < s.d && row < (kDx ? s.rows : s.v))
                out[((kDx ? static_cast<long long>(unit.split) * s.rows : 0LL) + row) * s.d + col] =
                    acc[mt][4 * jj + 2 * h + e];
            }
      }
    });
    // db (the dW pass's first slice): each thread's sums over its rows of x,
    // then over g by shuffles, then over the warpgroup's warps in order: a
    // fixed order
    if (!kDx && db != nullptr && unit.d0 == 0) {
      float* part = reinterpret_cast<float*>(smem + L::kDb);
      const int vrow0 = unit.tile * kTpRows;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float sum = db_run[jj][e];
          sum += __shfl_xor_sync(0xffffffffu, sum, 4);
          sum += __shfl_xor_sync(0xffffffffu, sum, 8);
          sum += __shfl_xor_sync(0xffffffffu, sum, 16);
          if (g == 0) part[warp * kTpRows + wg * 32 + 8 * jj + 2 * t + e] = sum;
        }
      hopper::named_sync(kTpSyncWg + wg, 128);
      if (wt < 32 && vrow0 + wg * 32 + wt < s.v) {
        const int c = wg * 32 + wt;
        db[vrow0 + c] = ((part[c] + part[kTpRows + c]) + part[2 * kTpRows + c]) + part[3 * kTpRows + c];
      }
      hopper::named_sync(kTpSyncWg + wg, 128);  // part is written again by the next unit
    }
  }
}

// the table's other plane as the score products read it, written once a
// call: f32 x its tf32 lo term (tf32_rest: the table as it is is the hi
// term), bf16 x the table rounded to bf16; `count` a multiple of 4
template <typename X>
__global__ void ce_table_aux_kernel(const float* __restrict__ w, X* __restrict__ aux, long long count) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; idx < count / 4;
       idx += stride) {
    const uint4 h = reinterpret_cast<const uint4*>(w)[idx];
    if constexpr (sizeof(X) == 2) {
      reinterpret_cast<uint2*>(aux)[idx] =
          make_uint2(tc::pack_bf16(__uint_as_float(h.x), __uint_as_float(h.y)),
                     tc::pack_bf16(__uint_as_float(h.z), __uint_as_float(h.w)));
    } else {
      reinterpret_cast<uint4*>(aux)[idx] = make_uint4(hopper::tf32_rest(h.x), hopper::tf32_rest(h.y),
                                                      hopper::tf32_rest(h.z), hopper::tf32_rest(h.w));
    }
  }
}

// dx (n, d) of type X: row i is the sum over the splits, in split order, of
// packed row pos[i] of the partials (splits, rows, d) f32, rounded once; or
// zero for a row not walked
template <typename X>
__global__ void ce_dx_combine_kernel(const float* __restrict__ part, const int32_t* __restrict__ pos,
                                     X* __restrict__ dx, int n, int d, int rows, int splits) {
  const int d4 = d / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < static_cast<long long>(n) * d4; idx += stride) {
    const int i = static_cast<int>(idx / d4);
    const int c = static_cast<int>(idx - static_cast<long long>(i) * d4);
    const int p = pos[i];
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p >= 0) {
      for (int sp = 0; sp < splits; ++sp) {
        const float4 v = reinterpret_cast<const float4*>(part + (static_cast<long long>(sp) * rows + p) * d)[c];
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
    }
    if constexpr (sizeof(X) == 2) {
      reinterpret_cast<uint2*>(dx)[idx] = make_uint2(tc::pack_bf16(sum.x, sum.y), tc::pack_bf16(sum.z, sum.w));
    } else {
      reinterpret_cast<float4*>(dx)[idx] = sum;
    }
  }
}

// one pass over the packed rows on one persistent block an SM
template <int PASS, int MTS, typename X>
cudaError_t launch_pass(const CUtensorMap& w_map, const CUtensorMap& aux_map, const CUtensorMap& x_map,
                        const float* bias, const float4* info, const int32_t* live, float* out, float* db,
                        const TpShape& s, cudaStream_t stream) {
  using L = TpLayout<X>;
  auto kernel = ce_bwd_two_pass_kernel<PASS, MTS, X>;
  cudaError_t err = allow_smem(kernel, L::kSmem);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  // the most units there can be (the dx pass's count of packed-row tiles is
  // the live count's, read on the device; this is its bound)
  const long long stat = PASS == kPassDx ? (s.rows + kTpRows - 1) / kTpRows : (s.v + kTpRows - 1) / kTpRows;
  const long long units = stat * (PASS == kPassDx ? s.splits : 1) * s.slices;
  if (units > INT_MAX) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(max(1LL, min(units, static_cast<long long>(sms))));
  kernel<<<grid, kTpThreads, L::kSmem, stream>>>(w_map, aux_map, x_map, bias, info, live, out, db, s);
  return cudaGetLastError();
}

// the tensor maps of the table, its other plane and the packed rows, the
// passes `which` asks for (1 dx, 2 dW, 3 both) and dx's combine. The rows
// packed by pack_live_rows; aux (v, d) of X written by ce_table_aux_kernel.
template <typename X>
cudaError_t two_pass(const PackedRows<X>& p, const int32_t* live, const void* w, const X* aux, const void* bias,
                     float* part, X* dx, float* dw, float* db, int n, int v, int d, int row_offset, int num_valid,
                     int splits, int per_split, int which, cudaStream_t stream) {
  using L = TpLayout<X>;
  const int rows = max(n, 1);
  const CUtensorMapDataType type = L::kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap w_map, aux_map, x_map;
  cudaError_t err = hopper::encode_2d(&w_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w, v, d, static_cast<uint64_t>(d) * 4,
                                      kTpRows, 32, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = hopper::encode_2d(&aux_map, type, aux, v, d, static_cast<uint64_t>(d) * sizeof(X), kTpRows, L::kCols,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = hopper::encode_2d(&x_map, type, p.xp, rows, d, static_cast<uint64_t>(d) * sizeof(X), kTpRows, L::kCols,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  // slices of D whose sums the registers hold: the fewest, at 6 m-tiles of
  // 64 columns where that takes no more slices than 8
  const int mtiles = (d + 63) / 64;
  const int slices = (mtiles + kTpWideTiles - 1) / kTpWideTiles;
  const bool wide = slices < (mtiles + kTpSliceTiles - 1) / kTpSliceTiles;
  const TpShape s{v, d, rows, row_offset, num_valid, splits, per_split, (mtiles + slices - 1) / slices, slices};
  const auto pass = [&](auto narrow, auto wider, float* out, float* sums) {
    const auto launch = wide ? wider : narrow;
    return launch(w_map, aux_map, x_map, static_cast<const float*>(bias), p.info, live, out, sums, s, stream);
  };
  if (which & 1) {
    err = pass(launch_pass<kPassDx, kTpSliceTiles, X>, launch_pass<kPassDx, kTpWideTiles, X>, part, nullptr);
    int grid = 1;
    if (err == cudaSuccess) err = elementwise_grid(static_cast<long long>(n) * (d / 4), &grid);
    if (err != cudaSuccess) return err;
    if (n > 0) {
      ce_dx_combine_kernel<X><<<grid, 256, 0, stream>>>(part, live + 1 + n, dx, n, d, rows, splits);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  if (which & 2) err = pass(launch_pass<kPassDw, kTpSliceTiles, X>, launch_pass<kPassDw, kTpWideTiles, X>, dw, db);
  return err;
}

template <typename X>
cudaError_t bwd_two_pass(const X* x, const void* w, const void* bias, const int32_t* lab, const float* logz,
                         const float* dnll, int32_t* live, float* work, X* aux, float* part, X* dx, float* dw,
                         float* db, int n, int v, int d, int row_offset, int num_valid, int splits, int per_split,
                         int which, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if ((d * sizeof(X)) % 16 != 0 || !aligned(x) || !aligned(w) || !aligned(work) || !aligned(aux) ||
      ((which & 1) && (!aligned(part) || !aligned(dx))) || splits < 1 ||
      static_cast<long long>(splits) * per_split < (v + kTpRows - 1) / kTpRows)
    return cudaErrorInvalidValue;
  PackedRows<X> p;
  cudaError_t err = pack_live_rows(x, lab, logz, dnll, live, work, n, d, false, &p, stream);
  const long long count = static_cast<long long>(v) * d;
  int grid = 1;
  if (err == cudaSuccess) err = elementwise_grid(count / 4, &grid);
  if (err != cudaSuccess) return err;
  ce_table_aux_kernel<X><<<grid, 256, 0, stream>>>(static_cast<const float*>(w), aux, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return two_pass(p, live, w, aux, bias, part, dx, dw, db, n, v, d, row_offset, num_valid, splits, per_split, which,
                  stream);
}

}  // namespace

// The two-pass backward: `which` 1 the dx pass, 2 the dW pass, 3 both, from
// one listing and packing of the live rows. bias and db may be null. live
// is (2n + 1) int32 scratch; work is (rows d + 4 rows) f32 scratch, rows =
// max(n, 1); aux is (v, d) scratch of x's type (the table's other plane);
// part is (splits, rows, d) f32 scratch (the dx pass's partials; splits *
// tiles_per_split must cover the 64-row vocab tiles); dx (n, d) in x's type,
// dw (v, d) f32 and db (v,) f32 are written whole. d a multiple of 16 bytes
// of x's type, x, w, work, aux, part and dx 16-byte aligned (the wrapper
// pads). row_start is the global row id of w's first row; the window
// [row_offset, row_offset + num_valid) is in global rows (the kernels take
// it in w's local rows); lab holds each label's row in w's local rows (the
// global row - row_start; the caller shifts it), so a row whose label lies
// on another shard matches no row here and still adds its softmax share.
extern "C" int b4cp_ce_bwd_two_pass(const void* x, const void* w, const void* bias, const void* lab,
                                    const void* logz, const void* dnll, void* live, void* work, void* aux, void* part,
                                    void* dx, void* dw, void* db, int is_bf16, int n, int v, int d, int row_offset,
                                    int num_valid, int row_start, int splits, int tiles_per_split, int which,
                                    int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's device in it
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 0) return static_cast<int>(cudaGetLastError());
  if (v == 0) {  // no table row: dx is zero, dW and db empty
    const cudaError_t err = (which & 1) && n > 0
                                ? cudaMemsetAsync(dx, 0, static_cast<size_t>(n) * d * (is_bf16 ? 2 : 4), s)
                                : cudaSuccess;
    return static_cast<int>(err);
  }
  const auto args = [&](auto typed_x) {
    using X = std::remove_const_t<std::remove_pointer_t<decltype(typed_x)>>;
    return bwd_two_pass(typed_x, w, bias, static_cast<const int32_t*>(lab), static_cast<const float*>(logz),
                        static_cast<const float*>(dnll), static_cast<int32_t*>(live), static_cast<float*>(work),
                        static_cast<X*>(aux), static_cast<float*>(part), static_cast<X*>(dx),
                        static_cast<float*>(dw), static_cast<float*>(db), n, v, d, row_offset - row_start, num_valid,
                        splits, tiles_per_split, which, s);
  };
  const cudaError_t err =
      is_bf16 ? args(static_cast<const __nv_bfloat16*>(x)) : args(static_cast<const float*>(x));
  return static_cast<int>(err);
}
