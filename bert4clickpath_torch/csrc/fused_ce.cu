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
// The forward (ce_fwd_wgmma_kernel) is built on Hopper's own tools
// (hopper.cuh): TMA loads into a ring of shared-memory stages, mbarriers,
// and wgmma. A block of three warpgroups owns 128 rows of x and walks a
// split of 128-row vocab tiles, kCeFwdChunk = 32 columns a stage:
//
//   producer warpgroup, warp 0: one thread keeps kCeFwdStages stages of TMA
//     loads in flight: the table's (128, 32) f32 chunk and x's (128, 32)
//     chunk (f32, or bf16), both swizzled by the load (128 bytes a row, 64
//     for bf16 x), one "full" mbarrier a stage that the loads complete;
//   producer warpgroup, warps 1-3: convert each landed table chunk once
//     into the numerics' planes and arrive on the stage's "ready" barrier
//     after fence.proxy.async (wgmma reads through the async proxy):
//     f32 x (tf32 x3, three products as every CE backward kernel): the
//     chunk as loaded is its hi term (a tf32 product reads an f32's top 19
//     bits: truncation), and its lo term, w - trunc(w), exact in f32, goes
//     to a plane beside it in the same swizzled layout; bf16 x: the chunk
//     rounded to bf16 (the JAX kernel's w.astype(x.dtype)) into a plane of
//     64-byte swizzled rows;
//   two consumer warpgroups, 64 rows of x each: wait for the stage, read
//     their A fragments of x from it (f32: split in registers into tf32
//     hi and lo terms rounded to nearest, as kDxNumerics splits them: the
//     dropped lo . lo term stays ~2^-22 of a product; truncating x too was
//     faster still but doubled the error at the widest logits, PERF.md),
//     run the chunk's products on wgmma m64n128 with A in registers and B
//     (the table's planes) through a descriptor, and arrive on the stage's
//     "empty" barrier once the
//     products have read it. f32 x: per k-step of 8 the three products
//     lo . hi, hi . lo, hi . hi (one tf32 product errs by ~|s| 2^-11, 5e-3
//     at logits of ~10, and logz is held to 1e-4); bf16 x: one exact bf16
//     product per k-step of 16. A chunk's products go into fresh registers
//     (the first with scale-d 0) and join the running logits with adds that
//     round to nearest (kstep_sum's rule: the tensor cores' own
//     accumulation does not round to nearest, and chained over a row of
//     D / 8 k-steps that bias reached 1.75e-4 in the dx pass).
//
// Per vocab tile a consumer thread holds rows g and g + 8 of its warp's 16
// and columns 8j + 2t, 8j + 2t + 1 of the tile's 16 n8 blocks: it adds the
// bias, blinds the tile (interior tiles skip that), takes the tile's max
// per row across its quad and updates the row's running (m, l) in
// registers. One warpgroup holds whole rows, so each block writes (m, l)
// of its split for its 128 rows directly; ce_fwd_combine_kernel combines
// the splits, a warp a row, in a fixed order. Nothing is atomic: two runs
// give the same bits. Every D takes this one mainloop (x's chunk comes with
// the table's, whatever the width), ragged N, V and D are the loads' zero
// fill, and the wrapper pads D to a multiple of 16 bytes (a TMA row
// stride) through a copy where it is not one.
//
// The blocks are persistent, one an SM (the ring takes most of the shared
// memory), and walk units of (row tile, vocab split): block b takes units
// b, b + gridDim.x, ..., row tiles fastest, its ring running on across
// units, so the card idles at most one unit a block at the end. The blocks
// of one split read the same table rows side by side and share them
// through L2: the table streams from HBM about once a call (5.12 GB at the
// large catalog's 10,000,384 x 128), while each stage's 32 KB come from L2.
// The vocabulary is split until the units reach a target count
// (ops/kernels/fused_ce.py, ce_splits), so that a short N fills the card.
//
// Its bound is the tensor cores' TF32 rate, three products of 2 N V D each
// for f32 x (19.66 TFLOP at the large catalog, 39.7 ms at 495 TFLOP/s).
// What holds it at 0.50-0.61 of that is the stream of stages and their
// conversion, not the products: without them it still takes ~0.69 of its
// time (PERF.md).
//
// The merged backward (ce_bwd_merged_wgmma_kernel) is built from the same
// pieces. A unit is Tv table rows (64 at D <= 128, 32 up to D = 256; 64 for
// bf16 x), resident in shared memory for the unit as TMA loaded them (raw
// f32: f32 x's hi term) beside a plane that the producer's converter warps
// write once (f32 x: its tf32_rest lo term; bf16 x: the tile rounded to
// bf16); the live rows of x stream past in stages of 64 rows, loaded by one
// TMA thread. The live rows are packed first, on the device and in the same
// C entry: ce_live_rows_kernel lists the rows whose dnll is nonzero (the
// others add nothing, and their dx rows are 0; a fifth fewer at the
// flagship's inputs) and ce_pack_rows_kernel copies them with their logz,
// dnll and label into contiguous scratch, which a tensor map tiles (TMA
// cannot gather rows). The count stays on the device: no host read. Per
// stage each of the two consumer warpgroups
//
//   * recomputes its half of the scores, S = x . W^T (M = the 64 rows of x,
//     N = Tv / 2 table rows, K = D): x in registers (f32: split rounded to
//     nearest into tf32 hi and lo terms, as the forward splits it), the
//     table's planes through descriptors; f32 x three products a k-step
//     (lo . hi, hi . lo, hi . hi), bf16 x one; fresh sums per 128-byte box
//     of columns, joined by round-to-nearest adds (kstep_sum's rule);
//   * forms A = dnll (exp(s (+ b) - logz) - onehot) on the accumulators
//     (blinded rows -1e30, rows past V and past the live count exactly 0),
//     adds it to its running db, and writes it twice into shared memory in
//     the 128-byte swizzle that the descriptors read (f32 x: raw f32 as the
//     hi term and tf32_rest as the lo term; bf16 x: rounded once): P1
//     [table row][x row] and P2 [x row][table row]. A tf32 wgmma reads B
//     only K-major, so both gradient products are taken transposed, with M
//     = D and the warpgroup owning half of D:
//   * dW^T += x^T . A (K = the 64 rows of x): x^T read into registers from
//     the stage with ld.shared (any order; f32 split there), B = P1; fresh
//     sums per stage joined to the running dW^T (in registers for the unit)
//     by round-to-nearest adds;
//   * dx^T = W^T . A^T (K = Tv): W^T read into registers from the resident
//     tile, B = P2; one group of k-steps.
//
// dx^T goes to a staging in the layout TMA loads (f32 x: back into the stage
// it came from, once x's rows are read; bf16 x: the table tile's raw f32,
// converted by then), and one thread of the warpgroup adds it into a packed
// f32 dx scratch with a TMA reduce-add (cp.reduce.async.bulk.tensor .add.f32:
// atomic adds in L2, 128-byte boxes) before the staging is used again; a
// last kernel scatters the packed dx into the (N, D) result (zero rows for
// the rows not walked). dx sums across units in an order that varies from
// run to run (two runs within 1e-5 of the largest |dx| of each other,
// CE_DX_REPEAT; kept on purpose); dW and db are summed in a fixed order and
// written once: two runs give the same bits. kCeBwdDxReduce = false (tune
// only) keeps dx's product and drops the reduce-adds, which prices them.
// Persistent blocks, one an SM, walk the units (block b takes b, b +
// gridDim.x, ...), the ring of stages running on across units.
//
// Its bound is the TF32 rate, three products of 2 N_live V D each, three
// terms apiece (96.45 ms at the large catalog, 1.046 at the flagship; bf16
// x one bf16 product each). What it reaches, and what holds it back:
// PERF.md.
// The TPU tile tiers (vocab tiles up to 1024, _bwd_chunk_rows, the 4 MiB
// use_fused_backward budget) were VMEM limits and are gone: any N and V
// work, with the ragged edges masked. Wider rows than D = 256 take the
// two-pass backward of fused_ce_two_pass.cu, which, like the forward,
// takes any D; its kernels still run on mma.sync.

#include <climits>

#include "fused_ce_mma.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------- forward

constexpr int kCeFwdRows = 128;    // rows of x a block owns: two consumer warpgroups of 64
constexpr int kCeFwdVocab = 128;   // table rows per vocab tile: the products' N
constexpr int kCeFwdChunk = 32;    // columns a stage: one 128-byte swizzled row of f32
constexpr int kCeFwdStages = 4;    // stages in the ring
constexpr int kCeFwdThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kCeFwdConverters = 96;  // producer warps 1-3
constexpr int kCeFwdProducerRegs = 56;   // setmaxnreg: 128 x 56 + 256 x 224 <= 65,536
constexpr int kCeFwdConsumerRegs = 224;

// byte offsets of a stage (every plane on a 1,024-byte boundary: the
// swizzle is a function of the address) and of the barriers after the ring
template <int MODE>
struct CeFwdStage {
  static constexpr bool kBf16 = MODE == kDxBf16;
  static constexpr int kW = kCeFwdVocab * kCeFwdChunk * 4;  // the table's chunk as loaded (tf32 x3: its hi term too)
  static constexpr int kAux = kBf16 ? kW / 2 : kW;      // bf16 plane, or the lo term
  static constexpr int kX = kCeFwdRows * kCeFwdChunk * (kBf16 ? 2 : 4);
  static constexpr int kBytes = kW + kAux + kX;
  static constexpr int kLoadBytes = kW + kX;  // what TMA completes on the full barrier
  static constexpr int kRing = kCeFwdStages * kBytes;
  static constexpr size_t kSmem = kRing + 3 * kCeFwdStages * sizeof(uint64_t) + 1024;  // + alignment slack
};

// the table's landed chunk (at stage) into the numerics' planes, by the 96
// converter threads (ct): tf32 x3 writes its lo term (hopper::tf32_rest: the
// chunk as loaded is its hi term) to the plane after it (same offsets: the
// layout is kept); bf16 writes it rounded to bf16 as 64-byte swizzled rows
template <int MODE>
__device__ __forceinline__ void convert_fwd_chunk(unsigned char* stage, int ct) {
  using S = CeFwdStage<MODE>;
  if constexpr (S::kBf16) {
    for (int i = ct; i < kCeFwdVocab * 4; i += kCeFwdConverters) {  // 16-byte chunks of 8 bf16
      const int r = i >> 2, q = i & 3;
      const float4 a = *reinterpret_cast<const float4*>(stage + hopper::swizzled<hopper::kSwizzle128>(r, 32 * q));
      const float4 b = *reinterpret_cast<const float4*>(stage + hopper::swizzled<hopper::kSwizzle128>(r, 32 * q + 16));
      *reinterpret_cast<uint4*>(stage + S::kW + hopper::swizzled<hopper::kSwizzle64>(r, 16 * q)) = make_uint4(
          tc::pack_bf16(a.x, a.y), tc::pack_bf16(a.z, a.w), tc::pack_bf16(b.x, b.y), tc::pack_bf16(b.z, b.w));
    }
  } else {
    static_assert(MODE == kDxTf32x3, "the forward compiles tf32 x3 for f32 x");
    const uint4* hi = reinterpret_cast<const uint4*>(stage);
    uint4* lo = reinterpret_cast<uint4*>(stage + S::kW);
    for (int i = ct; i < S::kW / 16; i += kCeFwdConverters) {
      const uint4 h = hi[i];
      lo[i] = make_uint4(hopper::tf32_rest(h.x), hopper::tf32_rest(h.y), hopper::tf32_rest(h.z),
                         hopper::tf32_rest(h.w));
    }
  }
}

// A block's units of work, in the order every role of the block walks
// them: unit u = (row tile u % row_tiles, vocab split u / row_tiles), the
// block taking u = blockIdx.x, blockIdx.x + gridDim.x, ... (row tiles
// fastest: the blocks that run side by side share a split's table rows
// through L2). The ring of stages runs on across units.
struct CeFwdUnit {
  int row0, split, j0, j1;
  __device__ CeFwdUnit(int u, int row_tiles, int tiles_per_split, int n_vtiles)
      : row0((u % row_tiles) * kCeFwdRows),
        split(u / row_tiles),
        j0(split * tiles_per_split),
        j1(min(n_vtiles, j0 + tiles_per_split)) {}
};

template <int MODE>
__global__ void __launch_bounds__(kCeFwdThreads, 1)
    ce_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap x_map,
                        const float* __restrict__ bias, float* __restrict__ m_part, float* __restrict__ l_part,
                        int n, int v, int d, int row_offset, int num_valid, int row_tiles, int units,
                        int tiles_per_split) {
  using S = CeFwdStage<MODE>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kRing);  // TMA landed
  uint64_t* ready = full + kCeFwdStages;                              // converted
  uint64_t* empty = ready + kCeFwdStages;                             // read by both consumers
  const int n_vtiles = (v + kCeFwdVocab - 1) / kCeFwdVocab;
  const int nk = (d + kCeFwdChunk - 1) / kCeFwdChunk;  // stages per vocab tile
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kCeFwdStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(ready + s, kCeFwdConverters);
      hopper::mbar_init(empty + s, 256);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------ producer warpgroup
    hopper::reg_dealloc<kCeFwdProducerRegs>();
    const int pt = threadIdx.x - 256;
    if (pt == 0) {
      hopper::prefetch_map(&w_map);
      hopper::prefetch_map(&x_map);
      int i = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const CeFwdUnit unit(u, row_tiles, tiles_per_split, n_vtiles);
        for (int j = unit.j0; j < unit.j1; ++j) {
          for (int c = 0; c < nk; ++c, ++i) {
            const int st = i % kCeFwdStages;
            hopper::mbar_wait(empty + st, ((i / kCeFwdStages) & 1) ^ 1);
            unsigned char* stage = smem + st * S::kBytes;
            hopper::mbar_arrive_expect_tx(full + st, S::kLoadBytes);
            hopper::tma_load_2d(stage, &w_map, full + st, c * kCeFwdChunk, j * kCeFwdVocab);
            hopper::tma_load_2d(stage + S::kW + S::kAux, &x_map, full + st, c * kCeFwdChunk, unit.row0);
          }
        }
      }
    } else if (pt >= 32) {
      int total = 0;  // the block's stages
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const CeFwdUnit unit(u, row_tiles, tiles_per_split, n_vtiles);
        total += max(0, unit.j1 - unit.j0) * nk;
      }
      for (int i = 0; i < total; ++i) {
        const int st = i % kCeFwdStages;
        hopper::mbar_wait(full + st, (i / kCeFwdStages) & 1);
        convert_fwd_chunk<MODE>(smem + st * S::kBytes, pt - 32);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(ready + st);
      }
    }
  } else {
    // ----------------------------------------------- consumer warpgroups
    hopper::reg_alloc<kCeFwdConsumerRegs>();
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int xr = wg * 64 + warp * 16 + g;  // the thread's first row of the unit's x (and xr + 8)
    float ks[64];  // a chunk's products; the first product of each chunk overwrites them
#pragma unroll
    for (int e = 0; e < 64; ++e) ks[e] = 0.f;
    int i = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const CeFwdUnit unit(u, row_tiles, tiles_per_split, n_vtiles);
      float m_run[2] = {kNegBig, kNegBig};  // the JAX kernel's init
      float l_run[2] = {0.f, 0.f};
      for (int j = unit.j0; j < unit.j1; ++j) {
        float s[64];
#pragma unroll
        for (int e = 0; e < 64; ++e) s[e] = 0.f;
        for (int c = 0; c < nk; ++c, ++i) {
          const int st = i % kCeFwdStages;
          hopper::mbar_wait(ready + st, (i / kCeFwdStages) & 1);
          const unsigned char* stage = smem + st * S::kBytes;
          const unsigned char* xs = stage + S::kW + S::kAux;
          const uint32_t w_addr = hopper::smem_addr(stage);
          if constexpr (S::kBf16) {
            uint32_t a[2][4];
#pragma unroll
            for (int kb = 0; kb < 2; ++kb)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                a[kb][q] = *reinterpret_cast<const uint32_t*>(
                    xs + hopper::swizzled<hopper::kSwizzle64>(xr + 8 * (q & 1), kb * 32 + 16 * (q >> 1) + 4 * t));
            const uint64_t desc = hopper::make_desc(w_addr + S::kW, hopper::kSwizzle64, 8 * 64);
            hopper::fence_regs(ks);
            hopper::wgmma_fence();
#pragma unroll
            for (int kb = 0; kb < 2; ++kb) hopper::wgmma_bf16_m64n128k16(ks, a[kb], desc + 2 * kb, kb);
          } else {
            uint32_t hi[4][4], lo[4][4];
#pragma unroll
            for (int kb = 0; kb < 4; ++kb)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const uint32_t raw = *reinterpret_cast<const uint32_t*>(
                    xs + hopper::swizzled<hopper::kSwizzle128>(xr + 8 * (q & 1), 4 * (kb * 8 + t + 4 * (q >> 1))));
                tc::split_tf32(raw, hi[kb][q], lo[kb][q]);
              }
            const uint64_t desc_hi = hopper::make_desc(w_addr, hopper::kSwizzle128, 8 * 128);
            const uint64_t desc_lo = hopper::make_desc(w_addr + S::kW, hopper::kSwizzle128, 8 * 128);
            hopper::fence_regs(ks);
            hopper::wgmma_fence();
            // per k-step of 8 (32 bytes: 2 in the descriptor's units) the
            // small terms first, then hi . hi
#pragma unroll
            for (int kb = 0; kb < 4; ++kb) {
              hopper::wgmma_tf32_m64n128k8(ks, lo[kb], desc_hi + 2 * kb, kb);
              hopper::wgmma_tf32_m64n128k8(ks, hi[kb], desc_lo + 2 * kb, 1);
              hopper::wgmma_tf32_m64n128k8(ks, hi[kb], desc_hi + 2 * kb, 1);
            }
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(ks);
          hopper::mbar_arrive(empty + st);
#pragma unroll
          for (int e = 0; e < 64; ++e) s[e] = __fadd_rn(s[e], ks[e]);
        }

        // + bias, then -1e30 outside the window and -inf past v (no such row:
        // it adds nothing); the tile's max per row over the quad's 32
        // columns, then the running (m, l)
        const int vrow0 = j * kCeFwdVocab;
        const bool interior = vrow0 >= row_offset && vrow0 + kCeFwdVocab <= v &&
                              vrow0 + kCeFwdVocab <= row_offset + num_valid;
        float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nb = 0; nb < kCeFwdVocab / 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = vrow0 + nb * 8 + 2 * t + e;
            const float bc = bias != nullptr && col < v ? __ldg(bias + col) : 0.f;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float val = s[4 * nb + 2 * half + e];
              if (bias != nullptr) val = __fadd_rn(val, bc);  // before blinding
              if (!interior) {
                if (col >= v) {
                  val = -INFINITY;
                } else if (!in_window(col, row_offset, num_valid)) {
                  val = kNegBig;
                }
              }
              s[4 * nb + 2 * half + e] = val;
              mt[half] = fmaxf(mt[half], val);
            }
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float m_new = fmaxf(m_run[half], tc::quad_max(mt[half]));
          float sum = 0.f;
#pragma unroll
          for (int nb = 0; nb < kCeFwdVocab / 8; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) sum += expf(s[4 * nb + 2 * half + e] - m_new);
          l_run[half] = l_run[half] * expf(m_run[half] - m_new) + tc::quad_sum(sum);
          m_run[half] = m_new;
        }
      }
      if (t == 0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = unit.row0 + xr + 8 * half;
          if (row < n) {
            m_part[static_cast<long long>(unit.split) * n + row] = m_run[half];
            l_part[static_cast<long long>(unit.split) * n + row] = l_run[half];
          }
        }
      }
    }
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

// the tensor maps of the table (V, D) f32 and x (N, D), the forward over
// row tiles x splits units on one block an SM, then the splits combined. x and w are
// 16-byte aligned and their rows a multiple of 16 bytes (the wrapper pads).
template <int MODE>
cudaError_t launch_fwd(const void* x, const void* w, const void* bias, void* m_part, void* l_part,
                       void* m, void* l, int n, int v, int d, int row_offset, int num_valid,
                       int splits, int tiles_per_split, cudaStream_t stream) {
  using S = CeFwdStage<MODE>;
  const int x_bytes = S::kBf16 ? 2 : 4;
  if ((static_cast<long long>(d) * x_bytes) % 16 != 0 || (d * 4) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap w_map, x_map;
  cudaError_t err = hopper::encode_2d(&w_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w, v, d,
                                      static_cast<uint64_t>(d) * 4, kCeFwdVocab, kCeFwdChunk,
                                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = S::kBf16 ? hopper::encode_2d(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, n, d,
                                     static_cast<uint64_t>(d) * 2, kCeFwdRows, kCeFwdChunk, CU_TENSOR_MAP_SWIZZLE_64B)
                 : hopper::encode_2d(&x_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, n, d,
                                     static_cast<uint64_t>(d) * 4, kCeFwdRows, kCeFwdChunk, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kernel = ce_fwd_wgmma_kernel<MODE>;
  err = allow_smem(kernel, S::kSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int row_tiles = (n + kCeFwdRows - 1) / kCeFwdRows;
  const long long units = static_cast<long long>(row_tiles) * splits;
  if (units > INT_MAX) return cudaErrorInvalidValue;
  // persistent: one block an SM (its ring takes most of the shared memory)
  const int grid = static_cast<int>(min(units, static_cast<long long>(sms)));
  kernel<<<grid, kCeFwdThreads, S::kSmem, stream>>>(w_map, x_map, static_cast<const float*>(bias),
                                                    static_cast<float*>(m_part), static_cast<float*>(l_part), n, v,
                                                    d, row_offset, num_valid, row_tiles, static_cast<int>(units),
                                                    tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_fwd_combine_kernel<<<(n + kCombineRows - 1) / kCombineRows, 32 * kCombineRows, 0, stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<float*>(m), static_cast<float*>(l), n, splits);
  return cudaGetLastError();
}

// -------------------------------------------------------- merged backward

constexpr int kCeBwdRows = 64;        // rows of packed x a stage: the N of dx^T, the K of dW^T
constexpr int kCeBwdThreads = 384;    // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kCeBwdConverters = 96;  // producer warps 1-3
constexpr int kCeBwdProducerRegs = 40;  // setmaxnreg: 128 x 40 + 256 x 232 <= 65,536
constexpr int kCeBwdConsumerRegs = 232;
constexpr bool kCeBwdDxReduce = true;  // false (tune only): dx's reduce-adds dropped, its product kept
constexpr int kCeBwdSyncAll = 1;       // named barriers: both consumer warpgroups,
constexpr int kCeBwdSyncWg = 2;        // and warpgroup w alone (2 + w)
// per instance (D <= DP): table rows a unit of f32 x (bf16 x: 64, the rows
// of a dx tile, whose staging is the table tile's raw f32 once converted),
// and stages of x in the ring
template <int DP>
constexpr int kCeBwdTv = DP > 128 ? 32 : 64;
template <int DP>
constexpr int kCeBwdStages = DP > 128 ? 2 : 3;

// byte offsets of the shared memory of the instance for D <= DP and x of
// type X (every plane and box on a 1,024-byte boundary: the swizzle is a
// function of the address). A box is 128 bytes a row (32 f32 or 64 bf16
// columns), as TMA writes it with the 128-byte swizzle.
template <int DP, typename X>
struct CeBwdLayout {
  static_assert(DP == 128 || DP == 256, "instances for D <= 128 and D <= 256");
  static constexpr bool kBf16 = sizeof(X) == 2;
  static constexpr int kCols = 128 / static_cast<int>(sizeof(X));  // columns of x (and of A) in a box row
  static constexpr int kTv = kBf16 ? kCeBwdRows : kCeBwdTv<DP>;    // table rows a unit
  static constexpr int kHalf = kTv / 2;                            // of them in a warpgroup's scores
  static constexpr int kStages = kCeBwdStages<DP>;
  static constexpr int kRawBoxes = DP / 32;   // the table tile as TMA loads it: f32 boxes
  static constexpr int kXBoxes = DP / kCols;  // boxes of a row of x (and of the bf16 plane)
  static constexpr int kMt = DP / 128;        // m64 tiles of D a consumer warpgroup owns (half of D)
  static constexpr int kWBox = kTv * 128;
  // the table tile as loaded: f32 x its hi plane; bf16 x converted into the
  // bf16 plane, then the staging of dx^T (64 rows x DP f32: kTv = 64)
  static constexpr int kRaw = kRawBoxes * kWBox;
  static constexpr int kAux = kXBoxes * kWBox;  // f32 x: the lo plane; bf16 x: the bf16 plane
  static constexpr int kXBox = kCeBwdRows * 128;
  static constexpr int kX = kXBoxes * kXBox;  // a stage of x (f32 x: and of dx^T on its way out)
  static constexpr int kTerms = kBf16 ? 1 : 2;  // an A plane's terms
  static constexpr int kP = kTv * kCeBwdRows * static_cast<int>(sizeof(X));  // a term of an A plane
  static constexpr int kWHi = 0, kWAux = kRaw;
  static constexpr int kP1 = kRaw + kAux;     // [table row][x row]: boxes of kCols x rows, kWBox bytes
  static constexpr int kP2 = kP1 + kTerms * kP;  // [x row][table row]: boxes of kCols table rows, kXBox bytes
  static constexpr int kRing = kP2 + kTerms * kP;
  static constexpr int kDb = kRing + kStages * kX;  // (4 warps, kTv) f32: db across a warpgroup's warps
  static constexpr int kBars = kDb + 4 * kTv * 4;
  static constexpr int kNumBars = 3 + 2 * kStages;  // table full / ready / empty, stage full, empty
  static constexpr size_t kSmem = kBars + kNumBars * sizeof(uint64_t) + 1024;  // + alignment slack
  // boxes of K of the gradient products: dW^T over the stage's rows of x,
  // dx^T over the unit's table rows
  static constexpr int kDwBoxes = kCeBwdRows / kCols;
  static constexpr int kDxBoxes = kTv / kCols;
  static_assert(!kBf16 || kTv == kCeBwdRows, "bf16 x stages dx^T in the raw table tile");
  static_assert(kSmem <= kMaxSmem, "the layout fits one block's shared memory");
};

// byte offset of (row, column) in a run of 128-byte boxes of `rows` rows
// of elements of type T
template <int ROWS, typename T>
__device__ __forceinline__ int boxed(int row, int col) {
  constexpr int kCols = 128 / static_cast<int>(sizeof(T));
  return (col / kCols) * ROWS * 128 +
         hopper::swizzled<hopper::kSwizzle128>(row, static_cast<int>(sizeof(T)) * (col % kCols));
}

// The warpgroup's A fragments of one box (4 k-steps) of an operand stored
// transposed: its element (m, k) at row k, column m of a run of 128-byte
// boxes of ROWS rows of X at `tile` (x^T from a stage of x, W^T from the
// table tile), rows m0 and m0 + 8 of the fragment (the caller's m0 holds
// 16 warp + g), k from k0 (a multiple of 32). f32: k-steps of 8, each
// value split rounded to nearest into tf32 hi and lo terms, as
// wgmma_tf32_m64n128k8 lays them out; bf16: k-steps of 16, pairs of k, as
// wgmma_bf16_m64n128k16 lays them out (lo unused). A k-step moves 8 (16)
// rows, which leaves the swizzle's row bits alone: one address a register,
// the k-steps immediate offsets from it.
template <int ROWS, typename X>
__device__ __forceinline__ void box_frags_t(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4], const unsigned char* tile,
                                            int m0, int k0, int t) {
  constexpr int kElem = static_cast<int>(sizeof(X));
  constexpr int kCols = 128 / kElem;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = m0 + 8 * (q & 1);
    const int byte = kElem * (m % kCols);
    const unsigned char* col = tile + (m / kCols) * ROWS * 128 + (byte & 15);
    // row k0 + r (r: the row within the first k-step's rows)
    auto at = [&](int r) { return col + (k0 + r) * 128 + ((((byte >> 4) ^ r) & 7) << 4); };
    if constexpr (kElem == 2) {
      // rows k0 + 16 kb + 8 (q >> 1) + 2t and the next
      const unsigned char* p0 = at(8 * (q >> 1) + 2 * t);
      const unsigned char* p1 = at(8 * (q >> 1) + 2 * t + 1);
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
        hi[kb][q] = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p0 + kb * 16 * 128)) |
                    static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p1 + kb * 16 * 128)) << 16;
    } else {
      // row k0 + 8 kb + t + 4 (q >> 1)
      const unsigned char* p = at(t + 4 * (q >> 1));
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
        tc::split_tf32(*reinterpret_cast<const uint32_t*>(p + kb * 8 * 128), hi[kb][q], lo[kb][q]);
    }
  }
}

// The same for a K-major operand in a 128-byte-swizzled box (rows of 128
// bytes from a 1,024-byte boundary, at shared address `box`): the
// warpgroup's rows 16 warp .. + 15, one ldmatrix.x4 a k-step (its four 8 x
// 16-byte matrices are the fragment's four registers: rows 0-7 and 8-15 of
// the k-step's first 16 bytes, then of its second).
template <bool BF16>
__device__ __forceinline__ void box_frags_ldsm(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4], uint32_t box, int warp,
                                               int lane) {
  const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const int chunk = 2 * kb + (lane >> 4);
    tc::ldmatrix_x4(hi[kb], box + row * 128 + (((chunk ^ row) & 7) << 4));
    if constexpr (!BF16) {
#pragma unroll
      for (int q = 0; q < 4; ++q) tc::split_tf32(hi[kb][q], hi[kb][q], lo[kb][q]);
    }
  }
}

// acc (64 x N) (+)= A . B^T over one box's 4 k-steps: A's fragments in
// registers, B's plane at b_addr (the box, K-major, 128-byte rows). f32:
// three tf32 products a k-step (lo . hi, hi . lo, hi . hi), B's lo term
// `lo_bytes` further; bf16: one product. FIRST: the first k-step writes acc
// without reading it (a group's fresh sums). Issued only: the caller fences
// before the group's first box and commits after its last.
template <int N, bool BF16>
__device__ __forceinline__ void box_product(float (&acc)[N / 2], const uint32_t (&hi)[4][4],
                                            const uint32_t (&lo)[4][4], uint32_t b_addr, int lo_bytes, bool first) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const uint64_t desc_hi = hopper::make_desc(b_addr + kb * 32, hopper::kSwizzle128, 8 * 128);
    if constexpr (BF16) {
      hopper::wgmma_rs<N, true>(acc, hi[kb], desc_hi, kb > 0 || !first);
    } else {
      const uint64_t desc_lo = hopper::make_desc(b_addr + kb * 32 + lo_bytes, hopper::kSwizzle128, 8 * 128);
      hopper::wgmma_rs<N, false>(acc, lo[kb], desc_hi, kb > 0 || !first);
      hopper::wgmma_rs<N, false>(acc, hi[kb], desc_lo, 1);
      hopper::wgmma_rs<N, false>(acc, hi[kb], desc_hi, 1);
    }
  }
}

// Group q of a stage's gradient products, one box (4 k-steps) of K each:
// dW^T (dw) or dx^T, its m-tile of D and its box. f32 x takes every dW^T
// group first (dx^T goes into the stage, which must hold no x^T fragment
// still to be read); bf16 x takes each m-tile's dW^T and then dx^T (dx^T
// goes to its own staging), so that their sums leave registers sooner.
template <typename L>
struct CeBwdGroup {
  static constexpr int kPerMt = L::kDwBoxes + L::kDxBoxes;
  static constexpr int kCount = L::kMt * kPerMt;
  bool dw;
  int mt, box;
  __device__ explicit CeBwdGroup(int q) {
    if (L::kBf16) {
      mt = q / kPerMt;
      dw = q % kPerMt < L::kDwBoxes;
      box = dw ? q % kPerMt : q % kPerMt - L::kDwBoxes;
    } else {
      dw = q < L::kMt * L::kDwBoxes;
      const int r = dw ? q : q - L::kMt * L::kDwBoxes;
      const int per = dw ? L::kDwBoxes : L::kDxBoxes;
      mt = r / per;
      box = r % per;
    }
  }
  // the last box of its product for its m-tile: the sums are complete
  __device__ bool last() const { return box == (dw ? L::kDwBoxes : L::kDxBoxes) - 1; }
};

template <int DP, typename X>
__global__ void __launch_bounds__(kCeBwdThreads, 1)
    ce_bwd_merged_wgmma_kernel(const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap x_map,
                               const __grid_constant__ CUtensorMap dx_map, const float* __restrict__ bias,
                               const float4* __restrict__ info, const int32_t* __restrict__ live,
                               float* __restrict__ dw, float* __restrict__ db, int v, int d, int row_offset,
                               int num_valid, int units) {
  using L = CeBwdLayout<DP, X>;
  constexpr bool kBf16 = L::kBf16;
  constexpr int kTv = L::kTv;
  constexpr int kHalf = L::kHalf;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* wfull = reinterpret_cast<uint64_t*>(smem + L::kBars);  // the table tile landed
  uint64_t* wready = wfull + 1;                                     // its other plane written
  uint64_t* wempty = wfull + 2;                                     // read by every consumer
  uint64_t* full = wfull + 3;                                       // a stage of x landed
  uint64_t* empty = full + L::kStages;  // read by every consumer (f32 x: and its dx^T by both reduces)
  const int n_live = __ldg(live);
  const int n_tiles = (n_live + kCeBwdRows - 1) / kCeBwdRows;
  const int nw = (d + 31) / 32;                // boxes of the table tile's rows that exist
  const int nx = (d + L::kCols - 1) / L::kCols;  // and of x's
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(wfull, 1);
    hopper::mbar_init(wready, kCeBwdConverters);
    hopper::mbar_init(wempty, 256);
    for (int s = 0; s < L::kStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kBf16 ? 256 : 2);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------ producer warpgroup
    hopper::reg_dealloc<kCeBwdProducerRegs>();
    const int pt = threadIdx.x - 256;
    if (pt == 0) {
      hopper::prefetch_map(&w_map);
      hopper::prefetch_map(&x_map);
      hopper::prefetch_map(&dx_map);
      int i = 0, nu = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++nu) {
        hopper::mbar_wait(wempty, (nu & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(wfull, nw * L::kWBox);
        for (int c = 0; c < nw; ++c) hopper::tma_load_2d(smem + L::kWHi + c * L::kWBox, &w_map, wfull, c * 32, u * kTv);
        for (int j = 0; j < n_tiles; ++j, ++i) {
          const int st = i % L::kStages;
          hopper::mbar_wait(empty + st, ((i / L::kStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(full + st, nx * L::kXBox);
          unsigned char* stage = smem + L::kRing + st * L::kX;
          for (int c = 0; c < nx; ++c)
            hopper::tma_load_2d(stage + c * L::kXBox, &x_map, full + st, c * L::kCols, j * kCeBwdRows);
        }
      }
    } else if (pt >= 32) {
      // the table tile's other plane: f32 x its lo term (the tile as loaded
      // is the hi term), bf16 x the tile rounded to bf16 (zero past d)
      int nu = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++nu) {
        hopper::mbar_wait(wfull, nu & 1);
        if constexpr (kBf16) {
          for (int idx = pt - 32; idx < nx * kTv * 8; idx += kCeBwdConverters) {  // 16-byte chunks of 8 bf16
            const int b = idx / (kTv * 8), r = (idx / 8) % kTv, q = idx % 8;
            const int col = b * 64 + 8 * q;
            float4 f[2];
#pragma unroll
            for (int z = 0; z < 2; ++z)  // two 16-byte chunks of the swizzled f32 rows: apart, not adjacent
              f[z] = *reinterpret_cast<const float4*>(smem + L::kWHi + boxed<kTv, float>(r, col + 4 * z));
            float* e = reinterpret_cast<float*>(f);
#pragma unroll
            for (int z = 0; z < 8; ++z) e[z] = col + z < d ? e[z] : 0.f;
            *reinterpret_cast<uint4*>(smem + L::kWAux + boxed<kTv, X>(r, col)) =
                make_uint4(tc::pack_bf16(e[0], e[1]), tc::pack_bf16(e[2], e[3]), tc::pack_bf16(e[4], e[5]),
                           tc::pack_bf16(e[6], e[7]));
          }
        } else {
          const uint4* hi = reinterpret_cast<const uint4*>(smem + L::kWHi);
          uint4* lo = reinterpret_cast<uint4*>(smem + L::kWAux);
          for (int idx = pt - 32; idx < nw * L::kWBox / 16; idx += kCeBwdConverters) {
            const uint4 h = hi[idx];
            lo[idx] = make_uint4(hopper::tf32_rest(h.x), hopper::tf32_rest(h.y), hopper::tf32_rest(h.z),
                                 hopper::tf32_rest(h.w));
          }
        }
        hopper::fence_proxy_async();
        hopper::mbar_arrive(wready);
      }
    }
  } else {
    // ----------------------------------------------- consumer warpgroups
    hopper::reg_alloc<kCeBwdConsumerRegs>();
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const bool elected = (threadIdx.x & 127) == 0;  // issues the warpgroup's reduce-adds
    const uint32_t base = hopper::smem_addr(smem);
    const int xr0 = warp * 16 + g;  // the thread's first row of x in the scores (and xr0 + 8)
    // where dx^T waits for its reduce-adds: the stage it came from (f32 x)
    // or the table tile's raw f32 (bf16 x, converted by then)
    auto dx_staging = [&](unsigned char* stage) { return kBf16 ? smem + L::kWHi : stage; };
    int i = 0, nu = 0;
    int pending = -1;  // f32 x: the stage whose reduce-adds were issued last and not yet waited for
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++nu) {
      const int vrow0 = u * kTv;
      // the thread's table rows in the scores, wg * kHalf + 8 jj + 2t + e of
      // the unit: whether they exist, their bias, whether in the window
      float b_col[kHalf / 8][2], db_run[kHalf / 8][2];
      bool ok_col[kHalf / 8][2], in_col[kHalf / 8][2];
#pragma unroll
      for (int jj = 0; jj < kHalf / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = vrow0 + wg * kHalf + 8 * jj + 2 * t + e;
          ok_col[jj][e] = row < v;
          in_col[jj][e] = in_window(row, row_offset, num_valid);
          b_col[jj][e] = bias != nullptr && row < v ? __ldg(bias + row) : 0.f;
          db_run[jj][e] = 0.f;
        }
      float dwa[L::kMt][kTv / 2];  // dW^T: D rows of the warpgroup's m-tiles x the unit's table rows
#pragma unroll
      for (int mt = 0; mt < L::kMt; ++mt)
#pragma unroll
        for (int e = 0; e < kTv / 2; ++e) dwa[mt][e] = 0.f;
      hopper::mbar_wait(wready, nu & 1);

      for (int j = 0; j < n_tiles; ++j, ++i) {
        const int st = i % L::kStages;
        unsigned char* stage = smem + L::kRing + st * L::kX;
        float4 row_info[2];  // (logz, dnll, label, -) of rows xr0 and xr0 + 8 of the tile
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = j * kCeBwdRows + xr0 + 8 * h;
          row_info[h] = k < n_live ? __ldg(info + k) : make_float4(0.f, 0.f, __int_as_float(-1), 0.f);
        }
        hopper::mbar_wait(full + st, (i / L::kStages) & 1);

        // S = x . W^T over the warpgroup's kHalf table rows, a box of x's
        // columns (4 k-steps, read by ldmatrix) a group into fresh sums,
        // joined to s by round-to-nearest adds
        float s[kHalf / 2];
#pragma unroll
        for (int e = 0; e < kHalf / 2; ++e) s[e] = 0.f;
        const uint32_t w_at = base + (kBf16 ? L::kWAux : L::kWHi) + wg * kHalf * 128;
        const uint32_t stage_at = hopper::smem_addr(stage);
        {
          uint32_t hi[2][4][4], lo[2][4][4];
          box_frags_ldsm<kBf16>(hi[0], lo[0], stage_at, warp, lane);
#pragma unroll
          for (int c = 0; c < L::kXBoxes; ++c) {
            if (c < nx) {
              float ks[kHalf / 2];
              hopper::fence_regs(ks);
              hopper::wgmma_fence();
              box_product<kHalf, kBf16>(ks, hi[c & 1], lo[c & 1], w_at + c * L::kWBox, L::kRaw, true);
              hopper::wgmma_commit();
              if (c == 0 && elected && pending >= 0) {
                // the previous stage's dx^T has been read out: give it back
                hopper::wait_bulk_read<0>();
                hopper::mbar_arrive(empty + pending);
                pending = -1;
              }
              // the next box's fragments are read while this box's product runs
              if (c + 1 < nx)
                box_frags_ldsm<kBf16>(hi[(c + 1) & 1], lo[(c + 1) & 1], stage_at + (c + 1) * L::kXBox, warp, lane);
              hopper::wgmma_wait<0>();
              hopper::fence_regs(ks);
#pragma unroll
              for (int e = 0; e < kHalf / 2; ++e) s[e] = __fadd_rn(s[e], ks[e]);
            }
          }
        }

        // A = dnll (exp(s (+ b) - logz) - onehot) on the accumulators: rows
        // xr0 + 8h of x, table rows wg * kHalf + 8 jj + 2t + e
        float a[kHalf / 8][2][2];
#pragma unroll
        for (int jj = 0; jj < kHalf / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int tl = wg * kHalf + 8 * jj + 2 * t + e;
              float val = 0.f;
              if (ok_col[jj][e] && j * kCeBwdRows + xr0 + 8 * h < n_live) {
                float sv = s[4 * jj + 2 * h + e];
                if (bias != nullptr) sv = __fadd_rn(sv, b_col[jj][e]);  // before blinding
                if (!in_col[jj][e]) sv = kNegBig;
                val = row_info[h].y * (expf(sv - row_info[h].x) -
                                       (vrow0 + tl == __float_as_int(row_info[h].z) ? 1.f : 0.f));
              }
              a[jj][h][e] = val;
              db_run[jj][e] += val;
            }
        // every consumer is done with the previous stage's products (they
        // read the A planes) and with this stage's scores (they read every
        // box of x)
        hopper::named_sync(kCeBwdSyncAll, 256);
        // A into P1 [table row][x row] and P2 [x row][table row]: f32 x raw
        // f32 (the hi term) and its tf32_rest lo term; bf16 x rounded once
#pragma unroll
        for (int jj = 0; jj < kHalf / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int tl = wg * kHalf + 8 * jj + 2 * t;
            const int xr = xr0 + 8 * h;
            const int p2 = L::kP2 + boxed<kCeBwdRows, X>(xr, tl);
            if constexpr (kBf16) {
              const uint32_t pair = tc::pack_bf16(a[jj][h][0], a[jj][h][1]);
#pragma unroll
              for (int e = 0; e < 2; ++e)
                *reinterpret_cast<uint16_t*>(smem + L::kP1 + boxed<kTv, X>(tl + e, xr)) =
                    static_cast<uint16_t>(pair >> (16 * e));
              *reinterpret_cast<uint32_t*>(smem + p2) = pair;
            } else {
              uint32_t hb[2], lb[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                hb[e] = __float_as_uint(a[jj][h][e]);
                lb[e] = hopper::tf32_rest(hb[e]);
                const int p1 = L::kP1 + boxed<kTv, X>(tl + e, xr);
                *reinterpret_cast<uint32_t*>(smem + p1) = hb[e];
                *reinterpret_cast<uint32_t*>(smem + p1 + L::kP) = lb[e];
              }
              *reinterpret_cast<uint2*>(smem + p2) = make_uint2(hb[0], hb[1]);
              *reinterpret_cast<uint2*>(smem + p2 + L::kP) = make_uint2(lb[0], lb[1]);
            }
          }
        hopper::fence_proxy_async();
        // bf16 x: the previous stage's dx^T has been read out of its staging
        if (kBf16 && elected) hopper::wait_bulk_read<0>();
        hopper::named_sync(kCeBwdSyncAll, 256);

        // dW^T += x^T . A over the stage's 64 rows of x (fresh sums, one
        // group of k-steps a stage, joined to dW^T by round-to-nearest adds)
        // and dx^T = W^T . A^T over the unit's table rows, per m-tile of D,
        // a box of K at a time: x^T read from the stage and W^T from the
        // resident tile into registers (f32 split rounded)
        {
          using G = CeBwdGroup<L>;
          float dk[L::kMt][kTv / 2], xk[L::kMt][kCeBwdRows / 2];
          uint32_t hi[2][4][4], lo[2][4][4];
          auto frags = [&](int q, uint32_t (&fh)[4][4], uint32_t (&fl)[4][4]) {
            const G grp(q);
            const int dc = wg * (DP / 2) + grp.mt * 64 + warp * 16 + g;  // the thread's first D row
            if (grp.dw) {
              box_frags_t<kCeBwdRows, X>(fh, fl, stage, dc, grp.box * L::kCols, t);
            } else {
              box_frags_t<kTv, X>(fh, fl, smem + (kBf16 ? L::kWAux : L::kWHi), dc, grp.box * L::kCols, t);
            }
          };
          frags(0, hi[0], lo[0]);
#pragma unroll
          for (int q = 0; q < G::kCount; ++q) {
            const G grp(q);
            const int b = q & 1;
            if (grp.dw) {
              hopper::fence_regs(dk[grp.mt]);
              hopper::wgmma_fence();
              box_product<kTv, kBf16>(dk[grp.mt], hi[b], lo[b], base + L::kP1 + grp.box * L::kWBox, L::kP,
                                      grp.box == 0);
            } else {
              hopper::fence_regs(xk[grp.mt]);
              hopper::wgmma_fence();
              box_product<kCeBwdRows, kBf16>(xk[grp.mt], hi[b], lo[b], base + L::kP2 + grp.box * L::kXBox, L::kP,
                                             grp.box == 0);
            }
            hopper::wgmma_commit();
            if (q + 1 < G::kCount) frags(q + 1, hi[b ^ 1], lo[b ^ 1]);  // while this group runs
            hopper::wgmma_wait<0>();
            if (!grp.last()) continue;
            const int dc = wg * (DP / 2) + grp.mt * 64 + warp * 16 + g;
            if (grp.dw) {  // the stage's dW^T joins the running sums
              hopper::fence_regs(dk[grp.mt]);
#pragma unroll
              for (int e = 0; e < kTv / 2; ++e) dwa[grp.mt][e] = __fadd_rn(dwa[grp.mt][e], dk[grp.mt][e]);
              continue;
            }
            // dx^T into its staging, as TMA lays out x's rows; f32 x: the
            // stage, once every thread of the warpgroup has read its x^T
            if (!kBf16 && grp.mt == 0) hopper::named_sync(kCeBwdSyncWg + wg, 128);
            hopper::fence_regs(xk[grp.mt]);
            unsigned char* out = dx_staging(stage);
#pragma unroll
            for (int jj = 0; jj < kCeBwdRows / 8; ++jj)
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  *reinterpret_cast<float*>(out + boxed<kCeBwdRows, float>(8 * jj + 2 * t + e, dc + 8 * h)) =
                      xk[grp.mt][4 * jj + 2 * h + e];
          }
        }
        hopper::fence_proxy_async();
        hopper::named_sync(kCeBwdSyncWg + wg, 128);
        if constexpr (kBf16) hopper::mbar_arrive(empty + st);  // every read of this stage is done
        if (elected) {
          if constexpr (kCeBwdDxReduce) {
            unsigned char* out = dx_staging(stage);
            for (int c = wg * L::kRawBoxes / 2; c < (wg + 1) * L::kRawBoxes / 2 && c < nw; ++c)
              hopper::tma_reduce_add_2d(&dx_map, out + c * L::kXBox, c * 32, j * kCeBwdRows);
          }
          hopper::commit_bulk();
          if constexpr (!kBf16) pending = st;
        }
      }
      // bf16 x: the last dx^T has been read out of the raw tile before the
      // next unit's table lands there
      if (kBf16 && elected) hopper::wait_bulk_read<0>();
      hopper::mbar_arrive(wempty);  // the unit's last read of its table tile

      // dW rows vrow0 + 8 jj + 2t + e, columns dc + 8h: written once
#pragma unroll
      for (int mt = 0; mt < L::kMt; ++mt) {
        const int dc = wg * (DP / 2) + mt * 64 + warp * 16 + g;
#pragma unroll
        for (int jj = 0; jj < kTv / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = vrow0 + 8 * jj + 2 * t + e;
              const int col = dc + 8 * h;
              if (row < v && col < d) dw[static_cast<long long>(row) * d + col] = dwa[mt][4 * jj + 2 * h + e];
            }
      }
      // db: each thread's sums over its rows of x, then over g by shuffles,
      // then over the warpgroup's warps in order: a fixed order
      if (db != nullptr) {
        float* part = reinterpret_cast<float*>(smem + L::kDb);
#pragma unroll
        for (int jj = 0; jj < kHalf / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float sum = db_run[jj][e];
            sum += __shfl_xor_sync(0xffffffffu, sum, 4);
            sum += __shfl_xor_sync(0xffffffffu, sum, 8);
            sum += __shfl_xor_sync(0xffffffffu, sum, 16);
            if (g == 0) part[warp * kTv + wg * kHalf + 8 * jj + 2 * t + e] = sum;
          }
        hopper::named_sync(kCeBwdSyncWg + wg, 128);
        const int r = threadIdx.x & 127;
        if (r < kHalf && vrow0 + wg * kHalf + r < v) {
          const int col = wg * kHalf + r;
          db[vrow0 + col] = ((part[col] + part[kTv + col]) + part[2 * kTv + col]) + part[3 * kTv + col];
        }
        hopper::named_sync(kCeBwdSyncWg + wg, 128);  // part is written again by the next unit
      }
    }
    if (elected) hopper::wait_bulk();  // the last reduce-adds complete before the block exits
  }
}

// The rows with a nonzero dnll: live[0] = how many, live[1 ..] = those rows
// in order, and pos[i] = row i's place among them or -1. A row whose dnll
// is 0 (a LABEL_PAD row) has A = 0: it adds nothing to dW or db, and its
// dx row is 0. One block, the rows in turns of kLiveThreads: a ballot and
// the warps' counts place each row.
constexpr int kLiveThreads = 1024;
__global__ void __launch_bounds__(kLiveThreads)
    ce_live_rows_kernel(const float* __restrict__ dnll, int n, int32_t* __restrict__ live, int32_t* __restrict__ pos) {
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
    const int at = before + __popc(ballot & ((1u << lane) - 1u));
    if (keep) live[1 + at] = i;
    if (i < n) pos[i] = keep ? at : -1;
    base = total;
    __syncthreads();  // counts is rewritten by the next turn
  }
  if (threadIdx.x == 0) live[0] = base;
}

// The listed rows of x (n, d) packed into xp (n, d), 16-byte chunks: packed
// row k < live[0] is row live[1 + k], the rest zero; info[k] = (logz, dnll,
// label bits, 0) of the same row ((0, 0, -1, 0) past the count); dxp (n,
// d) f32 zeroed. Rows of x and xp are a multiple of 16 bytes, every pointer
// 16-byte aligned.
template <typename X>
__global__ void ce_pack_rows_kernel(const X* __restrict__ x, const float* __restrict__ logz,
                                    const float* __restrict__ dnll, const int32_t* __restrict__ lab,
                                    const int32_t* __restrict__ live, X* __restrict__ xp, float* __restrict__ dxp,
                                    float4* __restrict__ info, int n, int d) {
  const int n_live = live[0];
  const int chunks = d * static_cast<int>(sizeof(X)) / 16;  // of a row of x
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long idx = first; idx < static_cast<long long>(n) * chunks; idx += stride) {
    const int k = static_cast<int>(idx / chunks);
    const int c = static_cast<int>(idx - static_cast<long long>(k) * chunks);
    reinterpret_cast<uint4*>(xp)[idx] =
        k < n_live ? reinterpret_cast<const uint4*>(x + static_cast<long long>(live[1 + k]) * d)[c]
                   : make_uint4(0u, 0u, 0u, 0u);
  }
  for (long long idx = first; idx < static_cast<long long>(n) * (d / 4); idx += stride)
    reinterpret_cast<float4*>(dxp)[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long k = first; k < n; k += stride) {
    float4 row = make_float4(0.f, 0.f, __int_as_float(-1), 0.f);
    if (k < n_live) {
      const int src = live[1 + k];
      row = make_float4(logz[src], dnll[src], __int_as_float(lab[src]), 0.f);
    }
    info[k] = row;
  }
}

// dx (n, d) f32: row i is packed row pos[i] of dxp, or zero
__global__ void ce_unpack_dx_kernel(const float* __restrict__ dxp, const int32_t* __restrict__ pos,
                                    float* __restrict__ dx, int n, int d) {
  const int d4 = d / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < static_cast<long long>(n) * d4; idx += stride) {
    const int i = static_cast<int>(idx / d4);
    const int c = static_cast<int>(idx - static_cast<long long>(i) * d4);
    const int p = pos[i];
    reinterpret_cast<float4*>(dx)[idx] =
        p >= 0 ? reinterpret_cast<const float4*>(dxp + static_cast<long long>(p) * d)[c] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// blocks of 256 for an elementwise pass over `items` items: a few waves
cudaError_t elementwise_grid(long long items, int* grid) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *grid = static_cast<int>(max(1LL, min((items + 255) / 256, 8LL * sms)));
  return cudaSuccess;
}

// the packed rows' tensor maps and the merged backward over them: xp (rows
// >= 1, d) of type X, dxp (rows, d) f32; d a multiple of 16 bytes of X, w
// 16-byte aligned
template <int DP, typename X>
cudaError_t launch_bwd_merged(const X* xp, float* dxp, const float4* info, const int32_t* live, const void* w,
                              const void* bias, void* dw, void* db, int rows, int v, int d, int row_offset,
                              int num_valid, cudaStream_t stream) {
  using L = CeBwdLayout<DP, X>;
  CUtensorMap w_map, x_map, dx_map;
  const uint64_t f32_row = static_cast<uint64_t>(d) * 4;
  cudaError_t err = hopper::encode_2d(&w_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w, v, d, f32_row, L::kTv, 32,
                                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = hopper::encode_2d(&x_map, L::kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, xp,
                            rows, d, static_cast<uint64_t>(d) * sizeof(X), kCeBwdRows, L::kCols,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = hopper::encode_2d(&dx_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, dxp, rows, d, f32_row, kCeBwdRows, 32,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kernel = ce_bwd_merged_wgmma_kernel<DP, X>;
  err = allow_smem(kernel, L::kSmem);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int units = (v + L::kTv - 1) / L::kTv;
  kernel<<<min(units, sms), kCeBwdThreads, L::kSmem, stream>>>(
      w_map, x_map, dx_map, static_cast<const float*>(bias), info, live, static_cast<float*>(dw),
      static_cast<float*>(db), v, d, row_offset, num_valid, units);
  return cudaGetLastError();
}

// The merged backward of x (n, d) of type X: the live rows listed and
// packed, the kernel over them, dx scattered back into dx (n, d) f32.
// work holds xp (rows x d of X, in a region of rows x d f32), dxp (rows x d
// f32) and info (rows float4), rows = max(n, 1); live is (2n + 1) int32:
// the count, the rows, then each row's place (pos).
template <typename X>
cudaError_t bwd_merged(const X* x, const void* w, const void* bias, const int32_t* lab, const float* logz,
                       const float* dnll, int32_t* live, float* work, float* dx, void* dw, void* db, int n, int v,
                       int d, int row_offset, int num_valid, cudaStream_t stream) {
  if ((d * sizeof(X)) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || reinterpret_cast<uintptr_t>(work) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dx) % 16 != 0)
    return cudaErrorInvalidValue;
  const int rows = max(n, 1);
  X* xp = reinterpret_cast<X*>(work);
  float* dxp = work + static_cast<long long>(rows) * d;
  float4* info = reinterpret_cast<float4*>(work + 2LL * rows * d);
  int32_t* pos = live + 1 + n;
  ce_live_rows_kernel<<<1, kLiveThreads, 0, stream>>>(dnll, n, live, pos);
  cudaError_t err = cudaGetLastError();
  int grid = 1;
  if (err == cudaSuccess) err = elementwise_grid(static_cast<long long>(n) * (d / 4), &grid);
  if (err != cudaSuccess) return err;
  ce_pack_rows_kernel<X><<<grid, 256, 0, stream>>>(x, logz, dnll, lab, live, xp, dxp, info, n, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = d <= 128 ? launch_bwd_merged<128, X>(xp, dxp, info, live, w, bias, dw, db, rows, v, d, row_offset,
                                             num_valid, stream)
                 : launch_bwd_merged<256, X>(xp, dxp, info, live, w, bias, dw, db, rows, v, d, row_offset,
                                             num_valid, stream);
  if (err != cudaSuccess) return err;
  ce_unpack_dx_kernel<<<grid, 256, 0, stream>>>(dxp, pos, dx, n, d);
  return cudaGetLastError();
}

}  // namespace

// bias may be null. m_part / l_part are (splits, n) f32 scratch; m, l (n,).
// splits * tiles_per_split must cover the vocab tiles of kCeFwdVocab rows.
// x and w are 16-byte aligned, their rows a multiple of 16 bytes (TMA's
// row stride; the wrapper pads D through a copy). row_start is the
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
  if (splits < 1 || static_cast<long long>(splits) * tiles_per_split < (v + kCeFwdVocab - 1) / kCeFwdVocab)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto launch) {
    return launch(x, w, bias, m_part, l_part, m, l, n, v, d, row_offset - row_start, num_valid,
                  splits, tiles_per_split, s);
  };
  // f32 x: tf32 x3, the forward's one f32 numerics (kDxNumerics' value)
  const cudaError_t err = is_bf16 ? args(launch_fwd<kDxBf16>) : args(launch_fwd<kDxTf32x3>);
  return static_cast<int>(err);
}

// bias and db may be null. live is (2n + 1) int32 scratch; work is (2
// rows d + 4 rows) f32 scratch, rows = max(n, 1); dx32 (n, d) f32, dw (v,
// d) f32 and db (v,) f32 are written whole (zero when n == 0). d <= 256, d
// a multiple of 16 bytes of x's type, x and w 16-byte aligned (the wrapper
// pads). row_start and the window as for b4cp_ce_fwd; lab holds each
// label's row in w's local rows (the global row - row_start; the caller
// shifts it), so a row whose label lies on another shard matches no row
// here and still adds its softmax share.
extern "C" int b4cp_ce_bwd(const void* x, const void* w, const void* bias,
                           const void* lab, const void* logz,
                           const void* dnll, void* live, void* work, void* dx32, void* dw, void* db,
                           int is_bf16, int n, int v, int d, int row_offset,
                           int num_valid, int row_start, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (v == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  if (d > 256) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto typed_x) {
    return bwd_merged(typed_x, w, bias, static_cast<const int32_t*>(lab), static_cast<const float*>(logz),
                      static_cast<const float*>(dnll), static_cast<int32_t*>(live), static_cast<float*>(work),
                      static_cast<float*>(dx32), dw, db, n, v, d, row_offset - row_start, num_valid, s);
  };
  const cudaError_t err =
      is_bf16 ? args(static_cast<const __nv_bfloat16*>(x)) : args(static_cast<const float*>(x));
  return static_cast<int>(err);
}
