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
// takes any D. The backward kernels still run on mma.sync; moving them onto
// the forward's TMA + wgmma mainloop is later work.

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
