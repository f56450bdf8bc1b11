// Grouped expert products of the DeepSeek-V2 block's expert layer
// (models/deepseek_v2.py:MoE, through ops/kernels/grouped_gemm.py). It
// replaces no TPU kernel: the JAX package has no experts. It was added
// because the layer's rows arrive sorted by expert in a buffer whose split
// only the device knows (offsets: each expert's first row, its count
// padded to a multiple of kBM with zero rows, and the end), so a product
// per expert would need the counts on the host.
//
// Two modes, one mainloop: an output tile (kBM x kBN, f32 sums) is the sum
// over chunks of kBK of A_chunk (kBM rows) . B_chunk (kBN rows)^T, bf16 in
// device memory, loaded by TMA with the 128-byte swizzle and multiplied by
// wgmma with both operands in shared memory.
//
// * rows (mode 0): Y (M, N) = X (M, K) . W_e^T, W (E, N, K). Units are
//   (128-row tile, 128-column tile) over all of Y; a row tile lies in one
//   expert's padded rows (found by a binary search of the offsets in shared
//   memory), or past the last, where the tile is written 0 without loads.
// * rows_w (mode 2): dX (M, K) = dY (M, N) . W_e, the input gradient: the
//   units of mode 0, with W (E, N, K) read as it lies, MN-major (a chunk is
//   64 of the expert's rows of W, two boxes of 64 columns; the products set
//   B's transpose bit).
// * dw (mode 1): dW_e (N, K) = dY_e^T . X_e, f32, over expert e's rows:
//   dY (M, N) and X (M, K) are read as they lie, MN-major (a chunk is 64 of
//   the expert's rows, each box 64 rows x 64 columns; the products set both
//   transpose bits), and the chunks run over rows [offsets[e], offsets[e +
//   1]), ragged, none for an expert without rows (its tile is written 0).
//
// Bound: compute. The forward of one MoE layer at the cell's traffic is
// 2 R (2 F + F) D FLOPs with R ~ 91k routed rows, against (E (3 F D) + R (D
// + 3 F)) bf16 bytes: ~1,000 operations a byte, above the card's ~295.
// Design: persistent blocks, one an SM, walk the units; one producer thread
// keeps kStages chunks of A and B in flight (each stage guarded by a full
// and an empty mbarrier); two consumer warpgroups take 64 rows each of the
// tile with m64n128k16 products, one wgmma group in flight while the next
// chunk's is issued, and store their f32 sums (rounded to bf16 in mode 0)
// straight from registers while the producer loads the next unit.

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;  // rows of an output tile: two consumer warpgroups of 64
constexpr int kBN = 128;  // columns of an output tile
constexpr int kBK = 64;   // a chunk of the reduction: one 128-byte swizzled row of bf16
constexpr int kStages = 6;
constexpr int kTileBytes = kBM * kBK * 2;  // A's part of a stage; B's (kBN rows) is as large
constexpr int kBoxBytes = 64 * 64 * 2;     // mode 1: a box of 64 rows x 64 columns
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kRing = kStages * kStageBytes;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // the third warpgroup's first thread is the producer
constexpr int kMaxExperts = 1024;
constexpr size_t kSmemBytes = 1024 + kRing + 2 * kStages * sizeof(uint64_t) + (kMaxExperts + 1) * sizeof(int);
static_assert(kBM == kBN && kBK == 64, "one stage shape serves both modes");

#define GG_ACC8(i)                                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, f32) = d * (scale_d != 0) + A (64 x 16) . B^T (128 x 16),
// bf16, both in shared memory through their descriptors; TA, TB: the
// operand is MN-major (its transpose bit set), else K-major
template <bool TA, bool TB>
__device__ __forceinline__ void mma(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : GG_ACC8(0), GG_ACC8(8), GG_ACC8(16), GG_ACC8(24), GG_ACC8(32), GG_ACC8(40), GG_ACC8(48), GG_ACC8(56)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA ? 1 : 0), "n"(TB ? 1 : 0));
}
#undef GG_ACC8

enum Mode : int { kRows = 0, kDw = 1, kRowsW = 2 };

struct Unit {
  int a_row, a_col;    // the first row and column of A's boxes
  int b_row, b_col;    // the first row and column of B's boxes
  int chunks;          // chunks of kBK (0: the tile is written 0)
  long long out_off;   // the tile's first element in the output
};

// unit u of the walk; off: the offsets in shared memory; n, k: the
// output's columns and the reduction's length
template <int MODE>
__device__ __forceinline__ Unit unit_of(int u, const int* off, int experts, int n, int k) {
  Unit w;
  if constexpr (MODE != kDw) {
    const int n_tiles = n / kBN;
    const int row0 = (u / n_tiles) * kBM, col0 = (u % n_tiles) * kBN;
    w.a_row = row0;
    w.a_col = 0;
    w.b_row = 0;
    w.b_col = 0;
    w.out_off = static_cast<long long>(row0) * n + col0;
    if (row0 >= off[experts]) {
      w.chunks = 0;
      return w;
    }
    int lo = 0, hi = experts;  // the last expert whose rows start at or before row0
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (off[mid] <= row0) lo = mid; else hi = mid;
    }
    if constexpr (MODE == kRows) {
      w.b_row = lo * n + col0;  // W (E n, k): the expert's rows of this tile's columns
    } else {
      w.b_row = lo * k;  // W (E k, n): the expert's rows, read from the first
      w.b_col = col0;
    }
    w.chunks = k / kBK;
  } else {
    const int n_tiles = n / kBM, k_tiles = k / kBN;
    const int e = u / (n_tiles * k_tiles), rest = u % (n_tiles * k_tiles);
    const int row0 = (rest / k_tiles) * kBM, col0 = (rest % k_tiles) * kBN;
    w.a_row = off[e];
    w.a_col = row0;
    w.b_row = off[e];
    w.b_col = col0;
    w.chunks = (off[e + 1] - off[e]) / kBK;
    w.out_off = (static_cast<long long>(e) * n + row0) * k + col0;
  }
  return w;
}

// the loads of chunk c of unit w into stage `stage`, completing on bar: a
// K-major operand one box of 128 rows x 64 columns at (chunk column, row),
// an MN-major one two boxes of 64 rows x 64 columns at (column, chunk row)
template <int MODE>
__device__ __forceinline__ void load_chunk(unsigned char* stage, const CUtensorMap* a_map, const CUtensorMap* b_map,
                                           uint64_t* bar, const Unit& w, int c) {
  if constexpr (MODE == kDw) {
#pragma unroll
    for (int j = 0; j < 2; ++j) hopper::tma_load_2d(stage + j * kBoxBytes, a_map, bar, w.a_col + 64 * j, w.a_row + c * kBK);
  } else {
    hopper::tma_load_2d(stage, a_map, bar, c * kBK, w.a_row);
  }
  if constexpr (MODE == kRows) {
    hopper::tma_load_2d(stage + kTileBytes, b_map, bar, c * kBK, w.b_row);
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      hopper::tma_load_2d(stage + kTileBytes + j * kBoxBytes, b_map, bar, w.b_col + 64 * j, w.b_row + c * kBK);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    grouped_gemm_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
                        void* __restrict__ out, const int* __restrict__ offsets, int experts, int n, int k,
                        int units) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRing);  // a stage's A and B landed
  uint64_t* empty = full + kStages;                            // a stage read by every consumer
  int* off = reinterpret_cast<int*>(empty + kStages);
  for (int i = threadIdx.x; i <= experts; i += kThreads) off[i] = offsets[i];
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // the same in every thread of a warp, and known to be by the compiler
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x == kConsumers) {
      hopper::prefetch_map(&a_map);
      hopper::prefetch_map(&b_map);
      int i = 0;  // the block's chunks so far
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of<MODE>(u, off, experts, n, k);
        for (int c = 0; c < w.chunks; ++c, ++i) {
          const int st = i % kStages;
          hopper::mbar_wait(empty + st, ((i / kStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(full + st, kStageBytes);
          load_chunk<MODE>(smem + st * kStageBytes, &a_map, &b_map, full + st, w, c);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  const int warp = (threadIdx.x / 32) & 3;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  // acc: rows 16 warp + g (acc[4j], acc[4j + 1]) and + 8 (acc[4j + 2],
  // acc[4j + 3]) of the warpgroup's 64, columns 8j + 2t and 8j + 2t + 1
  float acc[64];
  // stage 0's descriptors; a stage is kStageBytes further, a k-step of 16
  // 32 bytes (K-major) or 16 rows of 128 bytes (MN-major) further (the
  // address field is the address / 16)
  constexpr bool DW = MODE == kDw;
  constexpr bool kAMn = MODE == kDw, kBMn = MODE != kRows;
  const uint32_t ring = hopper::smem_addr(smem);
  const uint64_t a_desc0 =
      kAMn ? hopper::make_desc_mn(ring + wg * kBoxBytes, hopper::kSwizzle128, kBoxBytes, 1024)
           : hopper::make_desc(ring + wg * 64 * 128, hopper::kSwizzle128, 1024);
  const uint64_t b_desc0 = kBMn ? hopper::make_desc_mn(ring + kTileBytes, hopper::kSwizzle128, kBoxBytes, 1024)
                                : hopper::make_desc(ring + kTileBytes, hopper::kSwizzle128, 1024);
  constexpr uint32_t kStepA = kAMn ? (16 * 128) >> 4 : 32 >> 4;
  constexpr uint32_t kStepB = kBMn ? (16 * 128) >> 4 : 32 >> 4;
  const int ld = DW ? k : n;
  const int r0 = wg * 64 + warp * 16 + g;
  int i = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit_of<MODE>(u, off, experts, n, k);
    for (int c = 0; c < w.chunks; ++c, ++i) {
      const int st = i % kStages;
      const uint32_t so = (st * kStageBytes) >> 4;
      hopper::mbar_wait(full + st, (i / kStages) & 1);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        mma<kAMn, kBMn>(acc, a_desc0 + so + kk * kStepA, b_desc0 + so + kk * kStepB, c > 0 || kk > 0);
      hopper::wgmma_commit();
      hopper::fence_regs(acc);
      // the previous chunk's group done (at c = 0 the last unit's, long
      // done): its stage may be loaded again
      hopper::wgmma_wait<1>();
      hopper::fence_regs(acc);
      if (c > 0) hopper::mbar_arrive(empty + (i - 1) % kStages);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (w.chunks > 0) {
      hopper::mbar_arrive(empty + (i - 1) % kStages);
    } else {
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    }
    if constexpr (DW) {
      float* o = static_cast<float*>(out) + w.out_off;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * t;
        *reinterpret_cast<float2*>(o + static_cast<long long>(r0) * ld + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(o + static_cast<long long>(r0 + 8) * ld + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    } else {
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + w.out_off;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(o + static_cast<long long>(r0) * ld + col) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(o + static_cast<long long>(r0 + 8) * ld + col) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

template <int MODE>
cudaError_t launch(const CUtensorMap& a_map, const CUtensorMap& b_map, void* out, const int* offsets, int experts,
                   int n, int k, int units, int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(grouped_gemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const int grid = units < sms ? units : sms;
  grouped_gemm_kernel<MODE><<<grid, kThreads, kSmemBytes, stream>>>(a_map, b_map, out, offsets, experts, n, k, units);
  return cudaGetLastError();
}

}  // namespace

// mode 0 (rows): a = X (m, k), b = W (experts * n, k), out = Y (m, n) bf16.
// mode 1 (dw): a = dY (m, n), b = X (m, k), out = dW (experts, n, k) f32.
// mode 2 (rows_w): a = dY (m, k), b = W (experts * k, n), out = dX (m, n)
// bf16.
// offsets: (experts + 1) int32 on the device, multiples of 128, the last
// at most m. a and b bf16, contiguous, 16-byte aligned; m % 128 == 0, n %
// 128 == 0, k % 64 == 0 (mode 1: k % 128 == 0).
extern "C" int b4cp_grouped_gemm(const void* a, const void* b, void* out, const int* offsets, int mode, int m,
                                 int n, int k, int experts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (experts < 1 || experts > kMaxExperts || m % kBM || n % kBN || k % kBK || (mode == kDw && k % kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto swizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  const uint64_t e = static_cast<uint64_t>(experts);
  CUtensorMap a_map, b_map;
  int units;
  if (mode == kRows) {
    if ((err = hopper::encode_2d(&a_map, bf16, a, m, k, 2ull * k, kBM, kBK, swizzle)) != cudaSuccess) return err;
    if ((err = hopper::encode_2d(&b_map, bf16, b, e * n, k, 2ull * k, kBN, kBK, swizzle)) != cudaSuccess) return err;
    units = (m / kBM) * (n / kBN);
  } else if (mode == kDw) {
    if ((err = hopper::encode_2d(&a_map, bf16, a, m, n, 2ull * n, kBK, 64, swizzle)) != cudaSuccess) return err;
    if ((err = hopper::encode_2d(&b_map, bf16, b, m, k, 2ull * k, kBK, 64, swizzle)) != cudaSuccess) return err;
    units = experts * (n / kBM) * (k / kBN);
  } else if (mode == kRowsW) {
    if ((err = hopper::encode_2d(&a_map, bf16, a, m, k, 2ull * k, kBM, kBK, swizzle)) != cudaSuccess) return err;
    if ((err = hopper::encode_2d(&b_map, bf16, b, e * k, n, 2ull * n, kBK, 64, swizzle)) != cudaSuccess) return err;
    units = (m / kBM) * (n / kBN);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (units == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = mode == kRows ? launch<kRows>(a_map, b_map, out, offsets, experts, n, k, units, device, s)
        : mode == kDw ? launch<kDw>(a_map, b_map, out, offsets, experts, n, k, units, device, s)
                      : launch<kRowsW>(a_map, b_map, out, offsets, experts, n, k, units, device, s);
  return static_cast<int>(err);
}
