// Pieces shared by the fused CE kernels of fused_ce.cu (the forward and the
// merged backward) and fused_ce_two_pass.cu (the dx and dW passes), all on
// hopper.cuh's TMA loads and wgmma products:
//
//   * the numerics: f32 x as tf32 x3 (an f32 operand as hi + lo tf32 terms,
//     three products a k-step: lo . hi, hi . lo, hi . hi), bf16 x as one
//     exact bf16 product (the table rounded to bf16 as the JAX kernels'
//     w.astype(x.dtype), A rounded once); fresh sums per group of k-steps
//     joined to the running f32 sums by round-to-nearest adds (kstep_sum);
//   * the 128-byte swizzled boxes TMA writes and the descriptors read
//     (boxed), and the A fragments of one box read from them: K-major by
//     ldmatrix (box_frags_ldsm), transposed element by element
//     (box_frags_t); the products of one box (box_product);
//   * the live rows: ce_live_rows_kernel lists the rows whose dnll is
//     nonzero (the others add nothing to dW or db and have a zero dx row),
//     ce_pack_rows_kernel packs them with their (logz, dnll, label) into
//     contiguous scratch that a tensor map tiles (TMA cannot gather rows).

#pragma once

#include "attention_mma.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegBig = -1e30f;  // the blinding of rows outside the window
// the most dynamic shared memory one block can have on sm_90
constexpr size_t kMaxSmem = 232448;

// the numerics of a kernel instance: f32 x (tf32 x3) or bf16 x
enum CeNumerics : int { kDxTf32x3 = 1, kDxBf16 = 3 };

__device__ __forceinline__ bool in_window(int col, int row_offset, int num_valid) {
  return col >= row_offset && col < row_offset + num_valid;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

// acc += ks with f32 adds that round to nearest. The tensor cores add a
// product into their accumulator without rounding it to nearest: a group of
// k-steps chained onto a running sum many times its size loses the bits
// below the sum's last place, and over a row of D / 8 k-steps (tf32) that
// bias grew to 1.8e-4 of the largest |dx| at logits of ~13 (PERF.md §6,
// what PR 1-7 taught). So each group's products go into fresh registers,
// whose size is one group's, and join the running sums here.
template <int N>
__device__ __forceinline__ void kstep_sum(float (&acc)[N], const float (&ks)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = __fadd_rn(acc[e], ks[e]);
}

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
// boxes of ROWS rows of X at `tile`, rows m0 and m0 + 8 of the fragment (the
// caller's m0 holds 16 warp + g), k from k0 (a multiple of 32). f32: k-steps
// of 8, each value split rounded to nearest into tf32 hi and lo terms, as
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
// row k < live[0] is row live[1 + k], the rest zero; where given, dxp (n, d)
// f32 zeroed; info[k] = (logz, dnll, label bits, 0) of the same row ((0, 0,
// -1, 0) past the count). Rows of x and xp are a multiple of 16 bytes,
// every pointer 16-byte aligned.
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
  if (dxp != nullptr)
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

// the SMs of the current device: the size of a persistent grid
cudaError_t sm_count(int* sms) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  return err == cudaSuccess ? cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device) : err;
}

// blocks of 256 for an elementwise pass over `items` items: a few waves
cudaError_t elementwise_grid(long long items, int* grid) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  *grid = static_cast<int>(max(1LL, min((items + 255) / 256, 8LL * sms)));
  return cudaSuccess;
}

// the live rows of x (n, d) of type X listed and packed into work: xp (rows
// x d of X, in a region of rows x d f32), then where asked dxp (rows x d
// f32, zeroed), then info (rows float4), rows = max(n, 1); live is (2n + 1)
// int32: the count, the rows, then each row's place (pos).
template <typename X>
struct PackedRows {
  X* xp;
  float* dxp;  // null unless asked for
  float4* info;
};
template <typename X>
cudaError_t pack_live_rows(const X* x, const int32_t* lab, const float* logz, const float* dnll, int32_t* live,
                           float* work, int n, int d, bool with_dxp, PackedRows<X>* out, cudaStream_t stream) {
  const long long plane = static_cast<long long>(max(n, 1)) * d;
  out->xp = reinterpret_cast<X*>(work);
  out->dxp = with_dxp ? work + plane : nullptr;
  out->info = reinterpret_cast<float4*>(work + (with_dxp ? 2 : 1) * plane);
  ce_live_rows_kernel<<<1, kLiveThreads, 0, stream>>>(dnll, n, live, live + 1 + n);
  cudaError_t err = cudaGetLastError();
  int grid = 1;
  if (err == cudaSuccess) err = elementwise_grid(static_cast<long long>(n) * (d / 4), &grid);
  if (err != cudaSuccess) return err;
  ce_pack_rows_kernel<X><<<grid, 256, 0, stream>>>(x, logz, dnll, lab, live, out->xp, out->dxp, out->info, n, d);
  return cudaGetLastError();
}

}  // namespace
