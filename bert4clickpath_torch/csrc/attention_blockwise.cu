// Blockwise (K/V-streaming) masked multi-head attention over (B, L, D),
// heads as column sub-ranges of D: the forward, dq, and dk/dv kernels.
//
// Replaces bert4clickpath_tpu/ops/pallas/attention.py:_bmha_fwd_kernel,
// _bmha_dq_kernel and _bmha_dkv_kernel (blockwise_mha and its VJP). Per batch
// row b and head h, with Dh = D / H and scale = 1/sqrt(Dh):
//
//   forward   s = (q_h . k_h^T) * scale + bias[b]          f32
//             online softmax over key tiles: running max m and sum l per
//             query row; the un-normalised p = exp(s - m) is rounded to the
//             input type before the PV product (f32 sums), the sum is divided
//             by l once at the end; lse = m + log(l) is kept per (row, head)
//   backward  p = exp(s - lse)                              f32, recomputed
//             dv_h = round_to_input(p)^T . do_h             f32 sums
//             dp = do_h . v_h^T                             f32
//             ds = round_to_input(p * (dp - delta) * scale) from the f32 p
//             dq_h = ds . k_h,  dk_h = ds^T . q_h           f32 sums
//             delta = rowsum(do_h * out_h) comes from the wrapper
//
// bias is the (B, 1, 1, L) f32 additive padding bias, -1e9 (finite) at [PAD]
// keys: a fully padded row gives a uniform softmax, and a first key tile that
// is all padding is rescaled away (alpha = exp(m_prev - m_new) underflows to
// 0) once a real key arrives. q, k and v may be column slices of one
// (B, L, 3D) projection: each has a batch and a row stride, and only the last
// dimension must be contiguous. do, out, dq, dk, dv are contiguous (B, L, D);
// lse and delta are (B, L, H) f32. Unlike the TPU kernels, which add each
// tile pair's partial dq / dk / dv into an output of the input type, the
// gradients are summed in f32 registers over all tiles and rounded once; one
// block owns its output rows, so there are no atomics and two runs give the
// same bits. The TPU kernel takes dv from the unrounded f32 p; here p is
// rounded to the input type first (the identity for f32 inputs), as the
// forward rounds it before its PV product, so that in bf16 every product of
// the backward has bf16 operands.
//
// What bounds all three on the H100: operations. At the long-session shape
// (B=16, L=1024, D=256, H=4) one product over all heads is 2 B L^2 D = 8.6
// GFLOP over ~34 MB of q/k/v/out: the forward is two products (17.2 GFLOP,
// 0.0174 ms at the bf16 peak), dq three and dk/dv four, 60 GFLOP per layer
// in the backward. In the forward the exponentials come close behind: one
// per score, 16 a cycle an SM, take about as long as the two products at
// Dh = 64.
//
// Three designs live here, chosen by the input type alone: f32 inputs take
// (1), bf16 inputs (2) and (3).
//
// (1) The f32 kernels: scalar f32 FMA out of
// shared memory, so that f32 inputs keep f32 accuracy (the exactness route).
// A block of 256 threads (16 x 16) owns one 64-row tile of one (b, h): a
// query tile in the forward and dq (grid: q tiles x H x B), a key tile in
// dk/dv, which then sums over all query tiles inside the block. It walks the
// other sequence axis in 64-row tiles. Tiles are converted to f32 in shared
// memory with a row stride of Dh' + 4 floats (Dh' = Dh rounded up to 16, 32,
// 64 or 128 and zero-filled, a template parameter), which makes the 16-byte
// reads of both products conflict-free. Thread (ty, tx) computes the 4 x 4
// scores at rows ty + 16 i and columns tx + 16 j, reduces max and sum over
// the 16 lanes that share its rows by warp shuffles, writes the probability
// (or ds) tile to shared memory, and then accumulates its rows' output for
// the Dh'/16 head columns it owns. Shared memory at Dh = 64: forward 68 KB,
// dq 85 KB, dk/dv 103 KB per block; at Dh = 128: 116, 149 and 167 KB.
//
// (2) The bf16 backward (bmha_dq_mma_kernel, bmha_dkv_mma_kernel): every
// product on the tensor cores, mma.sync.m16n8k16 (bf16 x bf16, f32 sums)
// with ldmatrix fragment loads; the building blocks are in attention_mma.cuh.
// A warp owns 16 rows of one (b, h): query rows in dq (8 warps, 128 rows a
// block), key rows in dk/dv (4 warps, 64 rows a block), so one block owns
// its output rows. Its own operands (q and do; k and v) are loaded once into
// bf16 tiles (row stride Dh' + 8: no bank conflicts) and, for Dh' <= 64,
// their A fragments then stay in registers. The walked operand (k and v
// tiles of 64 keys with their bias; q and do tiles of 64 rows with their lse
// and delta) comes through two stages of shared memory by cp.async: tile
// j + 1 is in flight while tile j multiplies, with one barrier per tile. dq
// computes s = q k^T and dp = do v^T; dk/dv computes the transposed tiles
// s^T = k q^T and dp^T = v do^T, so that p^T and ds^T arrive in the
// accumulator layout of the key rows the warp owns. exp(s - lse),
// (dp - delta), the scale and the rounding to bf16 happen on the accumulator
// fragments, which are repacked in registers as the A operand of the next
// product (dq += ds k; dv += p^T do, dk += ds^T q, the B operand read down
// its rows with ldmatrix.trans): p and ds never touch shared memory. A warp
// takes a walked tile through this chain a few columns at a time (16 in dq,
// 64 or 32 in dk/dv), which bounds its score registers. Keys past L carry a
// bias of -inf and query rows past L an lse of +inf, so their p is exactly 0
// before any product; rows past L are never stored. Where the head width, a
// stride or a base address does not allow 16-byte copies, plain loads fill
// the same tiles. At Dh = 64 (ptxas, sm_90a): dq 128 registers, 74 KB of
// shared memory, two blocks (16 warps) per SM; dk/dv 168 registers, 56 KB,
// three blocks (12 warps); at Dh = 128: 140 and 105 KB, one block each. The
// gradients stay in f32 registers over all tiles and are rounded once.
// mma.sync, not wgmma: its fragment layouts are explicit, which the
// register-level chaining of p and ds needs to be sure of without a compiler
// at hand while writing; wgmma (A from registers for the second product of
// each chain, 128-byte-swizzled B tiles behind descriptors) is what a later
// version would add for the last factor towards the tensor cores' peak.
//
// (3) The bf16 forward (bmha_fwd_wgmma_kernel) on Hopper's own tools
// (hopper.cuh): TMA loads into a ring of mbarrier-guarded stages and
// warpgroup wgmma products for both S = Q K^T and O += P V. A block of two
// consumer warpgroups (64 query rows each) and one producer warpgroup is
// persistent, one an SM, and walks units of (128-row query tile, head,
// batch row); one producer thread keeps the loads in flight:
// the unit's Q tile (two Q buffers, so that the next unit's Q lands while
// this one runs) and, through kFwdStages stages, 128-key K and V tiles with
// their bias, the ring running on across units. q, k and v are read through
// rank-4 tensor maps over (head column, head, row, batch) with their own
// strides, so columns past dh and rows past seq_len arrive as zeros: no tile
// reads the next head's columns or the next batch row's rows. A box is at
// most 64 columns (one row of the 128-byte swizzle; 64- and 32-byte at
// Dh' = 32, 16), so a head of 128 comes as two boxes. The bias comes as a
// box of a rank-1 map over its B L values, from the 16-byte boundary at or
// below the stage's first key (a box start must lie on one).
//
// A consumer warpgroup takes a stage: S = Q K^T on wgmma m64n128k16 with
// both operands K-major in shared memory, the stage's bias read from its
// box while that product runs. The online softmax runs on S in registers,
// one step of 128 keys, in log2 units (scale and bias carry log2 e, so each
// p is one ex2): row maxima over the four lanes of a row (quad_max), alpha =
// 2^(m_prev - m_new) rescales the O accumulators (a warp none of whose
// rows' maxima moved skips that: alpha = 1), the un-normalised
// p = 2^(s - m_new) is summed unrounded into the lane's share of l and
// rounded to bf16 in place into the A fragments of O += P V (wgmma
// m64n{Dh'}k16, A from registers): S's accumulator layout is the A layout
// of the next product, two n8 blocks a k-step, so p never touches shared
// memory. B of that product is the V tile as it lies, [key][head column]:
// MN-major, read through the transposed-B descriptor (make_desc_mn), so no
// transposed copy of V is made. Each consumer arrives on the stage's
// "empty" barrier once its P V product has completed, and on the Q
// buffer's once its last Q K^T has. At the end of a unit l is summed over
// the quad, out = O / l is rounded once and stored from registers row by
// row (rows past seq_len are not stored), lse = m ln 2 + log l. The finite
// -1e9 padding bias keeps its meaning (a fully padded row: uniform p; a
// first tile that is all padding is rescaled away by alpha = 0 once a real
// key arrives). ex2 is the fast one (ex2.approx): p moves by ~1e-6
// relative, which lse's tolerance (1e-5 relative) holds. The products are
// not what bounds it: with both removed it still takes 0.96 of its time at
// the long-session shape, which the softmax's instruction stream sets
// (PERF.md).
// The wrapper hands over a contiguous copy of an input whose base or
// strides a tensor map cannot describe (ops/kernels/attention.py,
// _tma_operands); the main paths make none.

#include <climits>
#include <type_traits>

#include "attention_mma.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;           // query rows / keys per tile
constexpr int kPad = 4;             // floats of padding per shared-memory row
constexpr int kSs = kTile + kPad;   // row stride of a 64 x 64 score tile

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows [row0, row0 + 64) x columns [0, dh) of src (row stride in elements)
// as f32 into a tile with row stride DHP + kPad; zero past seq_len and dh.
// vec: dh, the strides and the base pointers allow 4-element loads.
template <typename T, int DHP>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long long row_stride, int row0,
                                          int seq_len, int dh, bool vec) {
  constexpr int RS = DHP + kPad;
  if (vec) {
    constexpr int CPR = DHP / 4;  // 4-element chunks per row
#pragma unroll 4
    for (int idx = threadIdx.x; idx < kTile * CPR; idx += kThreads) {
      const int r = idx / CPR;
      const int c = (idx % CPR) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < seq_len && c < dh) {
        val = load4(src + (row0 + r) * row_stride + c);
      }
      *reinterpret_cast<float4*>(dst + r * RS + c) = val;
    }
  } else {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < kTile * DHP; idx += kThreads) {
      const int r = idx / DHP;
      const int c = idx % DHP;
      float val = 0.f;
      if (row0 + r < seq_len && c < dh) {
        val = to_f(src[(row0 + r) * row_stride + c]);
      }
      dst[r * RS + c] = val;
    }
  }
}

// acc[i][j] += a[ty + 16 i, :] . b[tx + 16 j, :] over the DHP columns
template <int DHP>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4],
                                         const float* __restrict__ a,
                                         const float* __restrict__ b, int ty,
                                         int tx) {
  constexpr int RS = DHP + kPad;
#pragma unroll 2
  for (int c = 0; c < DHP; c += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * RS + c);
      bv[i] = *reinterpret_cast<const float4*>(b + (tx + 16 * i) * RS + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][c] += sum_n s[ty + 16 i, n] * m[n, tx * NC + c]: s is a 64 x 64
// score tile (row stride kSs), m a 64-row tile (row stride DHP + kPad)
template <int DHP>
__device__ __forceinline__ void tile_accumulate(float (&acc)[4][DHP / 16],
                                                const float* __restrict__ s,
                                                const float* __restrict__ m,
                                                int ty, int tx) {
  constexpr int RS = DHP + kPad;
  constexpr int NC = DHP / 16;
#pragma unroll 2
  for (int n = 0; n < kTile; n += 4) {
    float sv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(s + (ty + 16 * i) * kSs + n);
      sv[i][0] = t.x;
      sv[i][1] = t.y;
      sv[i][2] = t.z;
      sv[i][3] = t.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* mr = m + (n + u) * RS + tx * NC;
      float mv[NC];
      if constexpr (NC % 4 == 0) {
#pragma unroll
        for (int c = 0; c < NC; c += 4) {
          const float4 t = *reinterpret_cast<const float4*>(mr + c);
          mv[c] = t.x;
          mv[c + 1] = t.y;
          mv[c + 2] = t.z;
          mv[c + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) mv[c] = mr[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(sv[i][u], mv[c], acc[i][c]);
      }
    }
  }
}

// max / sum over the 16 lanes (tx) that share a thread's rows
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the thread's rows' accumulators, rounded once, to a contiguous (B, L, D)
// tensor: rows row0 + ty + 16 i, head columns tx * NC + c
template <typename T, int NC>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           const float (&acc)[4][NC],
                                           long long base, int row0,
                                           int seq_len, int d, int dh, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= seq_len) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx * NC + c;
      if (col < dh) dst[base + static_cast<long long>(row) * d + col] = from_f<T>(acc[i][c]);
    }
  }
}

struct Strides {
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;
};

// The f32 kernels: the scalar design (1) of the header.

template <int DHP>
__global__ void __launch_bounds__(kThreads, DHP <= 64 ? 2 : 1)
    bmha_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ bias,
                        float* __restrict__ out, float* __restrict__ lse, int seq_len,
                        int d, int dh, int heads, Strides st, float scale,
                        int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RS = DHP + kPad;
  constexpr int NC = DHP / 16;
  float* qs = smem;
  float* ks = qs + kTile * RS;
  float* vs = ks + kTile * RS;
  float* ss = vs + kTile * RS;   // p
  float* bs = ss + kTile * kSs;  // this key tile's bias
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float* kb = k + b * st.k_sb + h * dh;
  const float* vb = v + b * st.v_sb + h * dh;

  load_tile<float, DHP>(qs, q + b * st.q_sb + h * dh, st.q_sl, q0, seq_len, dh, vec);
  float m_run[4], l_run[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < seq_len; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<float, DHP>(ks, kb, st.k_sl, k0, seq_len, dh, vec);
    load_tile<float, DHP>(vs, vb, st.v_sl, k0, seq_len, dh, vec);
    if (threadIdx.x < kTile) {
      const int key = k0 + threadIdx.x;
      bs[threadIdx.x] = key < seq_len ? bias[static_cast<long long>(b) * seq_len + key] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {};
    tile_dot<DHP>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        // every visited tile holds at least one key < seq_len, and the bias
        // is finite, so the row maximum is finite
        s[i][j] = k0 + kj < seq_len ? __fadd_rn(__fmul_rn(s[i][j], scale), bs[kj]) : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], row_max(mx));
      const float alpha = expf(m_run[i] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);  // exp(-inf) = 0 past seq_len
        sum += p;
        ss[(ty + 16 * i) * kSs + tx + 16 * j] = p;
      }
      l_run[i] = l_run[i] * alpha + row_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_accumulate<DHP>(acc, ss, vs, ty, tx);
  }

  const long long base = static_cast<long long>(b) * seq_len * d + h * dh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] /= l_run[i];
    if (tx == 0 && row < seq_len) {
      lse[(static_cast<long long>(b) * seq_len + row) * heads + h] = m_run[i] + logf(l_run[i]);
    }
  }
  store_rows<float, NC>(out, acc, base, q0, seq_len, d, dh, ty, tx);
}

template <int DHP>
__global__ void __launch_bounds__(kThreads, DHP <= 64 ? 2 : 1)
    bmha_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ bias,
                   const float* __restrict__ lse, const float* __restrict__ dout,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int seq_len, int d, int dh, int heads, Strides st,
                   float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RS = DHP + kPad;
  constexpr int NC = DHP / 16;
  float* qs = smem;
  float* dos = qs + kTile * RS;
  float* ks = dos + kTile * RS;
  float* vs = ks + kTile * RS;
  float* ss = vs + kTile * RS;   // ds
  float* bs = ss + kTile * kSs;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long base = static_cast<long long>(b) * seq_len * d + h * dh;
  const float* kb = k + b * st.k_sb + h * dh;
  const float* vb = v + b * st.v_sb + h * dh;

  load_tile<float, DHP>(qs, q + b * st.q_sb + h * dh, st.q_sl, q0, seq_len, dh, vec);
  load_tile<float, DHP>(dos, dout + base, d, q0, seq_len, dh, vec);
  float lse_r[4], delta_r[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const long long at = (static_cast<long long>(b) * seq_len + row) * heads + h;
    lse_r[i] = row < seq_len ? lse[at] : 0.f;
    delta_r[i] = row < seq_len ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < seq_len; k0 += kTile) {
    __syncthreads();
    load_tile<float, DHP>(ks, kb, st.k_sl, k0, seq_len, dh, vec);
    load_tile<float, DHP>(vs, vb, st.v_sl, k0, seq_len, dh, vec);
    if (threadIdx.x < kTile) {
      const int key = k0 + threadIdx.x;
      bs[threadIdx.x] = key < seq_len ? bias[static_cast<long long>(b) * seq_len + key] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {};
    tile_dot<DHP>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        // p; 0 for a key past seq_len
        s[i][j] = k0 + kj < seq_len
                      ? expf(__fadd_rn(__fmul_rn(s[i][j], scale), bs[kj]) - lse_r[i])
                      : 0.f;
      }
    }
    float dp[4][4] = {};
    tile_dot<DHP>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float ds = __fmul_rn(__fmul_rn(s[i][j], __fsub_rn(dp[i][j], delta_r[i])), scale);
        ss[(ty + 16 * i) * kSs + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    tile_accumulate<DHP>(acc, ss, ks, ty, tx);
  }
  store_rows<float, NC>(dq, acc, base, q0, seq_len, d, dh, ty, tx);
}

// One block per key tile: it keeps k and v, walks the query tiles, and
// computes the scores transposed (rows = keys, columns = queries), so the
// thread's rows are the dk / dv rows it sums.
template <int DHP>
__global__ void __launch_bounds__(kThreads, DHP <= 64 ? 2 : 1)
    bmha_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ bias,
                    const float* __restrict__ lse, const float* __restrict__ dout,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int seq_len, int d, int dh, int heads,
                    Strides st, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RS = DHP + kPad;
  constexpr int NC = DHP / 16;
  float* ks = smem;
  float* vs = ks + kTile * RS;
  float* qs = vs + kTile * RS;
  float* dos = qs + kTile * RS;
  float* pt = dos + kTile * RS;     // p^T
  float* dst = pt + kTile * kSs;    // ds^T
  float* lses = dst + kTile * kSs;  // this query tile's lse
  float* deltas = lses + kTile;     // and delta
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long base = static_cast<long long>(b) * seq_len * d + h * dh;
  const float* qb = q + b * st.q_sb + h * dh;

  load_tile<float, DHP>(ks, k + b * st.k_sb + h * dh, st.k_sl, k0, seq_len, dh, vec);
  load_tile<float, DHP>(vs, v + b * st.v_sb + h * dh, st.v_sl, k0, seq_len, dh, vec);
  float bias_r[4], acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    bias_r[i] = key < seq_len ? bias[static_cast<long long>(b) * seq_len + key] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc_k[i][c] = 0.f;
      acc_v[i][c] = 0.f;
    }
  }

  for (int q0 = 0; q0 < seq_len; q0 += kTile) {
    __syncthreads();
    load_tile<float, DHP>(qs, qb, st.q_sl, q0, seq_len, dh, vec);
    load_tile<float, DHP>(dos, dout + base, d, q0, seq_len, dh, vec);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const long long at = (static_cast<long long>(b) * seq_len + row) * heads + h;
      lses[threadIdx.x] = row < seq_len ? lse[at] : 0.f;
      deltas[threadIdx.x] = row < seq_len ? delta[at] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {};
    tile_dot<DHP>(s, ks, qs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = tx + 16 * j;
        // p; 0 for a query row or a key past seq_len
        s[i][j] = q0 + qj < seq_len && k0 + ty + 16 * i < seq_len
                      ? expf(__fadd_rn(__fmul_rn(s[i][j], scale), bias_r[i]) - lses[qj])
                      : 0.f;
        pt[(ty + 16 * i) * kSs + qj] = s[i][j];
      }
    }
    float dp[4][4] = {};
    tile_dot<DHP>(dp, vs, dos, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = tx + 16 * j;
        const float ds = __fmul_rn(__fmul_rn(s[i][j], __fsub_rn(dp[i][j], deltas[qj])), scale);
        dst[(ty + 16 * i) * kSs + qj] = ds;
      }
    }
    __syncthreads();
    tile_accumulate<DHP>(acc_v, pt, dos, ty, tx);
    tile_accumulate<DHP>(acc_k, dst, qs, ty, tx);
  }
  store_rows<float, NC>(dv, acc_v, base, k0, seq_len, d, dh, ty, tx);
  store_rows<float, NC>(dk, acc_k, base, k0, seq_len, d, dh, ty, tx);
}

// The bf16 backward on the tensor cores (design (2) of the header).

constexpr int kWalk = 64;  // rows of a walked tile: one barrier and one stage each

// The shape of each kernel, found on the card at the long-session shape
// (examples/long_context/tune_blockwise_bwd.py). Warps: 16 rows of the
// block's own tile each. Pass: the columns of a walked tile that a warp takes
// through its chain of products at a time (its two score tiles are 16 x pass
// f32 in registers). MinBlocks: the blocks per SM that the register
// allocation leaves room for; ptxas otherwise takes all 255 registers to
// hoist loads, and the fewer warps in flight cost more than the hoisting
// gains. kFragmentsResident: the A fragments of the block's own operands
// stay in registers (else they are read from shared memory at every k-step).
template <int DHP>
constexpr bool kFragmentsResident = DHP <= 64;
template <int DHP>
constexpr int kDqWarps = 8;
template <int DHP>
constexpr int kDqPass = 16;
template <int DHP>
constexpr int kDqMinBlocks = DHP <= 64 ? 2 : 1;  // 128 registers; at Dh' = 128 shared memory holds one block
template <int DHP>
constexpr int kDkvWarps = 4;
template <int DHP>
constexpr int kDkvPass = DHP <= 64 ? 64 : 32;  // dk and dv alone are 128 registers at Dh' = 128
template <int DHP>
constexpr int kDkvMinBlocks = DHP <= 64 ? 3 : 1;  // 168 registers

// bytes of dynamic shared memory of the mma kernels: two resident tiles of
// 16 rows a warp, two stages of two walked tiles, and two stages of
// `rows_f32` f32 rows of kWalk values
template <int DHP>
constexpr size_t mma_smem_bytes(int warps, int rows_f32) {
  return sizeof(__nv_bfloat16) * (2 * 16 * warps + 4 * kWalk) * (DHP + tc::kSkew) +
         sizeof(float) * 2 * rows_f32 * kWalk;
}

// One block per (query tile of 16 rows a warp, h, b): q and do stay, k and v
// tiles walk.
template <int DHP, int WARPS, int NP, bool RESIDENT, int MIN_BLOCKS>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
    bmha_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                       const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                       int seq_len, int d, int dh, int heads, Strides st, float scale,
                       int vec) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  constexpr int RS = DHP + tc::kSkew;
  constexpr int kMmaThreads = WARPS * 32;
  constexpr int kMmaRows = WARPS * 16;  // rows the block owns
  constexpr int NT = NP / 8;  // n8 tiles of a pass
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* dos = qs + kMmaRows * RS;
  __nv_bfloat16* ks = dos + kMmaRows * RS;  // two stages
  __nv_bfloat16* vs = ks + 2 * kWalk * RS;  // two stages
  float* bs = reinterpret_cast<float*>(vs + 2 * kWalk * RS);  // two stages of kWalk
  const int q0 = blockIdx.x * kMmaRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long base = static_cast<long long>(b) * seq_len * d + h * dh;
  const __nv_bfloat16* kb = k + b * st.k_sb + h * dh;
  const __nv_bfloat16* vb = v + b * st.v_sb + h * dh;
  const float* bias_b = bias + static_cast<long long>(b) * seq_len;

  auto fill_walked = [&](int stage, int k0) {
    tc::fill_tile<kWalk, DHP, kMmaThreads>(ks + stage * kWalk * RS, kb, st.k_sl, k0, seq_len, dh, vec);
    tc::fill_tile<kWalk, DHP, kMmaThreads>(vs + stage * kWalk * RS, vb, st.v_sl, k0, seq_len, dh, vec);
    // a key past seq_len: p = exp(-inf) = 0
    tc::fill_rows_f32<kMmaThreads>(bs + stage * kWalk, bias_b, 1, k0, kWalk, seq_len, -INFINITY);
    tc::cp_async_commit();
  };

  tc::fill_tile<kMmaRows, DHP, kMmaThreads>(qs, q + b * st.q_sb + h * dh, st.q_sl, q0, seq_len, dh, vec);
  tc::fill_tile<kMmaRows, DHP, kMmaThreads>(dos, dout + base, d, q0, seq_len, dh, vec);
  tc::cp_async_commit();
  fill_walked(0, 0);

  // the thread's two rows: g and g + 8 of the warp's 16 (a row past seq_len
  // is computed on zeros and never stored)
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    const long long at = (static_cast<long long>(b) * seq_len + row) * heads + h;
    lse_r[i] = row < seq_len ? lse[at] : 0.f;
    delta_r[i] = row < seq_len ? delta[at] : 0.f;
  }
  float acc[DHP / 8][4] = {};

  const int rows_first = tc::lane_offset_rows_first<RS>(lane) * 2;
  const int cols_first = tc::lane_offset_cols_first<RS>(lane) * 2;
  const uint32_t q_addr = tc::shared_addr(qs + warp * 16 * RS) + rows_first;
  const uint32_t do_addr = tc::shared_addr(dos + warp * 16 * RS) + rows_first;
  const uint32_t k_addr = tc::shared_addr(ks);
  const uint32_t v_addr = tc::shared_addr(vs);
  constexpr uint32_t kStageBytes = kWalk * RS * 2;
  constexpr uint32_t kPassBytes = NP * RS * 2;

  uint32_t qf[DHP / 16][4], dof[DHP / 16][4];
  if constexpr (RESIDENT) {
    tc::cp_async_wait<1>();  // q and do have arrived
    __syncthreads();
    tc::load_a<DHP>(qf, q_addr);
    tc::load_a<DHP>(dof, do_addr);
  }

  const int n_tiles = (seq_len + kWalk - 1) / kWalk;
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile j is visible; tile j - 1's readers are done
    if (j + 1 < n_tiles) fill_walked(stage ^ 1, (j + 1) * kWalk);

#pragma unroll
    for (int c = 0; c < kWalk / NP; ++c) {
      const uint32_t k_at = k_addr + stage * kStageBytes + c * kPassBytes;
      const uint32_t v_at = v_addr + stage * kStageBytes + c * kPassBytes;
      float s[NT][4] = {}, dp[NT][4] = {};
      if constexpr (RESIDENT) {
        tc::product_abt<DHP, NT>(s, qf, k_at + cols_first);
        tc::product_abt<DHP, NT>(dp, dof, v_at + cols_first);
      } else {
        tc::product_abt<DHP, NT>(s, q_addr, k_at + cols_first);
        tc::product_abt<DHP, NT>(dp, do_addr, v_at + cols_first);
      }
      // ds on the accumulator fragments, rounded and repacked as A fragments
      uint32_t dsf[NP / 16][4];
      const float* bj = bs + stage * kWalk + c * NP + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 b2 = *reinterpret_cast<const float2*>(bj + nt * 8);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = __expf(fmaf(s[nt][e], scale, (e & 1) ? b2.y : b2.x) - lse_r[r]);
          ds[e] = p * (dp[nt][e] - delta_r[r]) * scale;
        }
        dsf[nt >> 1][(nt & 1) * 2] = tc::pack_bf16(ds[0], ds[1]);
        dsf[nt >> 1][(nt & 1) * 2 + 1] = tc::pack_bf16(ds[2], ds[3]);
      }
      tc::product_ab<DHP, NP / 16>(acc, dsf, k_at + rows_first);
    }
  }
  tc::store_acc<DHP>(dq + base, acc, q0 + warp * 16, seq_len, d, dh, lane, vec);
}

// One block per (key tile of 16 rows a warp, h, b): k and v stay, q and do
// tiles walk with their lse and delta; the scores are computed transposed
// (rows = keys).
template <int DHP, int WARPS, int NP, bool RESIDENT, int MIN_BLOCKS>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
    bmha_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                        const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int seq_len, int d, int dh, int heads,
                        Strides st, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  constexpr int RS = DHP + tc::kSkew;
  constexpr int kMmaThreads = WARPS * 32;
  constexpr int kMmaRows = WARPS * 16;  // rows the block owns
  constexpr int NT = NP / 8;  // n8 tiles of a pass
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* vs = ks + kMmaRows * RS;
  __nv_bfloat16* qs = vs + kMmaRows * RS;   // two stages
  __nv_bfloat16* dos = qs + 2 * kWalk * RS;  // two stages
  float* lses = reinterpret_cast<float*>(dos + 2 * kWalk * RS);  // two stages of kWalk
  float* deltas = lses + 2 * kWalk;                              // two stages of kWalk
  const int k0 = blockIdx.x * kMmaRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long base = static_cast<long long>(b) * seq_len * d + h * dh;
  const __nv_bfloat16* qb = q + b * st.q_sb + h * dh;
  const float* lse_b = lse + static_cast<long long>(b) * seq_len * heads + h;
  const float* delta_b = delta + static_cast<long long>(b) * seq_len * heads + h;

  auto fill_walked = [&](int stage, int q0) {
    tc::fill_tile<kWalk, DHP, kMmaThreads>(qs + stage * kWalk * RS, qb, st.q_sl, q0, seq_len, dh, vec);
    tc::fill_tile<kWalk, DHP, kMmaThreads>(dos + stage * kWalk * RS, dout + base, d, q0, seq_len, dh, vec);
    // a query row past seq_len: lse = +inf gives p = exp(-inf) = 0, so it
    // adds nothing to dk and dv
    tc::fill_rows_f32<kMmaThreads>(lses + stage * kWalk, lse_b, heads, q0, kWalk, seq_len, INFINITY);
    tc::fill_rows_f32<kMmaThreads>(deltas + stage * kWalk, delta_b, heads, q0, kWalk, seq_len, 0.f);
    tc::cp_async_commit();
  };

  tc::fill_tile<kMmaRows, DHP, kMmaThreads>(ks, k + b * st.k_sb + h * dh, st.k_sl, k0, seq_len, dh, vec);
  tc::fill_tile<kMmaRows, DHP, kMmaThreads>(vs, v + b * st.v_sb + h * dh, st.v_sl, k0, seq_len, dh, vec);
  tc::cp_async_commit();
  fill_walked(0, 0);

  // the thread's two key rows (a key past seq_len: p = 0, never stored)
  float bias_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + g + 8 * i;
    bias_r[i] = key < seq_len ? bias[static_cast<long long>(b) * seq_len + key] : -INFINITY;
  }
  float acc_k[DHP / 8][4] = {}, acc_v[DHP / 8][4] = {};

  const int rows_first = tc::lane_offset_rows_first<RS>(lane) * 2;
  const int cols_first = tc::lane_offset_cols_first<RS>(lane) * 2;
  const uint32_t k_addr = tc::shared_addr(ks + warp * 16 * RS) + rows_first;
  const uint32_t v_addr = tc::shared_addr(vs + warp * 16 * RS) + rows_first;
  const uint32_t q_addr = tc::shared_addr(qs);
  const uint32_t do_addr = tc::shared_addr(dos);
  constexpr uint32_t kStageBytes = kWalk * RS * 2;
  constexpr uint32_t kPassBytes = NP * RS * 2;

  uint32_t kf[DHP / 16][4], vf[DHP / 16][4];
  if constexpr (RESIDENT) {
    tc::cp_async_wait<1>();  // k and v have arrived
    __syncthreads();
    tc::load_a<DHP>(kf, k_addr);
    tc::load_a<DHP>(vf, v_addr);
  }

  const int n_tiles = (seq_len + kWalk - 1) / kWalk;
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile j is visible; tile j - 1's readers are done
    if (j + 1 < n_tiles) fill_walked(stage ^ 1, (j + 1) * kWalk);

#pragma unroll
    for (int c = 0; c < kWalk / NP; ++c) {
      const uint32_t q_at = q_addr + stage * kStageBytes + c * kPassBytes;
      const uint32_t do_at = do_addr + stage * kStageBytes + c * kPassBytes;
      float sT[NT][4] = {}, dpT[NT][4] = {};  // s^T and dp^T: rows = keys
      if constexpr (RESIDENT) {
        tc::product_abt<DHP, NT>(sT, kf, q_at + cols_first);
        tc::product_abt<DHP, NT>(dpT, vf, do_at + cols_first);
      } else {
        tc::product_abt<DHP, NT>(sT, k_addr, q_at + cols_first);
        tc::product_abt<DHP, NT>(dpT, v_addr, do_at + cols_first);
      }
      // p^T and ds^T on the accumulator fragments, rounded and repacked
      uint32_t pf[NP / 16][4], dsf[NP / 16][4];
      const float* lj = lses + stage * kWalk + c * NP + 2 * t;
      const float* dj = deltas + stage * kWalk + c * NP + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 l2 = *reinterpret_cast<const float2*>(lj + nt * 8);
        const float2 d2 = *reinterpret_cast<const float2*>(dj + nt * 8);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          p[e] = __expf(fmaf(sT[nt][e], scale, bias_r[r]) - ((e & 1) ? l2.y : l2.x));
          ds[e] = p[e] * (dpT[nt][e] - ((e & 1) ? d2.y : d2.x)) * scale;
        }
        pf[nt >> 1][(nt & 1) * 2] = tc::pack_bf16(p[0], p[1]);
        pf[nt >> 1][(nt & 1) * 2 + 1] = tc::pack_bf16(p[2], p[3]);
        dsf[nt >> 1][(nt & 1) * 2] = tc::pack_bf16(ds[0], ds[1]);
        dsf[nt >> 1][(nt & 1) * 2 + 1] = tc::pack_bf16(ds[2], ds[3]);
      }
      tc::product_ab<DHP, NP / 16>(acc_v, pf, do_at + rows_first);
      tc::product_ab<DHP, NP / 16>(acc_k, dsf, q_at + rows_first);
    }
  }
  tc::store_acc<DHP>(dv + base, acc_v, k0 + warp * 16, seq_len, d, dh, lane, vec);
  tc::store_acc<DHP>(dk + base, acc_k, k0 + warp * 16, seq_len, d, dh, lane, vec);
}

// The bf16 forward on Hopper's TMA and wgmma (design (3) of the header).

constexpr int kFwdRows = 128;  // query rows of a unit: two consumer warpgroups of 64
constexpr int kFwdKeys = 128;  // keys of a stage: the N of S = Q K^T (wgmma m64n128)
// a stage's bias box: its keys and up to 3 before them, so that the box
// starts on a 16-byte boundary of the bias row (a TMA box start must)
constexpr int kFwdBiasBox = kFwdKeys + 4;
constexpr int kFwdBiasSlot = 640;  // bytes a stage: the box, rounded up to 128

// Found on the card at the long-session shape (PERF.md; copies of this
// source with other values: examples/long_context/tune_blockwise_bwd.py
// --kernel fwd). Stages: K/V stages in the ring (two at Dh' = 128, where a
// stage is 64 KB). QBuffers: Q tiles, so that the next unit's Q loads while
// this one runs. Regs: the setmaxnreg split, 128 x producer + 256 x
// consumer <= 65,536.
template <int DHP>
constexpr int kFwdStages = DHP == 128 ? 2 : 4;
constexpr int kFwdQBuffers = 2;
constexpr int kFwdProducerRegs = 40;
constexpr int kFwdConsumerRegs = 232;

// Shared memory of one block: kFwdQBuffers Q tiles, then kFwdStages stages
// of a K and a V tile, each stage's bias box, then the barriers. A tile is
// rows x Dh' bf16 as TMA writes it: column boxes of kBoxCols (one swizzled
// row of 128, 64 or 32 bytes), every box on a 1,024-byte boundary.
template <int DHP>
struct FwdLayout {
  static constexpr int kConsumers = 256;
  static constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
  static constexpr int kBoxCols = DHP < 64 ? DHP : 64;
  static constexpr int kRowBytes = kBoxCols * 2;
  static constexpr int kBoxes = DHP / kBoxCols;
  static constexpr int kQBox = kFwdRows * kRowBytes;    // one column box of Q
  static constexpr int kBoxBytes = kFwdKeys * kRowBytes;  // one column box of K or V
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kTile = kBoxes * kBoxBytes;
  static constexpr int kStages = kFwdStages<DHP>;
  static constexpr int kQ = kFwdQBuffers * kQTile;
  static constexpr int kBias = kQ + kStages * 2 * kTile;  // each stage's bias box
  static constexpr int kRing = kBias + kStages * kFwdBiasSlot;
  static constexpr int kStageBytes = 2 * kTile + kFwdBiasBox * 4;  // what TMA completes on a stage's barrier
  static constexpr size_t kSmem = kRing + (2 * kFwdQBuffers + 2 * kStages) * sizeof(uint64_t) + 1024;  // + alignment
  static constexpr hopper::Swizzle kSwizzle = hopper::swizzle_of<kRowBytes>();
  static constexpr uint32_t kGroup = 8 * kRowBytes;  // 8 rows of a box: the descriptors' stride
  static_assert(kQBox % 1024 == 0 && kBoxBytes % 1024 == 0, "boxes on 1,024-byte boundaries");
};

// A block's units, in the order both roles walk them: unit u = (query tile
// u % q_tiles, head, batch row), the block taking u = blockIdx.x,
// blockIdx.x + gridDim.x, ... (query tiles fastest: the blocks that run side
// by side read the same K and V and share them through L2).
struct FwdUnit {
  int q0, h, b;
  __device__ FwdUnit(int u, int q_tiles, int heads)
      : q0((u % q_tiles) * kFwdRows), h((u / q_tiles) % heads), b(u / q_tiles / heads) {}
};

// keeps the compiler from moving the writes of A fragments past the
// wgmma.fence that must follow them
__device__ __forceinline__ void fence_frags(uint32_t (&a)[kFwdKeys / 16][4]) {
#pragma unroll
  for (int i = 0; i < kFwdKeys / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of a stage (the warpgroup's 64 rows against 128 keys), started
// and committed: 16 head columns (32 bytes) a k-step, both operands K-major
// in their column boxes. q_desc and k_desc describe the tiles' first k-step;
// a later one adds its byte offset / 16 (the offsets are constants).
template <int DHP>
__device__ __forceinline__ void start_scores(float (&s)[64], uint64_t q_desc, uint64_t k_desc) {
  using S = FwdLayout<DHP>;
  hopper::wgmma_bf16_m64n128k16_ss_first(s, q_desc, k_desc);
#pragma unroll
  for (int ks = 1; ks < DHP / 16; ++ks) {
    constexpr int kRow = S::kRowBytes;
    const int col = ks * 32;  // bytes into a row
    hopper::wgmma_bf16_m64n128k16_ss(s, q_desc + (((col / kRow) * S::kQBox + col % kRow) >> 4),
                                     k_desc + (((col / kRow) * S::kBoxBytes + col % kRow) >> 4));
  }
  hopper::wgmma_commit();
}

// O += P V, started and committed: V as it lies ([key][head column],
// MN-major, v_desc from make_desc_mn), 16 keys a k-step; the next column
// box (Dh' = 128) is the descriptor's next N group
template <int DHP>
__device__ __forceinline__ void start_pv(float (&o)[DHP / 2], const uint32_t (&pf)[kFwdKeys / 16][4],
                                         uint64_t v_desc) {
  using S = FwdLayout<DHP>;
#pragma unroll
  for (int kk = 0; kk < kFwdKeys / 16; ++kk)
    hopper::wgmma_bf16_tb<DHP>(o, pf[kk], v_desc + ((kk * 16 * S::kRowBytes) >> 4), 1);
  hopper::wgmma_commit();
}

constexpr float kLog2e = 1.4426950408889634f;

// the thread's keys' bias (8 nb + 2t + e of the stage at k0) times log2(e)
// from the stage's box, whose first `shift` values precede the stage (one
// address across a quad's rows); in the ragged last stage a key past
// seq_len (the box holds the next batch row's bias there) gets -inf, so
// p = 0
__device__ __forceinline__ void load_bias(float (&bj)[kFwdKeys / 4], const float* bias_s, int shift, int k0,
                                          int seq_len, int t) {
  const float* at = bias_s + shift + 2 * t;
#pragma unroll
  for (int nb = 0; nb < kFwdKeys / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) bj[2 * nb + e] = at[nb * 8 + e] * kLog2e;
  if (k0 + kFwdKeys > seq_len) {
    const int past = seq_len - k0 - 2 * t;  // the thread's keys 8 nb + e at or past it lie past seq_len
#pragma unroll
    for (int nb = 0; nb < kFwdKeys / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (nb * 8 + e >= past) bj[2 * nb + e] = -INFINITY;
  }
}

// max and sum over a row's 16 values, as pairwise trees (chains of four
// instead of one of 16)
template <typename Op>
__device__ __forceinline__ float tree16(const float (&x)[16], Op op) {
  float a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = op(x[2 * i], x[2 * i + 1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = op(a[2 * i], a[2 * i + 1]);
  return op(op(a[0], a[1]), op(a[2], a[3]));
}

// One step of the online softmax on a stage's scores, in registers, in
// log2 units (scale and bias carry log2(e), so p = 2^(s - m) is one ex2 an
// element): s = s * scale + bias, the row maxima over the quad, alpha =
// 2^(m_prev - m_new) (0 on the first stage), and the un-normalised
// p = 2^(s - m_new), summed unrounded into the lane's share of l and
// rounded to bf16 into the A fragments of P V (n8 blocks 2kk and 2kk + 1 are
// k-step kk: row g's pair in registers 0 and 2, row g + 8's in 1 and 3).
// s - m_new is exact where s is the maximum (a fully padded row, all of
// whose s absorb into the -1e9 bias, gets p = 1 at every key). The stage
// holds a key below seq_len with a finite bias, so m_new is finite and
// -inf - (-inf) is never formed.
__device__ __forceinline__ void softmax_step(float (&s)[64], const float (&bj)[kFwdKeys / 4], float scale,
                                             float (&m_run)[2], float (&l_run)[2], float (&alpha)[2],
                                             uint32_t (&pf)[kFwdKeys / 16][4]) {
  const float sc = scale * kLog2e;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx[16];
#pragma unroll
    for (int nb = 0; nb < kFwdKeys / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) s[4 * nb + 2 * r + e] = fmaf(s[4 * nb + 2 * r + e], sc, bj[2 * nb + e]);
      mx[nb] = fmaxf(s[4 * nb + 2 * r], s[4 * nb + 2 * r + 1]);
    }
    const float m_new = fmaxf(m_run[r], tc::quad_max(tree16(mx, [](float a, float b) { return fmaxf(a, b); })));
    alpha[r] = ex2(m_run[r] - m_new);
    float ps[16];
#pragma unroll
    for (int nb = 0; nb < kFwdKeys / 8; ++nb) {
      const float p0 = ex2(s[4 * nb + 2 * r] - m_new);
      const float p1 = ex2(s[4 * nb + 2 * r + 1] - m_new);
      ps[nb] = p0 + p1;
      pf[nb >> 1][(nb & 1) * 2 + r] = tc::pack_bf16(p0, p1);
    }
    l_run[r] = l_run[r] * alpha[r] + tree16(ps, [](float a, float b) { return a + b; });
    m_run[r] = m_new;
  }
}

template <int DHP>
__global__ void __launch_bounds__(FwdLayout<DHP>::kThreads, 1)
    bmha_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap bias_map,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int seq_len, int d, int dh,
                          int heads, int units, float scale, int paired) {
  using S = FwdLayout<DHP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::kRing);  // Q landed
  uint64_t* q_empty = q_full + kFwdQBuffers;                          // Q read by every consumer
  uint64_t* full = q_empty + kFwdQBuffers;                            // K, V and bias landed
  uint64_t* empty = full + S::kStages;                                // K and V read by every consumer
  const int q_tiles = (seq_len + kFwdRows - 1) / kFwdRows;
  const int n_tiles = (seq_len + kFwdKeys - 1) / kFwdKeys;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kFwdQBuffers; ++i) {
      hopper::mbar_init(q_full + i, 1);
      hopper::mbar_init(q_empty + i, S::kConsumers);
    }
    for (int i = 0; i < S::kStages; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, S::kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------ producer warpgroup
    hopper::reg_dealloc<kFwdProducerRegs>();
    if (threadIdx.x == S::kConsumers) {
      hopper::prefetch_map(&q_map);
      hopper::prefetch_map(&k_map);
      hopper::prefetch_map(&v_map);
      hopper::prefetch_map(&bias_map);
      int i = 0, n = 0;  // the block's stages and units so far
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
        const FwdUnit unit(u, q_tiles, heads);
        const int qb = n % kFwdQBuffers;
        hopper::mbar_wait(q_empty + qb, ((n / kFwdQBuffers) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(q_full + qb, S::kQTile);
        unsigned char* qs = smem + qb * S::kQTile;
#pragma unroll
        for (int c = 0; c < S::kBoxes; ++c)
          hopper::tma_load_4d(qs + c * S::kQBox, &q_map, q_full + qb, c * S::kBoxCols, unit.h, unit.q0, unit.b);
        for (int j = 0; j < n_tiles; ++j, ++i) {
          const int st = i % S::kStages;
          hopper::mbar_wait(empty + st, ((i / S::kStages) & 1) ^ 1);
          unsigned char* stage = smem + S::kQ + st * 2 * S::kTile;
          hopper::mbar_arrive_expect_tx(full + st, S::kStageBytes);
          hopper::tma_load_1d(smem + S::kBias + st * kFwdBiasSlot, &bias_map, full + st,
                              (unit.b * seq_len + j * kFwdKeys) & ~3);
#pragma unroll
          for (int c = 0; c < S::kBoxes; ++c) {
            hopper::tma_load_4d(stage + c * S::kBoxBytes, &k_map, full + st, c * S::kBoxCols, unit.h, j * kFwdKeys,
                                unit.b);
            hopper::tma_load_4d(stage + S::kTile + c * S::kBoxBytes, &v_map, full + st, c * S::kBoxCols, unit.h,
                                j * kFwdKeys, unit.b);
          }
        }
      }
    }
  } else {
    // ----------------------------------------------- consumer warpgroups
    hopper::reg_alloc<kFwdConsumerRegs>();
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    // S of a stage: rows 16 warp + g (s[4j], s[4j + 1]) and + 8 (s[4j + 2],
    // s[4j + 3]) of the warpgroup's 64, keys 8j + 2t, 8j + 2t + 1
    float s[64];
    float o[DHP / 2];  // O, the same layout over head columns
    // the descriptors of stage 0's K and V; stage st is 2 st kTile bytes on
    // (a descriptor's address field is the address / 16: no carry out of it
    // below 256 KB)
    const uint32_t ring = hopper::smem_addr(smem + S::kQ);
    const uint64_t k_desc0 = hopper::make_desc(ring, S::kSwizzle, S::kGroup);
    const uint64_t v_desc0 = hopper::make_desc_mn(ring + S::kTile, S::kSwizzle, S::kBoxBytes, S::kGroup);
    int i = 0, n = 0;  // the block's stages and units so far
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
      const FwdUnit unit(u, q_tiles, heads);
      const int qb = n % kFwdQBuffers;
      const int shift = (unit.b * seq_len) & 3;  // the bias boxes' values before each stage
#pragma unroll
      for (int e = 0; e < DHP / 2; ++e) o[e] = 0.f;
      // the thread's two rows. l_run is the lane's share of the row sum
      // (its keys 8j + 2t, + 1), summed over the quad at the end: alpha is
      // the same in all four lanes.
      float m_run[2] = {-INFINITY, -INFINITY};
      float l_run[2] = {0.f, 0.f};
      hopper::mbar_wait(q_full + qb, (n / kFwdQBuffers) & 1);
      const uint64_t q_desc = hopper::make_desc(hopper::smem_addr(smem + qb * S::kQTile) + wg * 64 * S::kRowBytes,
                                                S::kSwizzle, S::kGroup);
      for (int j = 0; j < n_tiles; ++j, ++i) {
        const int st = i % S::kStages;
        const uint32_t stage_off = (st * 2 * S::kTile) >> 4;
        hopper::mbar_wait(full + st, (i / S::kStages) & 1);
        hopper::wgmma_fence();
        start_scores<DHP>(s, q_desc, k_desc0 + stage_off);
        float bj[kFwdKeys / 4];  // read while the product runs
        load_bias(bj, reinterpret_cast<const float*>(smem + S::kBias + st * kFwdBiasSlot), shift, j * kFwdKeys,
                  seq_len, t);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        if (j == n_tiles - 1) hopper::mbar_arrive(q_empty + qb);  // the unit's last read of Q
        float alpha[2];
        uint32_t pf[kFwdKeys / 16][4];
        softmax_step(s, bj, scale, m_run, l_run, alpha, pf);
        // alpha = 1 in every row of the warp (no row's maximum moved, as in
        // most late stages): O stays as it is, bit for bit
        if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
          for (int e = 0; e < DHP / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
        }
        fence_frags(pf);
        hopper::fence_regs(o);
        hopper::wgmma_fence();
        start_pv<DHP>(o, pf, v_desc0 + stage_off);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        hopper::mbar_arrive(empty + st);
      }

      // out = O / l, rounded once; lse = m ln 2 + log l. Rows past seq_len (zero
      // rows of Q, by the load's fill) are never stored.
      const int row0 = unit.q0 + wg * 64 + warp * 16 + g;
      __nv_bfloat16* out_b = out + static_cast<long long>(unit.b) * seq_len * d + unit.h * dh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l = tc::quad_sum(l_run[r]);
        const int row = row0 + 8 * r;
        if (row >= seq_len) continue;
        if (t == 0) {  // m back in natural units
          lse[(static_cast<long long>(unit.b) * seq_len + row) * heads + unit.h] = m_run[r] / kLog2e + logf(l);
        }
        __nv_bfloat16* orow = out_b + static_cast<long long>(row) * d;
#pragma unroll
        for (int nt = 0; nt < DHP / 8; ++nt) {
          const int col = nt * 8 + 2 * t;
          const float lo = o[4 * nt + 2 * r] / l;
          const float hi = o[4 * nt + 2 * r + 1] / l;
          if (paired) {
            if (col < dh) *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(lo, hi);
          } else {
            if (col < dh) orow[col] = __float2bfloat16_rn(lo);
            if (col + 1 < dh) orow[col + 1] = __float2bfloat16_rn(hi);
          }
        }
      }
    }
  }
}

// bytes of dynamic shared memory of the scalar kernels: `tiles` 64-row
// operand tiles, `scores` 64 x 64 score tiles, `extra` floats
template <int DHP>
constexpr size_t smem_bytes(int tiles, int scores, int extra) {
  return sizeof(float) * (static_cast<size_t>(tiles) * kTile * (DHP + kPad) +
                          static_cast<size_t>(scores) * kTile * kSs + extra);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Args {
  const void *q, *k, *v, *bias, *lse_in, *dout, *delta;
  void *out, *lse_out, *dq, *dk, *dv;
  int batch, seq_len, d, heads, vec;
  int head_stride;  // elements between the heads of q, k and v (the bf16 forward's maps)
  Strides st;
  float scale;
  cudaStream_t stream;
};

// The bf16 forward: a rank-4 tensor map of q, k and v each over (head
// column, head, row, batch), boxes of kBoxCols x 1 x 128 x 1 with the
// 128-, 64- or 32-byte swizzle, zero past dh and past seq_len; one
// persistent block an SM over the units. Every base and stride must be a
// multiple of 16 bytes (the wrapper hands over a copy where one is not).
template <int DHP>
cudaError_t launch_fwd_wgmma(const Args& a) {
  using S = FwdLayout<DHP>;
  const int dh = a.d / a.heads;
  const void* bases[3] = {a.q, a.k, a.v};
  const long long batch_strides[3] = {a.st.q_sb, a.st.k_sb, a.st.v_sb};
  const long long row_strides[3] = {a.st.q_sl, a.st.k_sl, a.st.v_sl};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const uint64_t dims[4] = {static_cast<uint64_t>(dh), static_cast<uint64_t>(a.heads),
                              static_cast<uint64_t>(a.seq_len), static_cast<uint64_t>(a.batch)};
    const uint64_t strides[3] = {static_cast<uint64_t>(a.head_stride) * 2, static_cast<uint64_t>(row_strides[i]) * 2,
                                 static_cast<uint64_t>(batch_strides[i]) * 2};
    const uint32_t box[4] = {S::kBoxCols, 1, static_cast<uint32_t>(i == 0 ? kFwdRows : kFwdKeys), 1};
    if (reinterpret_cast<uintptr_t>(bases[i]) % 16 != 0 || strides[0] % 16 != 0 || strides[1] % 16 != 0 ||
        strides[2] % 16 != 0 || a.head_stride < dh)
      return cudaErrorInvalidValue;
    const cudaError_t err = hopper::encode_4d(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, bases[i], dims, strides, box,
                                              hopper::tma_swizzle_of<S::kRowBytes>());
    if (err != cudaSuccess) return err;
  }
  // the bias as one row of B L f32: a stage's box starts at b L + k0
  // rounded down to a multiple of 4 (past the batch row's end it holds the
  // next row's bias, masked by the consumers)
  CUtensorMap bias_map;
  if (reinterpret_cast<uintptr_t>(a.bias) % 16 != 0) return cudaErrorInvalidValue;
  {
    const uint64_t dims[1] = {static_cast<uint64_t>(a.batch) * a.seq_len};
    const uint32_t box[1] = {kFwdBiasBox};
    const cudaError_t err = hopper::encode_1d(&bias_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.bias, dims, box);
    if (err != cudaSuccess) return err;
  }
  auto kernel = bmha_fwd_wgmma_kernel<DHP>;
  cudaError_t err = allow_smem(kernel, S::kSmem);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long units = static_cast<long long>((a.seq_len + kFwdRows - 1) / kFwdRows) * a.heads * a.batch;
  if (units > INT_MAX) return cudaErrorInvalidValue;
  // persistent: one block an SM (the ring takes most of its shared memory)
  const int grid = static_cast<int>(min(units, static_cast<long long>(sms)));
  kernel<<<grid, S::kThreads, S::kSmem, a.stream>>>(
      maps[0], maps[1], maps[2], bias_map, static_cast<__nv_bfloat16*>(a.out),
      static_cast<float*>(a.lse_out), a.seq_len, a.d, dh, a.heads, static_cast<int>(units), a.scale,
      dh % 2 == 0 && a.d % 2 == 0);
  return cudaGetLastError();
}

enum Which { kFwd, kDq, kDkv };

// The input type alone picks the kernels: the scalar f32 ones for float, the
// tensor-core ones for bf16.
template <typename T, int DHP>
cudaError_t launch_one(Which which, const Args& a) {
  const int dh = a.d / a.heads;
  const dim3 grid((a.seq_len + kTile - 1) / kTile, a.heads, a.batch);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const float* bias = static_cast<const float*>(a.bias);
  const float* lse = static_cast<const float*>(a.lse_in);
  const float* delta = static_cast<const float*>(a.delta);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    if (which == kFwd) {
      constexpr size_t smem = smem_bytes<DHP>(3, 1, kTile);
      if ((err = allow_smem(bmha_fwd_f32_kernel<DHP>, smem)) != cudaSuccess) return err;
      bmha_fwd_f32_kernel<DHP><<<grid, kThreads, smem, a.stream>>>(
          q, k, v, bias, static_cast<T*>(a.out), static_cast<float*>(a.lse_out),
          a.seq_len, a.d, dh, a.heads, a.st, a.scale, a.vec);
    } else if (which == kDq) {
      constexpr size_t smem = smem_bytes<DHP>(4, 1, kTile);
      if ((err = allow_smem(bmha_dq_f32_kernel<DHP>, smem)) != cudaSuccess) return err;
      bmha_dq_f32_kernel<DHP><<<grid, kThreads, smem, a.stream>>>(
          q, k, v, bias, lse, dout, delta, static_cast<float*>(a.dq), a.seq_len, a.d,
          dh, a.heads, a.st, a.scale, a.vec);
    } else {
      constexpr size_t smem = smem_bytes<DHP>(4, 2, 2 * kTile);
      if ((err = allow_smem(bmha_dkv_f32_kernel<DHP>, smem)) != cudaSuccess) return err;
      bmha_dkv_f32_kernel<DHP><<<grid, kThreads, smem, a.stream>>>(
          q, k, v, bias, lse, dout, delta, static_cast<float*>(a.dk),
          static_cast<float*>(a.dv), a.seq_len, a.d, dh, a.heads, a.st, a.scale,
          a.vec);
    }
  } else {
    if (which == kFwd) {
      return launch_fwd_wgmma<DHP>(a);
    } else if (which == kDq) {
      constexpr int warps = kDqWarps<DHP>;
      auto kernel = bmha_dq_mma_kernel<DHP, warps, kDqPass<DHP>, kFragmentsResident<DHP>, kDqMinBlocks<DHP>>;
      constexpr size_t smem = mma_smem_bytes<DHP>(warps, 1);
      if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
      const dim3 tiles((a.seq_len + 16 * warps - 1) / (16 * warps), a.heads, a.batch);
      kernel<<<tiles, warps * 32, smem, a.stream>>>(
          q, k, v, bias, lse, dout, delta, static_cast<T*>(a.dq), a.seq_len, a.d, dh,
          a.heads, a.st, a.scale, a.vec);
    } else {
      constexpr int warps = kDkvWarps<DHP>;
      auto kernel = bmha_dkv_mma_kernel<DHP, warps, kDkvPass<DHP>, kFragmentsResident<DHP>, kDkvMinBlocks<DHP>>;
      constexpr size_t smem = mma_smem_bytes<DHP>(warps, 2);
      if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
      const dim3 tiles((a.seq_len + 16 * warps - 1) / (16 * warps), a.heads, a.batch);
      kernel<<<tiles, warps * 32, smem, a.stream>>>(
          q, k, v, bias, lse, dout, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
          a.seq_len, a.d, dh, a.heads, a.st, a.scale, a.vec);
    }
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(Which which, const Args& a) {
  const int dh = a.d / a.heads;
  if (dh <= 16) return launch_one<T, 16>(which, a);
  if (dh <= 32) return launch_one<T, 32>(which, a);
  if (dh <= 64) return launch_one<T, 64>(which, a);
  if (dh <= 128) return launch_one<T, 128>(which, a);
  return cudaErrorInvalidValue;  // the wrapper refuses Dh > 128 first
}

int run(Which which, int is_bf16, int device, const Args& a) {
  // this library links its own CUDA runtime: select the caller's device in it
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (a.batch == 0 || a.seq_len == 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(is_bf16 ? launch_dh<__nv_bfloat16>(which, a)
                                  : launch_dh<float>(which, a));
}

// what every entry fills alike; each then adds its own pointers
Args common_args(const void* q, const void* k, const void* v, const void* bias,
                 int batch, int seq_len, int d, int heads, long long q_sb,
                 long long q_sl, long long k_sb, long long k_sl, long long v_sb,
                 long long v_sl, float scale, int vec, void* stream) {
  Args a = {};
  a.q = q, a.k = k, a.v = v, a.bias = bias;
  a.batch = batch, a.seq_len = seq_len, a.d = d, a.heads = heads, a.vec = vec;
  a.head_stride = heads > 0 ? d / heads : 0;
  a.st = {q_sb, q_sl, k_sb, k_sl, v_sb, v_sl};
  a.scale = scale, a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// q, k, v: (B, L, D) through their batch and row strides (elements); bias
// (B, 1, 1, L) f32; out (B, L, D) and lse (B, L, H) f32 are written.
// vec (f32): 4-element loads are allowed (see load_tile). head_stride (bf16):
// the elements between two heads' first columns in q, k and v (D / H, or
// more in a padded copy); bf16 needs every base and stride (bytes) a
// multiple of 16 (tensor maps)
extern "C" int b4cp_bmha_fwd(const void* q, const void* k, const void* v,
                             const void* bias, void* out, void* lse,
                             int is_bf16, int batch, int seq_len, int d,
                             int heads, long long q_sb, long long q_sl,
                             long long k_sb, long long k_sl, long long v_sb,
                             long long v_sl, int head_stride, float scale, int vec,
                             int device, void* stream) {
  Args a = common_args(q, k, v, bias, batch, seq_len, d, heads, q_sb, q_sl, k_sb,
                       k_sl, v_sb, v_sl, scale, vec, stream);
  a.out = out, a.lse_out = lse, a.head_stride = head_stride;
  return run(kFwd, is_bf16, device, a);
}

// lse, delta: (B, L, H) f32; dout and dq: contiguous (B, L, D). vec: as
// above
extern "C" int b4cp_bmha_dq(const void* q, const void* k, const void* v,
                            const void* bias, const void* lse,
                            const void* dout, const void* delta, void* dq,
                            int is_bf16, int batch, int seq_len, int d,
                            int heads, long long q_sb, long long q_sl,
                            long long k_sb, long long k_sl, long long v_sb,
                            long long v_sl, float scale, int vec, int device,
                            void* stream) {
  Args a = common_args(q, k, v, bias, batch, seq_len, d, heads, q_sb, q_sl, k_sb,
                       k_sl, v_sb, v_sl, scale, vec, stream);
  a.lse_in = lse, a.dout = dout, a.delta = delta, a.dq = dq;
  return run(kDq, is_bf16, device, a);
}

// as b4cp_bmha_dq; dk and dv: contiguous (B, L, D)
extern "C" int b4cp_bmha_dkv(const void* q, const void* k, const void* v,
                             const void* bias, const void* lse,
                             const void* dout, const void* delta, void* dk,
                             void* dv, int is_bf16, int batch, int seq_len,
                             int d, int heads, long long q_sb, long long q_sl,
                             long long k_sb, long long k_sl, long long v_sb,
                             long long v_sl, float scale, int vec, int device,
                             void* stream) {
  Args a = common_args(q, k, v, bias, batch, seq_len, d, heads, q_sb, q_sl, k_sb,
                       k_sl, v_sb, v_sl, scale, vec, stream);
  a.lse_in = lse, a.dout = dout, a.delta = delta, a.dk = dk, a.dv = dv;
  return run(kDkv, is_bf16, device, a);
}
