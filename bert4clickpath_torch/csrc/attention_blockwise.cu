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
// GFLOP over ~34 MB of q/k/v/out: the forward is two products, dq three and
// dk/dv four, 60 GFLOP per layer in the backward.
//
// Two designs live here, chosen by the input type alone.
//
// (1) The forward (both types) and the f32 backward: scalar f32 FMA out of
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

#include <type_traits>

#include "attention_mma.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;           // query rows / keys per tile
constexpr int kPad = 4;             // floats of padding per shared-memory row
constexpr int kSs = kTile + kPad;   // row stride of a 64 x 64 score tile

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
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

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads, DHP <= 64 ? 2 : 1)
    bmha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    T* __restrict__ out, float* __restrict__ lse, int seq_len,
                    int d, int dh, int heads, Strides st, float scale,
                    int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RS = DHP + kPad;
  constexpr int NC = DHP / 16;
  float* qs = smem;
  float* ks = qs + kTile * RS;
  float* vs = ks + kTile * RS;
  float* ss = vs + kTile * RS;   // p, rounded to the input type
  float* bs = ss + kTile * kSs;  // this key tile's bias
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const T* kb = k + b * st.k_sb + h * dh;
  const T* vb = v + b * st.v_sb + h * dh;

  load_tile<T, DHP>(qs, q + b * st.q_sb + h * dh, st.q_sl, q0, seq_len, dh, vec);
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
    load_tile<T, DHP>(ks, kb, st.k_sl, k0, seq_len, dh, vec);
    load_tile<T, DHP>(vs, vb, st.v_sl, k0, seq_len, dh, vec);
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
        ss[(ty + 16 * i) * kSs + tx + 16 * j] = round_to<T>(p);
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
  store_rows<T, NC>(out, acc, base, q0, seq_len, d, dh, ty, tx);
}

// The f32 backward: the scalar design of the forward (see the header).

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
  Strides st;
  float scale;
  cudaStream_t stream;
};

enum Which { kFwd, kDq, kDkv };

// The forward in either type, and the backward by type: scalar f32 kernels
// for float, the tensor-core kernels for bf16.
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
  if (which == kFwd) {
    constexpr size_t smem = smem_bytes<DHP>(3, 1, kTile);
    if ((err = allow_smem(bmha_fwd_kernel<T, DHP>, smem)) != cudaSuccess) return err;
    bmha_fwd_kernel<T, DHP><<<grid, kThreads, smem, a.stream>>>(
        q, k, v, bias, static_cast<T*>(a.out), static_cast<float*>(a.lse_out),
        a.seq_len, a.d, dh, a.heads, a.st, a.scale, a.vec);
  } else if constexpr (std::is_same<T, float>::value) {
    if (which == kDq) {
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
    if (which == kDq) {
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
  a.st = {q_sb, q_sl, k_sb, k_sl, v_sb, v_sl};
  a.scale = scale, a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// q, k, v: (B, L, D) through their batch and row strides (elements); bias
// (B, 1, 1, L) f32; out (B, L, D) and lse (B, L, H) f32 are written.
// vec: 4-element loads are allowed (see load_tile)
extern "C" int b4cp_bmha_fwd(const void* q, const void* k, const void* v,
                             const void* bias, void* out, void* lse,
                             int is_bf16, int batch, int seq_len, int d,
                             int heads, long long q_sb, long long q_sl,
                             long long k_sb, long long k_sl, long long v_sb,
                             long long v_sl, float scale, int vec, int device,
                             void* stream) {
  Args a = common_args(q, k, v, bias, batch, seq_len, d, heads, q_sb, q_sl, k_sb,
                       k_sl, v_sb, v_sl, scale, vec, stream);
  a.out = out, a.lse_out = lse;
  return run(kFwd, is_bf16, device, a);
}

// lse, delta: (B, L, H) f32; dout and dq: contiguous (B, L, D). vec: f32
// as above; bf16: 8-element (16-byte) copies and paired stores are allowed
// (see tc::fill_tile)
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
