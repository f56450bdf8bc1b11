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
// (1), bf16 inputs (2) (the backward) and (3) (the forward, whose pieces (2)
// shares, so its code comes first).
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
// (2) The bf16 backward (bmha_dq_wgmma_kernel, bmha_dkv_wgmma_kernel),
// built as the forward (3) is and on its pieces: persistent blocks, one an
// SM, of one producer warpgroup and two consumer warpgroups of 64 rows; one
// producer thread keeps TMA loads in flight into a ring of mbarrier-guarded
// stages; every product is a wgmma. A unit is 128 rows of one (head, batch
// row), walked as the forward walks its units (FwdUnit): query rows in dq,
// keys in dk/dv, so one block owns its output rows (no atomics; two runs
// give the same bits). Both kernels read q, k, v and do through one set of
// rank-4 tensor maps with boxes of 64 rows, encoded once a backward call
// (a 128-row tile is two boxes), so rows past seq_len and columns past dh
// arrive as zeros.
//   dq: Q and dO of the unit stay (kDqQBuffers buffers, so that the next
// unit's land while this one runs); the forward's stages of 128 keys walk
// past, K and V with their bias box. Per stage a consumer warpgroup starts
// S = Q K^T and dP = dO V^T (m64n128k16, both operands K-major in shared
// memory, each product's first k-step write-only) as one group, reads the
// stage's bias while they run (keys past seq_len: -inf, so p = 0; the box
// holds the next batch row's bias there), then on the accumulator
// fragments p = exp(fma(s, scale, bias) - lse) and ds = p (dp - delta)
// scale in f32, ds rounded to bf16 in place into the A fragments of dQ +=
// dS K (m64n{Dh'}k16, A from registers; B the K tile as it lies, MN-major
// through make_desc_mn, as the forward reads V). lse and delta of the
// thread's two rows are read once a unit with plain loads.
//   dk/dv: K, V and the keys' bias of the unit stay; Q and dO walk past in
// stages of kDkvWalk rows (128; 64 at Dh' = 128, where dK and dV alone hold
// 128 registers a thread). The products are transposed: S^T = K Q^T and
// dP^T = V dO^T (m64n{kDkvWalk}k16, both from shared memory), so that p^T
// (rounded to bf16) and ds^T are the A fragments of dV += P^T dO and dK +=
// dS^T Q, dO and Q read MN-major as they lie. lse and delta are (B, L, H):
// one head's rows are H floats apart, which no TMA box describes (its inner
// extent is a multiple of 16 bytes), so one warp of the producer warpgroup
// copies each stage's with plain loads and arrives on the stage's barrier
// with the TMA thread; a row past seq_len gets lse = +inf and delta = 0, so
// its p is exactly 0 (its Q and dO rows are zeros).
// In both, a stage's last products (dQ; dV and dK) run on while the
// warpgroup waits for the next stage and starts its score products, which
// are waited for with them; the stage is released then. s - lse stays a
// subtraction after s = fma(q.k, scale, bias): a
// fully padded row (bias and lse -1e9) gets p = 1 at every key, as in the
// plain version. The gradients are summed in f32 registers over all stages
// and rounded once. The bf16 products' operands are bf16, the p, ds and
// their exponentials f32 (__expf, the fast one).
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
// _tma_operands, for (2) and (3) alike); the main paths make none.

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

// The block of the TMA + wgmma kernels (two consumer warpgroups, one
// producer warpgroup) and their tiles: a tile of ROWS rows of one head is
// ROWS x Dh' bf16 as TMA writes it, column boxes of kBoxCols (one swizzled
// row of 128, 64 or 32 bytes), each box ROWS x kRowBytes on a 1,024-byte
// boundary.
template <int DHP>
struct HeadTile {
  static constexpr int kConsumers = 256;
  static constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
  static constexpr int kBoxCols = DHP < 64 ? DHP : 64;
  static constexpr int kRowBytes = kBoxCols * 2;
  static constexpr int kBoxes = DHP / kBoxCols;
  static constexpr hopper::Swizzle kSwizzle = hopper::swizzle_of<kRowBytes>();
  static constexpr uint32_t kGroup = 8 * kRowBytes;  // 8 rows of a box: the descriptors' stride
  template <int ROWS>
  static constexpr int box() { return ROWS * kRowBytes; }
  template <int ROWS>
  static constexpr int tile() { return kBoxes * ROWS * kRowBytes; }
};

// Shared memory of one block of the forward: kFwdQBuffers Q tiles, then
// kFwdStages stages of a K and a V tile, each stage's bias box, then the
// barriers.
template <int DHP>
struct FwdLayout : HeadTile<DHP> {
  using T = HeadTile<DHP>;
  static constexpr int kQBox = T::template box<kFwdRows>();      // one column box of Q
  static constexpr int kBoxBytes = T::template box<kFwdKeys>();  // one column box of K or V
  static constexpr int kQTile = T::template tile<kFwdRows>();
  static constexpr int kTile = T::template tile<kFwdKeys>();
  static constexpr int kStages = kFwdStages<DHP>;
  static constexpr int kQ = kFwdQBuffers * kQTile;
  static constexpr int kBias = kQ + kStages * 2 * kTile;  // each stage's bias box
  static constexpr int kRing = kBias + kStages * kFwdBiasSlot;
  static constexpr int kStageBytes = 2 * kTile + kFwdBiasBox * 4;  // what TMA completes on a stage's barrier
  static constexpr size_t kSmem = kRing + (2 * kFwdQBuffers + 2 * kStages) * sizeof(uint64_t) + 1024;  // + alignment
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
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
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

// the thread's keys' bias (8 nb + 2t + e of the stage at k0) times `unit`
// (the forward's log2(e); 1 in the backward) from the stage's box, whose
// first `shift` values precede the stage (one address across a quad's
// rows); in the ragged last stage a key past seq_len (the box holds the
// next batch row's bias there) gets -inf, so p = 0
__device__ __forceinline__ void load_bias(float (&bj)[kFwdKeys / 4], const float* bias_s, int shift, int k0,
                                          int seq_len, int t, float unit) {
  const float* at = bias_s + shift + 2 * t;
#pragma unroll
  for (int nb = 0; nb < kFwdKeys / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) bj[2 * nb + e] = at[nb * 8 + e] * unit;
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
                  seq_len, t, kLog2e);
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

// The bf16 backward on Hopper's TMA and wgmma (design (2) of the header),
// on the forward's pieces: its unit walk (FwdUnit), its stage of 128 keys
// with the bias box (dq), load_bias, fence_frags.

constexpr int kBwdRows = 128;    // rows a unit owns: query rows (dq) or keys (dk/dv), two warpgroups of 64
constexpr int kBwdBoxRows = 64;  // rows of a box of the backward's tensor maps: one set of maps serves both kernels

// Found on the card at the long-session shape (PERF.md; copies of this
// source with other values: examples/long_context/tune_blockwise_bwd.py
// --kernel dq|dkv). Dq: the K/V stages of 128 keys in the ring and the
// Q + dO buffers (a 128-row Q tile and a dO tile each). Dkv: the query rows
// of a walked Q/dO stage (the N of S^T = K Q^T; 64 at Dh' = 128, where dK
// and dV alone hold 128 registers a thread), its stages, and the K + V
// buffers. Regs: the setmaxnreg split, 128 x producer + 256 x consumer <=
// 65,536.
template <int DHP>
constexpr int kDqStages = DHP == 128 ? 2 : 4;
template <int DHP>
constexpr int kDqQBuffers = DHP == 128 ? 1 : 2;
template <int DHP>
constexpr int kDkvWalk = DHP == 128 ? 64 : 128;
template <int DHP>
constexpr int kDkvStages = 4;
template <int DHP>
constexpr int kDkvKvBuffers = DHP == 128 ? 1 : 2;
constexpr int kBwdProducerRegs = 40;
constexpr int kBwdConsumerRegs = 232;

// dq's shared memory: kDqQBuffers x (Q tile, dO tile) of 128 rows, then
// kDqStages stages of a K and a V tile of 128 keys, each stage's bias box,
// then the barriers
template <int DHP>
struct DqLayout : HeadTile<DHP> {
  using T = HeadTile<DHP>;
  static constexpr int kStages = kDqStages<DHP>;
  static constexpr int kQBuffers = kDqQBuffers<DHP>;
  static constexpr int kBox = T::template box<kBwdRows>();
  static constexpr int kTile = T::template tile<kBwdRows>();
  static constexpr int kRing = kQBuffers * 2 * kTile;
  static constexpr int kBias = kRing + kStages * 2 * kTile;
  static constexpr int kBars = kBias + kStages * kFwdBiasSlot;
  static constexpr int kStageBytes = 2 * kTile + kFwdBiasBox * 4;  // what TMA completes on a stage's barrier
  static constexpr size_t kSmem = kBars + (2 * kQBuffers + 2 * kStages) * sizeof(uint64_t) + 1024;
  static_assert(kFwdKeys == kBwdRows, "a dq stage is the forward's 128 keys");
  static_assert(T::template box<kBwdBoxRows>() % 1024 == 0, "boxes on 1,024-byte boundaries");
};

// dk/dv's shared memory: kDkvKvBuffers x (K tile, V tile) of 128 keys, then
// kDkvStages stages of a Q and a dO tile of kDkvWalk rows, each stage's lse
// and delta rows (f32, kDkvWalk each), then the barriers
template <int DHP>
struct DkvLayout : HeadTile<DHP> {
  using T = HeadTile<DHP>;
  static constexpr int kWalk = kDkvWalk<DHP>;
  static constexpr int kStages = kDkvStages<DHP>;
  static constexpr int kKvBuffers = kDkvKvBuffers<DHP>;
  static constexpr int kKvBox = T::template box<kBwdRows>();
  static constexpr int kKvTile = T::template tile<kBwdRows>();
  static constexpr int kWBox = T::template box<kWalk>();
  static constexpr int kWTile = T::template tile<kWalk>();
  static constexpr int kRing = kKvBuffers * 2 * kKvTile;
  static constexpr int kRows = kRing + kStages * 2 * kWTile;
  static constexpr int kBars = kRows + kStages * 2 * kWalk * 4;
  static constexpr int kStageBytes = 2 * kWTile;  // what TMA completes on a stage's barrier
  static constexpr size_t kSmem = kBars + (2 * kKvBuffers + 2 * kStages) * sizeof(uint64_t) + 1024;
  static_assert(kWalk % kBwdBoxRows == 0 && kWalk % 32 == 0, "a stage is whole boxes; one lane copies W / 32 rows");
};

// rows [row0, row0 + ROWS) of head h of batch row b through a map of the
// backward (boxes of kBwdBoxRows rows x kBoxCols columns) into a tile whose
// column boxes are ROWS x kRowBytes apart, completing on bar; zero past
// seq_len and dh
template <int DHP, int ROWS>
__device__ __forceinline__ void load_rows(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int h, int row0,
                                          int b) {
  using T = HeadTile<DHP>;
#pragma unroll
  for (int c = 0; c < T::kBoxes; ++c)
#pragma unroll
    for (int r = 0; r < ROWS; r += kBwdBoxRows)
      hopper::tma_load_4d(dst + (c * ROWS + r) * T::kRowBytes, map, bar, c * T::kBoxCols, h, row0 + r, b);
}

// the warpgroup's rows of a 64 x Dh' accumulator (the thread's: row0 and
// row0 + 8), rounded once to bf16, into a contiguous (B, L, D) tensor at
// out_bh (batch row and head applied); rows past seq_len are not stored
template <int DHP>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* __restrict__ out_bh, const float (&acc)[DHP / 2],
                                                int row0, int seq_len, int d, int dh, int t, int paired) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= seq_len) continue;
    __nv_bfloat16* orow = out_bh + static_cast<long long>(row) * d;
#pragma unroll
    for (int nt = 0; nt < DHP / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      const float lo = acc[4 * nt + 2 * r], hi = acc[4 * nt + 2 * r + 1];
      if (paired) {
        if (col < dh) *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(lo, hi);
      } else {
        if (col < dh) orow[col] = __float2bfloat16_rn(lo);
        if (col + 1 < dh) orow[col + 1] = __float2bfloat16_rn(hi);
      }
    }
  }
}

// acc (64 x N) = A . B^T over Dh', both operands K-major in column boxes
// A_BOX and B_BOX bytes apart (a_desc: the warpgroup's 64 rows; b_desc: N
// rows), started, not committed; the first k-step writes acc without
// reading it (no instruction before it defines an input of the product)
template <int DHP, int N, int A_BOX, int B_BOX>
__device__ __forceinline__ void ss_product(float (&acc)[N / 2], uint64_t a_desc, uint64_t b_desc) {
  constexpr int kRow = HeadTile<DHP>::kRowBytes;
  hopper::wgmma_bf16_ss<N, true>(acc, a_desc, b_desc);
#pragma unroll
  for (int ks = 1; ks < DHP / 16; ++ks) {
    constexpr int kStep = 32;  // bytes of 16 head columns
    const int col = ks * kStep;
    hopper::wgmma_bf16_ss<N, false>(acc, a_desc + (((col / kRow) * A_BOX + col % kRow) >> 4),
                                    b_desc + (((col / kRow) * B_BOX + col % kRow) >> 4));
  }
}

// acc (64 x Dh') += A . B, A (64 x K bf16) in registers, K / 16 k-steps,
// B (K x Dh') a tile as it lies, [row][head column]: MN-major through b_desc
// (make_desc_mn), 16 rows a k-step; started, not committed
template <int DHP, int K>
__device__ __forceinline__ void rs_product(float (&acc)[DHP / 2], const uint32_t (&af)[K / 16][4], uint64_t b_desc) {
  constexpr int kRow = HeadTile<DHP>::kRowBytes;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) hopper::wgmma_bf16_tb<DHP>(acc, af[kk], b_desc + ((kk * 16 * kRow) >> 4), 1);
}

// One unit = (128 query rows, head, batch row): Q and dO stay, the K and V
// stages of the forward walk past with their bias.
template <int DHP>
__global__ void __launch_bounds__(HeadTile<DHP>::kThreads, 1)
    bmha_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                         const __grid_constant__ CUtensorMap bias_map, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int seq_len, int d, int dh,
                         int heads, int units, float scale, int paired) {
  using S = DqLayout<DHP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::kBars);  // Q and dO landed
  uint64_t* q_empty = q_full + S::kQBuffers;                          // Q and dO read by every consumer
  uint64_t* full = q_empty + S::kQBuffers;                            // K, V and bias landed
  uint64_t* empty = full + S::kStages;                                // K and V read by every consumer
  const int q_tiles = (seq_len + kBwdRows - 1) / kBwdRows;
  const int n_tiles = (seq_len + kFwdKeys - 1) / kFwdKeys;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S::kQBuffers; ++i) {
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
    hopper::reg_dealloc<kBwdProducerRegs>();
    if (threadIdx.x == S::kConsumers) {
      hopper::prefetch_map(&q_map);
      hopper::prefetch_map(&k_map);
      hopper::prefetch_map(&v_map);
      hopper::prefetch_map(&do_map);
      hopper::prefetch_map(&bias_map);
      int i = 0, n = 0;  // the block's stages and units so far
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
        const FwdUnit unit(u, q_tiles, heads);
        const int qb = n % S::kQBuffers;
        hopper::mbar_wait(q_empty + qb, ((n / S::kQBuffers) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(q_full + qb, 2 * S::kTile);
        unsigned char* qs = smem + qb * 2 * S::kTile;
        load_rows<DHP, kBwdRows>(qs, &q_map, q_full + qb, unit.h, unit.q0, unit.b);
        load_rows<DHP, kBwdRows>(qs + S::kTile, &do_map, q_full + qb, unit.h, unit.q0, unit.b);
        for (int j = 0; j < n_tiles; ++j, ++i) {
          const int st = i % S::kStages;
          hopper::mbar_wait(empty + st, ((i / S::kStages) & 1) ^ 1);
          unsigned char* stage = smem + S::kRing + st * 2 * S::kTile;
          hopper::mbar_arrive_expect_tx(full + st, S::kStageBytes);
          hopper::tma_load_1d(smem + S::kBias + st * kFwdBiasSlot, &bias_map, full + st,
                              (unit.b * seq_len + j * kFwdKeys) & ~3);
          load_rows<DHP, kFwdKeys>(stage, &k_map, full + st, unit.h, j * kFwdKeys, unit.b);
          load_rows<DHP, kFwdKeys>(stage + S::kTile, &v_map, full + st, unit.h, j * kFwdKeys, unit.b);
        }
      }
    }
  } else {
    // ----------------------------------------------- consumer warpgroups
    hopper::reg_alloc<kBwdConsumerRegs>();
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    // S and dP of a stage: rows 16 warp + g (s[4j], s[4j + 1]) and + 8
    // (s[4j + 2], s[4j + 3]) of the warpgroup's 64, keys 8j + 2t, + 1; dQ the
    // same layout over head columns
    float s[64], dp[64];
    float acc[DHP / 2];
    // stage 0's K (K-major for S, MN-major for dQ += dS K) and V (K-major
    // for dP); stage st is 2 st kTile bytes on
    const uint32_t ring = hopper::smem_addr(smem + S::kRing);
    const uint64_t k_desc0 = hopper::make_desc(ring, S::kSwizzle, S::kGroup);
    const uint64_t v_desc0 = hopper::make_desc(ring + S::kTile, S::kSwizzle, S::kGroup);
    const uint64_t k_mn_desc0 = hopper::make_desc_mn(ring, S::kSwizzle, S::kBox, S::kGroup);
    int i = 0, n = 0;  // the block's stages and units so far
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
      const FwdUnit unit(u, q_tiles, heads);
      const int qb = n % S::kQBuffers;
      const int shift = (unit.b * seq_len) & 3;  // the bias boxes' values before each stage
      // the thread's two rows' lse and delta (a row past seq_len is computed
      // on zero Q and dO rows, so its ds is 0, and never stored)
      const int row0 = unit.q0 + wg * 64 + warp * 16 + g;
      float lse_r[2], delta_r[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const long long at = (static_cast<long long>(unit.b) * seq_len + row) * heads + unit.h;
        lse_r[r] = row < seq_len ? lse[at] : 0.f;
        delta_r[r] = row < seq_len ? delta[at] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < DHP / 2; ++e) acc[e] = 0.f;
      hopper::mbar_wait(q_full + qb, (n / S::kQBuffers) & 1);
      const uint32_t qs = hopper::smem_addr(smem + qb * 2 * S::kTile) + wg * 64 * S::kRowBytes;
      const uint64_t q_desc = hopper::make_desc(qs, S::kSwizzle, S::kGroup);
      const uint64_t do_desc = hopper::make_desc(qs + S::kTile, S::kSwizzle, S::kGroup);
      for (int j = 0; j < n_tiles; ++j, ++i) {
        const int st = i % S::kStages;
        const uint32_t stage_off = (st * 2 * S::kTile) >> 4;
        hopper::mbar_wait(full + st, (i / S::kStages) & 1);
        hopper::wgmma_fence();
        ss_product<DHP, kFwdKeys, S::kBox, S::kBox>(s, q_desc, k_desc0 + stage_off);
        ss_product<DHP, kFwdKeys, S::kBox, S::kBox>(dp, do_desc, v_desc0 + stage_off);
        hopper::wgmma_commit();
        float bj[kFwdKeys / 4];  // read while the products run
        load_bias(bj, reinterpret_cast<const float*>(smem + S::kBias + st * kFwdBiasSlot), shift, j * kFwdKeys,
                  seq_len, t, 1.f);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        if (j > 0) hopper::mbar_arrive(empty + (i - 1) % S::kStages);  // its dQ product is done
        if (j == n_tiles - 1) hopper::mbar_arrive(q_empty + qb);  // the unit's last read of Q and dO
        // p = exp(s * scale + bias - lse) and ds = p (dp - delta) scale in
        // f32, ds rounded to bf16 into the A fragments of dQ += dS K (n8
        // blocks 2kk and 2kk + 1 are k-step kk, as the forward packs P)
        uint32_t dsf[kFwdKeys / 16][4];
#pragma unroll
        for (int nb = 0; nb < kFwdKeys / 8; ++nb) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * nb + 2 * r + e;
              const float p = __expf(fmaf(s[x], scale, bj[2 * nb + e]) - lse_r[r]);
              ds[e] = p * (dp[x] - delta_r[r]) * scale;
            }
            dsf[nb >> 1][(nb & 1) * 2 + r] = tc::pack_bf16(ds[0], ds[1]);
          }
        }
        fence_frags(dsf);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
        rs_product<DHP, kFwdKeys>(acc, dsf, k_mn_desc0 + stage_off);
        hopper::wgmma_commit();
        if (j == n_tiles - 1) {  // else it runs on while the next stage's products start
          hopper::wgmma_wait<0>();
          hopper::fence_regs(acc);
          hopper::mbar_arrive(empty + st);
        }
      }
      store_rows_bf16<DHP>(dq + static_cast<long long>(unit.b) * seq_len * d + unit.h * dh, acc, row0, seq_len, d,
                           dh, t, paired);
    }
  }
}

// One unit = (128 keys, head, batch row): K, V and the keys' bias stay, the
// Q and dO stages walk past with their rows' lse and delta; the scores are
// computed transposed (rows = keys), so that p^T and ds^T arrive in the
// layout of the A operand of dV += P^T dO and dK += dS^T Q.
template <int DHP>
__global__ void __launch_bounds__(HeadTile<DHP>::kThreads, 1)
    bmha_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ bias, const float* __restrict__ lse,
                          const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int seq_len, int d, int dh, int heads, int units,
                          float scale, int paired) {
  using S = DkvLayout<DHP>;
  constexpr int W = S::kWalk;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::kBars);  // K and V landed
  uint64_t* kv_empty = kv_full + S::kKvBuffers;                       // K and V read by every consumer
  uint64_t* full = kv_empty + S::kKvBuffers;                          // Q, dO, lse and delta landed
  uint64_t* empty = full + S::kStages;                                // Q and dO read by every consumer
  const int k_tiles = (seq_len + kBwdRows - 1) / kBwdRows;
  const int n_walk = (seq_len + W - 1) / W;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S::kKvBuffers; ++i) {
      hopper::mbar_init(kv_full + i, 1);
      hopper::mbar_init(kv_empty + i, S::kConsumers);
    }
    for (int i = 0; i < S::kStages; ++i) {
      hopper::mbar_init(full + i, 1 + 32);  // the TMA thread and the warp that copies lse and delta
      hopper::mbar_init(empty + i, S::kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------ producer warpgroup
    hopper::reg_dealloc<kBwdProducerRegs>();
    const int pwarp = (threadIdx.x - S::kConsumers) / 32;
    if (threadIdx.x == S::kConsumers) {
      hopper::prefetch_map(&q_map);
      hopper::prefetch_map(&k_map);
      hopper::prefetch_map(&v_map);
      hopper::prefetch_map(&do_map);
      int i = 0, n = 0;  // the block's stages and units so far
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
        const FwdUnit unit(u, k_tiles, heads);
        const int kb = n % S::kKvBuffers;
        hopper::mbar_wait(kv_empty + kb, ((n / S::kKvBuffers) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(kv_full + kb, 2 * S::kKvTile);
        unsigned char* kvs = smem + kb * 2 * S::kKvTile;
        load_rows<DHP, kBwdRows>(kvs, &k_map, kv_full + kb, unit.h, unit.q0, unit.b);
        load_rows<DHP, kBwdRows>(kvs + S::kKvTile, &v_map, kv_full + kb, unit.h, unit.q0, unit.b);
        for (int j = 0; j < n_walk; ++j, ++i) {
          const int st = i % S::kStages;
          hopper::mbar_wait(empty + st, ((i / S::kStages) & 1) ^ 1);
          unsigned char* stage = smem + S::kRing + st * 2 * S::kWTile;
          hopper::mbar_arrive_expect_tx(full + st, S::kStageBytes);
          load_rows<DHP, W>(stage, &q_map, full + st, unit.h, j * W, unit.b);
          load_rows<DHP, W>(stage + S::kWTile, &do_map, full + st, unit.h, j * W, unit.b);
        }
      }
    } else if (pwarp == 1) {
      // lse and delta are (B, L, H): one head's rows are H floats apart,
      // which no TMA box describes (its inner extent is a multiple of 16
      // bytes), so this warp copies them with plain loads. A row past
      // seq_len gets lse = +inf and delta = 0, so its p is exactly 0 (its Q
      // and dO rows are zeros): nothing of the next batch row is read.
      const int lane = threadIdx.x % 32;
      int i = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const FwdUnit unit(u, k_tiles, heads);
        const long long at = static_cast<long long>(unit.b) * seq_len * heads + unit.h;
        for (int j = 0; j < n_walk; ++j, ++i) {
          const int st = i % S::kStages;
          hopper::mbar_wait(empty + st, ((i / S::kStages) & 1) ^ 1);
          float* rows = reinterpret_cast<float*>(smem + S::kRows) + st * 2 * W;
#pragma unroll
          for (int r = lane; r < W; r += 32) {
            const int row = j * W + r;
            const bool in = row < seq_len;
            rows[r] = in ? lse[at + static_cast<long long>(row) * heads] : INFINITY;
            rows[W + r] = in ? delta[at + static_cast<long long>(row) * heads] : 0.f;
          }
          hopper::mbar_arrive(full + st);  // release: the stores are seen by whoever waits on the phase
        }
      }
    }
  } else {
    // ----------------------------------------------- consumer warpgroups
    hopper::reg_alloc<kBwdConsumerRegs>();
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    // S^T and dP^T of a stage: key rows 16 warp + g and + 8 of the
    // warpgroup's 64, query rows 8j + 2t, + 1 of the stage; dK and dV the
    // same rows over head columns
    float sT[W / 2], dpT[W / 2];
    float acc_k[DHP / 2], acc_v[DHP / 2];
    // stage 0's Q and dO (K-major for S^T and dP^T, MN-major for dK and dV);
    // stage st is 2 st kWTile bytes on
    const uint32_t ring = hopper::smem_addr(smem + S::kRing);
    const uint64_t q_desc0 = hopper::make_desc(ring, S::kSwizzle, S::kGroup);
    const uint64_t do_desc0 = hopper::make_desc(ring + S::kWTile, S::kSwizzle, S::kGroup);
    const uint64_t q_mn_desc0 = hopper::make_desc_mn(ring, S::kSwizzle, S::kWBox, S::kGroup);
    const uint64_t do_mn_desc0 = hopper::make_desc_mn(ring + S::kWTile, S::kSwizzle, S::kWBox, S::kGroup);
    int i = 0, n = 0;  // the block's stages and units so far
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
      const FwdUnit unit(u, k_tiles, heads);
      const int kb = n % S::kKvBuffers;
      // the thread's two keys' bias (a key past seq_len: -inf, so p = 0;
      // never stored)
      const int key0 = unit.q0 + wg * 64 + warp * 16 + g;
      float bias_r[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        bias_r[r] = key < seq_len ? bias[static_cast<long long>(unit.b) * seq_len + key] : -INFINITY;
      }
#pragma unroll
      for (int e = 0; e < DHP / 2; ++e) acc_k[e] = acc_v[e] = 0.f;
      hopper::mbar_wait(kv_full + kb, (n / S::kKvBuffers) & 1);
      const uint32_t kvs = hopper::smem_addr(smem + kb * 2 * S::kKvTile) + wg * 64 * S::kRowBytes;
      const uint64_t k_desc = hopper::make_desc(kvs, S::kSwizzle, S::kGroup);
      const uint64_t v_desc = hopper::make_desc(kvs + S::kKvTile, S::kSwizzle, S::kGroup);
      for (int j = 0; j < n_walk; ++j, ++i) {
        const int st = i % S::kStages;
        const uint32_t stage_off = (st * 2 * S::kWTile) >> 4;
        hopper::mbar_wait(full + st, (i / S::kStages) & 1);
        hopper::wgmma_fence();
        ss_product<DHP, W, S::kKvBox, S::kWBox>(sT, k_desc, q_desc0 + stage_off);
        ss_product<DHP, W, S::kKvBox, S::kWBox>(dpT, v_desc, do_desc0 + stage_off);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sT);
        hopper::fence_regs(dpT);
        if (j > 0) hopper::mbar_arrive(empty + (i - 1) % S::kStages);  // its dV, dK products are done
        if (j == n_walk - 1) hopper::mbar_arrive(kv_empty + kb);  // the unit's last read of K and V
        // p^T and ds^T on the accumulator fragments: p rounded to bf16 for
        // dV, ds from the f32 p rounded for dK; the stage's lse and delta
        // read per query-row pair
        const float* ls = reinterpret_cast<const float*>(smem + S::kRows) + st * 2 * W;
        uint32_t pf[W / 16][4], dsf[W / 16][4];
#pragma unroll
        for (int nb = 0; nb < W / 8; ++nb) {
          const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * nb + 2 * t);
          const float2 d2 = *reinterpret_cast<const float2*>(ls + W + 8 * nb + 2 * t);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float p[2], ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * nb + 2 * r + e;
              p[e] = __expf(fmaf(sT[x], scale, bias_r[r]) - (e ? l2.y : l2.x));
              ds[e] = p[e] * (dpT[x] - (e ? d2.y : d2.x)) * scale;
            }
            pf[nb >> 1][(nb & 1) * 2 + r] = tc::pack_bf16(p[0], p[1]);
            dsf[nb >> 1][(nb & 1) * 2 + r] = tc::pack_bf16(ds[0], ds[1]);
          }
        }
        fence_frags(pf);
        fence_frags(dsf);
        hopper::fence_regs(acc_v);
        hopper::fence_regs(acc_k);
        hopper::wgmma_fence();
        rs_product<DHP, W>(acc_v, pf, do_mn_desc0 + stage_off);
        rs_product<DHP, W>(acc_k, dsf, q_mn_desc0 + stage_off);
        hopper::wgmma_commit();
        if (j == n_walk - 1) {  // else they run on while the next stage's products start
          hopper::wgmma_wait<0>();
          hopper::fence_regs(acc_v);
          hopper::fence_regs(acc_k);
          hopper::mbar_arrive(empty + st);
        }
      }
      const long long base = static_cast<long long>(unit.b) * seq_len * d + unit.h * dh;
      store_rows_bf16<DHP>(dv + base, acc_v, key0, seq_len, d, dh, t, paired);
      store_rows_bf16<DHP>(dk + base, acc_k, key0, seq_len, d, dh, t, paired);
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

// what an entry asks for: the forward, or a mask of the backward's kernels
enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

struct Args {
  const void *q, *k, *v, *bias, *lse_in, *dout, *delta;
  void *out, *lse_out, *dq, *dk, *dv;
  int batch, seq_len, d, heads, vec;
  int head_stride;  // elements between the heads of q, k, v and dout (the bf16 kernels' maps)
  Strides st;
  long long do_sb, do_sl;  // dout's batch and row strides (the bf16 backward's map)
  float scale;
  cudaStream_t stream;
};

// A rank-4 tensor map of a bf16 (B, L, H x head_stride) operand at base
// over (head column, head, row, batch), boxes of box_cols x 1 x box_rows x
// 1 with the swizzle of box_cols' rows, zero past dh and past seq_len.
// Every base and stride must be a multiple of 16 bytes (the wrapper hands
// over a copy where one is not).
template <int ROW_BYTES>
cudaError_t encode_head_map(CUtensorMap* map, const void* base, const Args& a, long long batch_stride,
                            long long row_stride, uint32_t box_rows) {
  const int dh = a.d / a.heads;
  const uint64_t dims[4] = {static_cast<uint64_t>(dh), static_cast<uint64_t>(a.heads),
                            static_cast<uint64_t>(a.seq_len), static_cast<uint64_t>(a.batch)};
  const uint64_t strides[3] = {static_cast<uint64_t>(a.head_stride) * 2, static_cast<uint64_t>(row_stride) * 2,
                               static_cast<uint64_t>(batch_stride) * 2};
  const uint32_t box[4] = {ROW_BYTES / 2, 1, box_rows, 1};
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || strides[0] % 16 != 0 || strides[1] % 16 != 0 ||
      strides[2] % 16 != 0 || a.head_stride < dh)
    return cudaErrorInvalidValue;
  return hopper::encode_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box,
                           hopper::tma_swizzle_of<ROW_BYTES>());
}

// The bias as one row of B L f32: a stage's box starts at b L + k0 rounded
// down to a multiple of 4 (past the batch row's end it holds the next row's
// bias, masked by the consumers)
cudaError_t encode_bias_map(CUtensorMap* map, const Args& a) {
  if (reinterpret_cast<uintptr_t>(a.bias) % 16 != 0) return cudaErrorInvalidValue;
  const uint64_t dims[1] = {static_cast<uint64_t>(a.batch) * a.seq_len};
  const uint32_t box[1] = {kFwdBiasBox};
  return hopper::encode_1d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.bias, dims, box);
}

// one persistent block an SM (the ring takes most of its shared memory),
// over `units`
cudaError_t persistent_grid(long long units, int* grid) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (units > INT_MAX) return cudaErrorInvalidValue;
  *grid = static_cast<int>(min(units, static_cast<long long>(sms)));
  return cudaSuccess;
}

// The bf16 forward: maps of q, k and v with boxes of 128 rows (a Q tile or
// a stage's keys) and of the bias; one persistent block an SM over the
// units.
template <int DHP>
cudaError_t launch_fwd_wgmma(const Args& a) {
  using S = FwdLayout<DHP>;
  const int dh = a.d / a.heads;
  CUtensorMap q_map, k_map, v_map, bias_map;
  cudaError_t err = encode_head_map<S::kRowBytes>(&q_map, a.q, a, a.st.q_sb, a.st.q_sl, kFwdRows);
  if (err == cudaSuccess) err = encode_head_map<S::kRowBytes>(&k_map, a.k, a, a.st.k_sb, a.st.k_sl, kFwdKeys);
  if (err == cudaSuccess) err = encode_head_map<S::kRowBytes>(&v_map, a.v, a, a.st.v_sb, a.st.v_sl, kFwdKeys);
  if (err == cudaSuccess) err = encode_bias_map(&bias_map, a);
  auto kernel = bmha_fwd_wgmma_kernel<DHP>;
  if (err == cudaSuccess) err = allow_smem(kernel, S::kSmem);
  const long long units = static_cast<long long>((a.seq_len + kFwdRows - 1) / kFwdRows) * a.heads * a.batch;
  int grid = 0;
  if (err == cudaSuccess) err = persistent_grid(units, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, S::kThreads, S::kSmem, a.stream>>>(
      q_map, k_map, v_map, bias_map, static_cast<__nv_bfloat16*>(a.out),
      static_cast<float*>(a.lse_out), a.seq_len, a.d, dh, a.heads, static_cast<int>(units), a.scale,
      dh % 2 == 0 && a.d % 2 == 0);
  return cudaGetLastError();
}

// The bf16 backward: maps of q, k, v and dout with boxes of kBwdBoxRows
// rows (both kernels load whole boxes: 128-row tiles and stages, or 64-row
// stages), encoded once for both kernels, and of the bias (dq); dq (which &
// kDq) then dk/dv (which & kDkv), each on one persistent block an SM over
// its units of 128 rows.
template <int DHP>
cudaError_t launch_bwd_wgmma(const Args& a, int which) {
  using T = HeadTile<DHP>;
  const int dh = a.d / a.heads;
  const int paired = dh % 2 == 0 && a.d % 2 == 0;
  CUtensorMap q_map, k_map, v_map, do_map, bias_map;
  cudaError_t err = encode_head_map<T::kRowBytes>(&q_map, a.q, a, a.st.q_sb, a.st.q_sl, kBwdBoxRows);
  if (err == cudaSuccess) err = encode_head_map<T::kRowBytes>(&k_map, a.k, a, a.st.k_sb, a.st.k_sl, kBwdBoxRows);
  if (err == cudaSuccess) err = encode_head_map<T::kRowBytes>(&v_map, a.v, a, a.st.v_sb, a.st.v_sl, kBwdBoxRows);
  if (err == cudaSuccess) err = encode_head_map<T::kRowBytes>(&do_map, a.dout, a, a.do_sb, a.do_sl, kBwdBoxRows);
  if (err == cudaSuccess && (which & kDq)) err = encode_bias_map(&bias_map, a);
  const long long units = static_cast<long long>((a.seq_len + kBwdRows - 1) / kBwdRows) * a.heads * a.batch;
  int grid = 0;
  if (err == cudaSuccess) err = persistent_grid(units, &grid);
  if (err != cudaSuccess) return err;
  const float* lse = static_cast<const float*>(a.lse_in);
  const float* delta = static_cast<const float*>(a.delta);
  if (which & kDq) {
    auto kernel = bmha_dq_wgmma_kernel<DHP>;
    if ((err = allow_smem(kernel, DqLayout<DHP>::kSmem)) != cudaSuccess) return err;
    kernel<<<grid, T::kThreads, DqLayout<DHP>::kSmem, a.stream>>>(
        q_map, k_map, v_map, do_map, bias_map, lse, delta, static_cast<__nv_bfloat16*>(a.dq), a.seq_len, a.d, dh,
        a.heads, static_cast<int>(units), a.scale, paired);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (which & kDkv) {
    auto kernel = bmha_dkv_wgmma_kernel<DHP>;
    if ((err = allow_smem(kernel, DkvLayout<DHP>::kSmem)) != cudaSuccess) return err;
    kernel<<<grid, T::kThreads, DkvLayout<DHP>::kSmem, a.stream>>>(
        q_map, k_map, v_map, do_map, static_cast<const float*>(a.bias), lse, delta,
        static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv), a.seq_len, a.d, dh, a.heads,
        static_cast<int>(units), a.scale, paired);
  }
  return cudaGetLastError();
}

// The input type alone picks the kernels: the scalar f32 ones for float, the
// TMA + wgmma ones for bf16. `which`: kFwd, or a mask of kDq and kDkv.
template <typename T, int DHP>
cudaError_t launch_one(int which, const Args& a) {
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
      return cudaGetLastError();
    }
    if (which & kDq) {
      constexpr size_t smem = smem_bytes<DHP>(4, 1, kTile);
      if ((err = allow_smem(bmha_dq_f32_kernel<DHP>, smem)) != cudaSuccess) return err;
      bmha_dq_f32_kernel<DHP><<<grid, kThreads, smem, a.stream>>>(
          q, k, v, bias, lse, dout, delta, static_cast<float*>(a.dq), a.seq_len, a.d,
          dh, a.heads, a.st, a.scale, a.vec);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if (which & kDkv) {
      constexpr size_t smem = smem_bytes<DHP>(4, 2, 2 * kTile);
      if ((err = allow_smem(bmha_dkv_f32_kernel<DHP>, smem)) != cudaSuccess) return err;
      bmha_dkv_f32_kernel<DHP><<<grid, kThreads, smem, a.stream>>>(
          q, k, v, bias, lse, dout, delta, static_cast<float*>(a.dk),
          static_cast<float*>(a.dv), a.seq_len, a.d, dh, a.heads, a.st, a.scale,
          a.vec);
    }
    return cudaGetLastError();
  } else {
    return which == kFwd ? launch_fwd_wgmma<DHP>(a) : launch_bwd_wgmma<DHP>(a, which);
  }
}

template <typename T>
cudaError_t launch_dh(int which, const Args& a) {
  const int dh = a.d / a.heads;
  if (dh <= 16) return launch_one<T, 16>(which, a);
  if (dh <= 32) return launch_one<T, 32>(which, a);
  if (dh <= 64) return launch_one<T, 64>(which, a);
  if (dh <= 128) return launch_one<T, 128>(which, a);
  return cudaErrorInvalidValue;  // the wrapper refuses Dh > 128 first
}

int run(int which, int is_bf16, int device, const Args& a) {
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

// The backward's kernels: dq (which & 1) and dk/dv (which & 2), the bf16
// ones on one set of tensor maps. lse, delta: (B, L, H) f32; dq, dk, dv:
// contiguous (B, L, D) (null where not asked for). dout: (B, L, D) through
// its batch and row strides (elements; f32: contiguous); head_stride (bf16):
// as above, for q, k, v and dout alike. vec: as above
extern "C" int b4cp_bmha_bwd(const void* q, const void* k, const void* v,
                             const void* bias, const void* lse,
                             const void* dout, const void* delta, void* dq,
                             void* dk, void* dv, int is_bf16, int batch,
                             int seq_len, int d, int heads, long long q_sb,
                             long long q_sl, long long k_sb, long long k_sl,
                             long long v_sb, long long v_sl, long long do_sb,
                             long long do_sl, int head_stride, float scale,
                             int vec, int which, int device, void* stream) {
  if (which < 1 || which > (kDq | kDkv)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = common_args(q, k, v, bias, batch, seq_len, d, heads, q_sb, q_sl, k_sb,
                       k_sl, v_sb, v_sl, scale, vec, stream);
  a.lse_in = lse, a.dout = dout, a.delta = delta, a.dq = dq, a.dk = dk, a.dv = dv;
  a.do_sb = do_sb, a.do_sl = do_sl, a.head_stride = head_stride;
  return run(which, is_bf16, device, a);
}
