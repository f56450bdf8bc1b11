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
//             dv_h = p^T . do_h                             unrounded p, f32 do
//             dp = do_h . v_h^T                             f32
//             ds = round_to_input(p * (dp - delta) * scale)
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
// gradients are summed in f32 registers over all tiles and rounded once.
//
// What bounds it on the H100: operations. At the long-session shape (B=16,
// L=1024, D=256, H=4) the forward is 4 B L^2 D = 17.2 GFLOP over ~34 MB of
// q/k/v/out, dq is three such products and dk/dv four: 60 GFLOP per layer in
// the backward. The products here are scalar f32 FMA out of shared memory
// (so f32 inputs keep f32 accuracy); tensor cores (mma.sync / wgmma on the
// bf16 operands), cp.async / TMA double buffering and warp specialisation are
// what a fast version would add.
//
// Design (simple first). A block of 256 threads (16 x 16) owns one 64-row
// tile of one (b, h): a query tile in the forward and dq (grid: q tiles x H x
// B, 1,024 blocks at the shape above), a key tile in dk/dv, which then sums
// over all query tiles inside the block, so no atomics are needed. It walks
// the other sequence axis in 64-row tiles. Tiles are converted to f32 in
// shared memory with a row stride of Dh' + 4 floats (Dh' = Dh rounded up to
// 16, 32, 64 or 128 and zero-filled, a template parameter), which makes the
// 16-byte reads of both products conflict-free. Thread (ty, tx) computes the
// 4 x 4 scores at rows ty + 16 i and columns tx + 16 j, reduces max and sum
// over the 16 lanes that share its rows by warp shuffles, writes the
// probability (or ds) tile to shared memory, and then accumulates its rows'
// output for the Dh'/16 head columns it owns. Any L is taken: rows and keys
// past L are zero-filled, masked out of the softmax and never stored.
// Shared memory at Dh = 64: forward 68 KB, dq 85 KB, dk/dv 103 KB per block
// (two or three blocks per SM); at Dh = 128: 116, 149 and 167 KB.

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

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads, DHP <= 64 ? 2 : 1)
    bmha_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   const float* __restrict__ lse, const T* __restrict__ dout,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int seq_len, int d, int dh, int heads, Strides st,
                   float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RS = DHP + kPad;
  constexpr int NC = DHP / 16;
  float* qs = smem;
  float* dos = qs + kTile * RS;
  float* ks = dos + kTile * RS;
  float* vs = ks + kTile * RS;
  float* ss = vs + kTile * RS;   // ds, rounded to the input type
  float* bs = ss + kTile * kSs;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long base = static_cast<long long>(b) * seq_len * d + h * dh;
  const T* kb = k + b * st.k_sb + h * dh;
  const T* vb = v + b * st.v_sb + h * dh;

  load_tile<T, DHP>(qs, q + b * st.q_sb + h * dh, st.q_sl, q0, seq_len, dh, vec);
  load_tile<T, DHP>(dos, dout + base, d, q0, seq_len, dh, vec);
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
        ss[(ty + 16 * i) * kSs + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();
    tile_accumulate<DHP>(acc, ss, ks, ty, tx);
  }
  store_rows<T, NC>(dq, acc, base, q0, seq_len, d, dh, ty, tx);
}

// One block per key tile: it keeps k and v, walks the query tiles, and
// computes the scores transposed (rows = keys, columns = queries), so the
// thread's rows are the dk / dv rows it sums.
template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads, DHP <= 64 ? 2 : 1)
    bmha_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const float* __restrict__ lse, const T* __restrict__ dout,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int seq_len, int d, int dh, int heads,
                    Strides st, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RS = DHP + kPad;
  constexpr int NC = DHP / 16;
  float* ks = smem;
  float* vs = ks + kTile * RS;
  float* qs = vs + kTile * RS;
  float* dos = qs + kTile * RS;
  float* pt = dos + kTile * RS;     // p^T, f32 (not rounded)
  float* dst = pt + kTile * kSs;    // ds^T, rounded to the input type
  float* lses = dst + kTile * kSs;  // this query tile's lse
  float* deltas = lses + kTile;     // and delta
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long base = static_cast<long long>(b) * seq_len * d + h * dh;
  const T* qb = q + b * st.q_sb + h * dh;

  load_tile<T, DHP>(ks, k + b * st.k_sb + h * dh, st.k_sl, k0, seq_len, dh, vec);
  load_tile<T, DHP>(vs, v + b * st.v_sb + h * dh, st.v_sl, k0, seq_len, dh, vec);
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
    load_tile<T, DHP>(qs, qb, st.q_sl, q0, seq_len, dh, vec);
    load_tile<T, DHP>(dos, dout + base, d, q0, seq_len, dh, vec);
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
        dst[(ty + 16 * i) * kSs + qj] = round_to<T>(ds);
      }
    }
    __syncthreads();
    tile_accumulate<DHP>(acc_v, pt, dos, ty, tx);
    tile_accumulate<DHP>(acc_k, dst, qs, ty, tx);
  }
  store_rows<T, NC>(dv, acc_v, base, k0, seq_len, d, dh, ty, tx);
  store_rows<T, NC>(dk, acc_k, base, k0, seq_len, d, dh, ty, tx);
}

// bytes of dynamic shared memory: `tiles` 64-row operand tiles, `scores`
// 64 x 64 score tiles, `extra` floats
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
  } else if (which == kDq) {
    constexpr size_t smem = smem_bytes<DHP>(4, 1, kTile);
    if ((err = allow_smem(bmha_dq_kernel<T, DHP>, smem)) != cudaSuccess) return err;
    bmha_dq_kernel<T, DHP><<<grid, kThreads, smem, a.stream>>>(
        q, k, v, bias, lse, dout, delta, static_cast<T*>(a.dq), a.seq_len, a.d,
        dh, a.heads, a.st, a.scale, a.vec);
  } else {
    constexpr size_t smem = smem_bytes<DHP>(4, 2, 2 * kTile);
    if ((err = allow_smem(bmha_dkv_kernel<T, DHP>, smem)) != cudaSuccess) return err;
    bmha_dkv_kernel<T, DHP><<<grid, kThreads, smem, a.stream>>>(
        q, k, v, bias, lse, dout, delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.seq_len, a.d, dh, a.heads, a.st, a.scale,
        a.vec);
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

// lse, delta: (B, L, H) f32; dout and dq: contiguous (B, L, D)
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
