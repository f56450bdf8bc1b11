// Masked multi-head attention whose heads have v narrower than q and k, at
// a given softmax scale, bf16 on the tensor cores: a forward and the dq and
// dk/dv kernels of its backward. The DeepSeek-V2 block's latent attention
// gives such heads: q and k 192 wide (128 + 64 of RoPE), v 128, scale
// 192^-0.5 times YaRN's factor. The port's other attention kernels take one
// width for q, k and v and the scale 1 / sqrt(width), and stop at 128.
//
// Semantics (ops/kernels/attention.py: blockwise_mha_reference,
// blockwise_dq_reference and blockwise_dkv_reference with the scale and
// the narrower v): s = (q k^T) scale + bias, in f32, the scale before the
// bias, one rounding each; m the row maximum, l = sum exp(s - m); the
// un-normalised p = exp(s - m) rounded to bf16 before o = p v, o summed in
// f32, divided by l and rounded once; lse = m + log(l) per (row, head) in
// f32 is the backward's residual. The backward recomputes p = exp(s - lse)
// in f32, takes dp = do v^T in f32 and delta = rowsum(do o) from the
// caller, rounds ds = p (dp - delta) scale to bf16 before dq = ds k and
// dk = ds^T q, and rounds p to bf16 before dv = p^T do; each gradient is
// summed in f32 and rounded once.
//
// Design: the whole-row layout of csrc/attention.cu's tensor-core kernels
// (attention_mma.cuh: bf16 tiles filled by 16-byte cp.async copies,
// ldmatrix fragments, mma.sync.m16n8k16 with f32 sums), with two tile
// widths, DQK for q and k and DV for v and do. A block of 4 warps owns 64
// rows of one (batch row, head), 16 a warp; the other side of every
// product, all L rows of it rounded up to 64, is resident in shared memory
// (the forward's K and V, the dq kernel's K and V, the dk/dv kernel's q
// and do). At (192, 128) and L <= 256 that is under 217 KB a block, one
// block an SM. The forward finds m and l over passes of 64 keys, then
// takes p pass by pass into the A fragments of p v; the dq kernel takes
// passes of 32 keys, the dk/dv kernel passes of 16 query rows, with the
// scores transposed (rows = keys) as the whole-row backward does, so p and
// ds never touch shared memory. Keys past L carry a bias of -inf and query
// rows past L an lse of +inf, so their p is exactly 0; rows past L are
// never stored. Every output row is written by one warp, in a fixed order:
// no atomics, two runs give the same bits.
//
// Inputs: q, k contiguous (B, L, H DQK); v, do, out (B, L, H DV); bias
// (B, L) f32; lse, delta (B, L, H) f32; every base 16-byte aligned (the
// wrapper checks). Instances: (DQK, DV) = (192, 128), the block's heads.

#include "attention_mma.cuh"
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kUWarps = 4;
constexpr int kUThreads = kUWarps * 32;
constexpr int kUTile = 16 * kUWarps;  // a block's own rows
constexpr int kUChunk = 64;           // resident rows: L rounded up to this
constexpr int kUFwdPass = 64;         // keys of a forward pass
constexpr int kUDqPass = 32;          // keys of a dq pass
constexpr int kUDkvPass = 16;         // query rows of a dk/dv pass
constexpr size_t kUMaxShared = 227 * 1024;

__host__ __device__ inline int resident_rows(int seq_len) { return (seq_len + kUChunk - 1) / kUChunk * kUChunk; }

// own tile of q (forward), of q and do (dq) or of k and v (dk/dv), and the
// resident rows of the other side, plus the f32 rows
template <int DQK, int DV>
size_t shared_bytes(int seq_len, bool own_dv, int f32_rows) {
  const size_t rows = resident_rows(seq_len);
  const size_t own = kUTile * (DQK + tc::kSkew + (own_dv ? DV + tc::kSkew : 0));
  return sizeof(bf16) * (own + rows * (DQK + DV + 2 * tc::kSkew)) + sizeof(float) * f32_rows * rows;
}

__device__ __forceinline__ float scaled(float s, float scale, float bias) {
  return __fadd_rn(__fmul_rn(s, scale), bias);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kUThreads, 1)
    umha_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    bf16* __restrict__ out, float* __restrict__ lse, int seq_len, int heads,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem_uf[];
  constexpr int RQ = DQK + tc::kSkew;
  constexpr int RV = DV + tc::kSkew;
  constexpr int NT = kUFwdPass / 8;
  const int rows = resident_rows(seq_len);
  bf16* qs = reinterpret_cast<bf16*>(smem_uf);
  bf16* ks = qs + kUTile * RQ;
  bf16* vs = ks + rows * RQ;
  float* bs = reinterpret_cast<float*>(vs + rows * RV);  // the bias row, -inf past seq_len
  const int q0 = blockIdx.x * kUTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long qk_row = static_cast<long long>(heads) * DQK;
  const long long v_row = static_cast<long long>(heads) * DV;
  const long long qk_base = static_cast<long long>(b) * seq_len * qk_row + h * DQK;

  tc::fill_tile<kUTile, DQK, kUThreads>(qs, q + qk_base, qk_row, q0, seq_len, DQK, true);
  for (int r0 = 0; r0 < rows; r0 += kUChunk) {
    tc::fill_tile<kUChunk, DQK, kUThreads>(ks + r0 * RQ, k + qk_base, qk_row, r0, seq_len, DQK, true);
    tc::fill_tile<kUChunk, DV, kUThreads>(vs + r0 * RV, v + static_cast<long long>(b) * seq_len * v_row + h * DV,
                                          v_row, r0, seq_len, DV, true);
  }
  tc::fill_rows_f32<kUThreads>(bs, bias + static_cast<long long>(b) * seq_len, 1, 0, rows, seq_len, -INFINITY);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  if (q0 + warp * 16 >= seq_len) return;  // the warp's rows are all past seq_len

  const uint32_t q_at = tc::shared_addr(qs) + warp * (16 * RQ * 2) + tc::lane_offset_rows_first<RQ>(lane) * 2;
  const uint32_t k_addr = tc::shared_addr(ks) + tc::lane_offset_cols_first<RQ>(lane) * 2;
  const uint32_t v_addr = tc::shared_addr(vs) + tc::lane_offset_rows_first<RV>(lane) * 2;
  uint32_t qf[DQK / 16][4];
  tc::load_a<DQK>(qf, q_at);
  float s[NT][4];
  // s = (q k^T) * scale + bias for the keys of pass c
  auto scores = [&](int c) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
    tc::product_abt<DQK, NT>(s, qf, k_addr + c * (kUFwdPass * RQ * 2));
    const float* bj = bs + c * kUFwdPass + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 b2 = *reinterpret_cast<const float2*>(bj + nt * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = scaled(s[nt][e], scale, (e & 1) ? b2.y : b2.x);
    }
  };

  // the row maximum over all passes, then l; every pass holds a key below
  // seq_len, whose bias is finite, so m is finite and -inf - (-inf) is
  // never formed
  const int n_pass = (seq_len + kUFwdPass - 1) / kUFwdPass;
  float m[2] = {-INFINITY, -INFINITY};
  for (int c = 0; c < n_pass; ++c) {
    scores(c);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[nt][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) m[r] = tc::quad_max(m[r]);

  float l_part[2] = {0.f, 0.f};  // the lane's share of l
  float acc[DV / 8][4] = {};
  for (int c = 0; c < n_pass; ++c) {
    if (n_pass > 1) scores(c);  // one pass: s is still in registers
    uint32_t pf[kUFwdPass / 16][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[nt][e] - m[e >> 1]);  // 0 past seq_len
        l_part[e >> 1] += p[e];
      }
      pf[nt >> 1][(nt & 1) * 2] = tc::pack_bf16(p[0], p[1]);
      pf[nt >> 1][(nt & 1) * 2 + 1] = tc::pack_bf16(p[2], p[3]);
    }
    tc::product_ab<DV, kUFwdPass / 16>(acc, pf, v_addr + c * (kUFwdPass * RV * 2));
  }
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = tc::quad_sum(l_part[r]);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (t == 0 && row < seq_len) {
      lse[(static_cast<long long>(b) * seq_len + row) * heads + h] = m[r] + logf(l[r]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < DV / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = __fdiv_rn(acc[nt][e], l[e >> 1]);
  }
  tc::store_acc<DV>(out + static_cast<long long>(b) * seq_len * v_row + h * DV, acc, q0 + warp * 16, seq_len,
                    static_cast<int>(v_row), DV, lane, true);
}

// dq = ds k for the block's 64 query rows, K and V resident
template <int DQK, int DV>
__global__ void __launch_bounds__(kUThreads, 1)
    umha_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ bias,
                   const float* __restrict__ lse, const bf16* __restrict__ dout,
                   const float* __restrict__ delta, bf16* __restrict__ dq, int seq_len, int heads,
                   float scale) {
  extern __shared__ __align__(16) unsigned char smem_uq[];
  constexpr int RQ = DQK + tc::kSkew;
  constexpr int RV = DV + tc::kSkew;
  constexpr int NP = kUDqPass;
  constexpr int NT = NP / 8;
  const int rows = resident_rows(seq_len);
  bf16* qs = reinterpret_cast<bf16*>(smem_uq);
  bf16* dos = qs + kUTile * RQ;
  bf16* ks = dos + kUTile * RV;
  bf16* vs = ks + rows * RQ;
  float* bs = reinterpret_cast<float*>(vs + rows * RV);  // the bias row, -inf past seq_len
  const int q0 = blockIdx.x * kUTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long qk_row = static_cast<long long>(heads) * DQK;
  const long long v_row = static_cast<long long>(heads) * DV;
  const long long qk_base = static_cast<long long>(b) * seq_len * qk_row + h * DQK;
  const long long v_base = static_cast<long long>(b) * seq_len * v_row + h * DV;

  tc::fill_tile<kUTile, DQK, kUThreads>(qs, q + qk_base, qk_row, q0, seq_len, DQK, true);
  tc::fill_tile<kUTile, DV, kUThreads>(dos, dout + v_base, v_row, q0, seq_len, DV, true);
  for (int r0 = 0; r0 < rows; r0 += kUChunk) {
    tc::fill_tile<kUChunk, DQK, kUThreads>(ks + r0 * RQ, k + qk_base, qk_row, r0, seq_len, DQK, true);
    tc::fill_tile<kUChunk, DV, kUThreads>(vs + r0 * RV, v + v_base, v_row, r0, seq_len, DV, true);
  }
  tc::fill_rows_f32<kUThreads>(bs, bias + static_cast<long long>(b) * seq_len, 1, 0, rows, seq_len, -INFINITY);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  if (q0 + warp * 16 >= seq_len) return;

  // the thread's two query rows: lse +inf and delta 0 past seq_len (p = 0)
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const long long at = (static_cast<long long>(b) * seq_len + row) * heads + h;
    lse_r[r] = row < seq_len ? lse[at] : INFINITY;
    delta_r[r] = row < seq_len ? delta[at] : 0.f;
  }
  const uint32_t q_at = tc::shared_addr(qs) + warp * (16 * RQ * 2) + tc::lane_offset_rows_first<RQ>(lane) * 2;
  const uint32_t do_at = tc::shared_addr(dos) + warp * (16 * RV * 2) + tc::lane_offset_rows_first<RV>(lane) * 2;
  const uint32_t k_cols = tc::shared_addr(ks) + tc::lane_offset_cols_first<RQ>(lane) * 2;
  const uint32_t k_rows = tc::shared_addr(ks) + tc::lane_offset_rows_first<RQ>(lane) * 2;
  const uint32_t v_cols = tc::shared_addr(vs) + tc::lane_offset_cols_first<RV>(lane) * 2;

  float acc[DQK / 8][4] = {};
  const int n_pass = (seq_len + NP - 1) / NP;
  for (int c = 0; c < n_pass; ++c) {
    float s[NT][4] = {}, dp[NT][4] = {};
    tc::product_abt<DQK, NT>(s, q_at, k_cols + c * (NP * RQ * 2));
    tc::product_abt<DV, NT>(dp, do_at, v_cols + c * (NP * RV * 2));
    const float* bj = bs + c * NP + 2 * t;
    uint32_t dsf[NP / 16][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 b2 = *reinterpret_cast<const float2*>(bj + nt * 8);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = expf(scaled(s[nt][e], scale, (e & 1) ? b2.y : b2.x) - lse_r[r]);
        ds[e] = p * (dp[nt][e] - delta_r[r]) * scale;
      }
      dsf[nt >> 1][(nt & 1) * 2] = tc::pack_bf16(ds[0], ds[1]);
      dsf[nt >> 1][(nt & 1) * 2 + 1] = tc::pack_bf16(ds[2], ds[3]);
    }
    tc::product_ab<DQK, NP / 16>(acc, dsf, k_rows + c * (NP * RQ * 2));
  }
  tc::store_acc<DQK>(dq + qk_base, acc, q0 + warp * 16, seq_len, static_cast<int>(qk_row), DQK, lane, true);
}

// dk = ds^T q and dv = p^T do for the block's 64 key rows, q and do
// resident; the scores transposed (rows = keys)
template <int DQK, int DV>
__global__ void __launch_bounds__(kUThreads, 1)
    umha_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    const float* __restrict__ lse, const bf16* __restrict__ dout,
                    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    int seq_len, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem_ukv[];
  constexpr int RQ = DQK + tc::kSkew;
  constexpr int RV = DV + tc::kSkew;
  constexpr int NP = kUDkvPass;
  constexpr int NT = NP / 8;
  const int rows = resident_rows(seq_len);
  bf16* ks = reinterpret_cast<bf16*>(smem_ukv);
  bf16* vs = ks + kUTile * RQ;
  bf16* qs = vs + kUTile * RV;
  bf16* dos = qs + rows * RQ;
  float* ls = reinterpret_cast<float*>(dos + rows * RV);  // lse, +inf past seq_len
  float* dls = ls + rows;                                  // delta, 0 past seq_len
  const int k0 = blockIdx.x * kUTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long qk_row = static_cast<long long>(heads) * DQK;
  const long long v_row = static_cast<long long>(heads) * DV;
  const long long qk_base = static_cast<long long>(b) * seq_len * qk_row + h * DQK;
  const long long v_base = static_cast<long long>(b) * seq_len * v_row + h * DV;
  const long long stat_base = static_cast<long long>(b) * seq_len * heads + h;

  tc::fill_tile<kUTile, DQK, kUThreads>(ks, k + qk_base, qk_row, k0, seq_len, DQK, true);
  tc::fill_tile<kUTile, DV, kUThreads>(vs, v + v_base, v_row, k0, seq_len, DV, true);
  for (int r0 = 0; r0 < rows; r0 += kUChunk) {
    tc::fill_tile<kUChunk, DQK, kUThreads>(qs + r0 * RQ, q + qk_base, qk_row, r0, seq_len, DQK, true);
    tc::fill_tile<kUChunk, DV, kUThreads>(dos + r0 * RV, dout + v_base, v_row, r0, seq_len, DV, true);
  }
  tc::fill_rows_f32<kUThreads>(ls, lse + stat_base, heads, 0, rows, seq_len, INFINITY);
  tc::fill_rows_f32<kUThreads>(dls, delta + stat_base, heads, 0, rows, seq_len, 0.f);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  if (k0 + warp * 16 >= seq_len) return;

  // the thread's two keys: bias -inf past seq_len (p = 0, never stored)
  float bias_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    bias_r[r] = key < seq_len ? bias[static_cast<long long>(b) * seq_len + key] : -INFINITY;
  }
  const uint32_t k_at = tc::shared_addr(ks) + warp * (16 * RQ * 2) + tc::lane_offset_rows_first<RQ>(lane) * 2;
  const uint32_t v_at = tc::shared_addr(vs) + warp * (16 * RV * 2) + tc::lane_offset_rows_first<RV>(lane) * 2;
  const uint32_t q_cols = tc::shared_addr(qs) + tc::lane_offset_cols_first<RQ>(lane) * 2;
  const uint32_t q_rows = tc::shared_addr(qs) + tc::lane_offset_rows_first<RQ>(lane) * 2;
  const uint32_t do_cols = tc::shared_addr(dos) + tc::lane_offset_cols_first<RV>(lane) * 2;
  const uint32_t do_rows = tc::shared_addr(dos) + tc::lane_offset_rows_first<RV>(lane) * 2;

  float acc_k[DQK / 8][4] = {}, acc_v[DV / 8][4] = {};
  const int n_pass = (seq_len + NP - 1) / NP;
  for (int c = 0; c < n_pass; ++c) {
    float sT[NT][4] = {}, dpT[NT][4] = {};
    tc::product_abt<DQK, NT>(sT, k_at, q_cols + c * (NP * RQ * 2));
    tc::product_abt<DV, NT>(dpT, v_at, do_cols + c * (NP * RV * 2));
    const float* mj = ls + c * NP + 2 * t;
    const float* dj = dls + c * NP + 2 * t;
    uint32_t pf[NP / 16][4], dsf[NP / 16][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 m2 = *reinterpret_cast<const float2*>(mj + nt * 8);
      const float2 d2 = *reinterpret_cast<const float2*>(dj + nt * 8);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        p[e] = expf(scaled(sT[nt][e], scale, bias_r[e >> 1]) - (odd ? m2.y : m2.x));
        ds[e] = p[e] * (dpT[nt][e] - (odd ? d2.y : d2.x)) * scale;
      }
      const int ks16 = nt >> 1, at = (nt & 1) * 2;
      pf[ks16][at] = tc::pack_bf16(p[0], p[1]);
      pf[ks16][at + 1] = tc::pack_bf16(p[2], p[3]);
      dsf[ks16][at] = tc::pack_bf16(ds[0], ds[1]);
      dsf[ks16][at + 1] = tc::pack_bf16(ds[2], ds[3]);
    }
    tc::product_ab<DV, NP / 16>(acc_v, pf, do_rows + c * (NP * RV * 2));
    tc::product_ab<DQK, NP / 16>(acc_k, dsf, q_rows + c * (NP * RQ * 2));
  }
  tc::store_acc<DV>(dv + v_base, acc_v, k0 + warp * 16, seq_len, static_cast<int>(v_row), DV, lane, true);
  tc::store_acc<DQK>(dk + qk_base, acc_k, k0 + warp * 16, seq_len, static_cast<int>(qk_row), DQK, lane, true);
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem > kUMaxShared) return cudaErrorInvalidValue;  // the wrapper refuses such an L first
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

template <int DQK, int DV>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                       void* lse, int batch, int seq_len, int heads, float scale, cudaStream_t s) {
  const size_t smem = shared_bytes<DQK, DV>(seq_len, false, 1);
  auto kernel = umha_fwd_kernel<DQK, DV>;
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + kUTile - 1) / kUTile, heads, batch);
  kernel<<<grid, kUThreads, smem, s>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                       static_cast<const bf16*>(v), static_cast<const float*>(bias),
                                       static_cast<bf16*>(out), static_cast<float*>(lse), seq_len,
                                       heads, scale);
  return cudaGetLastError();
}

template <int DQK, int DV>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* lse, const void* dout, const void* delta, void* dq, void* dk,
                       void* dv, int batch, int seq_len, int heads, float scale, cudaStream_t s) {
  const dim3 grid((seq_len + kUTile - 1) / kUTile, heads, batch);
  const size_t smem_dq = shared_bytes<DQK, DV>(seq_len, true, 1);
  auto dq_kernel = umha_dq_kernel<DQK, DV>;
  cudaError_t err = allow_shared(dq_kernel, smem_dq);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, kUThreads, smem_dq, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const float*>(lse),
      static_cast<const bf16*>(dout), static_cast<const float*>(delta), static_cast<bf16*>(dq),
      seq_len, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_dkv = shared_bytes<DQK, DV>(seq_len, true, 2);
  auto dkv_kernel = umha_dkv_kernel<DQK, DV>;
  err = allow_shared(dkv_kernel, smem_dkv);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<grid, kUThreads, smem_dkv, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const float*>(lse),
      static_cast<const bf16*>(dout), static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), seq_len, heads, scale);
  return cudaGetLastError();
}

bool is_instance(int dqk, int dv) { return dqk == 192 && dv == 128; }

}  // namespace

extern "C" int b4cp_umha_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                             void* lse, int batch, int seq_len, int heads, int dqk, int dv,
                             float scale, int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's device in it
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (!is_instance(dqk, dv)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || seq_len == 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(launch_fwd<192, 128>(q, k, v, bias, out, lse, batch, seq_len, heads, scale,
                                               static_cast<cudaStream_t>(stream)));
}

extern "C" int b4cp_umha_bwd(const void* q, const void* k, const void* v, const void* bias,
                             const void* lse, const void* dout, const void* delta, void* dq,
                             void* dk, void* dv, int batch, int seq_len, int heads, int dqk,
                             int dv_width, float scale, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (!is_instance(dqk, dv_width)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || seq_len == 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(launch_bwd<192, 128>(q, k, v, bias, lse, dout, delta, dq, dk, dv, batch,
                                               seq_len, heads, scale, static_cast<cudaStream_t>(stream)));
}
