// Masked multi-head attention over (B, L, D), heads as column sub-ranges
// of D: the forward, and (further down) its backward.
//
// Replaces bert4clickpath_tpu/ops/pallas/attention.py:_mha_fwd_kernel (the
// forward of fused_mha). Per batch row b and head h, with Dh = D / H:
//
//     s = (q_h . k_h^T) * (1/sqrt(Dh)) + bias[b]     f32, scale before bias
//     p = softmax(s)                                  f32
//     o_h = round_to_input(p) . v_h                   f32 accumulation
//     out[b, :, h*Dh:(h+1)*Dh] = round_to_input(o_h)
//
// q, k, v are bf16 or f32; bias is the (B, 1, 1, L) f32 additive padding
// bias (-1e9 at [PAD] keys, finite, so a fully padded row gives a uniform
// softmax rather than NaN). q, k and v may be column slices of one
// (B, L, 3D) projection: the kernel takes a batch stride and a row stride
// for each, and needs only the last dimension to be contiguous.
//
// What bounds it on the H100: latency. At the serving shape (L=53, D=256,
// H=4) one (b, h) pair is ~0.7 MFLOP over ~40 KB; the whole call at B=64 is
// ~46 MFLOP and ~5 MB, far below both the tensor-core and the memory roofs,
// and at B=1 there are only H=4 blocks on 132 SMs. What the time is made of
// is the launch, one pass of K/V into shared memory, and the dependent
// chain of each row's score / max / sum / PV steps.
//
// Design (simple first): one block per (b, h), 8 warps. K_h and V_h are
// converted to f32 once into shared memory (K with a padded row stride, so
// lanes reading different keys hit different banks). Each warp takes query
// rows in turn: lanes over keys for the scores, warp-shuffle max and sum,
// then lanes over Dh for the PV product. The ragged edge (L=53 is odd) is
// masked by the loop bounds. Shared memory grows as L * (2*Dh + 1) floats;
// an L beyond what one block can hold goes to the blockwise kernels
// (attention_blockwise.cu), which stream K/V. No tensor cores yet: wgmma,
// TMA and several rows per warp are what a fast version would add.

#include <type_traits>

#include "attention_mma.cuh"
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   T* __restrict__ out, int seq_len, int d, int dh,
                   long long q_sb, long long q_sl, long long k_sb,
                   long long k_sl, long long v_sb, long long v_sl,
                   float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kstride = dh + 1;  // padded: lanes over keys avoid bank conflicts
  float* ks = smem;                          // seq_len * kstride
  float* vs = ks + seq_len * kstride;        // seq_len * dh
  float* bs = vs + seq_len * dh;             // seq_len
  float* qrow = bs + seq_len + warp * (dh + seq_len);  // dh, this warp's q row
  float* prow = qrow + dh;                   // seq_len, this warp's scores

  const T* kb = k + b * k_sb + h * dh;
  const T* vb = v + b * v_sb + h * dh;
  for (int idx = threadIdx.x; idx < seq_len * dh; idx += blockDim.x) {
    const int j = idx / dh;
    const int c = idx - j * dh;
    ks[j * kstride + c] = to_f(kb[j * k_sl + c]);
    vs[j * dh + c] = to_f(vb[j * v_sl + c]);
  }
  for (int j = threadIdx.x; j < seq_len; j += blockDim.x) {
    bs[j] = bias[static_cast<long long>(b) * seq_len + j];
  }
  __syncthreads();

  const T* qb = q + b * q_sb + h * dh;
  T* ob = out + static_cast<long long>(b) * seq_len * d + h * dh;
  for (int i = warp; i < seq_len; i += kWarps) {
    for (int c = lane; c < dh; c += 32) qrow[c] = to_f(qb[i * q_sl + c]);
    __syncwarp();
    // scores: lanes over keys
    float mx = -INFINITY;
    for (int j = lane; j < seq_len; j += 32) {
      const float* kr = ks + j * kstride;
      float acc = 0.f;
      for (int c = 0; c < dh; ++c) acc = fmaf(qrow[c], kr[c], acc);
      const float s = __fadd_rn(__fmul_rn(acc, scale), bs[j]);
      prow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < seq_len; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < seq_len; j += 32) prow[j] = round_to<T>(prow[j] / sum);
    __syncwarp();
    // PV: lanes over the head's columns
    for (int c = lane; c < dh; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < seq_len; ++j) acc = fmaf(prow[j], vs[j * dh + c], acc);
      ob[static_cast<long long>(i) * d + c] = from_f<T>(acc);
    }
    __syncwarp();  // the next row overwrites qrow/prow
  }
}

// Backward. Replaces bert4clickpath_tpu/ops/pallas/attention.py:
// _mha_bwd_kernel (the VJP of fused_mha, via _fused_mha_bwd). Per (b, h):
//
//     p = softmax(q_h . k_h^T * scale + bias[b])     f32, recomputed
//     dv_h = p^T . do_h                               f32 p (not rounded)
//     dp = do_h . v_h^T,  delta = rowsum(p * dp)
//     ds = round_to_input(p * (dp - delta) * scale)
//     dq_h = ds . k_h,  dk_h = ds^T . q_h             f32 accumulation
//
// each gradient stored in the input dtype; do is read as f32.
//
// What bounds it: like the forward, latency. At the flagship training shape
// (B=256, L=53, D=256, H=4) one (b, h) pair is ~2.2 MFLOP over ~55 KB of
// q/k/v/do, 1,024 blocks in all (~2.2 GFLOP, ~30 MB): far below both roofs.
//
// Design (simple first): one block per (b, h), 8 warps. q, k, v and do of
// the head go to shared memory as f32 (rows padded to Dh + 1 floats), with
// the full (L, L) p and ds (~22 KB at L=53). Phase 1, a warp per query row:
// scores and softmax (lanes over keys), dp and delta, ds, then dq (lanes
// over the head's columns). Phase 2, after a block barrier: dv and dk, each
// a sum over query rows, one thread per (key row, column). q, k and v may
// be strided column slices of one (B, L, 3D) projection, as in the forward;
// do, dq, dk and dv are contiguous (B, L, D). Shared memory grows as
// 4 L (Dh + 1) + 2 L (L + 1) floats: an L beyond one block goes to the
// blockwise dq / dkv kernels (attention_blockwise.cu).
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    mha_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   const T* __restrict__ dout, T* __restrict__ dq,
                   T* __restrict__ dk, T* __restrict__ dv, int seq_len, int d,
                   int dh, long long q_sb, long long q_sl, long long k_sb,
                   long long k_sl, long long v_sb, long long v_sl,
                   float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ps = dh + 1;       // padded row stride of q, k, v, do
  const int ls = seq_len + 1;  // row stride of p and ds
  float* qs = smem;
  float* ks = qs + seq_len * ps;
  float* vs = ks + seq_len * ps;
  float* dos = vs + seq_len * ps;
  float* bs = dos + seq_len * ps;  // seq_len
  float* pm = bs + seq_len;        // p, f32
  float* dsm = pm + seq_len * ls;  // dp, then ds rounded to the input type

  const long long o_base = static_cast<long long>(b) * seq_len * d + h * dh;
  const T* qb = q + b * q_sb + h * dh;
  const T* kb = k + b * k_sb + h * dh;
  const T* vb = v + b * v_sb + h * dh;
  const T* db = dout + o_base;
  for (int idx = threadIdx.x; idx < seq_len * dh; idx += blockDim.x) {
    const int j = idx / dh;
    const int c = idx - j * dh;
    qs[j * ps + c] = to_f(qb[j * q_sl + c]);
    ks[j * ps + c] = to_f(kb[j * k_sl + c]);
    vs[j * ps + c] = to_f(vb[j * v_sl + c]);
    dos[j * ps + c] = to_f(db[static_cast<long long>(j) * d + c]);
  }
  for (int j = threadIdx.x; j < seq_len; j += blockDim.x) {
    bs[j] = bias[static_cast<long long>(b) * seq_len + j];
  }
  __syncthreads();

  for (int i = warp; i < seq_len; i += kWarps) {
    const float* qr = qs + i * ps;
    const float* dr = dos + i * ps;
    float* pr = pm + i * ls;
    float* dsr = dsm + i * ls;
    float mx = -INFINITY;
    for (int j = lane; j < seq_len; j += 32) {
      const float* kr = ks + j * ps;
      float acc = 0.f;
      for (int c = 0; c < dh; ++c) acc = fmaf(qr[c], kr[c], acc);
      const float s = __fadd_rn(__fmul_rn(acc, scale), bs[j]);
      pr[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < seq_len; j += 32) {
      const float e = expf(pr[j] - mx);
      pr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float pdp = 0.f;
    for (int j = lane; j < seq_len; j += 32) {
      const float p = pr[j] / sum;
      pr[j] = p;
      const float* vr = vs + j * ps;
      float dp = 0.f;
      for (int c = 0; c < dh; ++c) dp = fmaf(dr[c], vr[c], dp);
      dsr[j] = dp;
      pdp += __fmul_rn(p, dp);
    }
    const float delta = warp_sum(pdp);
    for (int j = lane; j < seq_len; j += 32) {
      const float ds =
          __fmul_rn(__fmul_rn(pr[j], __fsub_rn(dsr[j], delta)), scale);
      dsr[j] = round_to<T>(ds);
    }
    __syncwarp();
    // dq_i: lanes over the head's columns
    T* dqr = dq + o_base + static_cast<long long>(i) * d;
    for (int c = lane; c < dh; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < seq_len; ++j) acc = fmaf(dsr[j], ks[j * ps + c], acc);
      dqr[c] = from_f<T>(acc);
    }
    __syncwarp();
  }
  __syncthreads();

  // dv_j = sum_i p[i, j] do_i,  dk_j = sum_i ds[i, j] q_i
  for (int idx = threadIdx.x; idx < seq_len * dh; idx += blockDim.x) {
    const int j = idx / dh;
    const int c = idx - j * dh;
    float av = 0.f;
    float ak = 0.f;
    for (int i = 0; i < seq_len; ++i) {
      av = fmaf(pm[i * ls + j], dos[i * ps + c], av);
      ak = fmaf(dsm[i * ls + j], qs[i * ps + c], ak);
    }
    const long long o = o_base + static_cast<long long>(j) * d + c;
    dv[o] = from_f<T>(av);
    dk[o] = from_f<T>(ak);
  }
}

// The bf16 backward on the tensor cores (mha_bwd_mma_kernel): what bf16
// inputs with a head width up to 128 take; f32 inputs, and bf16 heads wider
// than 128 (for which there is no tile instance, and which are on no path),
// keep the scalar kernel above. It computes the same function; what bounds
// it is still bytes and latency (30 MB at the flagship shape, 0.0145 ms; its
// 2.2 GFLOP are 0.002 ms of tensor-core time), so the design spends
// operations to save shared memory and barriers.
//
// One block per (b, h), 4 warps (168 registers: three blocks per SM). q, k, v and do of the head go once, by
// 16-byte cp.async copies, into bf16 tiles of L rounded up to a multiple of
// 64 rows (row stride Dh' + 8: no bank conflict for ldmatrix; rows and
// columns past L and Dh are exact zeros), with the bias row (-inf past L):
// 37 KB at L = 53, Dh = 64, against the scalar kernel's 78 KB of f32. Every
// product is mma.sync.m16n8k16 (bf16 x bf16, f32 sums) on fragments read
// with ldmatrix (attention_mma.cuh); p and ds never touch shared memory.
//
// Phase 1, a warp per 16 query rows: s = q k^T and dp = do v^T against the
// key rows in passes of 64, the softmax statistics m and l and
// delta = rowsum(p dp) / l on the accumulator fragments (online over the
// passes; reduced over the four lanes that share a row by shuffles), then
// ds = p (dp - delta) scale rounded to bf16 into the A fragments of
// dq = ds k. With one pass (L <= 64, the main paths' L = 53) the scores
// stay in registers between the statistics and ds; a longer row recomputes
// them pass by pass, which keeps the registers bounded at any L. m, 1 / l
// and delta of every query row are left in shared memory.
//
// Phase 2, after one block barrier, a warp per 16 key rows: dk and dv sum
// over query rows, that is across phase 1's warps. Rather than exchange
// (L, L) tiles of p and ds through shared memory, the warp recomputes them
// transposed, as the blockwise dk/dv kernel does: s^T = k q^T and
// dp^T = v do^T in passes of 16 query rows, p^T and ds^T from the saved
// statistics, dv += p^T do and dk += ds^T q (B read down its rows with
// ldmatrix.trans). That is seven products instead of five; the tiles it
// saves are what held the scalar kernel to two blocks per SM.
//
// dv takes p unrounded, as the TPU kernel does: p goes into the product as
// two bf16 terms, hi = round(p) and lo = round(p - hi), each multiplied into
// the same f32 sums (kMhaDvSplit; one more small product, measured against p
// rounded once in PERF.md, "the whole-row dv decision").
//
// Keys past L carry a bias of -inf and query rows past L a saved m of +inf,
// so their p is exactly 0 before any product; rows past L are never stored.
// One block owns its output rows and sums in a fixed order: no atomics, two
// runs give the same bits. Where the head width, a stride or a base address
// does not allow 16-byte copies, plain loads fill the same tiles.
//
// Its own limit: the four tiles and four f32 rows must fit one block,
// 8 R (Dh' + 10) bytes <= 227 KB with R = L rounded up to 64 (L <= 192 at
// Dh = 64), beyond the L <= 116 that the scalar kernel's f32 (L, L) tiles
// allow and that the dispatch (attention_family) still applies to both.

constexpr int kMhaMaxHeadDim = 128;  // the widest tile instance
constexpr int kMhaChunk = 64;  // tiles hold a multiple of this many rows; the widest pass

// The shape of the kernel, found on the card at (256, 53, 256), 4 heads
// (examples/long_context/tune_blockwise_bwd.py --kernel mha_bwd). PassQ: the
// key rows a warp takes through phase 1 at a time; PassK: the query rows of
// a phase-2 pass; MinBlocks: the blocks per SM that the register allocation
// leaves room for.
template <int DHP>
constexpr bool kMhaFragmentsResident = DHP <= 64;
template <int DHP>
constexpr int kMhaWarps = 4;
template <int DHP>
constexpr int kMhaPassQ = 64;
template <int DHP>
constexpr int kMhaPassK = 16;  // 168 registers without a spill; 32 spills 40 bytes
template <int DHP>
constexpr int kMhaMinBlocks = DHP <= 64 ? 3 : 1;
constexpr bool kMhaDvSplit = true;  // dv from p as hi + lo bf16 (false: p rounded once)

constexpr size_t mha_mma_smem_bytes(int seq_len, int dhp) {
  const size_t rows = static_cast<size_t>((seq_len + kMhaChunk - 1) / kMhaChunk) * kMhaChunk;
  return sizeof(__nv_bfloat16) * 4 * rows * (dhp + tc::kSkew) + sizeof(float) * 4 * rows;
}

template <int DHP, int WARPS, int NPQ, int NPK, bool RESIDENT, bool SPLIT, int MIN_BLOCKS>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
    mha_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                       const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int seq_len,
                       int d, int dh, long long q_sb, long long q_sl, long long k_sb,
                       long long k_sl, long long v_sb, long long v_sl, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  static_assert(kMhaChunk % NPQ == 0 && kMhaChunk % NPK == 0 && NPQ % 16 == 0 && NPK % 16 == 0,
                "a pass divides the row chunk");
  constexpr int RS = DHP + tc::kSkew;
  constexpr int kMmaThreads = WARPS * 32;
  constexpr int NTQ = NPQ / 8;  // n8 tiles of a phase-1 pass
  constexpr int NTK = NPK / 8;  // and of a phase-2 pass
  const int rows = (seq_len + kMhaChunk - 1) / kMhaChunk * kMhaChunk;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* ks = qs + rows * RS;
  __nv_bfloat16* vs = ks + rows * RS;
  __nv_bfloat16* dos = vs + rows * RS;
  float* bs = reinterpret_cast<float*>(dos + rows * RS);  // the bias row, -inf past seq_len
  float* ms = bs + rows;       // per query row: the row maximum, +inf past seq_len
  float* ils = ms + rows;      // 1 / l
  float* deltas = ils + rows;  // rowsum(p dp)
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long base = static_cast<long long>(b) * seq_len * d + h * dh;

  for (int r0 = 0; r0 < rows; r0 += kMhaChunk) {
    tc::fill_tile<kMhaChunk, DHP, kMmaThreads>(qs + r0 * RS, q + b * q_sb + h * dh, q_sl, r0, seq_len, dh, vec);
    tc::fill_tile<kMhaChunk, DHP, kMmaThreads>(ks + r0 * RS, k + b * k_sb + h * dh, k_sl, r0, seq_len, dh, vec);
    tc::fill_tile<kMhaChunk, DHP, kMmaThreads>(vs + r0 * RS, v + b * v_sb + h * dh, v_sl, r0, seq_len, dh, vec);
    tc::fill_tile<kMhaChunk, DHP, kMmaThreads>(dos + r0 * RS, dout + base, d, r0, seq_len, dh, vec);
  }
  tc::fill_rows_f32<kMmaThreads>(bs, bias + static_cast<long long>(b) * seq_len, 1, 0, rows, seq_len, -INFINITY);
  tc::cp_async_commit();
  // a query row past seq_len: m = +inf gives p = exp(-inf) = 0 in phase 2
  // (phase 1 overwrites the rows below seq_len, after the barrier)
  for (int i = threadIdx.x; i < rows; i += kMmaThreads) {
    ms[i] = INFINITY;
    ils[i] = 0.f;
    deltas[i] = 0.f;
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  const int rows_first = tc::lane_offset_rows_first<RS>(lane) * 2;
  const int cols_first = tc::lane_offset_cols_first<RS>(lane) * 2;
  const uint32_t q_addr = tc::shared_addr(qs);
  const uint32_t k_addr = tc::shared_addr(ks);
  const uint32_t v_addr = tc::shared_addr(vs);
  const uint32_t do_addr = tc::shared_addr(dos);
  constexpr uint32_t kBlockBytes = 16 * RS * 2;  // 16 rows of a tile
  const int n_blocks = (seq_len + 15) / 16;      // 16-row blocks that hold a row below seq_len

  // Phase 1: the warp's 16 query rows; the thread's two are g and g + 8.
  for (int rb = warp; rb < n_blocks; rb += WARPS) {
    const uint32_t q_at = q_addr + rb * kBlockBytes + rows_first;
    const uint32_t do_at = do_addr + rb * kBlockBytes + rows_first;
    uint32_t qf[DHP / 16][4], dof[DHP / 16][4];
    if constexpr (RESIDENT) {
      tc::load_a<DHP>(qf, q_at);
      tc::load_a<DHP>(dof, do_at);
    }
    float s[NTQ][4], dp[NTQ][4];
    // s = q k^T * scale + bias and dp = do v^T for the keys of pass c
    auto scores = [&](int c) {
#pragma unroll
      for (int nt = 0; nt < NTQ; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = 0.f;
          dp[nt][e] = 0.f;
        }
      }
      const uint32_t k_at = k_addr + c * (NPQ * RS * 2) + cols_first;
      const uint32_t v_at = v_addr + c * (NPQ * RS * 2) + cols_first;
      if constexpr (RESIDENT) {
        tc::product_abt<DHP, NTQ>(s, qf, k_at);
        tc::product_abt<DHP, NTQ>(dp, dof, v_at);
      } else {
        tc::product_abt<DHP, NTQ>(s, q_at, k_at);
        tc::product_abt<DHP, NTQ>(dp, do_at, v_at);
      }
      const float* bj = bs + c * NPQ + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NTQ; ++nt) {
        const float2 b2 = *reinterpret_cast<const float2*>(bj + nt * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = fmaf(s[nt][e], scale, (e & 1) ? b2.y : b2.x);
      }
    };

    // every pass holds a key below seq_len, whose bias is finite: m_new is
    // finite, and -inf - (-inf) is never formed
    const int n_pass = (seq_len + NPQ - 1) / NPQ;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // the lane's share of sum exp(s - m)
    float d_run[2] = {0.f, 0.f};  // and of sum exp(s - m) dp
    for (int c = 0; c < n_pass; ++c) {
      scores(c);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NTQ; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
      float m_new[2], sum[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) m_new[r] = fmaxf(m_run[r], tc::quad_max(mx[r]));
#pragma unroll
      for (int nt = 0; nt < NTQ; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(s[nt][e] - m_new[e >> 1]);  // exp(-inf) = 0 past seq_len
          sum[e >> 1] += p;
          dsum[e >> 1] = fmaf(p, dp[nt][e], dsum[e >> 1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float alpha = __expf(m_run[r] - m_new[r]);  // 0 on the first pass
        l_run[r] = l_run[r] * alpha + sum[r];
        d_run[r] = d_run[r] * alpha + dsum[r];
        m_run[r] = m_new[r];
      }
    }
    float inv_l[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      inv_l[r] = 1.f / tc::quad_sum(l_run[r]);
      delta[r] = tc::quad_sum(d_run[r]) * inv_l[r];
      const int row = rb * 16 + g + 8 * r;
      if (t == 0 && row < seq_len) {
        ms[row] = m_run[r];
        ils[row] = inv_l[r];
        deltas[row] = delta[r];
      }
    }

    float acc[DHP / 8][4] = {};
    for (int c = 0; c < n_pass; ++c) {
      if (n_pass > 1) scores(c);  // one pass: s and dp are still in registers
      uint32_t dsf[NPQ / 16][4];
#pragma unroll
      for (int nt = 0; nt < NTQ; ++nt) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = __expf(s[nt][e] - m_run[r]) * inv_l[r];
          ds[e] = p * (dp[nt][e] - delta[r]) * scale;
        }
        dsf[nt >> 1][(nt & 1) * 2] = tc::pack_bf16(ds[0], ds[1]);
        dsf[nt >> 1][(nt & 1) * 2 + 1] = tc::pack_bf16(ds[2], ds[3]);
      }
      tc::product_ab<DHP, NPQ / 16>(acc, dsf, k_addr + c * (NPQ * RS * 2) + rows_first);
    }
    tc::store_acc<DHP>(dq + base, acc, rb * 16, seq_len, d, dh, lane, vec);
  }
  __syncthreads();  // every query row's m, 1 / l and delta are in shared memory

  // Phase 2: the warp's 16 key rows; scores transposed (rows = keys).
  const int n_pass_k = (seq_len + NPK - 1) / NPK;
  for (int kb = warp; kb < n_blocks; kb += WARPS) {
    const uint32_t k_at = k_addr + kb * kBlockBytes + rows_first;
    const uint32_t v_at = v_addr + kb * kBlockBytes + rows_first;
    uint32_t kf[DHP / 16][4], vf[DHP / 16][4];
    if constexpr (RESIDENT) {
      tc::load_a<DHP>(kf, k_at);
      tc::load_a<DHP>(vf, v_at);
    }
    // a key past seq_len: bias -inf, p = 0, never stored
    const float bias_r[2] = {bs[kb * 16 + g], bs[kb * 16 + g + 8]};
    float acc_k[DHP / 8][4] = {}, acc_v[DHP / 8][4] = {};
    for (int c = 0; c < n_pass_k; ++c) {
      const uint32_t q_at = q_addr + c * (NPK * RS * 2);
      const uint32_t do_at = do_addr + c * (NPK * RS * 2);
      float sT[NTK][4] = {}, dpT[NTK][4] = {};
      if constexpr (RESIDENT) {
        tc::product_abt<DHP, NTK>(sT, kf, q_at + cols_first);
        tc::product_abt<DHP, NTK>(dpT, vf, do_at + cols_first);
      } else {
        tc::product_abt<DHP, NTK>(sT, k_at, q_at + cols_first);
        tc::product_abt<DHP, NTK>(dpT, v_at, do_at + cols_first);
      }
      uint32_t pf[NPK / 16][4], plo[NPK / 16][4], dsf[NPK / 16][4];
      const float* mj = ms + c * NPK + 2 * t;
      const float* lj = ils + c * NPK + 2 * t;
      const float* dj = deltas + c * NPK + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NTK; ++nt) {
        const float2 m2 = *reinterpret_cast<const float2*>(mj + nt * 8);
        const float2 l2 = *reinterpret_cast<const float2*>(lj + nt * 8);
        const float2 d2 = *reinterpret_cast<const float2*>(dj + nt * 8);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          p[e] = __expf(fmaf(sT[nt][e], scale, bias_r[e >> 1]) - (odd ? m2.y : m2.x)) * (odd ? l2.y : l2.x);
          ds[e] = p[e] * (dpT[nt][e] - (odd ? d2.y : d2.x)) * scale;
        }
        const int ks16 = nt >> 1, at = (nt & 1) * 2;
        if constexpr (SPLIT) {
          tc::split_bf16(p[0], p[1], pf[ks16][at], plo[ks16][at]);
          tc::split_bf16(p[2], p[3], pf[ks16][at + 1], plo[ks16][at + 1]);
        } else {
          pf[ks16][at] = tc::pack_bf16(p[0], p[1]);
          pf[ks16][at + 1] = tc::pack_bf16(p[2], p[3]);
        }
        dsf[ks16][at] = tc::pack_bf16(ds[0], ds[1]);
        dsf[ks16][at + 1] = tc::pack_bf16(ds[2], ds[3]);
      }
      tc::product_ab<DHP, NPK / 16>(acc_v, pf, do_at + rows_first);
      if constexpr (SPLIT) tc::product_ab<DHP, NPK / 16>(acc_v, plo, do_at + rows_first);
      tc::product_ab<DHP, NPK / 16>(acc_k, dsf, q_at + rows_first);
    }
    tc::store_acc<DHP>(dv + base, acc_v, kb * 16, seq_len, d, dh, lane, vec);
    tc::store_acc<DHP>(dk + base, acc_k, kb * 16, seq_len, d, dh, lane, vec);
  }
}

template <int DHP>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const void* bias,
                           const void* dout, void* dq, void* dk, void* dv, int batch,
                           int seq_len, int d, int heads, long long q_sb, long long q_sl,
                           long long k_sb, long long k_sl, long long v_sb, long long v_sl,
                           float scale, int vec, cudaStream_t stream) {
  constexpr int warps = kMhaWarps<DHP>;
  auto kernel = mha_bwd_mma_kernel<DHP, warps, kMhaPassQ<DHP>, kMhaPassK<DHP>,
                                   kMhaFragmentsResident<DHP>, kMhaDvSplit, kMhaMinBlocks<DHP>>;
  const size_t smem = mha_mma_smem_bytes(seq_len, DHP);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;  // the wrapper's own rule refuses such an L first
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  using B = __nv_bfloat16;
  kernel<<<dim3(heads, batch), warps * 32, smem, stream>>>(
      static_cast<const B*>(q), static_cast<const B*>(k), static_cast<const B*>(v),
      static_cast<const float*>(bias), static_cast<const B*>(dout), static_cast<B*>(dq),
      static_cast<B*>(dk), static_cast<B*>(dv), seq_len, d, d / heads, q_sb, q_sl, k_sb, k_sl,
      v_sb, v_sl, scale, vec);
  return cudaGetLastError();
}

// bf16 at a head width up to 128: the tensor-core kernel, in the tile
// instance that holds the head
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v, const void* bias,
                            const void* dout, void* dq, void* dk, void* dv, int batch,
                            int seq_len, int d, int heads, long long q_sb, long long q_sl,
                            long long k_sb, long long k_sl, long long v_sb, long long v_sl,
                            float scale, cudaStream_t stream) {
  const int dh = d / heads;
  // 16-byte copies and paired stores: the head width, every stride and every
  // base address allow them
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = dh % 8 == 0 && d % 8 == 0 && q_sb % 8 == 0 && q_sl % 8 == 0 && k_sb % 8 == 0 &&
                   k_sl % 8 == 0 && v_sb % 8 == 0 && v_sl % 8 == 0 && aligned(q) && aligned(k) &&
                   aligned(v) && aligned(dout) && aligned(dq) && aligned(dk) && aligned(dv);
  const auto run = [&](auto dhp) {
    return launch_bwd_mma<decltype(dhp)::value>(q, k, v, bias, dout, dq, dk, dv, batch, seq_len, d,
                                                heads, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale,
                                                vec, stream);
  };
  if (dh <= 16) return run(std::integral_constant<int, 16>{});
  if (dh <= 32) return run(std::integral_constant<int, 32>{});
  if (dh <= 64) return run(std::integral_constant<int, 64>{});
  return run(std::integral_constant<int, 128>{});
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* bias, const void* dout, void* dq, void* dk,
                       void* dv, int batch, int seq_len, int d, int heads,
                       long long q_sb, long long q_sl, long long k_sb,
                       long long k_sl, long long v_sb, long long v_sl,
                       float scale, cudaStream_t stream) {
  const int dh = d / heads;
  const size_t smem =
      sizeof(float) * (4 * static_cast<size_t>(seq_len) * (dh + 1) + seq_len +
                       2 * static_cast<size_t>(seq_len) * (seq_len + 1));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mha_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(heads, batch);
  mha_bwd_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), seq_len, d, dh, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, int batch, int seq_len,
                   int d, int heads, long long q_sb, long long q_sl,
                   long long k_sb, long long k_sl, long long v_sb,
                   long long v_sl, float scale, cudaStream_t stream) {
  const int dh = d / heads;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(seq_len) * (2 * dh + 2) +
                       static_cast<size_t>(kWarps) * (dh + seq_len));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mha_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(heads, batch);
  mha_fwd_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(out), seq_len, d, dh, q_sb, q_sl, k_sb, k_sl, v_sb,
      v_sl, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int b4cp_mha_fwd(const void* q, const void* k, const void* v,
                            const void* bias, void* out, int is_bf16,
                            int batch, int seq_len, int d, int heads,
                            long long q_sb, long long q_sl, long long k_sb,
                            long long k_sl, long long v_sb, long long v_sl,
                            float scale, int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's device in it
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (batch == 0 || seq_len == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, bias, out, batch, seq_len, d,
                                      heads, q_sb, q_sl, k_sb, k_sl, v_sb,
                                      v_sl, scale, s)
              : launch<float>(q, k, v, bias, out, batch, seq_len, d, heads,
                              q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale, s);
  return static_cast<int>(err);
}

// dout, dq, dk, dv: contiguous (B, L, D); q, k, v as in b4cp_mha_fwd
extern "C" int b4cp_mha_bwd(const void* q, const void* k, const void* v,
                            const void* bias, const void* dout, void* dq,
                            void* dk, void* dv, int is_bf16, int batch,
                            int seq_len, int d, int heads, long long q_sb,
                            long long q_sl, long long k_sb, long long k_sl,
                            long long v_sb, long long v_sl, float scale,
                            int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (batch == 0 || seq_len == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the input type alone picks the kernel (bf16 heads wider than the widest
  // tile instance stay with the scalar one)
  cudaError_t err;
  if (!is_bf16) {
    err = launch_bwd<float>(q, k, v, bias, dout, dq, dk, dv, batch, seq_len, d, heads, q_sb,
                            q_sl, k_sb, k_sl, v_sb, v_sl, scale, s);
  } else if (d / heads <= kMhaMaxHeadDim) {
    err = launch_bwd_bf16(q, k, v, bias, dout, dq, dk, dv, batch, seq_len, d, heads, q_sb, q_sl,
                          k_sb, k_sl, v_sb, v_sl, scale, s);
  } else {
    err = launch_bwd<__nv_bfloat16>(q, k, v, bias, dout, dq, dk, dv, batch, seq_len, d, heads,
                                    q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale, s);
  }
  return static_cast<int>(err);
}
