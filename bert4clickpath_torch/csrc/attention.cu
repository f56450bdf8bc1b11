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
// the wrapper refuses an L beyond what one block can hold (the blockwise
// kernel that streams K/V is later work). No tensor cores yet: wgmma, TMA
// and several rows per warp are for the PRs that make this fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p rounded to v's dtype before the PV product (attention.py:70)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

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
// 4 L (Dh + 1) + 2 L (L + 1) floats: the wrapper refuses an L beyond one
// block (the blockwise dq / dkv kernels are later work).
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
  const cudaError_t err =
      is_bf16 ? launch_bwd<__nv_bfloat16>(q, k, v, bias, dout, dq, dk, dv,
                                          batch, seq_len, d, heads, q_sb, q_sl,
                                          k_sb, k_sl, v_sb, v_sl, scale, s)
              : launch_bwd<float>(q, k, v, bias, dout, dq, dk, dv, batch,
                                  seq_len, d, heads, q_sb, q_sl, k_sb, k_sl,
                                  v_sb, v_sl, scale, s);
  return static_cast<int>(err);
}
