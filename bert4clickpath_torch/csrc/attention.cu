// Masked multi-head attention forward over (B, L, D), heads as column
// sub-ranges of D.
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
