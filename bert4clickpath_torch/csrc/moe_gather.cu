// The DeepSeek-V2 expert layer's moves between tokens and the rows sorted
// by expert (models/deepseek_v2.py, through ops/kernels/moe_gather.py). It
// replaces no TPU kernel: the JAX package has no experts. It was added
// because the plain ways to sum each token's k expert rows (a batched
// (1 x k) . (k x D) product, a scatter-add with bf16 atomics) ran at a few
// percent of the card's bandwidth.
//
// * gather_sum: out[t] = sum_j w[t, j] rows[idx[t, j]] over j < k, an
//   index past the rows giving 0; f32 sums rounded once to bf16. With k = 1
//   it is a gather (the dispatch of tokens to their expert rows, and the
//   rows' gradient); with k = the experts a token takes, the sum back.
// * gather_dot: dw[t, j] = <rows[idx[t, j]], g[t]> in f32: the gradient of
//   the gate weights.
//
// Bound: bytes (each row read once, each output written once). One warp a
// token, 16-byte loads (8 bf16 a lane), the k rows' sums in registers.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxK = 16;

__device__ __forceinline__ void add8(float (&acc)[8], const uint4& v, float w) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc[2 * i] += w * f.x;
    acc[2 * i + 1] += w * f.y;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    gather_sum_kernel(const __nv_bfloat16* __restrict__ rows, const long long* __restrict__ idx,
                      const float* __restrict__ w, __nv_bfloat16* __restrict__ out, int tokens, int k, int d,
                      long long n_rows) {
  const int t = blockIdx.x * kWarps + threadIdx.x / 32;
  if (t >= tokens) return;
  const int lane = threadIdx.x % 32;
  long long r[kMaxK];
  float wt[kMaxK];
  for (int j = 0; j < k; ++j) {
    r[j] = idx[static_cast<long long>(t) * k + j];
    wt[j] = w[static_cast<long long>(t) * k + j];
  }
  for (int c = lane * 8; c < d; c += 32 * 8) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < k; ++j) {
      if (r[j] < 0 || r[j] >= n_rows) continue;
      add8(acc, *reinterpret_cast<const uint4*>(rows + r[j] * d + c), wt[j]);
    }
    uint4 o;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    *reinterpret_cast<uint4*>(out + static_cast<long long>(t) * d + c) = o;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    gather_dot_kernel(const __nv_bfloat16* __restrict__ rows, const long long* __restrict__ idx,
                      const __nv_bfloat16* __restrict__ g, float* __restrict__ dw, int tokens, int k, int d,
                      long long n_rows) {
  const int t = blockIdx.x * kWarps + threadIdx.x / 32;
  if (t >= tokens) return;
  const int lane = threadIdx.x % 32;
  long long r[kMaxK];
  float part[kMaxK];
  for (int j = 0; j < k; ++j) {
    r[j] = idx[static_cast<long long>(t) * k + j];
    part[j] = 0.f;
  }
  for (int c = lane * 8; c < d; c += 32 * 8) {
    float gv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    add8(gv, *reinterpret_cast<const uint4*>(g + static_cast<long long>(t) * d + c), 1.f);
    for (int j = 0; j < k; ++j) {
      if (r[j] < 0 || r[j] >= n_rows) continue;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      add8(v, *reinterpret_cast<const uint4*>(rows + r[j] * d + c), 1.f);
#pragma unroll
      for (int i = 0; i < 8; ++i) part[j] += v[i] * gv[i];
    }
  }
  for (int j = 0; j < k; ++j) {
    const float s = warp_sum(part[j]);
    if (lane == 0) dw[static_cast<long long>(t) * k + j] = s;
  }
}

}  // namespace

// rows (n_rows, d) bf16, idx (tokens, k) int64, w (tokens, k) f32, out
// (tokens, d) bf16; d % 8 == 0, rows and out 16-byte aligned, k <= 16
extern "C" int b4cp_moe_gather_sum(const void* rows, const void* idx, const void* w, void* out, int tokens, int k,
                                   int d, long long n_rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 1 || k > kMaxK || d % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (tokens == 0) return 0;
  gather_sum_kernel<<<(tokens + kWarps - 1) / kWarps, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(rows), static_cast<const long long*>(idx), static_cast<const float*>(w),
      static_cast<__nv_bfloat16*>(out), tokens, k, d, n_rows);
  return static_cast<int>(cudaGetLastError());
}

// rows (n_rows, d) bf16, idx (tokens, k) int64, g (tokens, d) bf16, dw
// (tokens, k) f32; the same conditions
extern "C" int b4cp_moe_gather_dot(const void* rows, const void* idx, const void* g, void* dw, int tokens, int k,
                                   int d, long long n_rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 1 || k > kMaxK || d % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (tokens == 0) return 0;
  gather_dot_kernel<<<(tokens + kWarps - 1) / kWarps, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(rows), static_cast<const long long*>(idx),
      static_cast<const __nv_bfloat16*>(g), static_cast<float*>(dw), tokens, k, d, n_rows);
  return static_cast<int>(cudaGetLastError());
}
