// Fused inverted dropout with an in-kernel counter-based generator.
//
// Replaces bert4clickpath_tpu/ops/pallas/dropout.py:_make_kernel (and its
// _mask_kernel_body): no random bits and no mask ever reach device memory,
// and the backward regenerates the same mask from the same seed.
//
//     bits[e] = Philox4x32-10(counter = (e / 4, 0, 0, 0), key = (seed, 0))[e % 4]
//     out[e]  = bits[e] > threshold ? round_to_type(float(x[e]) * inv_keep) : 0
//
// with e the flat element index, threshold = min(int(rate * 2^32), 2^32 - 1)
// and inv_keep = 1 / (1 - rate) in f32. The TPU kernel seeds its core's
// generator per grid step (seed ^ tile * 0x61C88647), so its mask depends on
// the tiling; here the mask depends on (seed, e) only, not on the launch
// geometry or the vector width, so the backward (the same kernel on g) and
// the plain PyTorch version (the same Philox in integer tensor ops) give the
// same bits. The seed is read from device memory: the caller draws it on the
// device and never waits for it on the host.
//
// What bounds it on the H100: device-memory bytes, one read and one write
// per element (4 bytes per bf16 element; 17 MB at the long-session shape
// (16, 1024, 256), ~5 us at 3.35 TB/s). Ten Philox rounds are two 32x32->64
// multiplies each per four elements, far below the integer rate needed to
// keep up with memory.
//
// Design: one thread per 8 consecutive elements (two Philox calls): one
// 16-byte load and store in bf16, two in f32. A tail of fewer than 8
// elements, or a base pointer that is not 16-byte aligned, takes the
// element-wise path. Out of place in the backward too: autograd may still
// hold g.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;

struct Bits4 {
  uint32_t v[4];
};

__device__ __forceinline__ Bits4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return Bits4{{c0, c1, c2, c3}};
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&y)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(y[4], y[5], y[6], y[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&y)[8]) {
  __align__(16) __nv_bfloat162 pairs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) pairs[i] = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(pairs);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, const int32_t* __restrict__ seed,
                   T* __restrict__ out, long long n, uint32_t threshold,
                   float inv_keep, int aligned) {
  const long long base =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kPerThread;
  if (base >= n) return;
  const uint32_t key = static_cast<uint32_t>(*seed);
  const unsigned long long ctr = static_cast<unsigned long long>(base) / 4;
  uint32_t bits[8];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const unsigned long long c = ctr + half;
    const Bits4 r = philox4x32_10(static_cast<uint32_t>(c),
                                  static_cast<uint32_t>(c >> 32), 0u, 0u, key, 0u);
#pragma unroll
    for (int i = 0; i < 4; ++i) bits[4 * half + i] = r.v[i];
  }
  if (aligned && base + kPerThread <= n) {
    float v[8];
    load8(x + base, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // the product rounds to the element type; a dropped element is +0
      v[i] = bits[i] > threshold ? __fmul_rn(v[i], inv_keep) : 0.f;
    }
    store8(out + base, v);
  } else {
    for (int i = 0; i < kPerThread && base + i < n; ++i) {
      out[base + i] = bits[i] > threshold
                          ? from_f<T>(__fmul_rn(to_f(x[base + i]), inv_keep))
                          : from_f<T>(0.f);
    }
  }
}

}  // namespace

// x, out: n contiguous elements (bf16 or f32); seed: one int32 on the
// device; threshold and inv_keep as in the header comment
extern "C" int b4cp_dropout(const void* x, const void* seed, void* out,
                            int is_bf16, long long n, unsigned int threshold,
                            float inv_keep, int aligned, int device,
                            void* stream) {
  // this library links its own CUDA runtime: select the caller's device in it
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const long long per_block = static_cast<long long>(kThreads) * kPerThread;
  const dim3 grid(static_cast<unsigned int>((n + per_block - 1) / per_block));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* sd = static_cast<const int32_t*>(seed);
  if (is_bf16) {
    dropout_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), sd, static_cast<__nv_bfloat16*>(out),
        n, threshold, inv_keep, aligned);
  } else {
    dropout_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), sd, static_cast<float*>(out), n, threshold,
        inv_keep, aligned);
  }
  return static_cast<int>(cudaGetLastError());
}
