// Adam over every parameter in one pass: both moments, the bias correction,
// the weight decay and the learning rate, written in place.
//
// Replaces no Pallas kernel: the JAX package leaves optax's chain
// (scale_by_adam, add_decayed_weights, scale(-1)) and the learning rate's
// apply to XLA's fusion. The port's plain version is
// training/train_state.py:Adam.update followed by p.add_(u * lr): about 17
// elementwise PyTorch kernels a tensor, each reading and writing a full
// tensor. This kernel gives the same bits:
//
//     b1m = b1 * mu               (bf16 mu: b1 = bf16(0.9), product rounded to bf16)
//     mu' = (1 - b1) * g + b1m
//     nu' = (1 - b2) * (g * g) + b2 * nu
//     u   = (mu' * inv_bc1) / (sqrt(nu' * inv_bc2) + eps)
//     u  += wd * p                (decayed tensors only)
//     p  += -u * (lr * lr_scale)
//     mu  = round_to_mu_type(mu'), nu = nu'
//
// every operation in f32 with one rounding to nearest (the explicit _rn
// intrinsics keep nvcc from contracting any pair into an FMA), in the plain
// path's order. PyTorch on the card divides a tensor by a host float as a
// product with the float's f32 reciprocal, so the bias corrections come as
// inv_bc1 = 1 / bc1 and inv_bc2 = 1 / bc2, rounded to f32 on the host.
// lr_scale is read from device memory, so the step never waits on the host.
//
// What bounds it on the H100: device-memory bytes. It reads p, g, mu and nu
// and writes p, mu and nu once: 28 bytes a parameter with an f32 mu, 24 with
// a bf16 one (35.85 GB, 10.70 ms at 3.35 TB/s, for the 1.28 billion
// parameters of the 10M-item catalog). The arithmetic is a few tens of
// flops a parameter, far below the card's rate.
//
// Design: one launch for a list of up to kMaxTensors tensors, passed in the
// kernel's parameter struct. The work is cut into chunks of `chunk` elements,
// the same size for every tensor (a tensor's last chunk is shorter), and
// one block takes one chunk: the chunk size follows the total, so that a
// billion-element table and a few thousand elements of biases both give
// some kWaves blocks an SM, capped at kMaxChunk so that the last blocks of
// a large launch leave little tail. A block finds its tensor by a binary
// search over the tensors' first chunks. Offsets are 64-bit (a table
// exceeds 2^31 bytes). A tensor whose four arrays all start on 16 bytes (8
// for a bf16 mu) takes 16-byte loads and stores (an 8-byte one for bf16
// mu), four elements at a time, two such vectors in flight a thread, with
// a scalar tail of up to three elements; any other tensor takes the scalar
// path. Every byte is touched once, so loads and stores are streaming
// (evict-first: ld.global.cs / st.global.cs).

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxTensors = 80;
constexpr int kThreads = 256;
constexpr int kVec = 4;     // elements a 16-byte access of an f32 array holds
constexpr int kUnroll = 2;  // vectors a thread has in flight
constexpr int kIter = kThreads * kVec * kUnroll;  // elements a block pass
constexpr long long kMaxChunk = 8LL * kIter;      // 16,384 elements
constexpr int kWaves = 32;  // blocks an SM that a small launch aims at

constexpr unsigned char kDecay = 1;
constexpr unsigned char kAligned = 2;

struct AdamConsts {
  float c1;       // f32(1 - b1)
  float b1;       // b1 in mu's type, widened to f32
  float c2;       // f32(1 - b2)
  float b2;       // f32(b2)
  float inv_bc1;  // f32(1) / f32(1 - b1^t)
  float inv_bc2;  // f32(1) / f32(1 - b2^t)
  float eps;
  float wd;
  float lr;              // f32(schedule(step))
  const float* lr_scale;  // () f32 on the device
};

struct AdamTensors {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  void* mu[kMaxTensors];
  float* nu[kMaxTensors];
  long long n[kMaxTensors];
  int first_chunk[kMaxTensors];
  unsigned char flags[kMaxTensors];  // kDecay | kAligned
  int count;
  long long chunk;
};

static_assert(sizeof(AdamTensors) + sizeof(AdamConsts) <= 4096,
              "a kernel's parameters must fit in 4 KB");

// mu's loads and stores in its own type, widened to / rounded from f32
template <typename MuT>
struct MuIo;

template <>
struct MuIo<float> {
  static constexpr int kAlign = 16;
  static __device__ __forceinline__ float4 load4(const void* mu, long long e) {
    return __ldcs(reinterpret_cast<const float4*>(static_cast<const float*>(mu) + e));
  }
  static __device__ __forceinline__ void store4(void* mu, long long e, float4 v) {
    __stcs(reinterpret_cast<float4*>(static_cast<float*>(mu) + e), v);
  }
  static __device__ __forceinline__ float load1(const void* mu, long long e) {
    return __ldcs(static_cast<const float*>(mu) + e);
  }
  static __device__ __forceinline__ void store1(void* mu, long long e, float v) {
    __stcs(static_cast<float*>(mu) + e, v);
  }
};

template <>
struct MuIo<__nv_bfloat16> {
  static constexpr int kAlign = 8;
  static __device__ __forceinline__ float4 load4(const void* mu, long long e) {
    const uint2 raw =
        __ldcs(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(mu) + e));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  static __device__ __forceinline__ void store4(void* mu, long long e, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned int*>(&lo);
    raw.y = *reinterpret_cast<const unsigned int*>(&hi);
    __stcs(reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(mu) + e), raw);
  }
  static __device__ __forceinline__ float load1(const void* mu, long long e) {
    const unsigned short raw =
        __ldcs(reinterpret_cast<const unsigned short*>(static_cast<const __nv_bfloat16*>(mu) + e));
    return __bfloat162float(__ushort_as_bfloat16(raw));
  }
  static __device__ __forceinline__ void store1(void* mu, long long e, float v) {
    __stcs(reinterpret_cast<unsigned short*>(static_cast<__nv_bfloat16*>(mu) + e),
           __bfloat16_as_ushort(__float2bfloat16_rn(v)));
  }
};

// one parameter: the plain path's operations in its order, one rounding each
template <typename MuT>
__device__ __forceinline__ void adam_one(float& p, float g, float& mu, float& nu,
                                         const AdamConsts& k, float lr, bool decay) {
  // b1 * mu is a product in mu's type in the plain path
  const float b1m = round_to<MuT>(__fmul_rn(k.b1, mu));
  mu = __fadd_rn(__fmul_rn(k.c1, g), b1m);
  nu = __fadd_rn(__fmul_rn(k.c2, __fmul_rn(g, g)), __fmul_rn(k.b2, nu));
  const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(nu, k.inv_bc2)), k.eps);
  float u = __fdiv_rn(__fmul_rn(mu, k.inv_bc1), denom);
  if (decay) u = __fadd_rn(u, __fmul_rn(k.wd, p));
  p = __fadd_rn(p, __fmul_rn(-u, lr));
}

template <typename MuT>
__device__ __forceinline__ void adam_scalar(float* p, const float* g, void* mu, float* nu,
                                            long long e, const AdamConsts& k, float lr,
                                            bool decay) {
  float pv = __ldcs(p + e), mv = MuIo<MuT>::load1(mu, e), nv = __ldcs(nu + e);
  adam_one<MuT>(pv, __ldcs(g + e), mv, nv, k, lr, decay);
  __stcs(p + e, pv);
  MuIo<MuT>::store1(mu, e, mv);
  __stcs(nu + e, nv);
}

template <typename MuT>
__global__ void __launch_bounds__(kThreads)
    adam_kernel(const AdamTensors t, const AdamConsts k) {
  const int c = blockIdx.x;
  // the tensor holding chunk c: the last one whose first chunk is <= c
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_chunk[mid] <= c) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  float* p = t.p[lo];
  const float* g = t.g[lo];
  void* mu = t.mu[lo];
  float* nu = t.nu[lo];
  const bool decay = t.flags[lo] & kDecay;
  const long long start = static_cast<long long>(c - t.first_chunk[lo]) * t.chunk;
  const long long end = min(start + t.chunk, t.n[lo]);
  const float lr = __fmul_rn(k.lr, __ldg(k.lr_scale));

  if (!(t.flags[lo] & kAligned)) {
    for (long long e = start + threadIdx.x; e < end; e += kThreads) {
      adam_scalar<MuT>(p, g, mu, nu, e, k, lr, decay);
    }
    return;
  }
  // start is a multiple of the chunk, so of kVec: vectors up to vec_end
  const long long vec_end = start + ((end - start) & ~static_cast<long long>(kVec - 1));
  for (long long base = start + threadIdx.x * kVec; base < vec_end; base += kIter) {
    float4 pv[kUnroll], gv[kUnroll], mv[kUnroll], nv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = base + static_cast<long long>(u) * kThreads * kVec;
      if (e < vec_end) {
        pv[u] = __ldcs(reinterpret_cast<const float4*>(p + e));
        gv[u] = __ldcs(reinterpret_cast<const float4*>(g + e));
        mv[u] = MuIo<MuT>::load4(mu, e);
        nv[u] = __ldcs(reinterpret_cast<const float4*>(nu + e));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = base + static_cast<long long>(u) * kThreads * kVec;
      if (e < vec_end) {
        adam_one<MuT>(pv[u].x, gv[u].x, mv[u].x, nv[u].x, k, lr, decay);
        adam_one<MuT>(pv[u].y, gv[u].y, mv[u].y, nv[u].y, k, lr, decay);
        adam_one<MuT>(pv[u].z, gv[u].z, mv[u].z, nv[u].z, k, lr, decay);
        adam_one<MuT>(pv[u].w, gv[u].w, mv[u].w, nv[u].w, k, lr, decay);
        __stcs(reinterpret_cast<float4*>(p + e), pv[u]);
        MuIo<MuT>::store4(mu, e, mv[u]);
        __stcs(reinterpret_cast<float4*>(nu + e), nv[u]);
      }
    }
  }
  const long long e = vec_end + threadIdx.x;
  if (e < end) adam_scalar<MuT>(p, g, mu, nu, e, k, lr, decay);
}

bool on(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

extern "C" int b4cp_adam_capacity() { return kMaxTensors; }

// rows: `count` rows of six int64 (p, g, mu, nu, numel, decay); p, g and nu
// f32, mu f32 or (mu_is_bf16) bf16, all contiguous on `device`. Tensors with
// no elements are skipped. One launch on `stream`.
extern "C" int b4cp_adam(const long long* rows, int count, int mu_is_bf16, float c1,
                         float b1, float c2, float b2, float inv_bc1, float inv_bc2,
                         float eps, float wd, float lr, const void* lr_scale, int device,
                         void* stream) {
  // this library links its own CUDA runtime: select the caller's device in it
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (count < 0 || count > kMaxTensors) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  AdamTensors t;
  t.count = 0;
  long long total = 0;
  const int mu_align = mu_is_bf16 ? MuIo<__nv_bfloat16>::kAlign : MuIo<float>::kAlign;
  for (int i = 0; i < count; ++i) {
    const long long* r = rows + 6 * i;
    if (r[4] <= 0) continue;
    const int j = t.count++;
    t.p[j] = reinterpret_cast<float*>(r[0]);
    t.g[j] = reinterpret_cast<const float*>(r[1]);
    t.mu[j] = reinterpret_cast<void*>(r[2]);
    t.nu[j] = reinterpret_cast<float*>(r[3]);
    t.n[j] = r[4];
    const bool aligned = on(t.p[j], 16) && on(t.g[j], 16) && on(t.nu[j], 16) && on(t.mu[j], mu_align);
    t.flags[j] = (r[5] ? kDecay : 0) | (aligned ? kAligned : 0);
    total += r[4];
  }
  if (t.count == 0) return static_cast<int>(cudaGetLastError());
  // chunks of a multiple of kIter elements: about kWaves blocks an SM for a
  // small total, kMaxChunk for a large one
  const long long target = (total + static_cast<long long>(sms) * kWaves - 1) /
                           (static_cast<long long>(sms) * kWaves);
  t.chunk = std::min(kMaxChunk, std::max(1LL, (target + kIter - 1) / kIter) * kIter);
  long long chunks = 0;
  for (int j = 0; j < t.count; ++j) {
    t.first_chunk[j] = static_cast<int>(chunks);
    chunks += (t.n[j] + t.chunk - 1) / t.chunk;
  }
  if (chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  const AdamConsts k{c1, b1, c2, b2, inv_bc1, inv_bc2, eps, wd, lr,
                     static_cast<const float*>(lr_scale)};
  const dim3 grid(static_cast<unsigned int>(chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mu_is_bf16) {
    adam_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(t, k);
  } else {
    adam_kernel<float><<<grid, kThreads, 0, s>>>(t, k);
  }
  return static_cast<int>(cudaGetLastError());
}
