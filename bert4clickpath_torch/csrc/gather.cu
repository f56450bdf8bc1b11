// Fused embedding gather + scale + position add, forward.
//
// Replaces bert4clickpath_tpu/ops/pallas/gather.py:_gather_kernel (reached
// through fused_gather_scale_pos / fused_embed_scale_pos):
//
//     out[b, l, :] = round_to_out(float(table[ids[b, l], :]) * scale + pos[l, :])
//
// with table f32 (V, D), ids int32 (B, L), pos f32 (L, D) and out bf16 or
// f32 (B, L, D); a null pos adds nothing (the DeepSeek-V2 block takes its
// positions as RoPE inside attention). The product and the sum are taken in f32 without
// contraction into an FMA, and rounded once to the output type, as the
// plain version (gather_scale_pos_reference) does.
//
// What bounds it on the H100: device-memory bytes. Per token it reads one
// D-row of the table (4*D bytes) and one row of pos (4*D bytes, but only L
// distinct rows, which stay in L2) and writes D outputs (2*D bytes in bf16):
// about B*L*D*(4 + 2) bytes in all, with no arithmetic to speak of. At the
// serving shape (B=64, L=53, D=256) that is about 5 MB, a couple of
// microseconds at 3.35 TB/s, so at small B the launch itself dominates.
//
// Design: one warp per token row, lanes across D with 16-byte loads (D=256
// is two float4 per lane), so every load and store is coalesced. The TPU
// kernel's 8-row DMA window and its tile/divisibility rules are dropped:
// any B*L works, including the B=1 serving bucket (53 tokens). An id outside
// [0, V) traps on the device instead of reading out of bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float fused(float t, float scale, float p) {
  // __fmul_rn/__fadd_rn forbid FMA contraction: one rounding per op, as in
  // the plain PyTorch version
  return __fadd_rn(__fmul_rn(t, scale), p);
}

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  // two round-to-nearest-even pairs, one 8-byte store
  __nv_bfloat162 pair[2] = {__floats2bfloat162_rn(v.x, v.y),
                            __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(pair);
}

template <typename OutT, bool POS>
__global__ void gather_scale_pos_kernel(const float* __restrict__ table,
                                        const int32_t* __restrict__ ids,
                                        const float* __restrict__ pos,
                                        OutT* __restrict__ out, int n_tokens,
                                        int seq_len, int d, int v,
                                        float scale) {
  const int token = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (token >= n_tokens) return;
  const int id = ids[token];
  if (id < 0 || id >= v) {
    // out-of-range id: fail loudly rather than read another row
    __trap();
  }
  const float* row = table + static_cast<size_t>(id) * d;
  const float* prow = POS ? pos + static_cast<size_t>(token % seq_len) * d : nullptr;
  OutT* orow = out + static_cast<size_t>(token) * d;
  // d % 4 == 0 and 16-byte aligned rows are checked by the wrapper
  for (int c = lane * 4; c < d; c += 32 * 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(row + c));
    float4 r;
    if constexpr (POS) {
      const float4 p = __ldg(reinterpret_cast<const float4*>(prow + c));
      r.x = fused(t.x, scale, p.x);
      r.y = fused(t.y, scale, p.y);
      r.z = fused(t.z, scale, p.z);
      r.w = fused(t.w, scale, p.w);
    } else {
      r = make_float4(__fmul_rn(t.x, scale), __fmul_rn(t.y, scale), __fmul_rn(t.z, scale), __fmul_rn(t.w, scale));
    }
    store4(orow + c, r);
  }
}

}  // namespace

extern "C" int b4cp_gather_scale_pos(const void* table, const void* ids,
                                     const void* pos, void* out,
                                     int out_is_bf16, int n_tokens,
                                     int seq_len, int d, int v, float scale,
                                     int device, void* stream) {
  // this library links its own CUDA runtime: select the caller's device in it
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n_tokens == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n_tokens + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto* typed_out, auto with_pos) {
    using OutT = std::remove_pointer_t<decltype(typed_out)>;
    gather_scale_pos_kernel<OutT, decltype(with_pos)::value><<<grid, block, 0, s>>>(
        static_cast<const float*>(table), static_cast<const int32_t*>(ids),
        static_cast<const float*>(pos), typed_out, n_tokens, seq_len, d, v, scale);
  };
  if (out_is_bf16) {
    if (pos) {
      run(static_cast<__nv_bfloat16*>(out), std::true_type{});
    } else {
      run(static_cast<__nv_bfloat16*>(out), std::false_type{});
    }
  } else if (pos) {
    run(static_cast<float*>(out), std::true_type{});
  } else {
    run(static_cast<float*>(out), std::false_type{});
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* b4cp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
