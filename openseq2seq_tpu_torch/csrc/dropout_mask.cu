// Fused dropout (+ residual add): out = (x +) where(h < thr, y / q, 0),
// computed in fp32 and stored in y's type (bf16 or fp32).
//
// Replaces `_mask_kernel` in openseq2seq_tpu/ops/dropout_pallas.py:92
// (kernel B2), which the transformer reaches with the model key
// `fused_residual_dropout`: the FFN's relu dropout (no residual), in the
// forward and, applied to the cotangent with the same seed, in the
// backward; and `PreNormResidual`'s dropout + residual add.
//
// The random bits are the JAX package's interpret-mode stream (`_bits`,
// dropout_pallas.py:69-89), not the TPU hardware PRNG's, which nothing
// off the TPU reproduces: for element (r, c) of y flattened to (M, D),
// with the seed read as uint32 and all arithmetic mod 2^32,
//   s = seed + (r / 256) * 0x9E3779B1
//   h = ((r % 256) * 0x85EBCA77 ^ c * 0xC2B2AE3D) + s
//   h ^= h >> 16; h *= 0x7FEB352D; h ^= h >> 15; h *= 0x846CA68B;
//   h ^= h >> 16
// and the element is kept iff h < thr. The hash depends on the global row
// alone, so no padding to the TPU's 256-row tiles is needed. The seed is
// read from device memory (one int32 per call site and step, drawn on the
// device), so a launch never waits on the host.
//
// What bounds it on an H100: bytes. It reads y (and x) once and writes the
// output once; at the FFN shape (4096 x 4096 bf16) that is 67.1 MB, 20 us
// at 3.35 TB/s (the residual variant 100.7 MB, 30 us). The mask never
// reaches device memory. The hash is about 12 integer operations per
// element, far below the memory time.
//
// Design: one thread per 8 consecutive elements of a row (D % 8 == 0), a
// 16-byte load of bf16 (two of fp32) per operand, and a grid-stride loop
// over the (M * D / 8) groups; a few waves of 256-thread blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;                   // elements per thread
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  return h ^ (h >> 16);
}

struct Vec8f {
  float v[kVec];
};

__device__ __forceinline__ Vec8f load8(const float* p) {
  Vec8f r;
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
  return r;
}

__device__ __forceinline__ Vec8f load8(const __nv_bfloat16* p) {
  Vec8f r;
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    r.v[2 * i] = f.x;
    r.v[2 * i + 1] = f.y;
  }
  return r;
}

__device__ __forceinline__ void store8(float* p, const Vec8f& r) {
  reinterpret_cast<float4*>(p)[0] =
      make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  reinterpret_cast<float4*>(p)[1] =
      make_float4(r.v[4], r.v[5], r.v[6], r.v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const Vec8f& r) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i)
    h[i] = __floats2bfloat162_rn(r.v[2 * i], r.v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads)
dropout_mask_kernel(const T* __restrict__ y, const T* __restrict__ x,
                    T* __restrict__ out, const int* __restrict__ seed_ptr,
                    long long groups, int D, uint32_t thr, float inv_q) {
  const uint32_t seed = static_cast<uint32_t>(__ldg(seed_ptr));
  const int groups_per_row = D / kVec;
  for (long long g = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       g < groups; g += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = g / groups_per_row;
    const int c0 = static_cast<int>(g - r * groups_per_row) * kVec;
    const uint32_t s =
        seed + static_cast<uint32_t>(r >> 8) * 0x9E3779B1u;
    const uint32_t row_term = static_cast<uint32_t>(r & 255) * 0x85EBCA77u;
    const long long off = r * D + c0;
    Vec8f v = load8(y + off);
    Vec8f res;
    if (kResidual) res = load8(x + off);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const uint32_t h =
          mix((row_term ^ (static_cast<uint32_t>(c0 + i) * 0xC2B2AE3Du)) + s);
      // _rn intrinsics: no fused multiply-add, so the product is rounded
      // before the sum, as in the plain version
      float o = h < thr ? __fmul_rn(v.v[i], inv_q) : 0.f;
      if (kResidual) o = __fadd_rn(o, res.v[i]);
      v.v[i] = o;
    }
    store8(out + off, v);
  }
}

template <typename T>
int launch(const void* y, const void* x, void* out, const int* seed,
           long long M, int D, uint32_t thr, float inv_q,
           cudaStream_t stream) {
  const long long groups = M * (D / kVec);
  // enough blocks for a few waves of 132 SMs, then the grid-stride loop
  const long long want = (groups + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  if (x != nullptr)
    dropout_mask_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(y), static_cast<const T*>(x),
        static_cast<T*>(out), seed, groups, D, thr, inv_q);
  else
    dropout_mask_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(y), nullptr, static_cast<T*>(out), seed,
        groups, D, thr, inv_q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success). The caller guarantees M >= 1, D % 8 == 0, contiguous (M, D)
// device buffers of one type (bf16 when is_bf16, else fp32) aligned to 16
// bytes, x null (no residual) or of y's shape, and seed a device int32.
extern "C" int dropout_mask(const void* y, const void* x, void* out,
                            const void* seed, long long M, int D,
                            unsigned int thr, float inv_q, int is_bf16,
                            void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* seed_ptr = static_cast<const int*>(seed);
  if (is_bf16)
    return launch<__nv_bfloat16>(y, x, out, seed_ptr, M, D, thr, inv_q, s);
  return launch<float>(y, x, out, seed_ptr, M, D, thr, inv_q, s);
}
