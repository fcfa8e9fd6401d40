// Shared by the Conformer convolution module's forward and backward
// kernels (conformer_conv_fwd.cu, conformer_conv_bwd.cu): tile constants,
// conversions, the layer norm of a row, and the 64 x 64 output tile of a
// product over a 32-row weight chunk, on the CUDA cores (fp32) or the
// tensor cores (bf16 operands, fp32 accumulation).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "mma_sync.cuh"

namespace conformer_conv {

using namespace mma_sync;

constexpr int kRows = 64;       // rows (frames) per CTA
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 32;         // weight rows staged at once
constexpr int kWC = 64;         // weight columns staged at once
constexpr int kCC = 64;         // depthwise channels per pass
constexpr int kUS = kCC + 4;    // u tile row stride (floats)
// the transposed bf16 weight chunk's row stride (elements): 20 words, so
// that a B fragment's 8 x 4 words fall in 32 banks
constexpr int kWS = kKC + 8;

template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
// the activations' row stride past D (floats): 4 spreads the FMA path's
// 16-byte loads of rows 4 apart, 8 the tensor-core path's 8-byte loads of
// rows 1 apart, over the banks
template <typename T>
constexpr int kRowPad = kTensorCores<T> ? 8 : 4;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// a product operand rounded to the activations' type (the TPU kernel's
// mxu_dtype: bf16 for bf16 inputs, fp32 otherwise)
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The layer norm of one row of `row` (D floats in shared memory), in
// place, by one warp: fast variance, eps; the result rounded to T.
template <typename T>
__device__ __forceinline__ void layer_norm_row(float* row, int D,
                                               const float* scale,
                                               const float* bias, float eps,
                                               bool swish, int lane) {
  float sum = 0.f, sq = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float v = row[c];
    sum += v;
    sq = fmaf(v, v, sq);
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mu = sum / D;
  const float rstd = rsqrtf(sq / D - mu * mu + eps);
  for (int c = lane; c < D; c += 32) {
    float n = fmaf((row[c] - mu) * rstd, scale[c], bias[c]);
    if (swish) n = n * sigmoid(n);
    row[c] = round_to<T>(n);
  }
}

// acc[i][c] += sum over kk < kKC of a[ty*4 + i][kc + kk] * w[kk][tx*4 + c]:
// a (kRows x SA floats) and the staged weight chunk w (kKC x kWC floats)
// in shared memory, 16-byte loads of both.
__device__ __forceinline__ void product_chunk(const float* a, int SA, int kc,
                                              const float* w,
                                              float (&acc)[4][4], int tx,
                                              int ty) {
#pragma unroll 2
  for (int kk = 0; kk < kKC; kk += 4) {
    float av[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(
          a + (ty * 4 + i) * SA + kc + kk);
      av[i][0] = x.x;
      av[i][1] = x.y;
      av[i][2] = x.z;
      av[i][3] = x.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 x =
          *reinterpret_cast<const float4*>(w + (kk + q) * kWC + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(av[i][q], x.x, acc[i][0]);
        acc[i][1] = fmaf(av[i][q], x.y, acc[i][1]);
        acc[i][2] = fmaf(av[i][q], x.z, acc[i][2]);
        acc[i][3] = fmaf(av[i][q], x.w, acc[i][3]);
      }
    }
  }
}

// The tensor-core form of product_chunk: warp (wr, wc) = (warp % 4,
// warp / 4) accumulates rows wr*16 .. +15 against the chunk's n-tiles
// wc*4 .. +3 (8 columns each), acc[n] in the m16n8 accumulator layout;
// a holds values already rounded to bf16 (packing them is exact), wt is
// the chunk transposed, kWC x kWS bf16.
__device__ __forceinline__ void product_chunk_mma(const float* a, int SA,
                                                  int kc,
                                                  const __nv_bfloat16* wt,
                                                  float (&acc)[4][4],
                                                  int warp, int lane) {
  const int g = lane / 4, t4 = lane % 4, wr = warp % 4, wc = warp / 4;
  const float* a0 = a + (wr * 16 + g) * SA + kc + 2 * t4;
#pragma unroll
  for (int ks = 0; ks < kKC; ks += 16) {
    const float2 x0 = *reinterpret_cast<const float2*>(a0 + ks);
    const float2 x1 = *reinterpret_cast<const float2*>(a0 + 8 * SA + ks);
    const float2 x2 = *reinterpret_cast<const float2*>(a0 + ks + 8);
    const float2 x3 =
        *reinterpret_cast<const float2*>(a0 + 8 * SA + ks + 8);
    const unsigned af[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                            pack_bf16(x2.x, x2.y), pack_bf16(x3.x, x3.y)};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const __nv_bfloat16* wb =
          wt + ((wc * 4 + n) * 8 + g) * kWS + ks + 2 * t4;
      mma_bf16(acc[n], af, *reinterpret_cast<const unsigned*>(wb),
               *reinterpret_cast<const unsigned*>(wb + 8));
    }
  }
}

}  // namespace conformer_conv
