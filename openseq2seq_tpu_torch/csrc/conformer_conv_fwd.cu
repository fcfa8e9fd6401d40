// The Conformer convolution module's forward, layer-norm variant:
//   y = pw2(swish(LN2(dwconv_k(mask(GLU(pw1(LN1(x))))))))
// over x (B, T, D) in bf16 or fp32, with fp32 weights.
//
// Replaces `_fwd_kernel` in openseq2seq_tpu/ops/conformer_pallas.py:142
// (its pallas_call at :339; entry `conformer_conv_module`, :426), with
// that kernel's precision: x is read as fp32; LN1 and LN2 take the fast
// variance E[x^2] - E[x]^2 with eps (1e-6); the two pointwise products
// take operands rounded to x's type (h0 and pw1's weight, the swish output
// and pw2's weight) and accumulate in fp32, then add their fp32 biases;
// GLU, the time mask (u = 0 at t >= len), the depthwise conv with fp32
// taps and bias, LN2 and swish run in fp32; y is rounded to x's type.
// Rows t >= len of y are not zeroed: the caller's residual add and the
// encoder's masks take care of them, as in the JAX package. Dropout and
// the residual add are the caller's.
//
// What bounds it on an H100: operations. At Conformer-M (B=64, T=250,
// D=256, k=31, bf16) it does 2 B T D (2D) + 2 B T D D + 2 B T D k = 6.5
// GFLOP (6.6 us at 989 TFLOP/s) against 17.2 MB of x, y and weights (5.1 us
// at 3.35 TB/s).
//
// Design (a simple kernel that is right; wgmma and TMA are later work).
// Not the TPU's layout, a whole batch tile in VMEM: pw1's weight alone
// (D x 2D) does not fit beside the activations in one block's shared
// memory, so weights stream through shared memory in 32-row chunks, and
// the module runs as two launches with an fp32 (B, T, D) u between them
// (the TPU kernel keeps u in fp32 too, so nothing is rounded there):
//  1. `conformer_conv_pw1_kernel`: one CTA per 64 rows of (B x T): LN1 of
//     its rows into shared memory, then pw1 for 32 output channels at a
//     time, with each channel's GLU value and gate columns interleaved so
//     that one thread holds both, then the GLU and the mask, u written out;
//  2. `conformer_conv_dw_pw2_kernel`: one CTA per (64 frames, batch row):
//     the depthwise conv, 64 channels at a time, from a tile of u with its
//     (k - 1) / 2 halo on each side (zeros outside [0, T), XLA's SAME
//     padding), then LN2 and swish in place, then pw2 for 64 output
//     channels at a time.
// The products are the kernel's own, no library is called: for bf16 x,
// tensor cores through mma.sync m16n8k16 (bf16 operands, fp32
// accumulation: the TPU kernel's precision), each of the 8 warps a 16-row
// x 32-column tile, A fragments packed from the rounded activations and B
// fragments read from the weight chunk staged transposed in bf16; for
// fp32 x, fp32 FMAs on the CUDA cores (TF32 would round the operands), 4 x
// 4 outputs a thread from 16-byte shared-memory loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "conformer_conv.cuh"

namespace {

using namespace conformer_conv;

// LN1, pw1 (D -> 2D) + bias, GLU and the time mask over 64 rows of the
// flattened (B x T, D) input; u (B x T, D) fp32 out.
template <typename T>
__global__ void __launch_bounds__(kThreads)
conformer_conv_pw1_kernel(const T* __restrict__ x,
                          const int* __restrict__ lens,
                          const float* __restrict__ ln1s,
                          const float* __restrict__ ln1b,
                          const float* __restrict__ w1,
                          const float* __restrict__ b1,
                          float* __restrict__ u, int N, int Tn, int D,
                          float eps) {
  const int SA = D + kRowPad<T>;
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;                  // kRows x SA: LN1 output, rounded
  float* sw = sa + kRows * SA;       // a chunk of pw1's weight: kKC x kWC
                                     // fp32, or kWC x kWS bf16 transposed
  auto* swt = reinterpret_cast<__nv_bfloat16*>(sw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * kRows;

  for (int rr = warp; rr < kRows; rr += kWarps) {
    float* row = sa + rr * SA;
    const int n = r0 + rr;
    for (int c = lane; c < D; c += 32)
      row[c] = n < N ? to_float(x[static_cast<size_t>(n) * D + c]) : 0.f;
    __syncwarp();
    layer_norm_row<T>(row, D, ln1s, ln1b, eps, false, lane);
  }

  for (int j0 = 0; j0 < D; j0 += kWC / 2) {
    float acc[4][4] = {};
    for (int kc = 0; kc < D; kc += kKC) {
      __syncthreads();               // LN1 done; the last chunk's reads done
      // column 2 c of the chunk is output channel j0 + c's value column,
      // 2 c + 1 its gate column (D + j0 + c)
      for (int i = tid; i < kKC * kWC; i += kThreads) {
        const int kk = i / kWC, c = i % kWC;
        const int col = (c & 1 ? D : 0) + j0 + (c >> 1);
        const float w = w1[static_cast<size_t>(kc + kk) * 2 * D + col];
        if constexpr (kTensorCores<T>)
          swt[c * kWS + kk] = __float2bfloat16(w);
        else
          sw[i] = w;
      }
      __syncthreads();
      if constexpr (kTensorCores<T>)
        product_chunk_mma(sa, SA, kc, swt, acc, warp, lane);
      else
        product_chunk(sa, SA, kc, sw, acc, tx, ty);
    }
    // acc[i][c]: row ty*4 + i, chunk column tx*4 + c; with tensor cores
    // acc[n][e]: row wr*16 + lane/4 (+ 8 for e >= 2), chunk column
    // (wc*4 + n)*8 + 2 (lane % 4) + e % 2. Either way a thread holds both
    // columns of its channels.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int n, j;
        if constexpr (kTensorCores<T>) {
          n = r0 + (warp % 4) * 16 + lane / 4 + 8 * e;
          j = j0 + ((warp / 4) * 4 + i) * 4 + lane % 4;
        } else {
          n = r0 + ty * 4 + i;
          j = j0 + 2 * tx + e;
        }
        if (n >= N) continue;
        const int b = n / Tn, t = n - b * Tn;
        const float p = acc[i][2 * e] + b1[j];
        const float g = acc[i][2 * e + 1] + b1[D + j];
        u[static_cast<size_t>(n) * D + j] =
            t < lens[b] ? p * sigmoid(g) : 0.f;
      }
  }
}

// The depthwise conv (k taps, SAME) + bias, LN2, swish and pw2 (D -> D)
// + bias over 64 frames of one batch row; y (B, T, D) in T out.
template <typename T>
__global__ void __launch_bounds__(kThreads)
conformer_conv_dw_pw2_kernel(const float* __restrict__ u,
                             const float* __restrict__ wd,
                             const float* __restrict__ bd,
                             const float* __restrict__ ln2s,
                             const float* __restrict__ ln2b,
                             const float* __restrict__ w2,
                             const float* __restrict__ b2,
                             T* __restrict__ y, int Tn, int D, int K,
                             float eps) {
  const int SC = D + kRowPad<T>;
  const int halo = (K - 1) / 2;
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;                        // kRows x SC: conv, then swish
  float* su = sc + kRows * SC;             // (kRows + K - 1) x kUS: u tile
  float* sw = su + (kRows + K - 1) * kUS;  // a chunk of pw2, as in pw1
  float* swd = sw + kKC * kWC;             // K x kCC: depthwise taps
  auto* swt = reinterpret_cast<__nv_bfloat16*>(sw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;
  const int t0 = blockIdx.x * kRows, b = blockIdx.y;
  const float* ub = u + static_cast<size_t>(b) * Tn * D;

  for (int c0 = 0; c0 < D; c0 += kCC) {
    __syncthreads();                 // the last pass's reads are done
    for (int i = tid; i < (kRows + K - 1) * kCC; i += kThreads) {
      const int r = i / kCC, ch = i % kCC, t = t0 - halo + r;
      su[r * kUS + ch] =
          t >= 0 && t < Tn ? ub[static_cast<size_t>(t) * D + c0 + ch] : 0.f;
    }
    for (int i = tid; i < K * kCC; i += kThreads)
      swd[i] = wd[(i / kCC) * D + c0 + i % kCC];
    __syncthreads();
    const int ch = tid % kCC;
    for (int r = tid / kCC; r < kRows; r += kThreads / kCC) {
      float acc = 0.f;
      for (int j = 0; j < K; ++j)
        acc = fmaf(swd[j * kCC + ch], su[(r + j) * kUS + ch], acc);
      sc[r * SC + c0 + ch] = acc + bd[c0 + ch];
    }
  }
  __syncthreads();
  for (int rr = warp; rr < kRows; rr += kWarps)
    layer_norm_row<T>(sc + rr * SC, D, ln2s, ln2b, eps, true, lane);

  for (int j0 = 0; j0 < D; j0 += kWC) {
    float acc[4][4] = {};
    for (int kc = 0; kc < D; kc += kKC) {
      __syncthreads();               // swish done; the last chunk's reads done
      for (int i = tid; i < kKC * kWC; i += kThreads) {
        const int kk = i / kWC, c = i % kWC;
        const float w = w2[static_cast<size_t>(kc + kk) * D + j0 + c];
        if constexpr (kTensorCores<T>)
          swt[c * kWS + kk] = __float2bfloat16(w);
        else
          sw[i] = w;
      }
      __syncthreads();
      if constexpr (kTensorCores<T>)
        product_chunk_mma(sc, SC, kc, swt, acc, warp, lane);
      else
        product_chunk(sc, SC, kc, sw, acc, tx, ty);
    }
    // the accumulators' rows and columns as in conformer_conv_pw1_kernel
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kTensorCores<T>) {
        const int j = j0 + ((warp / 4) * 4 + i) * 8 + 2 * (lane % 4);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t0 + (warp % 4) * 16 + lane / 4 + 8 * e;
          if (t >= Tn) continue;
          *reinterpret_cast<unsigned*>(
              y + (static_cast<size_t>(b) * Tn + t) * D + j) =
              pack_bf16(acc[i][2 * e] + b2[j], acc[i][2 * e + 1] + b2[j + 1]);
        }
      } else {
        const int t = t0 + ty * 4 + i;
        if (t >= Tn) continue;
        T* dst = y + (static_cast<size_t>(b) * Tn + t) * D + j0 + tx * 4;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          store(dst + c, acc[i][c] + b2[j0 + tx * 4 + c]);
      }
    }
  }
}

size_t pw1_smem(int D) {
  return sizeof(float) * (static_cast<size_t>(kRows) * (D + 8) + kKC * kWC);
}

size_t dw_pw2_smem(int D, int K) {
  return sizeof(float) * (static_cast<size_t>(kRows) * (D + 8) +
                          static_cast<size_t>(kRows + K - 1) * kUS +
                          kKC * kWC + static_cast<size_t>(K) * kCC);
}

template <typename T>
int launch(const void* x, const int* lens, const float* ln1s,
           const float* ln1b, const float* w1, const float* b1,
           const float* wd, const float* bd, const float* ln2s,
           const float* ln2b, const float* w2, const float* b2, float* u,
           void* y, int B, int Tn, int D, int K, float eps,
           cudaStream_t stream) {
  const int N = B * Tn;
  const size_t smem1 = pw1_smem(D), smem2 = dw_pw2_smem(D, K);
  cudaError_t err = cudaFuncSetAttribute(
      conformer_conv_pw1_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(conformer_conv_dw_pw2_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  conformer_conv_pw1_kernel<T><<<(N + kRows - 1) / kRows, kThreads, smem1,
                                 stream>>>(static_cast<const T*>(x), lens,
                                           ln1s, ln1b, w1, b1, u, N, Tn, D,
                                           eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tn + kRows - 1) / kRows, B);
  conformer_conv_dw_pw2_kernel<T><<<grid, kThreads, smem2, stream>>>(
      u, wd, bd, ln2s, ln2b, w2, b2, static_cast<T*>(y), Tn, D, K, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches both kernels on `stream`; returns cudaGetLastError() after them
// (0 on success). The caller guarantees B, T >= 1, D a multiple of 64 from
// 64 to 512, 1 <= K <= 63, contiguous device buffers: x and y (B, T, D) of
// one type (bf16 when is_bf16, else fp32), lens (B,) int32, the fp32
// weights ln1s, ln1b, bd, ln2s, ln2b, b2 (D,), w1 (D, 2D), b1 (2D,), wd
// (K, D), w2 (D, D), and the fp32 scratch u (B, T, D).
extern "C" int conformer_conv_fwd(const void* x, const void* lens,
                                  const void* ln1s, const void* ln1b,
                                  const void* w1, const void* b1,
                                  const void* wd, const void* bd,
                                  const void* ln2s, const void* ln2b,
                                  const void* w2, const void* b2, void* u,
                                  void* y, int B, int Tn, int D, int K,
                                  int is_bf16, float eps, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto* n = static_cast<const int*>(lens);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* ub = static_cast<float*>(u);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, n, f(ln1s), f(ln1b), f(w1), f(b1), f(wd),
                                 f(bd), f(ln2s), f(ln2b), f(w2), f(b2), ub,
                                 y, B, Tn, D, K, eps, s);
  return launch<float>(x, n, f(ln1s), f(ln1b), f(w1), f(b1), f(wd), f(bd),
                       f(ln2s), f(ln2b), f(w2), f(b2), ub, y, B, Tn, D, K,
                       eps, s);
}
