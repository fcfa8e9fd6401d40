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
// taps and bias, LN2 and swish run in fp32 (u is never rounded); y is
// rounded to x's type. Rows t >= len of y are not zeroed: the caller's
// residual add and the encoder's masks take care of them, as in the JAX
// package. Dropout and the residual add are the caller's.
//
// What bounds it on an H100: operations. At Conformer-M (B=64, T=250,
// D=256, k=31, bf16) it does 2 B T D (2D) + 2 B T D D + 2 B T D k = 6.5
// GFLOP (6.6 us at 989 TFLOP/s) against 17.2 MB of x, y and weights (5.1 us
// at 3.35 TB/s).
//
// bf16 (the main path): one fused launch after a small pre-pass.
//  0. `conformer_conv_round_weights_kernel` rounds w1 and w2 to bf16 once
//     a call (0.4 MB at D 256), w1's value and gate columns interleaved,
//     so that no CTA converts a weight.
//  1. `conformer_conv_fused_kernel<TM>`: one CTA per TM frames (64; 32 or
//     16 where the tile does not fit shared memory: D 512, or large k) of
//     one batch row, 16 warps. It recomputes LN1 and pw1 for its frames and
//     their (k - 1) / 2 halo on each side (the extra pw1 work, 94 rows for
//     64 at k 31, is cheap beside a round trip of u through device memory)
//     and keeps everything on chip (conformer_conv.cuh's front half): the
//     LN1 tile in bf16; per pass of 64 channels pw1's value and gate
//     columns, the GLU and the mask giving u in fp32, the depthwise taps
//     into an fp32 c tile (each thread 8 output rows through a register
//     window of u); then LN2 and the swish in place, sw in bf16 over the
//     LN1 tile, and pw2 with its bias, y stored. The weights stream through
//     a ring of four 64 x 64 bf16 slots that cp.async fills two chunks
//     ahead (flash_relpos.cuh); the products are mma.sync m16n8k16 with
//     ldmatrix fragments, warps in a 4 x 4 grid, each 32 columns of a
//     128-column pass. u goes out only where the caller asks for it (the
//     checks), from the CTA that owns the frame.
// fp32: the first design's two launches on the CUDA cores (TF32 would
// round the operands), an fp32 u of (B, T, D) between them:
//  1. `conformer_conv_pw1_kernel`: one CTA per 64 rows of (B x T): LN1 of
//     its rows, then pw1 for 32 output channels at a time, each channel's
//     value and gate columns side by side, the GLU and the mask, u out;
//  2. `conformer_conv_dw_pw2_kernel`: one CTA per (64 frames, batch row):
//     the depthwise conv from a tile of u with its halo, LN2 and swish in
//     place, pw2 64 output channels at a time.
// The products are the kernels' own; no library is called.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "conformer_conv.cuh"

namespace {

using namespace conformer_conv;

constexpr int kNoFit = -2;      // no tile of the fused kernel fits an SM

// ---- fp32 ------------------------------------------------------------------

constexpr int kPad = 4;         // the activations' row stride past D

// LN1, pw1 (D -> 2D) + bias, GLU and the time mask over 64 rows of the
// flattened (B x T, D) input; u (B x T, D) fp32 out.
__global__ void __launch_bounds__(kThreads)
conformer_conv_pw1_kernel(const float* __restrict__ x,
                          const int* __restrict__ lens,
                          const float* __restrict__ ln1s,
                          const float* __restrict__ ln1b,
                          const float* __restrict__ w1,
                          const float* __restrict__ b1,
                          float* __restrict__ u, int N, int Tn, int D,
                          float eps) {
  const int SA = D + kPad;
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;                  // kRows x SA: LN1 output
  float* sw = sa + kRows * SA;       // a chunk of pw1's weight: kKC x kWC
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * kRows;

  for (int rr = warp; rr < kRows; rr += kWarps) {
    float* row = sa + rr * SA;
    const int n = r0 + rr;
    for (int c = lane; c < D; c += 32)
      row[c] = n < N ? x[static_cast<size_t>(n) * D + c] : 0.f;
    __syncwarp();
    layer_norm_row(row, D, ln1s, ln1b, eps, false, lane);
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
        sw[i] = w1[static_cast<size_t>(kc + kk) * 2 * D + col];
      }
      __syncthreads();
      product_chunk(sa, SA, kc, sw, acc, tx, ty);
    }
    // acc[i][c]: row ty*4 + i, chunk column tx*4 + c: a thread holds both
    // columns of its channels
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = r0 + ty * 4 + i, j = j0 + 2 * tx + e;
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
// + bias over 64 frames of one batch row; y (B, T, D) out.
__global__ void __launch_bounds__(kThreads)
conformer_conv_dw_pw2_kernel(const float* __restrict__ u,
                             const float* __restrict__ wd,
                             const float* __restrict__ bd,
                             const float* __restrict__ ln2s,
                             const float* __restrict__ ln2b,
                             const float* __restrict__ w2,
                             const float* __restrict__ b2,
                             float* __restrict__ y, int Tn, int D, int K,
                             float eps) {
  const int SC = D + kPad;
  const int halo = (K - 1) / 2;
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;                        // kRows x SC: conv, then swish
  float* su = sc + kRows * SC;             // (kRows + K - 1) x kUS: u tile
  float* sw = su + (kRows + K - 1) * kUS;  // a chunk of pw2, as in pw1
  float* swd = sw + kKC * kWC;             // K x kCC: depthwise taps
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
    layer_norm_row(sc + rr * SC, D, ln2s, ln2b, eps, true, lane);

  for (int j0 = 0; j0 < D; j0 += kWC) {
    float acc[4][4] = {};
    for (int kc = 0; kc < D; kc += kKC) {
      __syncthreads();               // swish done; the last chunk's reads done
      for (int i = tid; i < kKC * kWC; i += kThreads) {
        const int kk = i / kWC, c = i % kWC;
        sw[i] = w2[static_cast<size_t>(kc + kk) * D + j0 + c];
      }
      __syncthreads();
      product_chunk(sc, SC, kc, sw, acc, tx, ty);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      if (t >= Tn) continue;
      float* dst = y + (static_cast<size_t>(b) * Tn + t) * D + j0 + tx * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[c] = acc[i][c] + b2[j0 + tx * 4 + c];
    }
  }
}

size_t pw1_smem(int D) {
  return sizeof(float) * (static_cast<size_t>(kRows) * (D + kPad) +
                          kKC * kWC);
}

size_t dw_pw2_smem(int D, int K) {
  return sizeof(float) * (static_cast<size_t>(kRows) * (D + kPad) +
                          static_cast<size_t>(kRows + K - 1) * kUS +
                          kKC * kWC + static_cast<size_t>(K) * kCC);
}

int launch_fp32(const float* x, const int* lens, const float* const* w,
                float* u, float* y, int B, int Tn, int D, int K, float eps,
                cudaStream_t stream) {
  const int N = B * Tn;
  const size_t smem1 = pw1_smem(D), smem2 = dw_pw2_smem(D, K);
  cudaError_t err = cudaFuncSetAttribute(
      conformer_conv_pw1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(conformer_conv_dw_pw2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  conformer_conv_pw1_kernel<<<(N + kRows - 1) / kRows, kThreads, smem1,
                              stream>>>(x, lens, w[0], w[1], w[2], w[3], u, N,
                                        Tn, D, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tn + kRows - 1) / kRows, B);
  conformer_conv_dw_pw2_kernel<<<grid, kThreads, smem2, stream>>>(
      u, w[4], w[5], w[6], w[7], w[8], w[9], y, Tn, D, K, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 ------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
conformer_conv_round_weights_kernel(const float* __restrict__ w1,
                                    const float* __restrict__ w2,
                                    bf16* __restrict__ wb, int D) {
  round_weights(w1, w2, wb, D);
}

// The whole chain for TM frames of one batch row (see the top): the front
// half, then LN2 and the swish into the LN1 tile (sw, bf16: pw2's A), then
// pw2 + b2, y out for the frames below T.
template <int TM>
__global__ void __launch_bounds__(kFrontThreads, 1)
conformer_conv_fused_kernel(const bf16* __restrict__ x,
                            const int* __restrict__ lens,
                            const float* __restrict__ ln1s,
                            const float* __restrict__ ln1b,
                            const float* __restrict__ b1,
                            const float* __restrict__ wd,
                            const float* __restrict__ bd,
                            const float* __restrict__ ln2s,
                            const float* __restrict__ ln2b,
                            const float* __restrict__ b2,
                            const bf16* __restrict__ wb,
                            float* __restrict__ u_out, bf16* __restrict__ y,
                            int Tn, int D, int K, float eps) {
  constexpr int MT2 = (TM / 16 + kWarpRows - 1) / kWarpRows;
  extern __shared__ __align__(16) unsigned char raw[];
  const FrontLayout L(TM, D, K);
  bf16* hs = reinterpret_cast<bf16*>(raw + L.h);
  float* cs = reinterpret_cast<float*>(raw + L.c);
  float* us = reinterpret_cast<float*>(raw + L.u);
  const int b = blockIdx.y, t_own = blockIdx.x * TM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 2, wc = warp & 3, g = lane >> 2, t4 = lane & 3;
  const FrontChunks<false> chunks{wb, wb + 2 * D * D, D};
  auto ring = flash_relpos::make_ring<kRing, kAhead, kFrontThreads>(
      reinterpret_cast<bf16*>(raw), chunks.total(), chunks);
  ring.start();
  const size_t row0 = static_cast<size_t>(b) * Tn;
  front_half<TM>(ring, L, hs, cs, us, x + row0 * D, t_own,
                 min(Tn, lens[b]), Tn, D, K, ln1s, ln1b, b1, wd, bd, eps,
                 nullptr, nullptr, nullptr,
                 u_out == nullptr ? nullptr : u_out + row0 * D);
  ln2_rows(cs, L.sc, TM, t_own, Tn, D, ln2s, ln2b, eps, hs, L.sa, nullptr,
           nullptr, nullptr, nullptr);
  __syncthreads();
  for (int q = 0; q < (D + 127) / 128; ++q) {
    float acc[MT2][4][4];
    pass_product<false, MT2>(acc, ring, hs, L.sa, TM / 16, D, wr, wc);
#pragma unroll
    for (int m = 0; m < MT2; ++m) {
      const int mt = wr + kWarpRows * m;
      if (mt >= TM / 16) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = 128 * q + 32 * wc + 8 * n + 2 * t4;
        if (col >= D) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t_own + 16 * mt + g + 8 * e;
          if (t >= Tn) continue;
          *reinterpret_cast<unsigned*>(y + (row0 + t) * D + col) =
              pack_bf16(acc[m][n][2 * e] + b2[col],
                        acc[m][n][2 * e + 1] + b2[col + 1]);
        }
      }
    }
  }
}

size_t fused_smem(int TM, int D, int K) { return FrontLayout(TM, D, K).end; }

// out = [frames a CTA, dynamic shared memory, CTAs an SM] of the fused
// kernel at (D, K), the tile chosen as plan_tile does (CTAs as kernel_fit
// reports them with `count`)
int fused_fit(int D, int K, int tile, int* out, bool count) {
  const int tm = plan_tile(tile, smem_limit(),
                           [&](int t) { return fused_smem(t, D, K); });
  out[0] = tm;
  switch (tm) {
    case 64:
      return kernel_fit(conformer_conv_fused_kernel<64>,
                        fused_smem(64, D, K), kFrontThreads,
                        out + 1, count);
    case 32:
      return kernel_fit(conformer_conv_fused_kernel<32>,
                        fused_smem(32, D, K), kFrontThreads,
                        out + 1, count);
    case 16:
      return kernel_fit(conformer_conv_fused_kernel<16>,
                        fused_smem(16, D, K), kFrontThreads,
                        out + 1, count);
  }
  out[1] = static_cast<int>(fused_smem(tile != 0 ? tile : 16, D, K));
  out[2] = 0;
  return 0;
}

int launch_bf16(const bf16* x, const int* lens, const float* const* w,
                bf16* wb, float* u, bf16* y, int B, int Tn, int D, int K,
                int tile, float eps, cudaStream_t stream) {
  int fit[3];
  int err = fused_fit(D, K, tile, fit, false);
  if (err != 0) return err;
  if (fit[2] == 0) return kNoFit;
  const int n = 3 * D * D;
  conformer_conv_round_weights_kernel<<<std::min((n + kThreads - 1) /
                                                     kThreads, 1024),
                                        kThreads, 0, stream>>>(w[2], w[8],
                                                               wb, D);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 grid((Tn + fit[0] - 1) / fit[0], B);
  const size_t smem = static_cast<size_t>(fit[1]);
#define CONV_FUSED_LAUNCH(TM)                                                \
  conformer_conv_fused_kernel<TM><<<grid, kFrontThreads, smem, stream>>>(    \
      x, lens, w[0], w[1], w[3], w[4], w[5], w[6], w[7], w[9], wb, u, y, Tn, \
      D, K, eps)
  if (fit[0] == 64)
    CONV_FUSED_LAUNCH(64);
  else if (fit[0] == 32)
    CONV_FUSED_LAUNCH(32);
  else
    CONV_FUSED_LAUNCH(16);
#undef CONV_FUSED_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the forward on `stream`; returns cudaGetLastError() after the
// launches (0 on success), or -2 where no tile of the bf16 kernel fits an
// SM (the caller asks conformer_conv_fwd_resources first). The caller
// guarantees B, T >= 1, D a multiple of 64 from 64 to 512, 1 <= K <= 63,
// contiguous device buffers: x and y (B, T, D) of one type (bf16 when
// is_bf16, else fp32), lens (B,) int32, the fp32 weights ln1s, ln1b, bd,
// ln2s, ln2b, b2 (D,), w1 (D, 2D), b1 (2D,), wd (K, D), w2 (D, D); for
// bf16 the scratch wb of 3 D^2 bf16 and u (B, T, D) fp32 or null (written
// only where given), for fp32 the scratch u (wb unused). `tile` picks the
// bf16 kernel's frames a CTA (64, 32 or 16), 0 the largest that fits.
extern "C" int conformer_conv_fwd(const void* x, const void* lens,
                                  const void* ln1s, const void* ln1b,
                                  const void* w1, const void* b1,
                                  const void* wd, const void* bd,
                                  const void* ln2s, const void* ln2b,
                                  const void* w2, const void* b2, void* wb,
                                  void* u, void* y, int B, int Tn, int D,
                                  int K, int is_bf16, int tile, float eps,
                                  void* stream) {
  const float* w[10] = {
      static_cast<const float*>(ln1s), static_cast<const float*>(ln1b),
      static_cast<const float*>(w1),   static_cast<const float*>(b1),
      static_cast<const float*>(wd),   static_cast<const float*>(bd),
      static_cast<const float*>(ln2s), static_cast<const float*>(ln2b),
      static_cast<const float*>(w2),   static_cast<const float*>(b2)};
  const auto* n = static_cast<const int*>(lens);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* uf = static_cast<float*>(u);
  if (is_bf16)
    return launch_bf16(static_cast<const bf16*>(x), n, w,
                       static_cast<bf16*>(wb), uf, static_cast<bf16*>(y), B,
                       Tn, D, K, tile, eps, s);
  return launch_fp32(static_cast<const float*>(x), n, w, uf,
                     static_cast<float*>(y), B, Tn, D, K, eps, s);
}

// The bf16 fused kernel's resources at (D, K) and `tile` (0: the largest
// that fits), nothing launched: out = [frames a CTA (0 where none fits),
// dynamic shared memory in bytes, CTAs an SM (0 where it does not fit)].
// Returns a CUDA error, 0 on success.
extern "C" int conformer_conv_fwd_resources(int D, int K, int tile,
                                            int* out) {
  return fused_fit(D, K, tile, out, true);
}
