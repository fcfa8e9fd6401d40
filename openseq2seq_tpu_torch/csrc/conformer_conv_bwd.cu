// The Conformer convolution module's backward, layer-norm variant: given x
// (B, T, D), the fp32 weights and dy, the gradient dx in x's type and the
// ten weight gradients in fp32, summed over the batch, of
//   y = pw2(swish(LN2(dwconv_k(mask(GLU(pw1(LN1(x))))))))
//
// Replaces `_bwd_kernel` in openseq2seq_tpu/ops/conformer_pallas.py:158
// (its pallas_call at :381, run by `_fused_bwd`, :363), at its precision:
// the forward recomputed in fp32 from x alone (the VJP's only activation
// residual; the forward's u is not kept, since the GLU's backward needs the
// pw1 output anyway); every product on operands rounded to x's type (bf16
// for bf16 x, fp32 otherwise) with fp32 accumulation: pw1 again, dw2 =
// sw^T dy, ds = dy w2^T, dw1 = h0^T da and dh0 = da w1^T; the swish, LN2
// (`_ln_bwd`, fast-variance statistics), the depthwise conv's transpose
// within each row (du[t] = sum_j wd[j] dc[t - j + P], dwd[j] = sum_t u[t +
// j - P] dc[t], zeros outside [0, T)), the time mask on du, the GLU, pw1 and
// LN1 in fp32. Padded frames keep non-zero dc and dx, as in the TPU kernel.
//
// What bounds it on an H100: operations. At Conformer-M (B=64, T=250,
// D=256, k=31, bf16) the products are pw1 again (4 N D^2), dw2 and ds (2 N
// D^2 each), dw1 and dh0 (4 N D^2 each): 16 N D^2 = 16.8 GFLOP (N = B T =
// 16,000; 17 us at 989 TFLOP/s), and the taps, forward, du and dwd, 6 N D k
// = 0.76 GFLOP, against 26.2 MB of x, dy and dx and the weights and their
// gradients (7.8 us at 3.35 TB/s).
//
// Design (a simple chain of launches that is right; fusing them, wgmma and
// TMA are later work). The TPU kernel keeps a batch tile's whole chain in
// VMEM and carries the weight gradients across its sequential grid in
// revisited output blocks. Here a block's shared memory cannot hold a
// tile's chain beside pw1's weight, and blocks run in parallel, so the
// chain runs as separate launches with fp32 intermediates in a workspace,
// and each weight gradient is summed in two passes: every CTA writes its
// fp32 partial sums, then a reduction adds the partials in a fixed order.
// No atomics, so two calls give identical bits. The launches, in order:
//  1. LN1 of each row (one warp a row, 64 rows a CTA): h0;
//  2. a = h0 w1 + b1 (the product kernel below);
//  3. per (64 frames, batch row): u = mask(GLU(a)) with its (k - 1) / 2
//     halo from the neighbouring frames of the same row, the depthwise conv
//     + bias: c;
//  4. ds = dy w2^T;
//  5. per row: LN2 and swish recomputed from c (sw kept for step 6), then
//     dn = ds swish'(n), LN2's backward: dc; partial sums of dln2 scale and
//     bias, dbd and db2 over the CTA's 64 rows;
//  6. dw2 partials = sw^T dy over slices of the rows;
//  7. per (64 frames, batch row): du = the depthwise transpose of dc with
//     its halo, the mask, the GLU's backward: da; partials of dwd (from u
//     with its halo) and db1;
//  8. dh0 = da w1^T;
//  9. dw1 partials = h0^T da over slices of the rows;
//  10. per row: LN1's backward: dx; partials of dln1 scale and bias;
//  11. five reductions of the partials into the ten gradients.
// The products (2, 4, 6, 8, 9) are one kernel: a 64 x 64 output tile, its
// operands staged in shared memory 32 deep, rounded to x's type, then
// conformer_conv.cuh's tile product: tensor cores through mma.sync for
// bf16, fp32 FMAs on the CUDA cores for fp32 (TF32 would round the
// operands). The workspace is about 10 (B, T, D) fp32 arrays plus the
// partials: 191 MB at Conformer-M.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "conformer_conv.cuh"

// a named namespace, so that a profile tells these kernels apart
namespace conformer_conv_backward {

using namespace conformer_conv;

constexpr int kMaxCols = 512 / 32;      // D / 32 columns a lane at most

// the partial sums of a warp's rows for the lane's columns c = lane + 32 i,
// added over the CTA's warps in a fixed order and written to dst (D floats)
__device__ __forceinline__ void cta_column_sums(const float (&part)[kMaxCols],
                                               float* red, float* dst, int D,
                                               int warp, int lane) {
  __syncthreads();                       // the last call's reads are done
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i)
    if (i < D / 32) red[warp * D + lane + 32 * i] = part[i];
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * D + c];
    dst[c] = s;
  }
}

// 1. h0 = LN1(x) for 64 rows of the flattened (B x T, D) input
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln1_kernel(const T* __restrict__ x, const float* __restrict__ ln1s,
           const float* __restrict__ ln1b, float* __restrict__ h0, int N,
           int D, float eps) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int n = blockIdx.x * kRows + warp; n < min(N, (blockIdx.x + 1) *
                                                         kRows);
       n += kWarps) {
    const T* row = x + static_cast<size_t>(n) * D;
    float sum = 0.f, sq = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = to_float(row[c]);
      sum += v;
      sq = fmaf(v, v, sq);
    }
    const float mu = warp_sum(sum) / D;
    const float rstd = rsqrtf(warp_sum(sq) / D - mu * mu + eps);
    for (int c = lane; c < D; c += 32)
      h0[static_cast<size_t>(n) * D + c] =
          fmaf((to_float(row[c]) - mu) * rstd, ln1s[c], ln1b[c]);
  }
}

// The product kernel: out[z][r][c] = sum over kk in split z of X[r][kk]
// Y[kk][c] (+ bias[c]), for r < R and c < M (a multiple of 64), with X[r][kk]
// at X[r sxr + kk sxk] and Y[kk][c] at Y[kk syk + c syc], both rounded to T;
// split z covers kk in [z k_split, min(K, (z + 1) k_split)). One CTA a 64 x
// 64 tile of one split.
template <typename T, typename XT, typename YT>
__global__ void __launch_bounds__(kThreads)
product_kernel(const XT* __restrict__ X, long long sxr, long long sxk,
               const YT* __restrict__ Y, long long syk, long long syc,
               const float* __restrict__ bias, float* __restrict__ out, int R,
               int M, int K, int k_split) {
  constexpr int SA = kKC + kRowPad<T>;
  __shared__ __align__(16) float sa[kRows * SA];   // X's chunk, rounded
  __shared__ __align__(16) float sw[kKC * kWC];    // Y's chunk: kKC x kWC
                                                   // fp32, or kWC x kWS bf16
  auto* swt = reinterpret_cast<__nv_bfloat16*>(sw);  // transposed
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * kWC, r0 = blockIdx.y * kRows, z = blockIdx.z;
  const int kb = z * k_split, ke = min(K, kb + k_split);

  float acc[4][4] = {};
  for (int kc = kb; kc < ke; kc += kKC) {
    __syncthreads();                     // the last chunk's reads are done
    for (int i = tid; i < kRows * kKC; i += kThreads) {
      // the unit-stride index fastest, so that the loads coalesce
      const int r = sxk == 1 ? i / kKC : i % kRows;
      const int kk = sxk == 1 ? i % kKC : i / kRows;
      const int row = r0 + r, k = kc + kk;
      sa[r * SA + kk] =
          row < R && k < ke ? round_to<T>(to_float(X[row * sxr + k * sxk]))
                            : 0.f;
    }
    for (int i = tid; i < kKC * kWC; i += kThreads) {
      const int c = syc == 1 ? i % kWC : i / kKC;
      const int kk = syc == 1 ? i / kWC : i % kKC;
      const int k = kc + kk;
      const float w = k < ke ? to_float(Y[k * syk + (c0 + c) * syc]) : 0.f;
      if constexpr (kTensorCores<T>)
        swt[c * kWS + kk] = __float2bfloat16(w);
      else
        sw[kk * kWC + c] = w;
    }
    __syncthreads();
    if constexpr (kTensorCores<T>)
      product_chunk_mma(sa, SA, 0, swt, acc, warp, lane);
    else
      product_chunk(sa, SA, 0, sw, acc, tx, ty);
  }
  // the accumulators' rows and columns as in conformer_conv_fwd.cu
  float* dst = out + static_cast<size_t>(z) * R * M;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int r, c;
      if constexpr (kTensorCores<T>) {
        r = (warp % 4) * 16 + lane / 4 + 8 * (e / 2);
        c = ((warp / 4) * 4 + i) * 8 + 2 * (lane % 4) + e % 2;
      } else {
        r = ty * 4 + i;
        c = tx * 4 + e;
      }
      if (r0 + r >= R) continue;
      dst[static_cast<size_t>(r0 + r) * M + c0 + c] =
          acc[i][e] + (bias != nullptr ? bias[c0 + c] : 0.f);
    }
}

// u = mask(GLU(a)) at frame t of batch row b, channel ch; 0 outside [0, T)
__device__ __forceinline__ float glu_u(const float* a, int b, int t, int ch,
                                       int Tn, int D, int len) {
  if (t < 0 || t >= Tn || t >= len) return 0.f;
  const float* at = a + (static_cast<size_t>(b) * Tn + t) * 2 * D;
  return at[ch] * sigmoid(at[D + ch]);
}

// the u tile of frames t0 - P .. t0 + 63 + k - 1 - P, channels c0 .. c0 +
// 63, into su ((kRows + K - 1) x kUS), and the taps of those channels into
// swd (K x kCC)
__device__ __forceinline__ void stage_u(float* su, float* swd, const float* a,
                                        const float* wd, int b, int t0,
                                        int c0, int Tn, int D, int K,
                                        int len) {
  const int P = (K - 1) / 2;
  for (int i = threadIdx.x; i < (kRows + K - 1) * kCC; i += kThreads) {
    const int r = i / kCC, ch = i % kCC;
    su[r * kUS + ch] = glu_u(a, b, t0 - P + r, c0 + ch, Tn, D, len);
  }
  for (int i = threadIdx.x; i < K * kCC; i += kThreads)
    swd[i] = wd[(i / kCC) * D + c0 + i % kCC];
}

size_t dw_smem(int K) {
  return sizeof(float) * (2 * static_cast<size_t>(kRows + K - 1) * kUS +
                          static_cast<size_t>(K) * kCC + 2 * kThreads);
}

// 3. c = the depthwise conv of u + bias, over 64 frames of one batch row
__global__ void __launch_bounds__(kThreads)
dw_kernel(const float* __restrict__ a, const int* __restrict__ lens,
          const float* __restrict__ wd, const float* __restrict__ bd,
          float* __restrict__ c, int Tn, int D, int K) {
  extern __shared__ __align__(16) float smem[];
  float* su = smem;                              // (kRows + K - 1) x kUS
  float* swd = su + (kRows + K - 1) * kUS;       // K x kCC
  const int t0 = blockIdx.x * kRows, b = blockIdx.y;
  const int ch = threadIdx.x % kCC;
  for (int c0 = 0; c0 < D; c0 += kCC) {
    __syncthreads();                     // the last pass's reads are done
    stage_u(su, swd, a, wd, b, t0, c0, Tn, D, K, lens[b]);
    __syncthreads();
    for (int r = threadIdx.x / kCC; r < kRows; r += kThreads / kCC) {
      if (t0 + r >= Tn) break;
      float acc = 0.f;
      for (int j = 0; j < K; ++j)
        acc = fmaf(swd[j * kCC + ch], su[(r + j) * kUS + ch], acc);
      c[(static_cast<size_t>(b) * Tn + t0 + r) * D + c0 + ch] =
          acc + bd[c0 + ch];
    }
  }
}

// 5. per row: LN2 and swish from c (sw out), dn = ds swish'(n), LN2's
// backward (dc out); the CTA's partial sums [dln2s | dln2b | dbd | db2]
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln2_bwd_kernel(const float* __restrict__ c, const float* __restrict__ ds,
               const T* __restrict__ dy, const float* __restrict__ ln2s,
               const float* __restrict__ ln2b, float* __restrict__ sw,
               float* __restrict__ dc, float* __restrict__ partial, int N,
               int D, float eps) {
  __shared__ float red[kWarps * kMaxCols * 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nc = D / 32;
  float p_s[kMaxCols] = {}, p_b[kMaxCols] = {}, p_bd[kMaxCols] = {},
        p_b2[kMaxCols] = {};
  for (int n = blockIdx.x * kRows + warp; n < min(N, (blockIdx.x + 1) *
                                                         kRows);
       n += kWarps) {
    const size_t at = static_cast<size_t>(n) * D;
    float xh[kMaxCols], dxh[kMaxCols];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i)
      if (i < nc) {
        xh[i] = c[at + lane + 32 * i];
        sum += xh[i];
        sq = fmaf(xh[i], xh[i], sq);
      }
    const float mu = warp_sum(sum) / D;
    const float rstd = rsqrtf(warp_sum(sq) / D - mu * mu + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i)
      if (i < nc) {
        const int col = lane + 32 * i;
        xh[i] = (xh[i] - mu) * rstd;
        const float nn = fmaf(xh[i], ln2s[col], ln2b[col]);
        const float sn = sigmoid(nn);
        sw[at + col] = nn * sn;
        const float dn = ds[at + col] * (sn + nn * sn * (1.f - sn));
        dxh[i] = dn * ln2s[col];
        m1 += dxh[i];
        m2 = fmaf(dxh[i], xh[i], m2);
        p_s[i] = fmaf(dn, xh[i], p_s[i]);
        p_b[i] += dn;
        p_b2[i] += to_float(dy[at + col]);
      }
    m1 = warp_sum(m1) / D;
    m2 = warp_sum(m2) / D;
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i)
      if (i < nc) {
        const float g = rstd * (dxh[i] - m1 - xh[i] * m2);
        dc[at + lane + 32 * i] = g;
        p_bd[i] += g;
      }
  }
  float* dst = partial + static_cast<size_t>(blockIdx.x) * 4 * D;
  cta_column_sums(p_s, red, dst, D, warp, lane);
  cta_column_sums(p_b, red, dst + D, D, warp, lane);
  cta_column_sums(p_bd, red, dst + 2 * D, D, warp, lane);
  cta_column_sums(p_b2, red, dst + 3 * D, D, warp, lane);
}

// 7. per 64 frames of one batch row: du = the depthwise transpose of dc,
// the mask, the GLU's backward (da out); the CTA's partial sums [dwd (K x
// D) | db1 (2D)]
__global__ void __launch_bounds__(kThreads)
dw_bwd_kernel(const float* __restrict__ a, const float* __restrict__ dc,
              const int* __restrict__ lens, const float* __restrict__ wd,
              float* __restrict__ da, float* __restrict__ partial, int Tn,
              int D, int K) {
  extern __shared__ __align__(16) float smem[];
  float* su = smem;                              // (kRows + K - 1) x kUS
  float* sdc = su + (kRows + K - 1) * kUS;       // (kRows + K - 1) x kUS
  float* swd = sdc + (kRows + K - 1) * kUS;      // K x kCC
  float* sdb = swd + K * kCC;                    // 2 x kThreads
  const int P = (K - 1) / 2, Q = K - 1 - P;
  const int t0 = blockIdx.x * kRows, b = blockIdx.y;
  const int len = lens[b];
  const int ch = threadIdx.x % kCC, grp = threadIdx.x / kCC;
  constexpr int kGroups = kThreads / kCC;        // 4
  float* dst = partial +
               (static_cast<size_t>(b) * gridDim.x + blockIdx.x) *
                   (static_cast<size_t>(K) * D + 2 * D);
  for (int c0 = 0; c0 < D; c0 += kCC) {
    __syncthreads();                     // the last pass's reads are done
    stage_u(su, swd, a, wd, b, t0, c0, Tn, D, K, len);
    // dc of frames t0 - Q .. t0 + 63 + P
    for (int i = threadIdx.x; i < (kRows + K - 1) * kCC; i += kThreads) {
      const int r = i / kCC, c = i % kCC, t = t0 - Q + r;
      sdc[r * kUS + c] =
          t >= 0 && t < Tn ? dc[(static_cast<size_t>(b) * Tn + t) * D + c0 +
                                c]
                           : 0.f;
    }
    __syncthreads();
    // du[t0 + r] = sum_j wd[j] dc[t0 + r - j + P], dc's tile row r + K-1-j
    float db_p = 0.f, db_q = 0.f;
    for (int r = grp; r < kRows; r += kGroups) {
      const int t = t0 + r;
      if (t >= Tn) break;
      float du = 0.f;
      for (int j = 0; j < K; ++j)
        du = fmaf(swd[j * kCC + ch], sdc[(r + K - 1 - j) * kUS + ch], du);
      if (t >= len) du = 0.f;
      const size_t at = (static_cast<size_t>(b) * Tn + t) * 2 * D + c0 + ch;
      const float p = a[at], g = sigmoid(a[at + D]);
      const float dp = du * g, dq = du * p * g * (1.f - g);
      da[at] = dp;
      da[at + D] = dq;
      db_p += dp;
      db_q += dq;
    }
    // dwd[j] = sum over the tile's frames of u[t + j - P] dc[t]
    for (int j = grp; j < K; j += kGroups) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r)
        s = fmaf(su[(r + j) * kUS + ch], sdc[(r + Q) * kUS + ch], s);
      dst[static_cast<size_t>(j) * D + c0 + ch] = s;
    }
    sdb[threadIdx.x] = db_p;
    sdb[kThreads + threadIdx.x] = db_q;
    __syncthreads();
    if (threadIdx.x < kCC) {
      float sp = 0.f, sq = 0.f;
      for (int g = 0; g < kGroups; ++g) {
        sp += sdb[g * kCC + ch];
        sq += sdb[kThreads + g * kCC + ch];
      }
      dst[static_cast<size_t>(K) * D + c0 + ch] = sp;
      dst[static_cast<size_t>(K) * D + D + c0 + ch] = sq;
    }
  }
}

// 10. per row: LN1's backward from x and dh0 (dx out); the CTA's partial
// sums [dln1s | dln1b]
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln1_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dh0,
               const float* __restrict__ ln1s, T* __restrict__ dx,
               float* __restrict__ partial, int N, int D, float eps) {
  __shared__ float red[kWarps * kMaxCols * 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nc = D / 32;
  float p_s[kMaxCols] = {}, p_b[kMaxCols] = {};
  for (int n = blockIdx.x * kRows + warp; n < min(N, (blockIdx.x + 1) *
                                                         kRows);
       n += kWarps) {
    const size_t at = static_cast<size_t>(n) * D;
    float xh[kMaxCols], dxh[kMaxCols];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i)
      if (i < nc) {
        xh[i] = to_float(x[at + lane + 32 * i]);
        sum += xh[i];
        sq = fmaf(xh[i], xh[i], sq);
      }
    const float mu = warp_sum(sum) / D;
    const float rstd = rsqrtf(warp_sum(sq) / D - mu * mu + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i)
      if (i < nc) {
        const int col = lane + 32 * i;
        xh[i] = (xh[i] - mu) * rstd;
        const float g = dh0[at + col];
        dxh[i] = g * ln1s[col];
        m1 += dxh[i];
        m2 = fmaf(dxh[i], xh[i], m2);
        p_s[i] = fmaf(g, xh[i], p_s[i]);
        p_b[i] += g;
      }
    m1 = warp_sum(m1) / D;
    m2 = warp_sum(m2) / D;
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i)
      if (i < nc)
        store(dx + at + lane + 32 * i, rstd * (dxh[i] - m1 - xh[i] * m2));
  }
  float* dst = partial + static_cast<size_t>(blockIdx.x) * 2 * D;
  cta_column_sums(p_s, red, dst, D, warp, lane);
  cta_column_sums(p_b, red, dst + D, D, warp, lane);
}

// 11. out = the sum of `parts` rows of partial (parts x ncols), in row
// order; columns [0, n0) go to o0, the next n1 to o1, and so on
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ partial, int parts, int ncols,
              float* o0, int n0, float* o1, int n1, float* o2, int n2,
              float* o3) {
  for (int c = blockIdx.x * kThreads + threadIdx.x; c < ncols;
       c += gridDim.x * kThreads) {
    float s = 0.f;
    for (int z = 0; z < parts; ++z)
      s += partial[static_cast<size_t>(z) * ncols + c];
    if (c < n0)
      o0[c] = s;
    else if (c < n0 + n1)
      o1[c - n0] = s;
    else if (c < n0 + n1 + n2)
      o2[c - n0 - n1] = s;
    else
      o3[c - n0 - n1 - n2] = s;
  }
}

// the workspace's fp32 arrays, in floats from its start
struct Layout {
  int N, row_ctas, dw_ctas, splits, k_split;
  size_t h0, a, c, ds, sw, dc, da, dh0, p_ln2, p_dw, p_ln1, p_w2, p_w1, end;

  Layout(int B, int Tn, int D, int K) {
    N = B * Tn;
    row_ctas = (N + kRows - 1) / kRows;
    dw_ctas = B * ((Tn + kRows - 1) / kRows);
    // the weight products' rows split about 1024 at a time, enough tiles
    // to fill the card at Conformer-M
    splits = std::min(32, std::max(1, (N + 1023) / 1024));
    k_split = ((N + splits - 1) / splits + kKC - 1) / kKC * kKC;
    const size_t nd = static_cast<size_t>(N) * D;
    h0 = 0;
    a = h0 + nd;
    c = a + 2 * nd;
    ds = c + nd;
    sw = ds + nd;
    dc = sw + nd;
    da = dc + nd;
    dh0 = da + 2 * nd;
    p_ln2 = dh0 + nd;
    p_dw = p_ln2 + static_cast<size_t>(row_ctas) * 4 * D;
    p_ln1 = p_dw + static_cast<size_t>(dw_ctas) * (K + 2) * D;
    p_w2 = p_ln1 + static_cast<size_t>(row_ctas) * 2 * D;
    p_w1 = p_w2 + static_cast<size_t>(splits) * D * D;
    end = p_w1 + static_cast<size_t>(splits) * 2 * D * D;
  }
};

template <typename T, typename XT, typename YT>
int product(const XT* X, long long sxr, long long sxk, const YT* Y,
            long long syk, long long syc, const float* bias, float* out,
            int R, int M, int K, int splits, int k_split,
            cudaStream_t stream) {
  const dim3 grid(M / kWC, (R + kRows - 1) / kRows, splits);
  product_kernel<T, XT, YT><<<grid, kThreads, 0, stream>>>(
      X, sxr, sxk, Y, syk, syc, bias, out, R, M, K, k_split);
  return static_cast<int>(cudaGetLastError());
}

int reduce(const float* partial, int parts, int ncols, float* o0, int n0,
           float* o1, int n1, float* o2, int n2, float* o3,
           cudaStream_t stream) {
  const int blocks = std::min((ncols + kThreads - 1) / kThreads, 1024);
  reduce_kernel<<<blocks, kThreads, 0, stream>>>(partial, parts, ncols, o0,
                                                 n0, o1, n1, o2, n2, o3);
  return static_cast<int>(cudaGetLastError());
}

#define RETURN_IF_ERROR(expr)                   \
  do {                                          \
    const int e_ = (expr);                      \
    if (e_ != 0) return e_;                     \
  } while (0)

template <typename T>
int launch(const T* x, const T* dy, const int* lens, const float* const* w,
           float* work, T* dx, float* const* g, int B, int Tn, int D, int K,
           float eps, cudaStream_t stream) {
  const float *ln1s = w[0], *ln1b = w[1], *w1 = w[2], *b1 = w[3],
              *wd = w[4], *bd = w[5], *ln2s = w[6], *ln2b = w[7],
              *w2 = w[8];
  const Layout L(B, Tn, D, K);
  const int N = L.N;
  float *h0 = work + L.h0, *a = work + L.a, *c = work + L.c,
        *ds = work + L.ds, *sw = work + L.sw, *dc = work + L.dc,
        *da = work + L.da, *dh0 = work + L.dh0;
  const size_t smem = dw_smem(K);
  RETURN_IF_ERROR(static_cast<int>(cudaFuncSetAttribute(
      dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem))));
  RETURN_IF_ERROR(static_cast<int>(cudaFuncSetAttribute(
      dw_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem))));
  const dim3 dw_grid((Tn + kRows - 1) / kRows, B);

  ln1_kernel<T><<<L.row_ctas, kThreads, 0, stream>>>(x, ln1s, ln1b, h0, N,
                                                     D, eps);
  RETURN_IF_ERROR(static_cast<int>(cudaGetLastError()));
  // a = h0 w1 + b1
  RETURN_IF_ERROR((product<T, float, float>(h0, D, 1, w1, 2 * D, 1, b1, a,
                                            N, 2 * D, D, 1, D, stream)));
  dw_kernel<<<dw_grid, kThreads, smem, stream>>>(a, lens, wd, bd, c, Tn, D,
                                                 K);
  RETURN_IF_ERROR(static_cast<int>(cudaGetLastError()));
  // ds = dy w2^T
  RETURN_IF_ERROR((product<T, T, float>(dy, D, 1, w2, 1, D, nullptr, ds, N,
                                        D, D, 1, D, stream)));
  ln2_bwd_kernel<T><<<L.row_ctas, kThreads, 0, stream>>>(
      c, ds, dy, ln2s, ln2b, sw, dc, work + L.p_ln2, N, D, eps);
  RETURN_IF_ERROR(static_cast<int>(cudaGetLastError()));
  // dw2 = sw^T dy, by slices of rows
  RETURN_IF_ERROR((product<T, float, T>(sw, 1, D, dy, D, 1, nullptr,
                                        work + L.p_w2, D, D, N, L.splits,
                                        L.k_split, stream)));
  dw_bwd_kernel<<<dw_grid, kThreads, smem, stream>>>(a, dc, lens, wd, da,
                                                     work + L.p_dw, Tn, D, K);
  RETURN_IF_ERROR(static_cast<int>(cudaGetLastError()));
  // dh0 = da w1^T
  RETURN_IF_ERROR((product<T, float, float>(da, 2 * D, 1, w1, 1, 2 * D,
                                            nullptr, dh0, N, D, 2 * D, 1,
                                            2 * D, stream)));
  // dw1 = h0^T da, by slices of rows
  RETURN_IF_ERROR((product<T, float, float>(h0, 1, D, da, 2 * D, 1, nullptr,
                                            work + L.p_w1, D, 2 * D, N,
                                            L.splits, L.k_split, stream)));
  ln1_bwd_kernel<T><<<L.row_ctas, kThreads, 0, stream>>>(
      x, dh0, ln1s, dx, work + L.p_ln1, N, D, eps);
  RETURN_IF_ERROR(static_cast<int>(cudaGetLastError()));
  // g: dln1s, dln1b, dw1, db1, dwd, dbd, dln2s, dln2b, dw2, db2
  RETURN_IF_ERROR(reduce(work + L.p_ln2, L.row_ctas, 4 * D, g[6], D, g[7],
                         D, g[5], D, g[9], stream));
  RETURN_IF_ERROR(reduce(work + L.p_dw, L.dw_ctas, (K + 2) * D, g[4], K * D,
                         g[3], 2 * D, nullptr, 0, nullptr, stream));
  RETURN_IF_ERROR(reduce(work + L.p_ln1, L.row_ctas, 2 * D, g[0], D, g[1],
                         D, nullptr, 0, nullptr, stream));
  RETURN_IF_ERROR(reduce(work + L.p_w2, L.splits, D * D, g[8], D * D,
                         nullptr, 0, nullptr, 0, nullptr, stream));
  return reduce(work + L.p_w1, L.splits, 2 * D * D, g[2], 2 * D * D, nullptr,
                0, nullptr, 0, nullptr, stream);
}

}  // namespace conformer_conv_backward

using conformer_conv_backward::Layout;
using conformer_conv_backward::launch;

// Launches the backward's kernels on `stream`; returns the first non-zero
// cudaGetLastError() after a launch (0 on success). The caller guarantees
// B, T >= 1, D a multiple of 64 from 64 to 512, 1 <= K <= 63, contiguous
// device buffers: x, dy and dx (B, T, D) of one type (bf16 when is_bf16,
// else fp32); lens (B,) int32; the fp32 weights ln1s, ln1b, w1 (D, 2D), b1
// (2D,), wd (K, D), bd, ln2s, ln2b, w2 (D, D), b2 (D,) and their fp32
// gradients of the same shapes; and an fp32 workspace of
// conformer_conv_bwd_workspace(B, T, D, K) bytes. b2 is not read (its
// gradient is the sum of dy).
extern "C" int conformer_conv_bwd(
    const void* x, const void* dy, const void* lens, const void* ln1s,
    const void* ln1b, const void* w1, const void* b1, const void* wd,
    const void* bd, const void* ln2s, const void* ln2b, const void* w2,
    const void* b2, void* work, void* dx, void* dln1s, void* dln1b,
    void* dw1, void* db1, void* dwd, void* dbd, void* dln2s, void* dln2b,
    void* dw2, void* db2, int B, int Tn, int D, int K, int is_bf16,
    float eps, void* stream) {
  (void)b2;
  const float* w[10] = {
      static_cast<const float*>(ln1s), static_cast<const float*>(ln1b),
      static_cast<const float*>(w1),   static_cast<const float*>(b1),
      static_cast<const float*>(wd),   static_cast<const float*>(bd),
      static_cast<const float*>(ln2s), static_cast<const float*>(ln2b),
      static_cast<const float*>(w2),   nullptr};
  float* const g[10] = {
      static_cast<float*>(dln1s), static_cast<float*>(dln1b),
      static_cast<float*>(dw1),   static_cast<float*>(db1),
      static_cast<float*>(dwd),   static_cast<float*>(dbd),
      static_cast<float*>(dln2s), static_cast<float*>(dln2b),
      static_cast<float*>(dw2),   static_cast<float*>(db2)};
  const auto* n = static_cast<const int*>(lens);
  auto* ws = static_cast<float*>(work);
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), n, w, ws,
        static_cast<__nv_bfloat16*>(dx), g, B, Tn, D, K, eps, s);
  return launch<float>(static_cast<const float*>(x),
                       static_cast<const float*>(dy), n, w, ws,
                       static_cast<float*>(dx), g, B, Tn, D, K, eps, s);
}

// The workspace conformer_conv_bwd needs, in bytes.
extern "C" long long conformer_conv_bwd_workspace(int B, int Tn, int D,
                                                  int K) {
  return static_cast<long long>(Layout(B, Tn, D, K).end * sizeof(float));
}
