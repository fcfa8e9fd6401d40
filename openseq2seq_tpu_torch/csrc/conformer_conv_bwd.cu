// The Conformer convolution module's backward, layer-norm variant: given x
// (B, T, D), the fp32 weights and dy, the gradient dx in x's type and the
// ten weight gradients in fp32, summed over the batch, of
//   y = pw2(swish(LN2(dwconv_k(mask(GLU(pw1(LN1(x))))))))
//
// Replaces `_bwd_kernel` in openseq2seq_tpu/ops/conformer_pallas.py:158
// (its pallas_call at :381, run by `_fused_bwd`, :363), at its precision:
// the forward recomputed in fp32 from x alone (the VJP's only activation
// residual); every product on operands rounded to x's type (bf16 for bf16
// x, fp32 otherwise) with fp32 accumulation: pw1 again, dw2 = sw^T dy, ds =
// dy w2^T, dw1 = h0^T da and dh0 = da w1^T; the swish, LN2 (`_ln_bwd`,
// fast-variance statistics), the depthwise conv's transpose within each
// row (du[t] = sum_j wd[j] dc[t - j + P], dwd[j] = sum_t u[t + j - P]
// dc[t], zeros outside [0, T)), the time mask on du, the GLU, pw1 and LN1
// in fp32. Padded frames keep non-zero dc and dx, as in the TPU kernel.
//
// What bounds it on an H100: operations. At Conformer-M (B=64, T=250,
// D=256, k=31, bf16) the products are pw1 again (4 N D^2), dw2 and ds (2 N
// D^2 each), dw1 and dh0 (4 N D^2 each): 16 N D^2 = 16.8 GFLOP (N = B T =
// 16,000; 17 us at 989 TFLOP/s), and the taps, forward, du and dwd, 6 N D k
// = 0.76 GFLOP, against 26.2 MB of x, dy and dx and the weights and their
// gradients (7.8 us at 3.35 TB/s).
//
// No atomics anywhere: each weight gradient is summed in two passes, every
// CTA writing its fp32 partial sums, then a reduction adding them in a
// fixed order, so two calls give identical bits.
//
// bf16 (the main path): six launches, every product on the tensor cores
// (mma.sync m16n8k16, ldmatrix fragments, operands streamed by cp.async
// through flash_relpos.cuh's ring), and no fp32 (B, T, D) array that only
// feeds a product: h0, sw and da go through device memory in bf16, as the
// products read them (da's fp32 column sum db1 is taken before it is
// rounded). The workspace is about 72 MB at Conformer-M.
//  0. `round_weights_kernel`: w1 (its value and gate columns interleaved)
//     and w2 in bf16, once a call.
//  1. `front_kernel<TM>`, per TM frames of a batch row with their halo:
//     conformer_conv.cuh's front half (LN1, h0 out in bf16; pw1, the GLU,
//     the mask, u in fp32 on chip; the taps into c), then LN2 and the swish
//     (sw out in bf16, the normalised rows kept), then ds = dy w2^T over a
//     dy tile staged by cp.async, dn = ds swish'(n) kept in registers,
//     LN2's backward over the whole row: dc out in fp32; the CTA's partial
//     sums of dln2 scale and bias, dbd and db2.
//  2. `glu_bwd_kernel<TM>`, per TM frames with their halo: a and u
//     recomputed from launch 1's bf16 h0 with launch 1's code (the same
//     bits), then per pass of 64 channels du from a tile of dc with its
//     halo, the mask, the GLU's backward: da, its column sums (db1) in
//     fp32, da out in bf16 (interleaved as w1's columns); the CTA's partial
//     sums of dwd from the u tile and the dc tile.
//  3. `dh0_kernel`: dh0 = da w1^T for 64 rows (32 past D 256) and all D
//     columns in registers, LN1's backward in the epilogue: dx, and the
//     CTA's partials of dln1 scale and bias.
//  4. `weight_grads_kernel`: dw1 = h0^T da and dw2 = sw^T dy, 128 x 128
//     output tiles, the rows split about 1024 at a time: fixed-order
//     partials.
//  5. `reduce_all_kernel`: every partial summed into the ten gradients, in
//     blocks of ceil(sqrt(count)): a term of db1 passes at most TM / 8 + 8
//     + 2 sqrt(partials) additions, of dwd TM + 2 sqrt(partials), which
//     the checks' bounds take (ops/conformer_conv.py, `sum_depth`).
// Launches 1 and 2 take 64 frames a CTA, or 32 and 16 where a tile does
// not fit shared memory (D past 256 for launch 1, large k), 16 warps in a
// 4 x 4 grid; launches 3 and 4, 8 warps in a 2 x 4 grid.
//
// fp32: the first design's chain of 15 launches on the CUDA cores (TF32
// would round the operands) with fp32 intermediates in a workspace (187
// MB at Conformer-M's shape): LN1; a = h0 w1 + b1; c; ds; LN2's backward
// (dc); dw2 partials; du, da and the dwd, db1 partials; dh0; dw1
// partials; LN1's backward (dx); five reductions. Its products are one
// kernel, a 64 x 64 output tile over operands staged 32 deep.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "conformer_conv.cuh"

// a named namespace, so that a profile tells these kernels apart
namespace conformer_conv_backward {

using namespace conformer_conv;

constexpr int kNoFit = -2;      // a bf16 launch's CTA does not fit an SM

// ---- fp32 ------------------------------------------------------------------

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
__global__ void __launch_bounds__(kThreads)
ln1_kernel(const float* __restrict__ x, const float* __restrict__ ln1s,
           const float* __restrict__ ln1b, float* __restrict__ h0, int N,
           int D, float eps) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int n = blockIdx.x * kRows + warp; n < min(N, (blockIdx.x + 1) *
                                                         kRows);
       n += kWarps) {
    const float* row = x + static_cast<size_t>(n) * D;
    float sum = 0.f, sq = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = row[c];
      sum += v;
      sq = fmaf(v, v, sq);
    }
    const float mu = warp_sum(sum) / D;
    const float rstd = rsqrtf(warp_sum(sq) / D - mu * mu + eps);
    for (int c = lane; c < D; c += 32)
      h0[static_cast<size_t>(n) * D + c] =
          fmaf((row[c] - mu) * rstd, ln1s[c], ln1b[c]);
  }
}

// The product kernel: out[z][r][c] = sum over kk in split z of X[r][kk]
// Y[kk][c] (+ bias[c]), for r < R and c < M (a multiple of 64), with X[r][kk]
// at X[r sxr + kk sxk] and Y[kk][c] at Y[kk syk + c syc]; split z covers kk
// in [z k_split, min(K, (z + 1) k_split)). One CTA a 64 x 64 tile of one
// split.
__global__ void __launch_bounds__(kThreads)
product_kernel(const float* __restrict__ X, long long sxr, long long sxk,
               const float* __restrict__ Y, long long syk, long long syc,
               const float* __restrict__ bias, float* __restrict__ out, int R,
               int M, int K, int k_split) {
  constexpr int SA = kKC + 4;
  __shared__ __align__(16) float sa[kRows * SA];   // X's chunk
  __shared__ __align__(16) float sw[kKC * kWC];    // Y's chunk
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
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
      sa[r * SA + kk] = row < R && k < ke ? X[row * sxr + k * sxk] : 0.f;
    }
    for (int i = tid; i < kKC * kWC; i += kThreads) {
      const int c = syc == 1 ? i % kWC : i / kKC;
      const int kk = syc == 1 ? i / kWC : i % kKC;
      const int k = kc + kk;
      sw[kk * kWC + c] = k < ke ? Y[k * syk + (c0 + c) * syc] : 0.f;
    }
    __syncthreads();
    product_chunk(sa, SA, 0, sw, acc, tx, ty);
  }
  float* dst = out + static_cast<size_t>(z) * R * M;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = ty * 4 + i, c = tx * 4 + e;
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
__global__ void __launch_bounds__(kThreads)
ln2_bwd_kernel(const float* __restrict__ c, const float* __restrict__ ds,
               const float* __restrict__ dy, const float* __restrict__ ln2s,
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
        p_b2[i] += dy[at + col];
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
__global__ void __launch_bounds__(kThreads)
ln1_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dh0,
               const float* __restrict__ ln1s, float* __restrict__ dx,
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
        xh[i] = x[at + lane + 32 * i];
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
      if (i < nc) dx[at + lane + 32 * i] = rstd * (dxh[i] - m1 - xh[i] * m2);
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

// the dw1 and dw2 products' rows, split about 1024 at a time into at most
// 32 splits of a multiple of 64 rows (ops/conformer_conv.py, `dw_splits`)
struct Splits {
  int count, rows;
  explicit Splits(int N) {
    count = std::min(32, std::max(1, (N + 1023) / 1024));
    rows = ((N + count - 1) / count + 63) / 64 * 64;
    count = (N + rows - 1) / rows;
  }
};

// the fp32 chain's workspace arrays, in floats from its start
struct Layout {
  int N, row_ctas, dw_ctas, splits, k_split;
  size_t h0, a, c, ds, sw, dc, da, dh0, p_ln2, p_dw, p_ln1, p_w2, p_w1, end;

  Layout(int B, int Tn, int D, int K) {
    N = B * Tn;
    row_ctas = (N + kRows - 1) / kRows;
    dw_ctas = B * ((Tn + kRows - 1) / kRows);
    const Splits s(N);
    splits = s.count;
    k_split = s.rows;
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

int product(const float* X, long long sxr, long long sxk, const float* Y,
            long long syk, long long syc, const float* bias, float* out,
            int R, int M, int K, int splits, int k_split,
            cudaStream_t stream) {
  const dim3 grid(M / kWC, (R + kRows - 1) / kRows, splits);
  product_kernel<<<grid, kThreads, 0, stream>>>(X, sxr, sxk, Y, syk, syc,
                                                bias, out, R, M, K, k_split);
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

int launch_fp32(const float* x, const float* dy, const int* lens,
                const float* const* w, float* work, float* dx,
                float* const* g, int B, int Tn, int D, int K, float eps,
                cudaStream_t stream) {
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

  ln1_kernel<<<L.row_ctas, kThreads, 0, stream>>>(x, ln1s, ln1b, h0, N, D,
                                                  eps);
  RETURN_IF_ERROR(static_cast<int>(cudaGetLastError()));
  // a = h0 w1 + b1
  RETURN_IF_ERROR(product(h0, D, 1, w1, 2 * D, 1, b1, a, N, 2 * D, D, 1, D,
                          stream));
  dw_kernel<<<dw_grid, kThreads, smem, stream>>>(a, lens, wd, bd, c, Tn, D,
                                                 K);
  RETURN_IF_ERROR(static_cast<int>(cudaGetLastError()));
  // ds = dy w2^T
  RETURN_IF_ERROR(product(dy, D, 1, w2, 1, D, nullptr, ds, N, D, D, 1, D,
                          stream));
  ln2_bwd_kernel<<<L.row_ctas, kThreads, 0, stream>>>(
      c, ds, dy, ln2s, ln2b, sw, dc, work + L.p_ln2, N, D, eps);
  RETURN_IF_ERROR(static_cast<int>(cudaGetLastError()));
  // dw2 = sw^T dy, by slices of rows
  RETURN_IF_ERROR(product(sw, 1, D, dy, D, 1, nullptr, work + L.p_w2, D, D,
                          N, L.splits, L.k_split, stream));
  dw_bwd_kernel<<<dw_grid, kThreads, smem, stream>>>(a, dc, lens, wd, da,
                                                     work + L.p_dw, Tn, D, K);
  RETURN_IF_ERROR(static_cast<int>(cudaGetLastError()));
  // dh0 = da w1^T
  RETURN_IF_ERROR(product(da, 2 * D, 1, w1, 1, 2 * D, nullptr, dh0, N, D,
                          2 * D, 1, 2 * D, stream));
  // dw1 = h0^T da, by slices of rows
  RETURN_IF_ERROR(product(h0, 1, D, da, 2 * D, 1, nullptr, work + L.p_w1, D,
                          2 * D, N, L.splits, L.k_split, stream));
  ln1_bwd_kernel<<<L.row_ctas, kThreads, 0, stream>>>(
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

// ---- bf16 ------------------------------------------------------------------

// the fp32 intermediates the checks read, null on the main path: one
// buffer of 12 N D floats holding, in order, h0, a (2D wide), c, ds, sw,
// dc, da (2D), dh0 and a again (2D: the second launch's recompute)
struct Inter {
  float *h0, *a, *c, *ds, *sw, *dc, *da, *dh0, *a2;
  Inter(float* base, size_t nd) {
    float** at[9] = {&h0, &a, &c, &ds, &sw, &dc, &da, &dh0, &a2};
    const int width[9] = {1, 2, 1, 1, 1, 1, 2, 1, 2};
    size_t off = 0;
    for (int i = 0; i < 9; ++i) {
      *at[i] = base == nullptr ? nullptr : base + off;
      off += width[i] * nd;
    }
  }
};

// a batch row's part of an intermediate of `width` D columns, or null
__device__ __forceinline__ float* row_of(float* p, size_t row0, int width,
                                         int D) {
  return p == nullptr ? nullptr : p + row0 * width * D;
}

__global__ void __launch_bounds__(kThreads)
round_weights_kernel(const float* __restrict__ w1,
                     const float* __restrict__ w2, bf16* __restrict__ wb,
                     int D) {
  round_weights(w1, w2, wb, D);
}

// launch 1's shared memory: the front half's, then rstd (TM), the row
// sums (TM x 4 warp columns x 2) and the column sums (4 warp rows x 4 x D)
struct FrontBwdLayout {
  FrontLayout f;
  size_t rstd, rowred, colred, end;
  __host__ __device__ FrontBwdLayout(int TM, int D, int K) : f(TM, D, K) {
    rstd = f.end;
    rowred = rstd + sizeof(float) * TM;
    colred = rowred + sizeof(float) * TM * 8;
    end = colred + sizeof(float) * 4 * kWarpRows * D;
  }
};

// 1. the forward to sw, then ds, dn and LN2's backward, for TM frames of
// one batch row (see the top)
template <int TM>
__global__ void __launch_bounds__(kFrontThreads, 1)
front_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
             const int* __restrict__ lens, const float* __restrict__ ln1s,
             const float* __restrict__ ln1b, const float* __restrict__ b1,
             const float* __restrict__ wd, const float* __restrict__ bd,
             const float* __restrict__ ln2s, const float* __restrict__ ln2b,
             const bf16* __restrict__ wb, bf16* __restrict__ h0b,
             bf16* __restrict__ swb, float* __restrict__ dc,
             float* __restrict__ part, Inter in, int Tn, int D, int K,
             float eps) {
  constexpr int MT2 = (TM / 16 + kWarpRows - 1) / kWarpRows;
  // ds's passes of 128 columns: D <= 256 at TM 64 (the plan), else <= 512
  constexpr int kPasses = TM == 64 ? 2 : 4;
  extern __shared__ __align__(16) unsigned char raw[];
  const FrontBwdLayout L(TM, D, K);
  bf16* hs = reinterpret_cast<bf16*>(raw + L.f.h);
  float* cs = reinterpret_cast<float*>(raw + L.f.c);
  float* us = reinterpret_cast<float*>(raw + L.f.u);
  float* rstd_s = reinterpret_cast<float*>(raw + L.rstd);
  float* rowred = reinterpret_cast<float*>(raw + L.rowred);
  float* colred = reinterpret_cast<float*>(raw + L.colred);
  const int b = blockIdx.y, t_own = blockIdx.x * TM, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 2, wc = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int sa = L.f.sa, sc = L.f.sc, mtiles = TM / 16;
  const size_t row0 = static_cast<size_t>(b) * Tn;
  const FrontChunks<true> chunks{wb, wb + 2 * D * D, D};
  auto ring = flash_relpos::make_ring<kRing, kAhead, kFrontThreads>(
      reinterpret_cast<bf16*>(raw), chunks.total(), chunks);
  ring.start();
  front_half<TM>(ring, L.f, hs, cs, us, x + row0 * D, t_own,
                 min(Tn, lens[b]), Tn, D, K, ln1s, ln1b, b1, wd, bd, eps,
                 h0b + row0 * D, row_of(in.h0, row0, 1, D),
                 row_of(in.a, row0, 2, D), nullptr);
  // the dy tile over the LN1 tile (ds's A), rows past T zero
  stage_rows(hs, sa, dy + row0 * D, t_own, TM, Tn, D);
  ln2_rows(cs, sc, TM, t_own, Tn, D, ln2s, ln2b, eps, nullptr, 0,
           row_of(in.c, row0, 1, D), swb + row0 * D,
           row_of(in.sw, row0, 1, D), rstd_s);
  cp_async_wait<0>();
  __syncthreads();

  // ds = dy w2^T a pass of 128 columns at a time; dn = ds swish'(n) kept;
  // the rows' partial sums of dxh = dn ln2s and dxh xh
  float dn[kPasses][MT2][4][4];
  float r1[MT2][2] = {}, r2[MT2][2] = {};
#pragma unroll
  for (int q = 0; q < kPasses; ++q) {
    if (128 * q >= D) break;
    float acc[MT2][4][4];
    pass_product<true, MT2>(acc, ring, hs, sa, mtiles, D, wr, wc);
#pragma unroll
    for (int m = 0; m < MT2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int mt = wr + kWarpRows * m, r = 16 * mt + g + 8 * (e >> 1);
          const int i = 128 * q + 32 * wc + 8 * n + 2 * t4 + (e & 1);
          float d = 0.f;
          if (mt < mtiles && i < D) {
            const float dsv = acc[m][n][e];
            if (in.ds != nullptr && t_own + r < Tn)
              in.ds[(row0 + t_own + r) * D + i] = dsv;
            const float xh = cs[r * sc + i];
            const float nn = fmaf(xh, ln2s[i], ln2b[i]);
            const float sn = sigmoid(nn);
            d = dsv * (sn + nn * sn * (1.f - sn));
            const float dxh = d * ln2s[i];
            r1[m][e >> 1] += dxh;
            r2[m][e >> 1] = fmaf(dxh, xh, r2[m][e >> 1]);
          }
          dn[q][m][n][e] = d;
        }
  }
  // the rows' sums: the lane's four columns' lanes, then the four warps
  // of a warp row, in order
#pragma unroll
  for (int m = 0; m < MT2; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        r1[m][e] += __shfl_xor_sync(0xffffffffu, r1[m][e], o);
        r2[m][e] += __shfl_xor_sync(0xffffffffu, r2[m][e], o);
      }
      const int mt = wr + kWarpRows * m, r = 16 * mt + g + 8 * e;
      if (t4 == 0 && mt < mtiles) {
        rowred[r * 8 + 2 * wc] = r1[m][e];
        rowred[r * 8 + 2 * wc + 1] = r2[m][e];
      }
    }
  __syncthreads();
  float m1[MT2][2], m2[MT2][2], rs[MT2][2];
#pragma unroll
  for (int m = 0; m < MT2; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int mt = wr + kWarpRows * m, r = 16 * mt + g + 8 * e;
      m1[m][e] = m2[m][e] = rs[m][e] = 0.f;
      if (mt < mtiles) {
        const float* rr = rowred + r * 8;
        m1[m][e] = (rr[0] + rr[2] + rr[4] + rr[6]) / D;
        m2[m][e] = (rr[1] + rr[3] + rr[5] + rr[7]) / D;
        rs[m][e] = rstd_s[r];
      }
    }
  // dc = rstd (dxh - m1 - xh m2) out, a thread's column pair at a time;
  // the columns' sums over the CTA's rows of dn xh (dln2s), dn (dln2b), dc
  // (dbd) and dy (db2): a thread's rows, the eight lanes of a column, then
  // the four warp rows in order
#pragma unroll
  for (int q = 0; q < kPasses; ++q) {
    if (128 * q >= D) break;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      // columns i0 and i0 + 1: both below D or neither (D is a multiple
      // of 64), the same for the whole warp
      const int i0 = 128 * q + 32 * wc + 8 * n + 2 * t4;
      float sum[4][2] = {};
      if (i0 < D) {
        const float g2[2] = {ln2s[i0], ln2s[i0 + 1]};
#pragma unroll
        for (int m = 0; m < MT2; ++m)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int mt = wr + kWarpRows * m, r = 16 * mt + g + 8 * e;
            if (mt >= mtiles) continue;
            float v[2];
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              const float xh = cs[r * sc + i0 + s];
              const float d = dn[q][m][n][2 * e + s];
              v[s] = rs[m][e] * (d * g2[s] - m1[m][e] - xh * m2[m][e]);
              sum[0][s] = fmaf(d, xh, sum[0][s]);
              sum[1][s] += d;
              sum[2][s] += v[s];
              sum[3][s] += __bfloat162float(hs[r * sa + i0 + s]);
            }
            if (t_own + r < Tn) {
              const size_t at = (row0 + t_own + r) * D + i0;
              *reinterpret_cast<float2*>(dc + at) = make_float2(v[0], v[1]);
              if (in.dc != nullptr)
                *reinterpret_cast<float2*>(in.dc + at) =
                    make_float2(v[0], v[1]);
            }
          }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            sum[k][s] += __shfl_xor_sync(0xffffffffu, sum[k][s], o);
          if (g == 0 && i0 < D) colred[(wr * 4 + k) * D + i0 + s] = sum[k][s];
        }
    }
  }
  __syncthreads();
  float* dst = part + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 4 *
                          D;
  for (int c = tid; c < 4 * D; c += kFrontThreads)
    dst[c] = colred[c] + colred[4 * D + c] + colred[8 * D + c] +
             colred[12 * D + c];
}

// launch 2's shared memory: the ring, the LN1 tile (as the front half's),
// the u and dc tiles (RU rows of kCC), p and sigmoid(q) of the owned rows
// (TM rows of kUS each), the eight thread groups' db1 sums
struct GluLayout {
  int R, RU, sa;
  size_t h, u, dc, ps, sqs, red, end;
  __host__ __device__ GluLayout(int TM, int D, int K) {
    R = round16(TM + K - 1);
    RU = TM + round16(K);
    sa = D + 8;
    h = sizeof(bf16) * kRing * kSlot;
    u = h + sizeof(bf16) * static_cast<size_t>(R) * sa;
    dc = u + sizeof(float) * static_cast<size_t>(RU) * kUS;
    ps = dc + sizeof(float) * static_cast<size_t>(RU) * kUS;
    sqs = ps + sizeof(float) * static_cast<size_t>(TM) * kUS;
    red = sqs + sizeof(float) * static_cast<size_t>(TM) * kUS;
    end = red + sizeof(float) * 2 * kFrontThreads;
  }
};

// 2. du, da and the partials of dwd and db1, for TM frames of one batch
// row (see the top); partial: [dwd (K x D) | db1 (2D, natural layout)]
template <int TM>
__global__ void __launch_bounds__(kFrontThreads, 1)
glu_bwd_kernel(const bf16* __restrict__ h0b, const float* __restrict__ dc,
               const int* __restrict__ lens, const float* __restrict__ b1,
               const float* __restrict__ wd, const bf16* __restrict__ wb,
               bf16* __restrict__ dab, float* __restrict__ part, Inter in,
               int Tn, int D, int K) {
  constexpr int MT = front_mt<TM>(), RB = TM * kCC / kFrontThreads;
  constexpr int kGroups = kFrontThreads / kCC, JB = 4, IB = 16;
  extern __shared__ __align__(16) unsigned char raw[];
  const GluLayout L(TM, D, K);
  bf16* hs = reinterpret_cast<bf16*>(raw + L.h);
  float* us = reinterpret_cast<float*>(raw + L.u);
  float* dcs = reinterpret_cast<float*>(raw + L.dc);
  float* ps = reinterpret_cast<float*>(raw + L.ps);
  float* sqs = reinterpret_cast<float*>(raw + L.sqs);
  float* red = reinterpret_cast<float*>(raw + L.red);
  const int b = blockIdx.y, t_own = blockIdx.x * TM, tid = threadIdx.x;
  const int warp = tid >> 5, wr = warp >> 2, wc = warp & 3;
  const int P = (K - 1) / 2, Q = K - 1 - P, live_end = min(Tn, lens[b]);
  const int ch = tid % kCC, grp = tid / kCC;
  const size_t row0 = static_cast<size_t>(b) * Tn;
  const FrontChunks<false> chunks{wb, wb + 2 * D * D, D};
  auto ring = flash_relpos::make_ring<kRing, kAhead, kFrontThreads>(
      reinterpret_cast<bf16*>(raw), chunks.pw1_chunks(), chunks);
  ring.start();
  // the LN1 tile: launch 1's h0 of frames t_own - P .., zero outside [0, T)
  stage_rows(hs, L.sa, h0b + row0 * D, t_own - P, L.R, Tn, D);
  cp_async_wait<0>();
  __syncthreads();
  float* dst = part + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) *
                          (K + 2) * D;
  for (int p = 0; p < D / 64; ++p) {
    __syncthreads();                 // the last pass's tile reads are done
    // the dc tile of the pass: frames t_own - Q .., channels 64 p ..
    for (int i = tid; i < L.RU * 16; i += kFrontThreads) {
      const int r = i / 16, c = i % 16 * 4, t = t_own - Q + r;
      const bool live = t >= 0 && t < Tn;
      cp_async16(dcs + r * kUS + c,
                 dc + (row0 + (live ? t : 0)) * D + 64 * p + c,
                 live ? 16 : 0);
    }
    cp_async_commit();
    float acc[MT][4][4];
    pass_product<false, MT>(acc, ring, hs, L.sa, L.R / 16, D, wr, wc);
    glu_epilogue<MT>(acc, p, L.R / 16, b1, D, t_own - P, live_end, us, P,
                     TM, Tn, row_of(in.a2, row0, 2, D), nullptr, ps, sqs,
                     wr, wc);
    cp_async_wait<0>();
    __syncthreads();
    // du[i] = sum_j wd[j] dc[t_own + i - j + P] (dc tile row i + K - 1 -
    // j), the mask, the GLU's backward; da out, interleaved in bf16
    float du[RB];
    taps<RB, true>(du, dcs + ch, grp * RB, wd + 64 * p + ch, D, K);
    float sp = 0.f, sq = 0.f;
#pragma unroll
    for (int ii = 0; ii < RB; ++ii) {
      const int i = grp * RB + ii, t = t_own + i;
      if (t >= Tn) continue;
      const float d = t < live_end ? du[ii] : 0.f;
      const float pv = ps[i * kUS + ch], sg = sqs[i * kUS + ch];
      const float dp = d * sg, dq = d * pv * sg * (1.f - sg);
      sp += dp;
      sq += dq;
      *reinterpret_cast<unsigned*>(dab + (row0 + t) * 2 * D +
                                   2 * (64 * p + ch)) = pack_bf16(dp, dq);
      if (in.da != nullptr) {
        in.da[(row0 + t) * 2 * D + 64 * p + ch] = dp;
        in.da[(row0 + t) * 2 * D + D + 64 * p + ch] = dq;
      }
    }
    red[tid] = sp;
    red[kFrontThreads + tid] = sq;
    // dwd[j] = sum over the tile's frames i of u[t + j - P] dc[t] (u tile
    // row i + j, dc tile row i + Q): JB taps a thread, the frames IB at a
    // time through registers, in order
    for (int jb = grp * JB; jb < K; jb += kGroups * JB) {
      float sj[JB] = {};
      for (int i0 = 0; i0 < TM; i0 += IB) {
        float d[IB], w[IB + JB - 1];
#pragma unroll
        for (int ii = 0; ii < IB; ++ii)
          d[ii] = dcs[(i0 + ii + Q) * kUS + ch];
#pragma unroll
        for (int v = 0; v < IB + JB - 1; ++v)
          w[v] = us[(i0 + jb + v) * kUS + ch];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj)
#pragma unroll
          for (int ii = 0; ii < IB; ++ii)
            sj[jj] = fmaf(w[ii + jj], d[ii], sj[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
        if (jb + jj < K) dst[(jb + jj) * D + 64 * p + ch] = sj[jj];
    }
    __syncthreads();
    if (grp == 0) {
      float s0 = 0.f, s1 = 0.f;
      for (int q = 0; q < kGroups; ++q) {
        s0 += red[q * kCC + ch];
        s1 += red[kFrontThreads + q * kCC + ch];
      }
      dst[K * D + 64 * p + ch] = s0;
      dst[K * D + D + 64 * p + ch] = s1;
    }
  }
}

// launch 3's chunks: per 64-deep step s of da's 2D columns, the CTA's rows
// of da (its A), then w1's rows 64 j (dh0's columns) by the step's columns
struct Dh0Chunks {
  const bf16* da;
  const bf16* w1;
  int D, m0, live, per;
  __device__ Chunk operator()(int i) const {
    const int s = i / per, j = i % per;
    if (j == 0)
      return {da + static_cast<size_t>(m0) * 2 * D + 64 * s, 2 * D, 64,
              live};
    return {w1 + static_cast<size_t>(64 * (j - 1)) * 2 * D + 64 * s, 2 * D,
            64, 64};
  }
};

// launch 3's ring: a step's 1 + D / 64 chunks in flight while the last
// step's are read; the rows: 32 MT (MT 2 up to D 256, else 1)
template <int MT, int NT>
struct Dh0Shape {
  static constexpr int kRowsCta = 32 * MT, kAhead = 1 + NT / 2,
                       kSlots = 2 * kAhead;
};

template <int MT, int NT>
size_t dh0_smem(int D) {
  using S = Dh0Shape<MT, NT>;
  return sizeof(bf16) * S::kSlots * kSlot +
         sizeof(float) * (10 * S::kRowsCta + 4 * static_cast<size_t>(D));
}

// 3. dh0 = da w1^T for 32 MT rows and all D columns (NT >= D / 32
// n-tiles a warp), then LN1's backward: dx out; partial [dln1s | dln1b]
template <int MT, int NT>
__global__ void __launch_bounds__(kThreads, 1)
dh0_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dab,
           const float* __restrict__ ln1s, const bf16* __restrict__ w1b,
           bf16* __restrict__ dx, float* __restrict__ part,
           float* __restrict__ dh0_f, int N, int D, float eps) {
  using S = Dh0Shape<MT, NT>;
  constexpr int MR = S::kRowsCta, NS = S::kSlots;
  extern __shared__ __align__(16) unsigned char raw[];
  float* mu_s = reinterpret_cast<float*>(raw + sizeof(bf16) * NS * kSlot);
  float* rstd_s = mu_s + MR;
  float* rowred = rstd_s + MR;           // MR x 4 warp columns x 2
  float* colred = rowred + 8 * MR;       // 2 warp rows x 2 x D
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 2, wc = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.x * MR, per = 1 + D / 64, ntw = D / 32;
  const Dh0Chunks chunks{dab, w1b, D, m0, min(MR, N - m0), per};
  auto ring = flash_relpos::make_ring<NS, S::kAhead, kThreads>(
      reinterpret_cast<bf16*>(raw), (2 * D / 64) * per, chunks);
  ring.start();
  // LN1's statistics of the rows, as launch 1 takes them
  for (int r = warp; r < MR; r += kWarps) {
    const int n = m0 + r;
    if (n >= N) continue;
    const bf16* xr = x + static_cast<size_t>(n) * D;
    float sum = 0.f, sq = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = __bfloat162float(xr[c]);
      sum += v;
      sq = fmaf(v, v, sq);
    }
    const float mu = warp_sum(sum) / D;
    const float rstd = rsqrtf(warp_sum(sq) / D - mu * mu + eps);
    if (lane == 0) {
      mu_s[r] = mu;
      rstd_s[r] = rstd;
    }
  }
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  for (int s = 0; s < 2 * D / 64; ++s) {
    for (int j = 0; j < per; ++j) ring.acquire();
    const bf16* sa = ring.base + (s * per) % NS * kSlot;
#pragma unroll
    for (int ks = 0; ks < 64; ks += 16) {
      unsigned af[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        a_frag(af[m], sa, kCS, 16 * (MT * wr + m), ks);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        if (nt < ntw) {
          const int c = 8 * (wc * ntw + nt);
          const bf16* sb = ring.base + (s * per + 1 + c / 64) % NS * kSlot;
          unsigned r[4];
          b_frag_nk(r, sb, kCS, c % 64, ks);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_bf16(acc[m][nt], af[m], r[0], r[1]);
            mma_bf16(acc[m][nt + 1], af[m], r[2], r[3]);
          }
        }
      }
    }
  }
  // the rows' sums of dxh = dh0 ln1s and dxh xh
  float r1[MT][2] = {}, r2[MT][2] = {};
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 16 * (MT * wr + m) + g + 8 * e, n = m0 + r;
      if (n < N) {
        const float mu = mu_s[r], rs = rstd_s[r];
        const bf16* xr = x + static_cast<size_t>(n) * D;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (nt < ntw)
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              const int col = 8 * (wc * ntw + nt) + 2 * t4 + s;
              const float dh = acc[m][nt][2 * e + s];
              const float xh = (__bfloat162float(xr[col]) - mu) * rs;
              const float dxh = dh * ln1s[col];
              r1[m][e] += dxh;
              r2[m][e] = fmaf(dxh, xh, r2[m][e]);
              if (dh0_f != nullptr)
                dh0_f[static_cast<size_t>(n) * D + col] = dh;
            }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        r1[m][e] += __shfl_xor_sync(0xffffffffu, r1[m][e], o);
        r2[m][e] += __shfl_xor_sync(0xffffffffu, r2[m][e], o);
      }
      if (t4 == 0) {
        rowred[r * 8 + 2 * wc] = r1[m][e];
        rowred[r * 8 + 2 * wc + 1] = r2[m][e];
      }
    }
  __syncthreads();
  float m1[MT][2], m2[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float* rr = rowred + (16 * (MT * wr + m) + g + 8 * e) * 8;
      m1[m][e] = (rr[0] + rr[2] + rr[4] + rr[6]) / D;
      m2[m][e] = (rr[1] + rr[3] + rr[5] + rr[7]) / D;
    }
  // dx = rstd (dxh - m1 - xh m2) out; the columns' sums of dh0 xh and dh0
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= ntw) break;
    const int col0 = 8 * (wc * ntw + nt) + 2 * t4;
    float c_s[2] = {}, c_b[2] = {};
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 16 * (MT * wr + m) + g + 8 * e, n = m0 + r;
        if (n >= N) continue;
        const float mu = mu_s[r], rs = rstd_s[r];
        const bf16* xr = x + static_cast<size_t>(n) * D;
        float v[2];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float dh = acc[m][nt][2 * e + s];
          const float xh = (__bfloat162float(xr[col0 + s]) - mu) * rs;
          const float dxh = dh * ln1s[col0 + s];
          v[s] = rs * (dxh - m1[m][e] - xh * m2[m][e]);
          c_s[s] = fmaf(dh, xh, c_s[s]);
          c_b[s] += dh;
        }
        *reinterpret_cast<unsigned*>(dx + static_cast<size_t>(n) * D +
                                     col0) = pack_bf16(v[0], v[1]);
      }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        c_s[s] += __shfl_xor_sync(0xffffffffu, c_s[s], o);
        c_b[s] += __shfl_xor_sync(0xffffffffu, c_b[s], o);
      }
      if (g == 0) {
        colred[(wr * 2) * D + col0 + s] = c_s[s];
        colred[(wr * 2 + 1) * D + col0 + s] = c_b[s];
      }
    }
  }
  __syncthreads();
  float* dst = part + static_cast<size_t>(blockIdx.x) * 2 * D;
  for (int c = tid; c < 2 * D; c += kThreads)
    dst[c] = colred[c] + colred[2 * D + c];
}

// launch 4's chunks: per 64 rows (frames) of the split, A's columns d0 ..
// d0 + 127 in two chunks, then B's e0 .. e0 + 127; a chunk past a
// matrix's width is zero, rows past the split's end zero
struct WgChunks {
  const bf16* A;
  const bf16* B;
  int lda, ldb, d0, e0, begin, end;
  __device__ Chunk operator()(int i) const {
    const int j = i % 4, n0 = begin + 64 * (i / 4);
    const int live = min(64, end - n0);
    if (j < 2) {
      const int c = d0 + 64 * j;
      return c < lda ? Chunk{A + static_cast<size_t>(n0) * lda + c, lda, 64,
                             live}
                     : Chunk{A, lda, 64, 0};
    }
    const int c = e0 + 64 * (j - 2);
    return c < ldb ? Chunk{B + static_cast<size_t>(n0) * ldb + c, ldb, 64,
                           live}
                   : Chunk{B, ldb, 64, 0};
  }
};

constexpr int kWgSlots = 8, kWgAhead = 4;

// 4. the partial of split blockIdx.y of a 128 x 128 tile of dw1 = h0^T da
// (tiles first; da's columns interleaved, the partial's natural) or dw2 =
// sw^T dy: part [splits][dw1 (D x 2D) | dw2 (D x D)]
__global__ void __launch_bounds__(kThreads)
weight_grads_kernel(const bf16* __restrict__ h0b,
                    const bf16* __restrict__ dab,
                    const bf16* __restrict__ swb,
                    const bf16* __restrict__ dy, float* __restrict__ part,
                    int N, int D, int rows) {
  extern __shared__ __align__(16) unsigned char raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 2, wc = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int td = (D + 127) / 128, te1 = D / 64, z = blockIdx.y;
  const bool first = static_cast<int>(blockIdx.x) < td * te1;
  const int tile = first ? blockIdx.x : blockIdx.x - td * te1;
  const int te = first ? te1 : td, width = first ? 2 * D : D;
  const int d0 = 128 * (tile / te), e0 = 128 * (tile % te);
  const int begin = z * rows, end = min(N, begin + rows);
  const int steps = (end - begin + 63) / 64;
  const WgChunks chunks{first ? h0b : swb, first ? dab : dy, D, width, d0,
                        e0, begin, end};
  auto ring = flash_relpos::make_ring<kWgSlots, kWgAhead, kThreads>(
      reinterpret_cast<bf16*>(raw), 4 * steps, chunks);
  ring.start();
  float acc[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  for (int s = 0; s < steps; ++s) {
    for (int j = 0; j < 4; ++j) ring.acquire();
    const bf16* sa = ring.base + (4 * s + wr) % kWgSlots * kSlot;
    const bf16* sb = ring.base + (4 * s + 2 + wc / 2) % kWgSlots * kSlot;
    const int nb = (wc & 1) * 32;
#pragma unroll
    for (int ks = 0; ks < 64; ks += 16) {
      unsigned bf[2][4];
      b_frag_kn(bf[0], sb, kCS, ks, nb);
      b_frag_kn(bf[1], sb, kCS, ks, nb + 16);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        unsigned af[4];
        a_frag_km(af, sa, kCS, 16 * m, ks);
        mma_bf16(acc[m][0], af, bf[0][0], bf[0][1]);
        mma_bf16(acc[m][1], af, bf[0][2], bf[0][3]);
        mma_bf16(acc[m][2], af, bf[1][0], bf[1][1]);
        mma_bf16(acc[m][3], af, bf[1][2], bf[1][3]);
      }
    }
  }
  float* dst = part + static_cast<size_t>(z) * 3 * D * D +
               (first ? 0 : static_cast<size_t>(2) * D * D);
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + 64 * wr + 16 * m + g + 8 * (e >> 1);
        const int ec = e0 + 32 * wc + 8 * n + 2 * t4 + (e & 1);
        if (d >= D || ec >= width) continue;
        const int col = first ? (ec & 1) * D + (ec >> 1) : ec;
        dst[static_cast<size_t>(d) * width + col] = acc[m][n][e];
      }
}

// 5. one gradient's piece: out[c] = the sum over z < count of part[z
// stride + col0 + c], c < width, in blocks of blk partials
struct Piece {
  const float* part;
  long long stride;
  int count, blk, col0, width;
  float* out;
};
struct Pieces {
  Piece p[10];
};

// (`__grid_constant__`: a piece is read where the launch put it, not
// copied to each thread's local memory for the dynamic index)
__global__ void __launch_bounds__(kThreads)
reduce_all_kernel(const __grid_constant__ Pieces ps, int total) {
  for (int c = blockIdx.x * kThreads + threadIdx.x; c < total;
       c += gridDim.x * kThreads) {
    int i = 0, at = c;
    while (at >= ps.p[i].width) at -= ps.p[i++].width;
    const Piece& pc = ps.p[i];
    const float* src = pc.part + pc.col0 + at;
    float s = 0.f;
    for (int z0 = 0; z0 < pc.count; z0 += pc.blk) {
      float t = 0.f;
      const int z1 = min(pc.count, z0 + pc.blk);
      // eight loads in flight, added in order
      for (int z = z0; z < z1; z += 8) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[k] = z + k < z1 ? src[(z + k) * pc.stride] : 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (z + k < z1) t += v[k];
      }
      s += t;
    }
    pc.out[at] = s;
  }
}

// the smallest b with b b >= n: the reduction's block of partials
int block_of(int n) {
  int b = 1;
  while (b * b < n) ++b;
  return b;
}

size_t front_smem(int TM, int D, int K) {
  return FrontBwdLayout(TM, D, K).end;
}
size_t glu_smem(int TM, int D, int K) { return GluLayout(TM, D, K).end; }
size_t wg_smem() { return sizeof(bf16) * kWgSlots * kSlot; }

// out = [tile, smem, CTAs an SM] of each bf16 launch, 1 to 4: launch 1's
// and 2's frames a CTA (0 where none fits), launch 3's rows, launch 4's
// 128 (CTAs as kernel_fit reports them with `count`)
int bwd_fit(int D, int K, int tile, int* out, bool count) {
  const size_t limit = smem_limit();
  // launch 1 keeps ds's dn in registers: 64 frames only up to D 256
  const int tm1 = plan_tile(tile, limit, [&](int t) {
    return t == 64 && D > 256 ? ~size_t(0) : front_smem(t, D, K);
  });
  const int tm2 = plan_tile(tile, limit,
                            [&](int t) { return glu_smem(t, D, K); });
  int err = 0;
  out[0] = tm1;
  out[1] = static_cast<int>(front_smem(tm1 != 0 ? tm1 : 16, D, K));
  out[2] = 0;
  if (tm1 == 64)
    err = kernel_fit(front_kernel<64>, front_smem(64, D, K), kFrontThreads,
                     out + 1, count);
  else if (tm1 == 32)
    err = kernel_fit(front_kernel<32>, front_smem(32, D, K), kFrontThreads,
                     out + 1, count);
  else if (tm1 == 16)
    err = kernel_fit(front_kernel<16>, front_smem(16, D, K), kFrontThreads,
                     out + 1, count);
  if (err != 0) return err;
  out[3] = tm2;
  out[4] = static_cast<int>(glu_smem(tm2 != 0 ? tm2 : 16, D, K));
  out[5] = 0;
  if (tm2 == 64)
    err = kernel_fit(glu_bwd_kernel<64>, glu_smem(64, D, K), kFrontThreads,
                     out + 4, count);
  else if (tm2 == 32)
    err = kernel_fit(glu_bwd_kernel<32>, glu_smem(32, D, K), kFrontThreads,
                     out + 4, count);
  else if (tm2 == 16)
    err = kernel_fit(glu_bwd_kernel<16>, glu_smem(16, D, K), kFrontThreads,
                     out + 4, count);
  if (err != 0) return err;
  if (D <= 256) {
    out[6] = Dh0Shape<2, 8>::kRowsCta;
    err = kernel_fit(dh0_kernel<2, 8>, dh0_smem<2, 8>(D), kThreads, out + 7,
                     count);
  } else {
    out[6] = Dh0Shape<1, 16>::kRowsCta;
    err = kernel_fit(dh0_kernel<1, 16>, dh0_smem<1, 16>(D), kThreads, out + 7,
                     count);
  }
  if (err != 0) return err;
  out[9] = 128;
  return kernel_fit(weight_grads_kernel, wg_smem(), kThreads, out + 10,
                    count);
}

// the bf16 chain's workspace, in bytes from its start: h0, sw (N x D) and
// da (N x 2D, interleaved) in bf16; the rounded weights; dc (N x D, fp32);
// the partials of launches 1 to 4
struct BwdLayout {
  int tiles1, tiles2, parts3;
  Splits splits;
  size_t h0, sw, da, wb, dc, p1, p2, p3, p4, end;
  BwdLayout(int B, int Tn, int D, int K, int tm1, int tm2, int rows3)
      : splits(B * Tn) {
    const size_t N = static_cast<size_t>(B) * Tn, nd = N * D;
    tiles1 = (Tn + tm1 - 1) / tm1;
    tiles2 = (Tn + tm2 - 1) / tm2;
    parts3 = static_cast<int>((N + rows3 - 1) / rows3);
    h0 = 0;
    sw = h0 + sizeof(bf16) * nd;
    da = sw + sizeof(bf16) * nd;
    wb = da + sizeof(bf16) * 2 * nd;
    dc = wb + sizeof(bf16) * 3 * D * D;
    p1 = dc + sizeof(float) * nd;
    p2 = p1 + sizeof(float) * B * tiles1 * 4 * D;
    p3 = p2 + sizeof(float) * B * tiles2 * (K + 2) * D;
    p4 = p3 + sizeof(float) * parts3 * 2 * D;
    end = p4 + sizeof(float) * splits.count * 3 * D * D;
  }
};

int launch_bf16(const bf16* x, const bf16* dy, const int* lens,
                const float* const* w, unsigned char* work, bf16* dx,
                float* const* g, float* inter, int B, int Tn, int D, int K,
                int tile, float eps, cudaStream_t stream) {
  int fit[12];
  RETURN_IF_ERROR(bwd_fit(D, K, tile, fit, false));
  for (int i = 0; i < 4; ++i)
    if (fit[3 * i + 2] == 0) return kNoFit;
  const int tm1 = fit[0], tm2 = fit[3], rows3 = fit[6];
  const BwdLayout L(B, Tn, D, K, tm1, tm2, rows3);
  const int N = B * Tn;
  auto* h0b = reinterpret_cast<bf16*>(work + L.h0);
  auto* swb = reinterpret_cast<bf16*>(work + L.sw);
  auto* dab = reinterpret_cast<bf16*>(work + L.da);
  auto* wb = reinterpret_cast<bf16*>(work + L.wb);
  auto* dc = reinterpret_cast<float*>(work + L.dc);
  auto* p1 = reinterpret_cast<float*>(work + L.p1);
  auto* p2 = reinterpret_cast<float*>(work + L.p2);
  auto* p3 = reinterpret_cast<float*>(work + L.p3);
  auto* p4 = reinterpret_cast<float*>(work + L.p4);
  const Inter in(inter, static_cast<size_t>(N) * D);

  const int nw = 3 * D * D;
  round_weights_kernel<<<std::min((nw + kThreads - 1) / kThreads, 1024),
                         kThreads, 0, stream>>>(w[2], w[8], wb, D);
  RETURN_IF_ERROR(static_cast<int>(cudaGetLastError()));

  const dim3 grid1(L.tiles1, B);
  const size_t smem1 = static_cast<size_t>(fit[1]);
#define CONV_FRONT_LAUNCH(TM)                                               \
  front_kernel<TM><<<grid1, kFrontThreads, smem1, stream>>>(                \
      x, dy, lens, w[0], w[1], w[3], w[4], w[5], w[6], w[7], wb, h0b, swb, \
      dc, p1, in, Tn, D, K, eps)
  if (tm1 == 64)
    CONV_FRONT_LAUNCH(64);
  else if (tm1 == 32)
    CONV_FRONT_LAUNCH(32);
  else
    CONV_FRONT_LAUNCH(16);
#undef CONV_FRONT_LAUNCH
  RETURN_IF_ERROR(static_cast<int>(cudaGetLastError()));

  const dim3 grid2(L.tiles2, B);
  const size_t smem2 = static_cast<size_t>(fit[4]);
#define CONV_GLU_LAUNCH(TM)                                               \
  glu_bwd_kernel<TM><<<grid2, kFrontThreads, smem2, stream>>>(            \
      h0b, dc, lens, w[3], w[4], wb, dab, p2, in, Tn, D, K)
  if (tm2 == 64)
    CONV_GLU_LAUNCH(64);
  else if (tm2 == 32)
    CONV_GLU_LAUNCH(32);
  else
    CONV_GLU_LAUNCH(16);
#undef CONV_GLU_LAUNCH
  RETURN_IF_ERROR(static_cast<int>(cudaGetLastError()));

  const size_t smem3 = static_cast<size_t>(fit[7]);
  if (D <= 256)
    dh0_kernel<2, 8><<<L.parts3, kThreads, smem3, stream>>>(
        x, dab, w[0], wb, dx, p3, in.dh0, N, D, eps);
  else
    dh0_kernel<1, 16><<<L.parts3, kThreads, smem3, stream>>>(
        x, dab, w[0], wb, dx, p3, in.dh0, N, D, eps);
  RETURN_IF_ERROR(static_cast<int>(cudaGetLastError()));

  const int td = (D + 127) / 128;
  const dim3 grid4(td * (D / 64) + td * td, L.splits.count);
  weight_grads_kernel<<<grid4, kThreads, wg_smem(), stream>>>(
      h0b, dab, swb, dy, p4, N, D, L.splits.rows);
  RETURN_IF_ERROR(static_cast<int>(cudaGetLastError()));

  // g: dln1s, dln1b, dw1, db1, dwd, dbd, dln2s, dln2b, dw2, db2
  const int P1 = B * L.tiles1, P2 = B * L.tiles2, P3 = L.parts3,
            P4 = L.splits.count;
  const long long s1 = 4 * D, s2 = static_cast<long long>(K + 2) * D,
                  s3 = 2 * D, s4 = 3LL * D * D;
  const int b1 = block_of(P1), b2 = block_of(P2), b3 = block_of(P3),
            b4 = block_of(P4);
  const Pieces ps{{{p1, s1, P1, b1, 0, D, g[6]},
                   {p1, s1, P1, b1, D, D, g[7]},
                   {p1, s1, P1, b1, 2 * D, D, g[5]},
                   {p1, s1, P1, b1, 3 * D, D, g[9]},
                   {p2, s2, P2, b2, 0, K * D, g[4]},
                   {p2, s2, P2, b2, K * D, 2 * D, g[3]},
                   {p3, s3, P3, b3, 0, D, g[0]},
                   {p3, s3, P3, b3, D, D, g[1]},
                   {p4, s4, P4, b4, 0, 2 * D * D, g[2]},
                   {p4, s4, P4, b4, 2 * D * D, D * D, g[8]}}};
  int total = 0;
  for (const Piece& pc : ps.p) total += pc.width;
  reduce_all_kernel<<<std::min((total + kThreads - 1) / kThreads, 1024),
                      kThreads, 0, stream>>>(ps, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conformer_conv_backward

using conformer_conv_backward::BwdLayout;
using conformer_conv_backward::Layout;

// Launches the backward's kernels on `stream`; returns the first non-zero
// cudaGetLastError() after a launch (0 on success), or -2 where a bf16
// launch's CTA does not fit an SM (the caller asks
// conformer_conv_bwd_resources first). The caller guarantees B, T >= 1, D a
// multiple of 64 from 64 to 512, 1 <= K <= 63, contiguous device buffers:
// x, dy and dx (B, T, D) of one type (bf16 when is_bf16, else fp32); lens
// (B,) int32; the fp32 weights ln1s, ln1b, w1 (D, 2D), b1 (2D,), wd (K, D),
// bd, ln2s, ln2b, w2 (D, D), b2 (D,) and their fp32 gradients of the same
// shapes; a workspace of conformer_conv_bwd_workspace(B, T, D, K, is_bf16,
// tile) bytes; for bf16 `inter`, 12 B T D floats or null, gets the fp32
// intermediates (see Inter), and `tile` picks launches 1 and 2's frames a
// CTA (0: the largest that fits). b2 is not read (its gradient is the sum
// of dy).
extern "C" int conformer_conv_bwd(
    const void* x, const void* dy, const void* lens, const void* ln1s,
    const void* ln1b, const void* w1, const void* b1, const void* wd,
    const void* bd, const void* ln2s, const void* ln2b, const void* w2,
    const void* b2, void* work, void* dx, void* dln1s, void* dln1b,
    void* dw1, void* db1, void* dwd, void* dbd, void* dln2s, void* dln2b,
    void* dw2, void* db2, void* inter, int B, int Tn, int D, int K,
    int is_bf16, int tile, float eps, void* stream) {
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
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return conformer_conv_backward::launch_bf16(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), n, w,
        static_cast<unsigned char*>(work), static_cast<__nv_bfloat16*>(dx),
        g, static_cast<float*>(inter), B, Tn, D, K, tile, eps, s);
  return conformer_conv_backward::launch_fp32(
      static_cast<const float*>(x), static_cast<const float*>(dy), n, w,
      static_cast<float*>(work), static_cast<float*>(dx), g, B, Tn, D, K,
      eps, s);
}

// The workspace conformer_conv_bwd needs, in bytes; -2 where a bf16
// launch's CTA does not fit an SM.
extern "C" long long conformer_conv_bwd_workspace(int B, int Tn, int D,
                                                  int K, int is_bf16,
                                                  int tile) {
  if (!is_bf16)
    return static_cast<long long>(Layout(B, Tn, D, K).end * sizeof(float));
  int fit[12];
  if (conformer_conv_backward::bwd_fit(D, K, tile, fit, false) != 0 ||
      fit[2] == 0 || fit[5] == 0 || fit[8] == 0 || fit[11] == 0)
    return -2;
  return static_cast<long long>(
      BwdLayout(B, Tn, D, K, fit[0], fit[3], fit[6]).end);
}

// The bf16 launches' resources at (D, K) and `tile`, nothing launched: out
// = 4 x [frames (launches 1, 2; 0 where none fits), rows (3) or columns
// (4) a CTA; dynamic shared memory in bytes; CTAs an SM (0 where it does
// not fit)]. Returns a CUDA error, 0 on success.
extern "C" int conformer_conv_bwd_resources(int D, int K, int tile,
                                            int* out) {
  return conformer_conv_backward::bwd_fit(D, K, tile, out, true);
}
