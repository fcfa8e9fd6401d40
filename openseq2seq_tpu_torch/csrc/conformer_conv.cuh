// Shared by the Conformer convolution module's forward and backward
// kernels (conformer_conv_fwd.cu, conformer_conv_bwd.cu).
//
// The fp32 kernels (the products on the CUDA cores): tile constants, the
// layer norm of a row, and the 64 x 64 output tile of a product over a
// 32-row weight chunk.
//
// The bf16 kernels (every product on the tensor cores through mma.sync,
// bf16 operands, fp32 accumulation): the weights rounded to bf16 once a
// call (round_weights); their 64 x 64 chunks streamed through
// flash_relpos.cuh's ring of cp.async slots; and the "front half" that the
// forward and the backward's first launches share, for a CTA that owns TM
// frames of one batch row: LN1 of the frames and of their (k - 1) / 2 halo
// on each side into a bf16 tile, then for each pass of 64 channels pw1's
// value and gate columns, the GLU and the mask (u in fp32 in shared
// memory, never rounded) and the depthwise taps into an fp32 c tile, then
// LN2 and the swish. A halo frame's h0, a and u come from the same code in
// the same order as in the CTA that owns the frame, so they are the same
// bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <initializer_list>

#include "flash_relpos.cuh"
#include "mma_sync.cuh"

namespace conformer_conv {

using namespace mma_sync;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;       // rows (frames) per CTA of the fp32 kernels
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 32;         // weight rows staged at once (fp32)
constexpr int kWC = 64;         // weight columns staged at once (fp32)
constexpr int kCC = 64;         // depthwise channels per pass
constexpr int kUS = kCC + 4;    // u (and dc) tile row stride (floats)
constexpr int kMaxCols = 512 / 32;   // D / 32 columns a lane at most

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- the fp32 kernels ------------------------------------------------------

// The layer norm of one row of `row` (D floats in shared memory), in
// place, by one warp: fast variance, eps; with `swish` n sigmoid(n).
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
    row[c] = n;
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

// ---- the bf16 kernels ------------------------------------------------------

using flash_relpos::Chunk;
using flash_relpos::kCS;        // a slot's row stride (bf16)
using flash_relpos::kSlot;      // a slot's elements: 64 x kCS
// the weight ring: a pass reads its chunks two at a time (the 128 columns
// of a 64-deep step), so a slot must outlive the next acquire (KEEP 1)
constexpr int kRing = 4, kAhead = 2;
// the front-half kernels' CTA: 16 warps in a grid of 4 rows by 4 columns;
// the phases between the products (the layer norms, the GLU, the taps)
// are latency-bound, and 16 warps keep twice as many in flight as 8
constexpr int kFrontThreads = 512, kWarpRows = 4;

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// w1 and w2 rounded to bf16, once a call (wb: 3 D^2 elements): w1 with
// each channel's value and gate columns side by side (column 2c is w1's
// column c, 2c + 1 its column D + c), so that a thread's accumulator pair
// holds both; then w2 as it is
__device__ __forceinline__ void round_weights(const float* __restrict__ w1,
                                              const float* __restrict__ w2,
                                              bf16* __restrict__ wb, int D) {
  const int n1 = 2 * D * D, n = 3 * D * D;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float v;
    if (i < n1) {
      const int k = i / (2 * D), c = i % (2 * D);
      v = w1[static_cast<size_t>(k) * 2 * D + (c & 1) * D + (c >> 1)];
    } else {
      v = w2[i - n1];
    }
    wb[i] = __float2bfloat16(v);
  }
}

// The chunks (64 x 64 bf16) that the front half and the product after it
// read, in order. pw1: for each pass p of 64 channels, for each 64 rows kc
// of w1, the pass's 128 interleaved columns in two halves. Then the second
// product, for each pass q of 128 output columns, each 64-deep step kc,
// both halves: w2's rows kc (k) by columns 128 q + 64 h (kNK false: pw2,
// y = sw w2), or w2's rows 128 q + 64 h (n) by columns kc (kNK: ds = dy
// w2^T). A half past D is a zero chunk.
template <bool kNK>
struct FrontChunks {
  const bf16* w1;                // the interleaved w1, D x 2D
  const bf16* w2;                // D x D
  int D;

  __host__ __device__ int pw1_chunks() const {
    return 2 * (D / 64) * (D / 64);
  }
  __host__ __device__ int total() const {
    return pw1_chunks() + 2 * (D / 64) * ((D + 127) / 128);
  }
  __device__ Chunk operator()(int i) const {
    const int steps = D / 64;
    if (i < pw1_chunks()) {
      const int h = i & 1, kc = (i >> 1) % steps, p = (i >> 1) / steps;
      return {w1 + static_cast<size_t>(64 * kc) * 2 * D + 128 * p + 64 * h,
              2 * D, 64, 64};
    }
    i -= pw1_chunks();
    const int h = i & 1, kc = (i >> 1) % steps, q = (i >> 1) / steps;
    const int n0 = 128 * q + 64 * h;
    if (n0 >= D) return {w2, D, 64, 0};
    if (kNK) return {w2 + static_cast<size_t>(n0) * D + 64 * kc, D, 64, 64};
    return {w2 + static_cast<size_t>(64 * kc) * D + n0, D, 64, 64};
  }
};

// acc[m][n] += the rows 16 (wr + 4 m) .. + 15 of the bf16 tile a (row
// stride sa), columns a_k0 .. a_k0 + 63, times the 64 x 128 B of a slot
// pair (s0 its columns 0 .. 63, s1 64 .. 127; stored [n][k] with kNK, else
// [k][n]): warp (wr, wc) of the 4 x 4 grid takes columns 32 wc .. + 31
// (n-tiles n = 0 .. 3) and the m-tiles wr + 4 m below mtiles
template <bool kNK, int MT>
__device__ __forceinline__ void product_pair(float (&acc)[MT][4][4],
                                             const bf16* a, int sa, int a_k0,
                                             int mtiles, const bf16* s0,
                                             const bf16* s1, int wr, int wc) {
  const bf16* s = wc < 2 ? s0 : s1;
  const int n0 = (wc & 1) * 32;
#pragma unroll
  for (int ks = 0; ks < 64; ks += 16) {
    unsigned b[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (kNK)
        b_frag_nk(b[h], s, kCS, n0 + 16 * h, ks);
      else
        b_frag_kn(b[h], s, kCS, ks, n0 + 16 * h);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int mt = wr + kWarpRows * m;
      if (mt < mtiles) {
        unsigned af[4];
        a_frag(af, a, sa, 16 * mt, a_k0 + ks);
        mma_bf16(acc[m][0], af, b[0][0], b[0][1]);
        mma_bf16(acc[m][1], af, b[0][2], b[0][3]);
        mma_bf16(acc[m][2], af, b[1][0], b[1][1]);
        mma_bf16(acc[m][3], af, b[1][2], b[1][3]);
      }
    }
  }
}

// acc = the tile a (mtiles m-tiles, D columns) times the next D / 64 slot
// pairs of the ring: one pass of 128 columns
template <bool kNK, int MT, class Ring>
__device__ __forceinline__ void pass_product(float (&acc)[MT][4][4],
                                             Ring& ring, const bf16* a,
                                             int sa, int mtiles, int D,
                                             int wr, int wc) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  for (int kc = 0; kc < D; kc += 64) {
    const bf16* s0 = ring.acquire();
    const bf16* s1 = ring.acquire();
    product_pair<kNK, MT>(acc, a, sa, kc, mtiles, s0, s1, wr, wc);
  }
}

// The front half's shared memory, in bytes from a 16-byte aligned base:
// the ring; h, the LN1 tile (R rows: the TM frames with their halo, rounded
// up to 16; bf16, row stride sa); c (TM rows, fp32, row stride sc); the u
// tile (RU rows of kCC channels, fp32: room for the taps' register window,
// see `taps`). Tile row r is frame t_own - P + r.
struct FrontLayout {
  int R, RU, sa, sc;
  size_t h, c, u, end;
  __host__ __device__ FrontLayout(int TM, int D, int K) {
    R = round16(TM + K - 1);
    RU = TM + round16(K);
    sa = D + 8;
    sc = D + 8;
    h = sizeof(bf16) * kRing * kSlot;
    c = h + sizeof(bf16) * static_cast<size_t>(R) * sa;
    u = c + sizeof(float) * static_cast<size_t>(TM) * sc;
    end = u + sizeof(float) * static_cast<size_t>(RU) * kUS;
  }
};

// starts copying rows t0 .. t0 + R - 1 of a (T, D) bf16 matrix of one
// batch row into the tile h (row stride sh), 16 bytes a copy, one commit
// group; rows outside [0, T) are zero-filled
__device__ __forceinline__ void stage_rows(bf16* h, int sh, const bf16* src,
                                           int t0, int R, int Tn, int D) {
  for (int i = threadIdx.x; i < R * (D / 8); i += blockDim.x) {
    const int r = i / (D / 8), c = i % (D / 8) * 8, t = t0 + r;
    const bool live = t >= 0 && t < Tn;
    cp_async16(h + r * sh + c, src + static_cast<size_t>(live ? t : 0) * D + c,
               live ? 16 : 0);
  }
  cp_async_commit();
}

// LN1, in place, of the tile h of rows t0 .. t0 + R - 1 of one batch row's
// x (bf16, row stride sh, staged by stage_rows), one warp a row, rounded
// to bf16; rows outside [0, T) stay zero. The tile rows own .. own + TM -
// 1 also go out, where not null: h_g (bf16) and h_f (fp32), both (T, D)
// of the batch row.
__device__ __forceinline__ void ln1_rows(bf16* h, int sh, int t0, int R,
                                         int own, int TM, int Tn, int D,
                                         const float* s, const float* bias,
                                         float eps, bf16* h_g, float* h_f) {
  const int lane = threadIdx.x & 31;
  // the lane's columns are the same in every row: their scale and bias
  // once, ahead of the rows' stores
  float sv[kMaxCols], bv[kMaxCols];
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i)
    if (i < D / 32) {
      sv[i] = __ldg(s + lane + 32 * i);
      bv[i] = __ldg(bias + lane + 32 * i);
    }
  for (int r = threadIdx.x >> 5; r < R; r += blockDim.x >> 5) {
    const int t = t0 + r;
    bf16* row = h + r * sh;
    if (t < 0 || t >= Tn) continue;
    float v[kMaxCols];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i)
      if (i < D / 32) {
        v[i] = __bfloat162float(row[lane + 32 * i]);
        sum += v[i];
        sq = fmaf(v[i], v[i], sq);
      }
    const float mu = warp_sum(sum) / D;
    const float rstd = rsqrtf(warp_sum(sq) / D - mu * mu + eps);
    const bool out = r >= own && r < own + TM;
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i)
      if (i < D / 32) {
        const int c = lane + 32 * i;
        const float hv = fmaf((v[i] - mu) * rstd, sv[i], bv[i]);
        const bf16 hb = __float2bfloat16(hv);
        row[c] = hb;
        if (out) {
          const size_t at = static_cast<size_t>(t) * D + c;
          if (h_g != nullptr) h_g[at] = hb;
          if (h_f != nullptr) h_f[at] = hv;
        }
      }
  }
}

// pw1's epilogue for pass p (channels 64 p ..): + b1, the GLU and the mask
// (u = 0 outside frames [0, live_end)), u into the u tile. For the rows
// own .. own + TM - 1 of frames below T, where not null: a (fp32, natural
// layout, (T, 2D) of the batch row), u ((T, D)), and p and sigmoid(q)
// into ps and sqs (TM rows of kUS, row r - own).
template <int MT>
__device__ __forceinline__ void glu_epilogue(
    const float (&acc)[MT][4][4], int p, int mtiles, const float* b1, int D,
    int t0, int live_end, float* us, int own, int TM, int Tn, float* a_g,
    float* u_g, float* ps, float* sqs, int wr, int wc) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float bp[4], bq[4];                    // the biases, ahead of the stores
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    bp[n] = __ldg(b1 + 64 * p + 16 * wc + 4 * n + t4);
    bq[n] = __ldg(b1 + D + 64 * p + 16 * wc + 4 * n + t4);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int mt = wr + kWarpRows * m;
    if (mt >= mtiles) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int ch = 16 * wc + 4 * n + t4, j = 64 * p + ch;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 16 * mt + g + 8 * e, t = t0 + r;
        const float pv = acc[m][n][2 * e] + bp[n];
        const float qv = acc[m][n][2 * e + 1] + bq[n];
        const float sq = sigmoid(qv);
        const float u = t >= 0 && t < live_end ? pv * sq : 0.f;
        us[r * kUS + ch] = u;
        if (r >= own && r < own + TM && t < Tn) {
          if (a_g != nullptr) {
            a_g[static_cast<size_t>(t) * 2 * D + j] = pv;
            a_g[static_cast<size_t>(t) * 2 * D + D + j] = qv;
          }
          if (u_g != nullptr) u_g[static_cast<size_t>(t) * D + j] = u;
          if (ps != nullptr) {
            ps[(r - own) * kUS + ch] = pv;
            sqs[(r - own) * kUS + ch] = sq;
          }
        }
      }
    }
  }
}

// acc[i] = sum over j = 0 .. K - 1, in that order, of w(j) v[(r0 + i + j)
// kUS], i < RB: v a column of a tile of kUS-float rows, w(j) = wcol[j D]
// (with kReverse wcol[(K - 1 - j) D]). The tile's rows are read through a
// window of 2 RB registers, RB at a time, so the tile must hold rows to
// r0 + round_up(K, RB) + RB - 1; those past r0 + RB + K - 2 are read, not
// used.
template <int RB, bool kReverse>
__device__ __forceinline__ void taps(float (&acc)[RB], const float* v,
                                     int r0, const float* wcol, int D,
                                     int K) {
  float lo[RB], hi[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    acc[i] = 0.f;
    lo[i] = v[(r0 + i) * kUS];
  }
  for (int jb = 0; jb < K; jb += RB) {
    // the block's taps first, all loads in flight at once (a tap past K
    // loads tap K - 1, unused)
    float w[RB];
#pragma unroll
    for (int jj = 0; jj < RB; ++jj) {
      const int j = min(jb + jj, K - 1);
      w[jj] = __ldg(wcol + static_cast<size_t>(kReverse ? K - 1 - j : j) *
                               D);
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) hi[i] = v[(r0 + jb + RB + i) * kUS];
#pragma unroll
    for (int jj = 0; jj < RB; ++jj) {
      if (jb + jj < K) {
#pragma unroll
        for (int i = 0; i < RB; ++i)
          acc[i] = fmaf(w[jj], i + jj < RB ? lo[i + jj] : hi[i + jj - RB],
                        acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) lo[i] = hi[i];
  }
}

// the depthwise taps of pass p + bd into c: thread (ch = tid % 64, group
// tid / 64 of 8) computes the output rows group * TM / 8 .. + TM / 8 - 1,
// row i from u tile rows i .. i + K - 1
template <int TM>
__device__ __forceinline__ void taps_pass(const float* us, float* cs, int sc,
                                          int p, const float* wd,
                                          const float* bd, int D, int K) {
  constexpr int RB = TM * kCC / kFrontThreads;
  const int ch = threadIdx.x % kCC, r0 = threadIdx.x / kCC * RB;
  const int j = 64 * p + ch;
  float acc[RB];
  taps<RB, false>(acc, us + ch, r0, wd + j, D, K);
  const float bias = bd[j];
#pragma unroll
  for (int i = 0; i < RB; ++i) cs[(r0 + i) * sc + j] = acc[i] + bias;
}

// LN2 and the swish of the TM rows of c, one warp a row: c becomes xh, the
// normalised row (fp32); sw = n sigmoid(n), n = xh ln2s + ln2b, goes to
// sw_s (bf16, row stride ssw) where not null. For frames below T, where
// not null: c_f (the fp32 c), sw_g (bf16) and sw_f (fp32), (T, D) of the
// batch row; rstd_s[r] gets the row's rstd.
__device__ __forceinline__ void ln2_rows(float* cs, int sc, int TM, int t_own,
                                         int Tn, int D, const float* s,
                                         const float* bias, float eps,
                                         bf16* sw_s, int ssw, float* c_f,
                                         bf16* sw_g, float* sw_f,
                                         float* rstd_s) {
  const int lane = threadIdx.x & 31;
  float sv[kMaxCols], bv[kMaxCols];      // as in ln1_rows
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i)
    if (i < D / 32) {
      sv[i] = __ldg(s + lane + 32 * i);
      bv[i] = __ldg(bias + lane + 32 * i);
    }
  for (int r = threadIdx.x >> 5; r < TM; r += blockDim.x >> 5) {
    float* row = cs + r * sc;
    const int t = t_own + r;
    float v[kMaxCols];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i)
      if (i < D / 32) {
        v[i] = row[lane + 32 * i];
        sum += v[i];
        sq = fmaf(v[i], v[i], sq);
      }
    const float mu = warp_sum(sum) / D;
    const float rstd = rsqrtf(warp_sum(sq) / D - mu * mu + eps);
    if (rstd_s != nullptr && lane == 0) rstd_s[r] = rstd;
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i)
      if (i < D / 32) {
        const int c = lane + 32 * i;
        const float xh = (v[i] - mu) * rstd;
        const float n = fmaf(xh, sv[i], bv[i]);
        const float sw = n * sigmoid(n);
        row[c] = xh;
        if (sw_s != nullptr) sw_s[r * ssw + c] = __float2bfloat16(sw);
        if (t < Tn) {
          const size_t at = static_cast<size_t>(t) * D + c;
          if (c_f != nullptr) c_f[at] = v[i];
          if (sw_g != nullptr) sw_g[at] = __float2bfloat16(sw);
          if (sw_f != nullptr) sw_f[at] = sw;
        }
      }
  }
}

// the front half's m-tiles a warp row holds at most: R <= TM + 64 rows
template <int TM>
__host__ __device__ constexpr int front_mt() {
  return (TM + 64 + 16 * kWarpRows - 1) / (16 * kWarpRows);
}

// Steps 1 and 2 of the front half for the CTA of frames t_own .. t_own +
// TM - 1 of one batch row: LN1 of the tile rows (h0 out where h_g / h_f
// are not null), then each pass of 64 channels: pw1 from the ring, the GLU
// epilogue (a out where a_g is not null, u where u_g is), the taps into c.
// Ends after a barrier, c complete, h and the u tile free.
template <int TM, class Ring>
__device__ __forceinline__ void front_half(
    Ring& ring, const FrontLayout& L, bf16* hs, float* cs, float* us,
    const bf16* xb, int t_own, int live_end, int Tn, int D, int K,
    const float* ln1s, const float* ln1b, const float* b1, const float* wd,
    const float* bd, float eps, bf16* h_g, float* h_f, float* a_g,
    float* u_g) {
  constexpr int MT = front_mt<TM>();
  const int P = (K - 1) / 2, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  stage_rows(hs, L.sa, xb, t_own - P, L.R, Tn, D);
  cp_async_wait<0>();
  __syncthreads();
  ln1_rows(hs, L.sa, t_own - P, L.R, P, TM, Tn, D, ln1s, ln1b, eps, h_g,
           h_f);
  __syncthreads();
  for (int p = 0; p < D / 64; ++p) {
    float acc[MT][4][4];
    pass_product<false, MT>(acc, ring, hs, L.sa, L.R / 16, D, wr, wc);
    glu_epilogue<MT>(acc, p, L.R / 16, b1, D, t_own - P, live_end, us, P,
                     TM, Tn, a_g, u_g, nullptr, nullptr, wr, wc);
    __syncthreads();
    taps_pass<TM>(us, cs, L.sc, p, wd, bd, D, K);
  }
  __syncthreads();
}

// the frames a front-half CTA owns: the largest of 64, 32, 16 whose
// shared memory `smem(tile)` fits `limit` (large D and k take the smaller
// tiles), or `tile` if not 0 and it fits; 0 where none does
template <class Smem>
int plan_tile(int tile, size_t limit, Smem smem) {
  for (int tm : {64, 32, 16})
    if ((tile == 0 || tile == tm) && smem(tm) <= limit) return tm;
  return 0;
}

// the dynamic shared memory a block may opt in to on the current device
inline size_t smem_limit() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<size_t>(v);
}

// sets a kernel's dynamic shared memory and reports [smem, CTAs an SM]
// into out for CTAs of `threads`: 0 CTAs where it does not fit; without
// `count` (a launch) 1 where it fits, the occupancy not asked for
template <class Kernel>
int kernel_fit(Kernel kernel, size_t smem, int threads, int* out,
               bool count) {
  out[0] = static_cast<int>(smem);
  out[1] = 0;
  if (smem > smem_limit()) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = 1;
  if (!count) return 0;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], kernel, threads, smem));
}

}  // namespace conformer_conv
