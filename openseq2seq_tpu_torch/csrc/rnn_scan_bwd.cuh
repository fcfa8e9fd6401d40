// The persistent reverse-time scan shared by the GRU and LSTM backward
// kernels (gru_scan_bwd.cu, lstm_scan_bwd.cu): one cooperative launch
// walks all T steps of one direction of one layer backward, on the
// machinery of rnn_scan.cuh (grid barrier, cp.async, occupancy check).
//
// Layout. A step's recurrent cotangent is dh_prev = carry + dg W_h^T,
// where dg (B, G*H) is the step's gate cotangent rounded to the compute
// type (the GRU's dhp, the LSTM's dgates) and W_h is (H, G*H). CTA j owns
// U consecutive hidden units (the grid is H / U CTAs, 128 by default)
// and so the U rows of W_h that its units' dh_prev needs: G*H values
// each, widened to fp32 and kept in shared memory for all T steps,
// transposed to (G*H, U) (3072 x 8 x 4 B = 96 KiB for the GRU at H =
// 1024). Each (row, unit) pair's carries stay in the CTA that owns them
// (an fp32 (B, H) buffer that only that thread touches), so only dg is
// exchanged between CTAs.
//
// Each step k (the forward's steps in reverse order), for each tile of 32
// batch rows:
//  1. after a grid-wide barrier, every CTA streams step k's dg rows (all
//     G*H columns, written by all CTAs) from L2 with cp.async.cg through
//     shared memory, 256-byte column chunks four stages deep; lane b of
//     warp w accumulates row b's U products over warp w's eighth of each
//     chunk in fp32 registers, and the eight warps' sums meet in shared
//     memory in a fixed order (no atomics: two calls give the same bits);
//  2. one thread per (row, unit) pair adds the product to its carry, then
//     runs the cell's step k + 1 (its residuals read before the products,
//     so their latency hides behind them): the gate cotangents, written to
//     dx in the compute type and, rounded the same way, as step k + 1's
//     dg, and the carries without the product.
// Step 0's cell math runs before the loop; after the last step each pair
// writes dh0 in the compute type. T barriers in all.
//
// Time. The forward's step s handles t = s, or t = T - 1 - s for a
// reverse cell; backward step k is forward step T - 1 - k, so t walks
// down for a forward cell and up for a reverse one. The state before t
// in the forward's order is at t_prev = t - 1 (t + 1 for a reverse cell)
// when 0 <= t_prev < T and t_prev < length, and the initial state
// otherwise: the forward's ys and the kernels' masks are zero there, not
// the carried state. Past its length a row's step is dead: its cotangent
// from ys is dropped (ys is the constant 0 there) and its carry passes
// through unchanged.
#pragma once

#include "rnn_scan.cuh"

namespace rnn_scan {

struct BwdParams {
  const void* wh;         // (H, G*H) compute type
  const void* acts;       // (B, T, G*H) compute type: saved gate values
  const void* aux;        // (B, T, H): GRU hn (compute type), LSTM cs (fp32)
  const void* prev;       // (B, T, H): GRU ys (compute type), LSTM cs
  const void* init;       // (B, H): GRU h0 (compute type), LSTM c0 (fp32)
  const int* lens;        // (B,)
  const void* dys;        // (B, T, H) compute type
  float* hcarry;          // (B, H) fp32: dh_last in; carries without dg W_h^T
  float* ccarry;          // (B, H) fp32: dc_last in, dc0 out; or null
  void* dx;               // (B, T, G*H) compute type out: the gate cotangents
  void* xbuf;             // (2, B, G*H) compute type: dg when it is not dx
  void* dh0;              // (B, H) compute type out
  unsigned int* barrier;  // one counter, zero at launch
  int B, T, H, reverse;
};

template <int U>
__host__ __device__ constexpr int padded_units() { return (U + 3) / 4 * 4; }

template <int G, int U>
size_t bwd_smem_bytes(int H) {
  constexpr int UP = padded_units<U>();
  const size_t red = sizeof(float) * kWarps * UP * kRows;
  const size_t stages = static_cast<size_t>(kStages) * kStageBytes;
  return sizeof(float) * static_cast<size_t>(G) * H * UP +
         (red > stages ? red : stages);
}

__device__ __forceinline__ int bwd_time(const BwdParams& p, int k) {
  return p.reverse ? k : p.T - 1 - k;
}

// whether the state before t (in the forward's order) is seq[t_prev]
__device__ __forceinline__ bool has_prev(const BwdParams& p, int t, int len,
                                         int* t_prev) {
  *t_prev = p.reverse ? t + 1 : t - 1;
  return *t_prev >= 0 && *t_prev < p.T && *t_prev < len;
}

// Cell::kRes residual values per (row, unit) and step;
// Cell::load<E>(p, b, t, col, len, res) reads them;
// Cell::step<E>(p, b, t, col, live, carry, res, dg) runs the step's
// cotangent math from the carry (dh_prev of the step after, product
// included), writes dx (and dg when it is not dx) and the new carries.
template <typename E, int G, int U, class Cell>
__global__ void __launch_bounds__(kThreads, 1)
scan_bwd_kernel(const BwdParams p) {
  constexpr int UP = padded_units<U>();
  constexpr int VE = 16 / sizeof(E);            // dg values per 16 bytes
  constexpr int KC = kChunkBytes / sizeof(E);   // dg columns per chunk
  constexpr int KW = KC / kWarps;               // of them per warp
  constexpr int kPairs = (kRows * U + kThreads - 1) / kThreads;
  constexpr int R = Cell::kRes;
  static_assert(KW % VE == 0, "a warp's share is whole 16-byte reads");

  extern __shared__ float4 smem4[];
  const int H = p.H, GH = G * H, B = p.B, T = p.T;
  float* ws = reinterpret_cast<float*>(smem4);                 // GH x UP
  char* scratch = reinterpret_cast<char*>(ws + static_cast<size_t>(GH) * UP);
  const int unit0 = blockIdx.x * U;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const E* wh = static_cast<const E*>(p.wh);
  E* dx = static_cast<E*>(p.dx);
  E* xbuf = static_cast<E*>(p.xbuf);

  // this CTA's rows of W_h, transposed, zero-padded to UP columns
  for (int i = tid; i < UP * GH; i += kThreads) {
    const int u = i / GH, k = i - u * GH;
    ws[static_cast<size_t>(k) * UP + u] =
        u < U ? to_f(wh[static_cast<size_t>(unit0 + u) * GH + k]) : 0.f;
  }
  __syncthreads();

  const int nch = GH / KC;
  const int tiles = (B + kRows - 1) / kRows;
  constexpr int kSegs = kChunkBytes / 16;
  // step k's dg: the exchange buffer's half k & 1 (rows GH apart), or dx
  // at time t (rows T * GH apart)
  auto dg_dst = [&](int k) -> E* {
    return xbuf != nullptr ? xbuf + static_cast<size_t>(k & 1) * B * GH
                           : nullptr;
  };

  // step 0's cell math, from dh_last (and dc_last) in the carries
  {
    const int t = bwd_time(p, 0);
    for (int tile = 0; tile < tiles; ++tile) {
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int pair = tid + q * kThreads;
        const int b = tile * kRows + pair / U, col = unit0 + pair % U;
        if (pair < kRows * U && b < B) {
          const int len = __ldg(p.lens + b);
          float res[R];
          Cell::template load<E>(p, b, t, col, len, res);
          Cell::template step<E>(p, b, t, col, t < len,
                                 p.hcarry[static_cast<size_t>(b) * H + col],
                                 res, dg_dst(0));
        }
      }
    }
  }

  for (int k = 0; k < T; ++k) {
    grid_sync(p.barrier, gridDim.x * (k + 1u));
    const int t = bwd_time(p, k);
    const bool more = k + 1 < T;
    const int tn = more ? bwd_time(p, k + 1) : 0;
    const E* src;
    size_t row_stride;
    if (xbuf != nullptr) {
      src = xbuf + static_cast<size_t>(k & 1) * B * GH;
      row_stride = GH;
    } else {
      src = dx + static_cast<size_t>(t) * GH;
      row_stride = static_cast<size_t>(T) * GH;
    }
    for (int tile = 0; tile < tiles; ++tile) {
      const int b0 = tile * kRows;
      float res[kPairs][R];
      int lens[kPairs];
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int pair = tid + q * kThreads;
        const int b = b0 + pair / U, col = unit0 + pair % U;
        lens[q] = 0;
        if (more && pair < kRows * U && b < B) {
          lens[q] = __ldg(p.lens + b);
          Cell::template load<E>(p, b, tn, col, lens[q], res[q]);
        }
      }

      auto issue = [&](int c) {
        char* stage = scratch + (c % kStages) * kStageBytes;
        for (int i = tid; i < kRows * kSegs; i += kThreads) {
          const int row = i / kSegs, seg = i - row * kSegs;
          const int b = min(b0 + row, B - 1);
          const char* g = reinterpret_cast<const char*>(
              src + b * row_stride + c * KC) + seg * 16;
          cp_async16(stage + row * kRowStride + seg * 16, g,
                     b0 + row < B ? 16 : 0);     // zeros past the batch
        }
      };

      float acc[UP];
#pragma unroll
      for (int u = 0; u < UP; ++u) acc[u] = 0.f;
#pragma unroll
      for (int c = 0; c < kStages - 1; ++c) {
        if (c < nch) issue(c);
        cp_async_commit();
      }
      for (int c = 0; c < nch; ++c) {
        if (c + kStages - 1 < nch) issue(c + kStages - 1);
        cp_async_commit();
        cp_async_wait<kStages - 1>();
        __syncthreads();
        const char* row = scratch + (c % kStages) * kStageBytes +
                          lane * kRowStride + warp * KW * sizeof(E);
#pragma unroll
        for (int v = 0; v < KW / VE; ++v) {
          float gv[VE];
          unpack16(reinterpret_cast<const E*>(row + v * 16), gv);
          const int k0 = c * KC + warp * KW + v * VE;
#pragma unroll
          for (int e = 0; e < VE; ++e) {
            const float4* w = reinterpret_cast<const float4*>(
                ws + static_cast<size_t>(k0 + e) * UP);
#pragma unroll
            for (int q = 0; q < UP / 4; ++q) {
              const float4 w4 = w[q];
              acc[4 * q] = fmaf(gv[e], w4.x, acc[4 * q]);
              acc[4 * q + 1] = fmaf(gv[e], w4.y, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(gv[e], w4.z, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(gv[e], w4.w, acc[4 * q + 3]);
            }
          }
        }
        __syncthreads();
      }

      // the warps' partial sums, then the cells; the stages are free now
      float* red = reinterpret_cast<float*>(scratch);
#pragma unroll
      for (int u = 0; u < U; ++u)
        red[(warp * UP + u) * kRows + lane] = acc[u];
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int pair = tid + q * kThreads;
        const int bl = pair / U, u = pair % U, b = b0 + bl;
        if (pair < kRows * U && b < B) {
          float prod = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            prod += red[(w * UP + u) * kRows + bl];
          const size_t i = static_cast<size_t>(b) * H + unit0 + u;
          const float carry = p.hcarry[i] + prod;
          if (more)
            Cell::template step<E>(p, b, tn, unit0 + u, tn < lens[q], carry,
                                   res[q], dg_dst(k + 1));
          else
            static_cast<E*>(p.dh0)[i] = from_f<E>(carry);
        }
      }
      __syncthreads();          // before the next tile reuses the scratch
    }
  }
}

template <typename E, int G, class Cell>
struct BwdLaunch {
  template <int U>
  static int run(const BwdParams& p, cudaStream_t stream) {
    return launch_cooperative(scan_bwd_kernel<E, G, U, Cell>,
                              bwd_smem_bytes<G, U>(p.H), p.H / U, p, stream);
  }
};

template <typename E, int G, class Cell>
int dispatch_bwd_units(const BwdParams& p, int units, cudaStream_t stream) {
  return for_units<BwdLaunch<E, G, Cell>>(units, p, stream);
}

}  // namespace rnn_scan
