// The persistent reverse-time scan shared by the GRU and LSTM backward
// kernels (gru_scan_bwd.cu, lstm_scan_bwd.cu): one cooperative launch
// walks all T steps of one direction of one layer backward, on the
// machinery of rnn_scan.cuh (grid barrier, cp.async, clusters and bulk
// copies, occupancy check).
//
// Layout. A step's recurrent cotangent is dh_prev = carry + dg W_h^T,
// where dg (B, G*H) is the step's gate cotangent rounded to the compute
// type (the GRU's dhp, the LSTM's dgates) and W_h is (H, G*H). CTA j owns
// U consecutive hidden units (the grid is H / U CTAs, 128 by default)
// and so the U rows of W_h that its units' dh_prev needs: G*H values
// each, kept on chip for all T steps (fp32: widened and transposed to
// (G*H, U) in shared memory, 3072 x 8 x 4 B = 96 KiB for the GRU at H =
// 1024; bf16: in registers). Each (row, unit) pair's carries stay in the
// CTA that owns them
// (an fp32 (B, H) buffer that only that thread touches), so only dg is
// exchanged between CTAs.
//
// Each step k (the forward's steps in reverse order), for each tile of 32
// batch rows:
//  1. after a grid-wide barrier, every CTA reads step k's dg rows (all
//     G*H columns, written by all CTAs) from L2 and forms its units'
//     products. fp32 (scan_bwd_kernel, on the CUDA cores): the rows
//     stream through shared memory with cp.async.cg in 256-byte column
//     chunks four stages deep, a CTA barrier each; lane b of warp w
//     accumulates row b's U products over warp w's eighth of each chunk
//     in fp32 registers. bf16 (scan_bwd_mma_kernel, below): W_h stays in
//     registers as mma.sync fragments, each warp stages its own slice of
//     the columns, and clusters of two CTAs share each row's L2 read. In
//     both the eight warps' sums meet in shared memory in a fixed order
//     (no atomics: two calls give the same bits);
//  2. one thread per (row, unit) pair adds the product to its carry, then
//     runs the cell's step k + 1 (its residuals read before the products,
//     so their latency hides behind them): the gate cotangents, written to
//     dx in the compute type and, rounded the same way, as step k + 1's
//     dg, and the carries without the product; where asked for, the carry
//     into each step (``carries``, and the LSTM's ``ccarries``), which the
//     per-element checks of ops/scan_bounds.py recompute each step from.
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
  float* carries;         // (B, T, H) fp32 out: dh carried into each step
  float* ccarries;        // (B, T, H) fp32 out: the LSTM's dc likewise
  unsigned int* barrier;  // one counter, zero at launch
  int* query;             // or: (smem bytes, CTAs an SM) out, no launch
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

// step 0's cell math of this CTA's units, from dh_last (and dc_last) in
// the carries; dg goes to dg0 (or dx when it is null)
template <typename E, int U, class Cell>
__device__ __forceinline__ void bwd_first_step(const BwdParams& p, int unit0,
                                               E* dg0) {
  constexpr int kPairs = (kRows * U + kThreads - 1) / kThreads;
  const int t = bwd_time(p, 0);
  for (int tile = 0; tile < (p.B + kRows - 1) / kRows; ++tile) {
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const int pair = threadIdx.x + q * kThreads;
      const int b = tile * kRows + pair / U, col = unit0 + pair % U;
      if (pair < kRows * U && b < p.B) {
        const int len = __ldg(p.lens + b);
        float res[Cell::kRes];
        Cell::template load<E>(p, b, t, col, len, res);
        Cell::template step<E>(p, b, t, col, t < len,
                               p.hcarry[static_cast<size_t>(b) * p.H + col],
                               res, dg0);
      }
    }
  }
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

  bwd_first_step<E, U, Cell>(p, unit0, dg_dst(0));

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

// The bf16 design on the tensor cores. The grid and the ownership are the
// CUDA-core kernel's: CTA j owns U units, their rows of W_h and their
// carries, and only dg crosses CTAs. What differs is the product and how
// dg reaches it:
//  - warp w owns the K-slice [w G U 16, (w + 1) G U 16) of the G H columns
//    (G U k16 steps; the slices tile G H since H = 128 U) and keeps its
//    units' rows of W_h over that slice in registers, in bf16, as the B
//    fragments of mma.sync m16n8k16 for all T steps (G U 2 registers an
//    n8 tile of units: 48 for the GRU at U = 8, 32 for the LSTM at U = 4,
//    padded to n8 with zeros);
//  - the CTAs run in clusters of two, which need the same dg rows: each
//    step, CTA r of a cluster loads rows [16 r, 16 r + 16) of each warp's
//    slice of the tile's 32 dg rows, one copy a row, and multicasts them
//    to both CTAs' shared memories (cp.async.bulk ... multicast::cluster,
//    completing on an mbarrier of each warp), so that L2 serves each dg
//    byte to 64 SMs, not 128; a warp waits on its own mbarriers (no CTA
//    barrier: no warp reads another's slice) and runs (32 x 16) . (16 x 8)
//    products on ldmatrix A fragments, exact products of bf16 summed in
//    fp32 as the CUDA-core kernel's;
//  - a warp's slice lands in windows of at most kMaxWindow k16 steps, one
//    window where the whole slice fits (G U <= 25: the GRU up to H =
//    1024, the LSTM up to H = 768), each in one to three column parts
//    whose products start as the part lands; between two windows a
//    cluster barrier keeps a CTA from writing into a peer's window that
//    the peer still reads, as the grid barrier between steps and a
//    cluster barrier between tiles do;
//  - the eight warps' (32 x 8) partial tiles meet in shared memory and
//    are added in a fixed order (no atomics: two calls give the same
//    bits), and one CTA barrier later the cells run as in the CUDA-core
//    kernel, their residuals read before the products.
// Three CTA barriers a step in all (two in the grid barrier) at the main
// widths, against two a 256-byte chunk before, and no fp32 copy of W_h in
// shared memory. The cluster and bulk-copy helpers are rnn_scan.cuh's, as
// the bf16 forward's design is this one transposed.

// a warp's room: 32 rows of kMaxWindow k16 steps, padded by 16 bytes so
// that ldmatrix is conflict-free
constexpr int kMaxWindow = 25;
constexpr int kRoomBytes = kRows * (kMaxWindow * 32 + 16);

template <int U>
__host__ __device__ constexpr int unit_tiles() { return (U + 7) / 8; }

// the windows of a warp's KS k16 steps, of as even a size as fits the room
template <int KS>
__host__ __device__ constexpr int windows() {
  return (KS + kMaxWindow - 1) / kMaxWindow;
}

// the column parts of a window of W k16 steps that land (and are waited
// on) apart, so that the products of the first overlap the later copies:
// one while a row's window is at most 512 bytes, three beyond (on an
// H100 80GB HBM3 at 700 W the LSTM's backward at H = 512 took 2.43 ms in
// one part, 2.53 in two; the GRU's at H = 1024 2.84 ms in three, 3.01 in
// one)
constexpr int kMaxParts = 3;
__host__ __device__ constexpr int window_parts(int W) {
  return W > 16 ? 3 : 1;
}

template <int U>
size_t bwd_mma_smem_bytes() {
  return static_cast<size_t>(kWarps) * kRoomBytes +
         sizeof(float) * kWarps * kRows * 8 * unit_tiles<U>() +
         sizeof(uint64_t) * kWarps * kMaxParts;
}

template <int G, int U, class Cell>
__global__ void __launch_bounds__(kThreads, 1)
scan_bwd_mma_kernel(const BwdParams p) {
  using E = __nv_bfloat16;
  constexpr int NT = unit_tiles<U>();             // n8 tiles of units
  constexpr int NP = 8 * NT;                      // their columns
  constexpr int KS = G * U;                       // k16 steps a warp
  constexpr int NW = windows<KS>();
  constexpr int kWin = (KS + NW - 1) / NW;        // k16 steps a window
  constexpr int kParts = window_parts(kWin);
  constexpr int kPart = (kWin + kParts - 1) / kParts;   // k16 steps a part
  constexpr int kSlice = kWin * 32 + 16;          // bytes a staged row
  constexpr int kOwn = kRows / kCluster;          // rows this CTA loads
  constexpr int kPairs = (kRows * U + kThreads - 1) / kThreads;
  constexpr int R = Cell::kRes;
  static_assert(kRows == 32, "two m16 tiles of batch rows");
  static_assert(kRows * kSlice <= kRoomBytes, "a window fits the room");
  static_assert(KS - (NW - 1) * kWin > (kParts - 1) * kPart,
                "every window lands in every part");

  extern __shared__ float4 smem4[];
  const int H = p.H, GH = G * H, B = p.B, T = p.T;
  const int unit0 = blockIdx.x * U;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  char* room = reinterpret_cast<char*>(smem4) + warp * kRoomBytes;
  float* red = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                        kWarps * kRoomBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + kWarps * kRows * NP) +
                   warp * kMaxParts;               // this warp's parts'
  const E* wh = static_cast<const E*>(p.wh);
  E* dx = static_cast<E*>(p.dx);
  E* xbuf = static_cast<E*>(p.xbuf);
  const int col0 = warp * KS * 16;                // this warp's K-slice

  // B fragments: k = 2 tig, + 1 (and + 8) of k-step s, unit 8 nt + grp
  unsigned bw[KS][NT][2];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int u = 8 * nt + grp;
      const E* w = wh + static_cast<size_t>(unit0 + (u < U ? u : 0)) * GH +
                   col0 + 16 * s + 2 * tig;
      bw[s][nt][0] = u < U ? mma_sync::ld32(w) : 0u;
      bw[s][nt][1] = u < U ? mma_sync::ld32(w + 8) : 0u;
    }
  }

  const unsigned rank = cluster_rank();
  unsigned uses = 0;
  if (lane == 0) {
    for (int q = 0; q < kParts; ++q) mbar_init(bars + q);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  const int tiles = (B + kRows - 1) / kRows;
  auto dg_dst = [&](int k) -> E* {
    return xbuf != nullptr ? xbuf + static_cast<size_t>(k & 1) * B * GH
                           : nullptr;
  };
  bwd_first_step<E, U, Cell>(p, unit0, dg_dst(0));

  for (int k = 0; k < T; ++k) {
    // the cells' dg, written by this thread, is read next by the async
    // proxy of every CTA
    fence_proxy_async_global();
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

      float acc[2][NT][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][nt][e] = 0.f;
      // k-steps s0 .. s1 - 1 from the staged window whose first column
      // is k-step w0's
      auto products = [&](int w0, int s0, int s1) {
        const E* tile_rows = reinterpret_cast<const E*>(room);
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          if (s >= s0 && s < s1) {
            unsigned a[2][4];
            mma_sync::a_frag(a[0], tile_rows, kSlice / 2, 0, 16 * (s - w0));
            mma_sync::a_frag(a[1], tile_rows, kSlice / 2, 16, 16 * (s - w0));
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              mma_sync::mma_bf16(acc[0][nt], a[0], bw[s][nt][0],
                                 bw[s][nt][1]);
              mma_sync::mma_bf16(acc[1][nt], a[1], bw[s][nt][0],
                                 bw[s][nt][1]);
            }
          }
        }
      };
#pragma unroll
      for (int win = 0; win < NW; ++win) {
        const int w0 = win * kWin, wlen = min(kWin, KS - w0);
        if (win > 0) cluster_sync();  // both CTAs done with the window
        // this CTA's rows of the window, one copy a row and part,
        // multicast to the cluster
        if (lane == 0) {
#pragma unroll
          for (int q = 0; q < kParts; ++q)
            mbar_expect(bars + q, min(kRows, B - b0) * 32 *
                                      min(kPart, wlen - q * kPart));
        }
        fence_proxy_async_global();
        for (int i = lane; i < kParts * kOwn; i += 32) {
          const int q = i / kOwn, row = rank * kOwn + i % kOwn;
          if (b0 + row < B)
            bulk_multicast(room + row * kSlice + q * kPart * 32,
                           src + (b0 + row) * row_stride + col0 +
                               (w0 + q * kPart) * 16,
                           32 * min(kPart, wlen - q * kPart), bars + q,
                           static_cast<unsigned short>((1u << kCluster) - 1));
        }
#pragma unroll
        for (int q = 0; q < kParts; ++q) {
          mbar_wait(bars + q, uses & 1);
          products(w0, w0 + q * kPart, w0 + min((q + 1) * kPart, wlen));
        }
        ++uses;
      }

      // the warps' partial tiles (rows 16 m + grp and + 8, units 8 nt +
      // 2 tig and + 1), then the cells
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float* r0 = red + (warp * kRows + 16 * m + grp) * NP + 8 * nt +
                      2 * tig;
          *reinterpret_cast<float2*>(r0) =
              make_float2(acc[m][nt][0], acc[m][nt][1]);
          *reinterpret_cast<float2*>(r0 + 8 * NP) =
              make_float2(acc[m][nt][2], acc[m][nt][3]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int pair = tid + q * kThreads;
        const int bl = pair / U, u = pair % U, b = b0 + bl;
        if (pair < kRows * U && b < B) {
          float prod = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            prod += red[(w * kRows + bl) * NP + u];
          const size_t i = static_cast<size_t>(b) * H + unit0 + u;
          const float carry = p.hcarry[i] + prod;
          if (more)
            Cell::template step<E>(p, b, tn, unit0 + u, tn < lens[q], carry,
                                   res[q], dg_dst(k + 1));
          else
            static_cast<E*>(p.dh0)[i] = from_f<E>(carry);
        }
      }
      // the next tile reuses red and the rooms
      if (tile + 1 < tiles) cluster_sync();
    }
  }
  // no CTA leaves while a peer's copies into it may be in flight
  cluster_sync();
}

template <typename E, int G, class Cell>
struct BwdLaunch {
  template <int U>
  static int run(const BwdParams& p, cudaStream_t stream) {
    return launch_cooperative(scan_bwd_kernel<E, G, U, Cell>,
                              bwd_smem_bytes<G, U>(p.H), p.H / U, p, stream);
  }
};

template <int G, class Cell>
struct BwdMmaLaunch {
  template <int U>
  static int run(const BwdParams& p, cudaStream_t stream) {
    return launch_cooperative(scan_bwd_mma_kernel<G, U, Cell>,
                              bwd_mma_smem_bytes<U>(), p.H / U, p, stream,
                              kCluster);
  }
};

// bf16 on the tensor cores, fp32 on the CUDA cores
template <typename E, int G, class Cell>
int dispatch_bwd_units(const BwdParams& p, int units, cudaStream_t stream) {
  if constexpr (std::is_same_v<E, __nv_bfloat16>)
    return for_units<BwdMmaLaunch<G, Cell>>(units, p, stream);
  else
    return for_units<BwdLaunch<E, G, Cell>>(units, p, stream);
}

}  // namespace rnn_scan
