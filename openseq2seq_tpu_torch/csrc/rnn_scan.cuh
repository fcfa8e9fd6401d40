// The persistent scan shared by the GRU and LSTM forward kernels
// (gru_scan_fwd.cu, lstm_scan_fwd.cu): one cooperative launch walks all
// T steps of one direction of one layer. Its grid barrier, cp.async,
// cluster and bulk-copy helpers, cooperative launcher and unit dispatch
// also carry the backward kernels (rnn_scan_bwd.cuh).
//
// Layout. The gate pre-activations of step t are x_proj[t] + h_{t-1} W_h
// with W_h (H, G*H) for G gates. CTA j owns U consecutive hidden units
// (the grid is H / U CTAs, 128 by default) and so the U columns of each
// gate block of W_h, G*U columns in all, which it keeps on chip for all
// T steps. The T steps are dependent and each ends in a grid-wide
// barrier, so a step's latency, not the card's rates, sets the pace (the
// bounds in gru_scan_fwd.cu and lstm_scan_fwd.cu); both designs keep the
// step's path short.
//
// Each step, for each tile of 32 batch rows:
//  1. the tile's h_{t-1} rows (B x H in the compute type, written by all
//     CTAs in the previous step) come from L2, and the CTA forms its G*U
//     columns of h_{t-1} W_h:
//     - bf16 (scan_fwd_mma_kernel, below): on the tensor cores, W_h in
//       registers, each warp staging its own slice of h's columns, in
//       clusters of two CTAs that share each row's L2 read by multicast;
//     - fp32 (scan_fwd_kernel): W_h's columns widened to fp32 in shared
//       memory (1024 x 24 x 4 B = 96 KiB for the GRU at H = 1024); the
//       rows stream through shared memory with cp.async.cg (which
//       bypasses the SM's incoherent L1) in 256-byte column chunks, four
//       stages deep, two CTA barriers a chunk; lane b of warp w
//       accumulates row b's G*U pre-activations over warp w's eighth of
//       each chunk in fp32 registers, fp32 FMAs on the CUDA cores;
//  2. the eight warps' partial sums meet in shared memory and are added
//     in a fixed order (no atomics: two calls give the same bits);
//  3. one thread per (row, unit) pair adds x_proj[t] (read, with the
//     LSTM's c, before the products, so that their latency hides behind
//     them), runs the cell's gate
//     math and length mask in fp32, and writes h_t rounded to the
//     compute type (as the TPU kernel carries it) to the other half of a
//     ping-pong buffer, to ys[t] (zero past the row's length) and, when
//     asked, the residuals that a backward pass needs.
// A grid-wide barrier (a counter in device memory, release/acquire at
// GPU scope) then ends the step. The launch is cooperative, and the host
// checks with the occupancy API that the whole grid is co-resident
// before it launches, so the barrier cannot deadlock.
//
// Time runs forward, or backward with `reverse`: then step s handles
// t = T - 1 - s, and the mask is still t < length. That is the JAX
// package's flip, suffix mask and flip back without flipped copies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sync.cuh"

namespace rnn_scan {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                  // batch rows per tile, one a lane
constexpr int kChunkBytes = 256;           // of one h row per stage
constexpr int kRowStride = kChunkBytes + 16;  // 16-byte reads conflict-free
constexpr int kStages = 4;
constexpr int kStageBytes = kRows * kRowStride;
constexpr int kMaxUnits = 10;              // H <= 1280 at 128 CTAs
// returned when the grid cannot be co-resident, `units` is not built, or
// a CTA needs more shared memory than an SM gives one (nothing launches)
constexpr int kNotCoResident = -2;
constexpr int kBadUnits = -3;
constexpr int kTooMuchSmem = -4;
// the clusters' size of the tensor-core kernels: clusters of four are not
// co-resident at 128 CTAs on an H100
constexpr int kCluster = 2;

struct Params {
  const void* xp;         // (B, T, G*H) compute type: x_proj, gates blocked
  const void* wh;         // (H, G*H) compute type
  const float* bh;        // (G*H,) fp32, or null
  const int* lens;        // (B,)
  void* hbuf;             // (2, B, H) compute type; [0] holds h0
  float* cstate;          // (B, H) fp32 cell state (c0 in, c_last out)
  void* ys;               // (B, T, H) compute type
  void* h_last;           // (B, H) compute type
  void* acts;             // (B, T, G*H) compute type gate activations, or null
  void* aux;              // (B, T, H): the cell's second residual, or null
  unsigned int* barrier;  // one counter, zero at launch
  int* query;             // or: (smem bytes, CTAs an SM, CTAs resident at
                          // once) out, no launch
  int B, T, H, reverse;
  float forget_bias;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);             // round to nearest even
}

// an h value written by another CTA: from L2, never a stale L1 line
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_cg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ void unpack16(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// every CTA arrives, then waits until all gridDim.x * (s + 1) arrivals of
// the first s + 1 steps are in
__device__ __forceinline__ void grid_sync(unsigned int* counter,
                                          unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// The tensor-core kernels' cluster and bulk-copy helpers (this one's
// forward and rnn_scan_bwd.cuh's backward).
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// a copy that never lands traps (the launch then fails) rather than
// hanging the card: a step's wait is microseconds, the limit seconds
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned spins = 0; !done; ++spins) {
    if (spins == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}
// `bytes` from global `src` to `dst` in the shared memory of every CTA of
// the cluster in `mask`, completing on the mbarrier at `bar`'s offset
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src,
                                               unsigned bytes, uint64_t* bar,
                                               unsigned short mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)),
         "h"(mask) : "memory");
}
// generic stores to global memory made visible to (before) reads of the
// async proxy, which the bulk copies are
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

template <int G, int U>
__host__ __device__ constexpr int padded_cols() { return (G * U + 3) / 4 * 4; }

template <int G, int U>
size_t smem_bytes(int H) {
  constexpr int NCP = padded_cols<G, U>();
  const size_t red = sizeof(float) * kWarps * NCP * kRows;
  const size_t stages = static_cast<size_t>(kStages) * kStageBytes;
  return sizeof(float) * static_cast<size_t>(H) * NCP +
         (red > stages ? red : stages);
}

// Cell::state(p, b, col) reads the fp32 state besides h that row b,
// hidden unit col carries (the LSTM's c; 0 for the GRU), before the
// products so that its latency hides behind them;
// Cell::step(p, b, t, col, pre[G], x[G], h_prev, c_prev, live, last, dst)
// runs the gate math of row b, hidden unit col at time t and writes its
// outputs.
template <typename E, int G, int U, class Cell>
__global__ void __launch_bounds__(kThreads, 1)
scan_fwd_kernel(const Params p) {
  constexpr int NC = G * U;
  constexpr int NCP = padded_cols<G, U>();
  constexpr int VE = 16 / sizeof(E);            // h values per 16 bytes
  constexpr int KC = kChunkBytes / sizeof(E);   // h columns per chunk
  constexpr int KW = KC / kWarps;               // of them per warp
  constexpr int kPairs = (kRows * U + kThreads - 1) / kThreads;
  static_assert(KW % VE == 0, "a warp's share is whole 16-byte reads");

  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);                  // H x NCP
  char* scratch = reinterpret_cast<char*>(ws + static_cast<size_t>(p.H) *
                                                   NCP);
  const int H = p.H, GH = G * H, B = p.B, T = p.T;
  const int unit0 = blockIdx.x * U;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const E* xp = static_cast<const E*>(p.xp);
  const E* wh = static_cast<const E*>(p.wh);
  E* hbuf = static_cast<E*>(p.hbuf);

  // this CTA's columns of W_h, gate by gate, zero-padded to NCP
  for (int i = tid; i < H * NCP; i += kThreads) {
    const int k = i / NCP, c = i - k * NCP;
    ws[i] = c < NC ? to_f(wh[static_cast<size_t>(k) * GH + (c / U) * H +
                             unit0 + c % U])
                   : 0.f;
  }
  __syncthreads();

  const int nch = H / KC;
  const int tiles = (B + kRows - 1) / kRows;
  constexpr int kSegs = kChunkBytes / 16;
  for (int s = 0; s < T; ++s) {
    const int t = p.reverse ? T - 1 - s : s;
    const E* src = hbuf + static_cast<size_t>(s & 1) * B * H;
    E* dst = hbuf + static_cast<size_t>((s + 1) & 1) * B * H;
    for (int tile = 0; tile < tiles; ++tile) {
      const int b0 = tile * kRows;
      float xv[kPairs][G], hprev[kPairs], cprev[kPairs];
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int pair = tid + q * kThreads;
        const int b = b0 + pair / U, col = unit0 + pair % U;
        if (pair < kRows * U && b < B) {
          const E* x = xp + (static_cast<size_t>(b) * T + t) * GH + col;
#pragma unroll
          for (int g = 0; g < G; ++g) xv[q][g] = to_f(x[g * H]);
          hprev[q] = load_cg(src + static_cast<size_t>(b) * H + col);
          cprev[q] = Cell::state(p, b, col);
        }
      }

      auto issue = [&](int c) {
        char* stage = scratch + (c % kStages) * kStageBytes;
        for (int i = tid; i < kRows * kSegs; i += kThreads) {
          const int row = i / kSegs, seg = i - row * kSegs;
          const int b = min(b0 + row, B - 1);
          const char* g = reinterpret_cast<const char*>(
              src + static_cast<size_t>(b) * H + c * KC) + seg * 16;
          cp_async16(stage + row * kRowStride + seg * 16, g,
                     b0 + row < B ? 16 : 0);     // zeros past the batch
        }
      };

      float acc[NCP];
#pragma unroll
      for (int c = 0; c < NCP; ++c) acc[c] = 0.f;
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
          float hv[VE];
          unpack16(reinterpret_cast<const E*>(row + v * 16), hv);
          const int k0 = c * KC + warp * KW + v * VE;
#pragma unroll
          for (int e = 0; e < VE; ++e) {
            const float4* w = reinterpret_cast<const float4*>(
                ws + static_cast<size_t>(k0 + e) * NCP);
#pragma unroll
            for (int q = 0; q < NCP / 4; ++q) {
              const float4 w4 = w[q];
              acc[4 * q] = fmaf(hv[e], w4.x, acc[4 * q]);
              acc[4 * q + 1] = fmaf(hv[e], w4.y, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(hv[e], w4.z, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(hv[e], w4.w, acc[4 * q + 3]);
            }
          }
        }
        __syncthreads();
      }

      // the warps' partial sums, then the cells; the stages are free now
      float* red = reinterpret_cast<float*>(scratch);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        red[(warp * NCP + c) * kRows + lane] = acc[c];
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int pair = tid + q * kThreads;
        const int bl = pair / U, u = pair % U, b = b0 + bl;
        if (pair < kRows * U && b < B) {
          float pre[G];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float sum = 0.f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w)
              sum += red[(w * NCP + g * U + u) * kRows + bl];
            pre[g] = sum;
          }
          Cell::step(p, b, t, unit0 + u, pre, xv[q], hprev[q], cprev[q],
                     t < __ldg(p.lens + b), s == T - 1, dst);
        }
      }
      __syncthreads();          // before the next tile reuses the scratch
    }
    if (s + 1 < T) grid_sync(p.barrier, gridDim.x * (s + 1u));
  }
}

// The bf16 design on the tensor cores: the backward's (rnn_scan_bwd.cuh)
// transposed, with a smaller shared operand. The grid and the ownership
// are the CUDA-core kernel's; what differs is the product and how h
// reaches it:
//  - warp w owns the K-slice [16 U w, 16 U (w + 1)) of h's H columns (U
//    k16 steps; the slices tile H since H = 128 U) and keeps the CTA's
//    G U columns of W_h over that slice in registers, in bf16, as the B
//    fragments of mma.sync m16n8k16 for all T steps (U ceil(G U / 8) 2
//    registers: 48 for the GRU at H = 1024, 16 for the LSTM at H = 512,
//    100 for the LSTM at H = 1280; padded to n8 with zeros); there is no
//    copy of W_h in shared memory, so every width up to kMaxUnits fits;
//  - the CTAs run in clusters of two, which need the same h rows: each
//    step, CTA r of a cluster loads rows [16 r, 16 r + 16) of each warp's
//    slice of the tile's 32 h rows (32 U bytes a row: 256 at the GRU's
//    main width), one bulk copy a row, and multicasts them to both CTAs'
//    shared memories (cp.async.bulk ... multicast::cluster, completing on
//    the warp's mbarrier), so that L2 serves each h byte to 64 SMs, not
//    128 (4 MiB a step at the GRU's main shape, not 8); rows past B are
//    not loaded, and the product rows they give are dropped (a product's
//    rows do not mix);
//  - a warp waits on its own mbarrier (no CTA barrier: no warp reads
//    another's slice) and runs 2 U ceil(G U / 8) products on ldmatrix A
//    fragments (48 at the GRU's main shape, against 3,072 FMAs a thread on
//    the CUDA cores), exact products of bf16 summed in fp32;
//  - the eight warps' (32 x 8 ceil(G U / 8)) partial tiles meet in shared
//    memory and are added in a fixed order (no atomics: two calls give the
//    same bits), and one CTA barrier later the cells run as in the
//    CUDA-core kernel, x_proj[t] (and the LSTM's c) read while the copies
//    land.
// The ordering is the backward's: every thread fences its generic h
// stores for the async proxy before the grid barrier, the copying lanes
// fence again after it; the grid barrier between steps and a cluster
// barrier between tiles keep a CTA from multicasting into a peer's room
// that the peer still reads. Three CTA barriers a step in all (two in the
// grid barrier), against two a 256-byte chunk on the CUDA cores.
template <int U>
__host__ __device__ constexpr int fwd_row_bytes() { return U * 32 + 16; }

template <int G, int U>
__host__ __device__ constexpr int fwd_col_tiles() { return (G * U + 7) / 8; }

template <int G, int U>
size_t fwd_mma_smem_bytes() {
  return static_cast<size_t>(kWarps) * kRows * fwd_row_bytes<U>() +
         sizeof(float) * kWarps * kRows * 8 * fwd_col_tiles<G, U>() +
         sizeof(uint64_t) * kWarps;
}

template <int G, int U, class Cell>
__global__ void __launch_bounds__(kThreads, 1)
scan_fwd_mma_kernel(const Params p) {
  using E = __nv_bfloat16;
  constexpr int NC = G * U;                       // this CTA's columns
  constexpr int NT = fwd_col_tiles<G, U>();       // n8 tiles of them
  constexpr int NP = 8 * NT;
  constexpr int kRow = fwd_row_bytes<U>();        // a staged row, padded
  constexpr int kOwn = kRows / kCluster;          // rows this CTA loads
  constexpr int kPairs = (kRows * U + kThreads - 1) / kThreads;
  static_assert(kRows == 32, "two m16 tiles of batch rows");
  static_assert(kOwn <= 32, "a lane a row");

  extern __shared__ float4 smem4[];
  const int H = p.H, GH = G * H, B = p.B, T = p.T;
  const int unit0 = blockIdx.x * U;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  char* room = reinterpret_cast<char*>(smem4) + warp * kRows * kRow;
  float* red = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                        kWarps * kRows * kRow);
  uint64_t* bar = reinterpret_cast<uint64_t*>(red + kWarps * kRows * NP) +
                  warp;
  const E* xp = static_cast<const E*>(p.xp);
  const unsigned short* wbits = static_cast<const unsigned short*>(p.wh);
  E* hbuf = static_cast<E*>(p.hbuf);
  const int k0 = warp * U * 16;                   // this warp's K-slice

  // B fragments: rows k = 2 tig, + 1 (and + 8, + 9) of k-step s, column
  // n = 8 nt + grp of this CTA's (gate n / U, unit n % U), zero past NC
  unsigned bw[U][NT][2];
#pragma unroll
  for (int s = 0; s < U; ++s) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = 8 * nt + grp;
      const unsigned short* w =
          wbits + static_cast<size_t>(k0 + 16 * s + 2 * tig) * GH +
          (n < NC ? (n / U) * H + unit0 + n % U : 0);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const unsigned short* wk = w + static_cast<size_t>(8 * hi) * GH;
        bw[s][nt][hi] = n < NC ? static_cast<unsigned>(wk[0]) |
                                       static_cast<unsigned>(wk[GH]) << 16
                                 : 0u;
      }
    }
  }

  const unsigned rank = cluster_rank();
  unsigned uses = 0;
  if (lane == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  const int tiles = (B + kRows - 1) / kRows;
  for (int s = 0; s < T; ++s) {
    const int t = p.reverse ? T - 1 - s : s;
    const E* src = hbuf + static_cast<size_t>(s & 1) * B * H;
    E* dst = hbuf + static_cast<size_t>((s + 1) & 1) * B * H;
    for (int tile = 0; tile < tiles; ++tile) {
      const int b0 = tile * kRows, rows = min(kRows, B - b0);
      // this CTA's rows of the warp's slice, one copy a row, multicast to
      // the cluster
      if (lane == 0) mbar_expect(bar, rows * U * 32);
      fence_proxy_async_global();
      const int row = rank * kOwn + lane;
      if (lane < kOwn && row < rows)
        bulk_multicast(room + row * kRow,
                       src + static_cast<size_t>(b0 + row) * H + k0, U * 32,
                       bar, static_cast<unsigned short>((1u << kCluster) - 1));

      float xv[kPairs][G], hprev[kPairs], cprev[kPairs];
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int pair = tid + q * kThreads;
        const int b = b0 + pair / U, col = unit0 + pair % U;
        if (pair < kRows * U && b < B) {
          const E* x = xp + (static_cast<size_t>(b) * T + t) * GH + col;
#pragma unroll
          for (int g = 0; g < G; ++g) xv[q][g] = to_f(x[g * H]);
          hprev[q] = load_cg(src + static_cast<size_t>(b) * H + col);
          cprev[q] = Cell::state(p, b, col);
        }
      }

      float acc[2][NT][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][nt][e] = 0.f;
      mbar_wait(bar, uses & 1);
      ++uses;
      const E* tile_rows = reinterpret_cast<const E*>(room);
#pragma unroll
      for (int ks = 0; ks < U; ++ks) {
        unsigned a[2][4];
        mma_sync::a_frag(a[0], tile_rows, kRow / 2, 0, 16 * ks);
        mma_sync::a_frag(a[1], tile_rows, kRow / 2, 16, 16 * ks);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_sync::mma_bf16(acc[0][nt], a[0], bw[ks][nt][0], bw[ks][nt][1]);
          mma_sync::mma_bf16(acc[1][nt], a[1], bw[ks][nt][0], bw[ks][nt][1]);
        }
      }

      // the warps' partial tiles (rows 16 m + grp and + 8, columns 8 nt +
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
          float pre[G];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float sum = 0.f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w)
              sum += red[(w * kRows + bl) * NP + g * U + u];
            pre[g] = sum;
          }
          Cell::step(p, b, t, unit0 + u, pre, xv[q], hprev[q], cprev[q],
                     t < __ldg(p.lens + b), s == T - 1, dst);
        }
      }
      // the next tile reuses red and the rooms
      if (tile + 1 < tiles) cluster_sync();
    }
    // the h written here is read next by the async proxy of every CTA
    fence_proxy_async_global();
    if (s + 1 < T) grid_sync(p.barrier, gridDim.x * (s + 1u));
  }
  // no CTA leaves while a peer's copies into it may be in flight
  cluster_sync();
}

// One cooperative launch of `ctas` CTAs of `kernel(args)`, after the
// occupancy API has shown that they can all be resident at once; with
// `cluster` > 1 in clusters of that many CTAs, checked with
// cudaOccupancyMaxActiveClusters. A kernel whose shared memory passes
// what an SM gives a CTA is not launched (kTooMuchSmem). With `p.query`
// set it launches nothing and writes the kernel's dynamic shared memory,
// the CTAs an SM holds and the CTAs that can be resident at once in the
// launch's clusters (both 0 where the shared memory does not fit).
template <typename Args>
int launch_cooperative(void (*kernel)(const Args), size_t smem, int ctas,
                       const Args& p, cudaStream_t stream, int cluster = 1) {
  int device = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) {
    if (p.query == nullptr) return kTooMuchSmem;
    p.query[0] = static_cast<int>(smem);
    p.query[1] = p.query[2] = 0;
    return 0;
  }
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(smem))) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  long long resident = static_cast<long long>(per_sm) * sms;
  cudaLaunchAttribute attrs[2];
  cudaLaunchConfig_t cfg = {};
  if (cluster > 1) {
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = cluster;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeCooperative;
    attrs[1].val.cooperative = 1;
    cfg.gridDim = dim3(ctas);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attrs;
    cfg.numAttrs = 1;                  // the query takes the clusters alone
    int clusters = 0;
    if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) !=
        cudaSuccess)
      return static_cast<int>(err);
    resident = static_cast<long long>(clusters) * cluster;
  }
  if (p.query != nullptr) {       // the kernel's resources, no launch
    p.query[0] = static_cast<int>(smem);
    p.query[1] = per_sm;
    p.query[2] = static_cast<int>(resident < (1 << 30) ? resident : 1 << 30);
    return 0;
  }
  // the barrier needs every CTA resident at once: checked, never assumed
  if (resident < ctas) return kNotCoResident;
  Args args = p;
  if (cluster > 1) {
    cfg.numAttrs = 2;
    err = cudaLaunchKernelEx(&cfg, kernel, args);
  } else {
    void* argv[] = {&args};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                      dim3(ctas), dim3(kThreads), argv, smem,
                                      stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// L::template run<U>(p, stream) for U = units, 1 to kMaxUnits
template <class L, typename Args>
int for_units(int units, const Args& p, cudaStream_t stream) {
  switch (units) {
    case 1: return L::template run<1>(p, stream);
    case 2: return L::template run<2>(p, stream);
    case 3: return L::template run<3>(p, stream);
    case 4: return L::template run<4>(p, stream);
    case 5: return L::template run<5>(p, stream);
    case 6: return L::template run<6>(p, stream);
    case 7: return L::template run<7>(p, stream);
    case 8: return L::template run<8>(p, stream);
    case 9: return L::template run<9>(p, stream);
    case 10: return L::template run<10>(p, stream);
    default: return kBadUnits;
  }
}

template <typename E, int G, class Cell>
struct FwdLaunch {
  template <int U>
  static int run(const Params& p, cudaStream_t stream) {
    return launch_cooperative(scan_fwd_kernel<E, G, U, Cell>,
                              smem_bytes<G, U>(p.H), p.H / U, p, stream);
  }
};

template <int G, class Cell>
struct FwdMmaLaunch {
  template <int U>
  static int run(const Params& p, cudaStream_t stream) {
    return launch_cooperative(scan_fwd_mma_kernel<G, U, Cell>,
                              fwd_mma_smem_bytes<G, U>(), p.H / U, p, stream,
                              kCluster);
  }
};

// bf16 on the tensor cores, fp32 on the CUDA cores
template <typename E, int G, class Cell>
int dispatch_units(const Params& p, int units, cudaStream_t stream) {
  if constexpr (std::is_same_v<E, __nv_bfloat16>)
    return for_units<FwdMmaLaunch<G, Cell>>(units, p, stream);
  else
    return for_units<FwdLaunch<E, G, Cell>>(units, p, stream);
}

}  // namespace rnn_scan
