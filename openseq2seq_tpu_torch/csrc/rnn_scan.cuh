// The persistent scan shared by the GRU and LSTM forward kernels
// (gru_scan_fwd.cu, lstm_scan_fwd.cu): one cooperative launch walks all
// T steps of one direction of one layer. Its grid barrier, cp.async
// helpers, cooperative launcher and unit dispatch also carry the
// backward kernels (rnn_scan_bwd.cuh).
//
// Layout. The gate pre-activations of step t are x_proj[t] + h_{t-1} W_h
// with W_h (H, G*H) for G gates. CTA j owns U consecutive hidden units
// (the grid is H / U CTAs, 128 by default) and so the U columns of each
// gate block of W_h, G*U columns in all. Those columns are read once,
// widened to fp32 and kept in shared memory for all T steps (1024 x 24 x
// 4 B = 96 KiB for the GRU at H = 1024).
//
// Each step, for each tile of 32 batch rows:
//  1. the tile's h_{t-1} rows (B x H in the compute type, written by all
//     CTAs in the previous step and read from L2 with cp.async.cg, which
//     bypasses the SM's incoherent L1) stream through shared memory in
//     256-byte column chunks, four stages deep;
//  2. lane b of warp w accumulates row b's G*U pre-activations over
//     warp w's eighth of each chunk in fp32 registers: one 16-byte read
//     of h and G*U/4 broadcast 16-byte reads of W_h per 8 (bf16) or 4
//     (fp32) products per column, fp32 FMAs on the CUDA cores;
//  3. the eight warps' partial sums meet in shared memory and are added
//     in a fixed order (no atomics: two calls give the same bits);
//  4. one thread per (row, unit) pair adds x_proj[t] (read before the
//     products, so its latency hides behind them), runs the cell's gate
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

namespace rnn_scan {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                  // batch rows per tile, one a lane
constexpr int kChunkBytes = 256;           // of one h row per stage
constexpr int kRowStride = kChunkBytes + 16;  // 16-byte reads conflict-free
constexpr int kStages = 4;
constexpr int kStageBytes = kRows * kRowStride;
constexpr int kMaxUnits = 10;              // H <= 1280 at 128 CTAs
// returned when the grid cannot be co-resident, or `units` is not built
constexpr int kNotCoResident = -2;
constexpr int kBadUnits = -3;

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
  int* query;             // or: (smem bytes, CTAs an SM) out, no launch
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

// Cell::step(p, b, t, col, pre[G], x[G], h_prev, live, last, dst) runs the
// gate math of row b, hidden unit col at time t and writes its outputs.
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
      float xv[kPairs][G], hprev[kPairs];
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int pair = tid + q * kThreads;
        const int b = b0 + pair / U, col = unit0 + pair % U;
        if (pair < kRows * U && b < B) {
          const E* x = xp + (static_cast<size_t>(b) * T + t) * GH + col;
#pragma unroll
          for (int g = 0; g < G; ++g) xv[q][g] = to_f(x[g * H]);
          hprev[q] = load_cg(src + static_cast<size_t>(b) * H + col);
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
          Cell::step(p, b, t, unit0 + u, pre, xv[q], hprev[q],
                     t < __ldg(p.lens + b), s == T - 1, dst);
        }
      }
      __syncthreads();          // before the next tile reuses the scratch
    }
    if (s + 1 < T) grid_sync(p.barrier, gridDim.x * (s + 1u));
  }
}

// One cooperative launch of `ctas` CTAs of `kernel(args)`, after the
// occupancy API has shown that they can all be resident at once; with
// `cluster` > 1 in clusters of that many CTAs, checked with
// cudaOccupancyMaxActiveClusters. With `p.query` set it launches nothing
// and writes the kernel's dynamic shared memory and the CTAs an SM holds
// there.
template <typename Args>
int launch_cooperative(void (*kernel)(const Args), size_t smem, int ctas,
                       const Args& p, cudaStream_t stream, int cluster = 1) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.query != nullptr) {       // the kernel's resources, no launch
    p.query[0] = static_cast<int>(smem);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        p.query + 1, kernel, kThreads, smem));
  }
  Args args = p;
  if (cluster > 1) {
    cudaLaunchAttribute attrs[2];
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = cluster;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeCooperative;
    attrs[1].val.cooperative = 1;
    cudaLaunchConfig_t cfg = {};
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
    if (static_cast<long long>(clusters) * cluster < ctas)
      return kNotCoResident;
    cfg.numAttrs = 2;
    err = cudaLaunchKernelEx(&cfg, kernel, args);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  // the barrier needs every CTA resident at once: checked, never assumed
  if (static_cast<long long>(per_sm) * sms < ctas) return kNotCoResident;
  void* argv[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(ctas), dim3(kThreads), argv, smem,
                                    stream);
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

template <typename E, int G, class Cell>
int dispatch_units(const Params& p, int units, cudaStream_t stream) {
  return for_units<FwdLaunch<E, G, Cell>>(units, p, stream);
}

}  // namespace rnn_scan
