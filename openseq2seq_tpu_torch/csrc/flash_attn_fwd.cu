// Flash attention forward: out = softmax(q k^T * sm_scale + mask) v per
// (batch row, head), with fp32 scores, softmax and accumulation.
//
// Replaces `_attend_flash` in openseq2seq_tpu/parts/transformer/
// attention.py:120, which calls JAX's stock Pallas TPU kernel
// (jax.experimental.pallas.ops.tpu.flash_attention) for full-sequence
// attention: the encoder self-attention with key padding, the
// teacher-forced decoder self-attention (causal) and the cross-attention
// (key padding). Layout is JAX's, (B, T, H, D), contiguous; the output
// has the input's type (bf16 or fp32).
//
// Masking is `_attend`'s: a masked key (kv_valid[b, k] == 0, or k > q
// under `causal`) gets the finite additive -1e9, never -inf, so one valid
// key makes a masked key's weight exactly 0 and a row without a valid key
// degrades as `_attend` does (no NaN). Keys past Tk in a ragged tile are
// not keys at all: weight 0.
//
// What bounds it on an H100: bytes. At the transformer-big encoder shape
// (B=64, H=16, Tq=Tk=64, D=64, bf16) it does 4*B*H*Tq*Tk*D = 1.07 GFLOP
// (1.1 us at 989 TFLOP/s) but must read q, k, v and write o, 8.4 MB each,
// 33.6 MB (10.0 us at 3.35 TB/s). The score matrix never reaches device
// memory: that is the whole point of the design.
//
// Design (a simple kernel that is right; wgmma/TMA are later work):
//  * one CTA per (64-query tile, head, batch row); 256 threads, four per
//    query row, so a row's online-softmax state lives in one quad of
//    lanes and is combined with two xor-shuffles;
//  * q is staged once and each 64-key K/V tile in turn in shared memory
//    as fp32, rows padded by one float so that the eight rows a warp reads
//    fall in eight banks; dynamic shared memory (66 KB at D=64, 214 KB at
//    D=256) is requested with cudaFuncSetAttribute;
//  * scores and P.V are fp32 FMAs from shared memory (no tensor cores
//    yet): each thread computes 16 scores of its row, then its D/4 output
//    columns from the row's 64 weights, which go through shared memory;
//  * under `causal`, key tiles wholly above the tile's last query are
//    skipped: each row keeps its diagonal key, so skipping is exact.
// The q.k head dim DQK and the v head dim DV are separate template
// parameters (instantiated equal here) so that a kernel with Dqk != Dv
// can reuse this one.
//
// For training the caller passes an fp32 `lse` (B, H, Tq), which receives
// each row's log-sum-exp m + log(l) (relative to the mask value for a row
// without any valid key); flash_attn_bwd.cu recomputes the weights from
// it. Inference passes null and writes nothing more.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;                 // queries per CTA
constexpr int kKeys = 64;                 // keys per K/V tile
constexpr int kTpr = 4;                   // threads per query row
constexpr int kThreads = kRows * kTpr;    // 256
constexpr float kMasked = -1e9f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int DQK, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kRows) * (DQK + 1) +
                          static_cast<size_t>(kKeys) * (DQK + 1) +
                          static_cast<size_t>(kKeys) * (DV + 1) +
                          static_cast<size_t>(kRows) * (kKeys + 1) + kKeys);
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const unsigned char* __restrict__ kv_valid,
                      T* __restrict__ out, float* __restrict__ lse, int Tq,
                      int Tk, int H, int causal, float sm_scale) {
  constexpr int QS = DQK + 1, VS = DV + 1, PS = kKeys + 1;
  constexpr int KPT = kKeys / kTpr;       // scores per thread
  constexpr int OPT = DV / kTpr;          // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;                       // kRows x QS
  float* sk = sq + kRows * QS;            // kKeys x QS
  float* sv = sk + kKeys * QS;            // kKeys x VS
  float* sp = sv + kKeys * VS;            // kRows x PS: the tile's weights
  float* sbias = sp + kRows * PS;         // kKeys: 0, -1e9 or -inf

  const int tid = threadIdx.x;
  const int row = tid / kTpr, sub = tid % kTpr;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int qi = q0 + row;

  for (int i = tid; i < kRows * DQK; i += kThreads) {
    const int r = i / DQK, d = i % DQK, t = q0 + r;
    sq[r * QS + d] =
        t < Tq ? to_float(q[((static_cast<size_t>(b) * Tq + t) * H + h) *
                                DQK + d])
               : 0.f;
  }

  // with lse: the first valid key of the batch row, which tells a row
  // without any valid key (see the store of lse below)
  __shared__ int first_valid;
  if (lse != nullptr) {
    if (tid == 0) first_valid = kv_valid != nullptr ? Tk : 0;
    __syncthreads();
    if (kv_valid != nullptr)
      for (int t = tid; t < Tk; t += kThreads)
        if (kv_valid[static_cast<size_t>(b) * Tk + t]) {
          atomicMin(&first_valid, t);
          break;
        }
    __syncthreads();
  }

  float o[OPT];
#pragma unroll
  for (int c = 0; c < OPT; ++c) o[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  // under causal no row of this tile sees a key past its last real query
  const int k_end = causal ? min(Tk, min(q0 + kRows, Tq)) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    __syncthreads();                      // the last tile's reads are done
    for (int i = tid; i < kKeys * DQK; i += kThreads) {
      const int j = i / DQK, d = i % DQK, t = k0 + j;
      sk[j * QS + d] =
          t < Tk ? to_float(k[((static_cast<size_t>(b) * Tk + t) * H + h) *
                                  DQK + d])
                 : 0.f;
    }
    for (int i = tid; i < kKeys * DV; i += kThreads) {
      const int j = i / DV, d = i % DV, t = k0 + j;
      sv[j * VS + d] =
          t < Tk ? to_float(v[((static_cast<size_t>(b) * Tk + t) * H + h) *
                                  DV + d])
                 : 0.f;
    }
    if (tid < kKeys) {
      const int t = k0 + tid;
      sbias[tid] = t >= Tk ? -INFINITY
                   : (kv_valid != nullptr &&
                      !kv_valid[static_cast<size_t>(b) * Tk + t])
                       ? kMasked
                       : 0.f;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int c = 0; c < KPT; ++c) s[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DQK; ++d) {
      const float qd = sq[row * QS + d];
#pragma unroll
      for (int c = 0; c < KPT; ++c)
        s[c] = fmaf(qd, sk[(sub + kTpr * c) * QS + d], s[c]);
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int c = 0; c < KPT; ++c) {
      const int j = sub + kTpr * c;
      float bias = sbias[j];
      if (causal && bias == 0.f && k0 + j > qi) bias = kMasked;
      s[c] = s[c] * sm_scale + bias;
      tile_max = fmaxf(tile_max, s[c]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    // key k0 < Tk is in every tile, so tile_max and m_new are finite
    const float m_new = fmaxf(m, tile_max);
    const float rescale = expf(m - m_new);   // 0 on the first tile
    float row_sum = 0.f;
#pragma unroll
    for (int c = 0; c < KPT; ++c) {
      const float p = expf(s[c] - m_new);    // 0 for keys past Tk
      sp[row * PS + sub + kTpr * c] = p;
      row_sum += p;
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    l = l * rescale + row_sum;
    m = m_new;
    __syncwarp();                           // the row's weights are in sp
#pragma unroll
    for (int c = 0; c < OPT; ++c) o[c] *= rescale;
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float pj = sp[row * PS + j];
#pragma unroll
      for (int c = 0; c < OPT; ++c)
        o[c] = fmaf(pj, sv[j * VS + sub + kTpr * c], o[c]);
    }
  }

  if (qi < Tq) {
    const float inv = 1.f / l;
    T* dst = out + ((static_cast<size_t>(b) * Tq + qi) * H + h) * DV;
#pragma unroll
    for (int c = 0; c < OPT; ++c) store(dst + sub + kTpr * c, o[c] * inv);
    // the row's log-sum-exp, for the backward's recompute of the weights.
    // A row without a valid key has m near -1e9, where fp32 cannot hold
    // m + log(l); its lse is taken relative to the mask value instead
    // (m - kMasked is exact), and the backward subtracts the same offset
    if (lse != nullptr && sub == 0) {
      const bool none = first_valid > (causal ? qi : Tk - 1);
      lse[(static_cast<size_t>(b) * H + h) * Tq + qi] =
          (none ? m - kMasked : m) + logf(l);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v,
           const unsigned char* kv_valid, void* out, float* lse, int B,
           int Tq, int Tk, int H, int causal, float sm_scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, D>();
  auto* kernel = flash_attn_fwd_kernel<T, D, D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_valid, static_cast<T*>(out), lse, Tq, Tk,
      H, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v,
             const unsigned char* kv_valid, void* out, float* lse, int B,
             int Tq, int Tk, int H, int D, int causal, float sm_scale,
             cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, kv_valid, out, lse, B, Tq, Tk, H,
                           causal, sm_scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, kv_valid, out, lse, B, Tq, Tk, H,
                            causal, sm_scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, kv_valid, out, lse, B, Tq, Tk, H,
                            causal, sm_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success). The caller guarantees B, Tq, Tk, H >= 1, D in {64, 128, 256},
// contiguous (B, T, H, D) device buffers of one type (bf16 when is_bf16,
// else fp32), kv_valid null or a (B, Tk) byte mask, and lse null or a
// (B, H, Tq) fp32 buffer, which then receives each row's m + log(l).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* kv_valid, void* out, void* lse,
                              int B, int Tq, int Tk, int H, int D,
                              int is_bf16, int causal, float sm_scale,
                              void* stream) {
  const auto* mask = static_cast<const unsigned char*>(kv_valid);
  auto* lse_out = static_cast<float*>(lse);
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, mask, out, lse_out, B, Tq, Tk,
                                   H, D, causal, sm_scale, s);
  return dispatch<float>(q, k, v, mask, out, lse_out, B, Tq, Tk, H, D,
                         causal, sm_scale, s);
}
