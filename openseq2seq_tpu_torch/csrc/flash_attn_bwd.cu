// Flash attention backward: dq, dk, dv of out = softmax(q k^T * sm_scale
// + mask) v per (batch row, head), with fp32 scores and accumulation, in
// the FlashAttention-2 split: a dq kernel over query tiles and a dkv
// kernel over key tiles. No atomics, so two calls give identical bits.
//
// Replaces the backward of `_attend_flash` in openseq2seq_tpu/parts/
// transformer/attention.py:120, which runs JAX's stock Pallas TPU kernels
// `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`
// (jax/experimental/pallas/ops/tpu/flash_attention.py, jax 0.9.0). Layout
// is JAX's, (B, T, H, D), contiguous; the gradients have the inputs' type
// (bf16 or fp32).
//
// The weights are recomputed from the forward's lse (flash_attn_fwd.cu):
// p = exp(s * sm_scale + mask - off - lse), with the forward's masking (the
// finite -1e9 on a masked key, -inf past Tk in a ragged tile, no padded
// copies), so p is exactly 0 on a masked key wherever the row has a valid
// key, as in `_attend`'s autograd; off is -1e9 on a row without any valid
// key (whose lse is stored relative to the mask value) and 0 elsewhere.
// di = rowsum(dO * O) in fp32 (JAX computes it outside its kernels) is
// computed by the dq kernel, which runs first and writes it to a (B, H, Tq)
// scratch that the dkv kernel reads. Then ds = p * (dO v^T - di),
// dq = ds k * sm_scale, dk = ds^T q * sm_scale, dv = p^T dO.
//
// What bounds it on an H100: bytes. At the transformer-big encoder shape
// (B=64, H=16, Tq=Tk=64, D=64, bf16) it must read q, k, v, o and dO (8.4 MB
// each) and lse, and write dq, dk and dv: 67.4 MB, 20 us at 3.35 TB/s,
// against 10 * B*H*Tq*Tk*D = 2.7 GFLOP, 2.7 us at 989 TFLOP/s.
//
// Design (a simple kernel that is right; tensor cores are later work):
//  * dq: one CTA per (query tile, head, batch row), TPR threads per query
//    row; q and dO staged once, each K/V tile in turn, in shared memory as
//    fp32 with rows padded by one float; a thread computes the scores and
//    dO.v of ROWS/TPR keys of its row, the row's ds go through shared
//    memory, and the thread accumulates DQK/TPR columns of dq. Under
//    causal, key tiles past the tile's last query are skipped, as in the
//    forward.
//  * dkv: one CTA per (key tile, head, batch row), TPR threads per key; K/V
//    staged once, each Q/dO tile (with its lse and di) in turn; a thread
//    computes p and ds of its key for ROWS/TPR queries, the key's p and ds
//    go through shared memory, and the thread accumulates DQK/TPR columns
//    of dk and DV/TPR of dv. Under causal, query tiles wholly before the
//    key tile are skipped (their p is exactly 0).
//  * ROWS = 64 and TPR = 4 at D = 64 and 128; at D = 256 fp32 staging of
//    64-row tiles would exceed 227 KB of shared memory, so ROWS = 32 and
//    TPR = 8 there (140 KB). DQK and DV are separate template parameters
//    (instantiated equal here), so a kernel with Dqk != Dv can reuse these.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kMasked = -1e9f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [t0, t0 + ROWS) of head h of batch row b of a (B, T, H, D) tensor
// into dst (ROWS x (D + 1)) as fp32; rows past T are zeros
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int t0, int T_len, int H, int h,
                                      int b) {
  for (int i = threadIdx.x; i < ROWS * D; i += NT) {
    const int r = i / D, d = i % D, t = t0 + r;
    dst[r * (D + 1) + d] =
        t < T_len ? to_float(src[((static_cast<size_t>(b) * T_len + t) * H +
                                  h) * D + d])
                  : 0.f;
  }
}

// the first valid key of batch row b (Tk when none; 0 without a mask),
// which tells the rows without any valid key; ends with a barrier
template <int NT>
__device__ __forceinline__ int first_valid_key(
    const unsigned char* __restrict__ kv_valid, int b, int Tk, int* slot) {
  if (threadIdx.x == 0) *slot = kv_valid != nullptr ? Tk : 0;
  __syncthreads();
  if (kv_valid != nullptr)
    for (int t = threadIdx.x; t < Tk; t += NT)
      if (kv_valid[static_cast<size_t>(b) * Tk + t]) {
        atomicMin(slot, t);
        break;
      }
  __syncthreads();
  return *slot;
}

template <int DQK, int DV, int ROWS>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * static_cast<size_t>(ROWS) * (DQK + 1) +
                          2 * static_cast<size_t>(ROWS) * (DV + 1) +
                          static_cast<size_t>(ROWS) * (ROWS + 1) + ROWS);
}

template <int DQK, int DV, int ROWS>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * static_cast<size_t>(ROWS) * (DQK + 1) +
                          2 * static_cast<size_t>(ROWS) * (DV + 1) +
                          2 * static_cast<size_t>(ROWS) * (ROWS + 1) +
                          3 * ROWS);
}

template <typename T, int DQK, int DV, int ROWS, int TPR>
__global__ void __launch_bounds__(ROWS * TPR)
flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const unsigned char* __restrict__ kv_valid,
                         T* __restrict__ dq, float* __restrict__ di_out,
                         int Tq, int Tk, int H, int causal, float sm_scale) {
  constexpr int NT = ROWS * TPR;
  constexpr int QS = DQK + 1, VS = DV + 1, PS = ROWS + 1;
  constexpr int KPT = ROWS / TPR;         // keys per thread per tile
  constexpr int CPT = DQK / TPR;          // dq columns per thread
  constexpr int VPT = DV / TPR;
  extern __shared__ float smem[];
  float* sq = smem;                       // ROWS x QS
  float* sk = sq + ROWS * QS;             // ROWS x QS
  float* sdo = sk + ROWS * QS;            // ROWS x VS
  float* sv = sdo + ROWS * VS;            // ROWS x VS
  float* sds = sv + ROWS * VS;            // ROWS x PS: the tile's ds
  float* sbias = sds + ROWS * PS;         // ROWS: 0, -1e9 or -inf
  __shared__ int first_valid_slot;

  const int tid = threadIdx.x;
  const int row = tid / TPR, sub = tid % TPR;
  const int q0 = blockIdx.x * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int qi = q0 + row;
  const size_t row_stat = (static_cast<size_t>(b) * H + h) * Tq + qi;

  const int first_valid =
      first_valid_key<NT>(kv_valid, b, Tk, &first_valid_slot);
  stage<T, DQK, ROWS, NT>(sq, q, q0, Tq, H, h, b);
  stage<T, DV, ROWS, NT>(sdo, dout, q0, Tq, H, h, b);

  // di = rowsum(dO * O), over the row's TPR threads
  float di = 0.f;
  if (qi < Tq) {
    const size_t base = ((static_cast<size_t>(b) * Tq + qi) * H + h) * DV;
#pragma unroll 4
    for (int c = 0; c < VPT; ++c) {
      const int d = sub + TPR * c;
      di = fmaf(to_float(dout[base + d]), to_float(o[base + d]), di);
    }
  }
#pragma unroll
  for (int w = 1; w < TPR; w <<= 1)
    di += __shfl_xor_sync(0xffffffffu, di, w);
  if (qi < Tq && sub == 0) di_out[row_stat] = di;
  const float row_lse = qi < Tq ? lse[row_stat] : 0.f;
  const float off =
      first_valid > (causal ? qi : Tk - 1) ? kMasked : 0.f;

  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;

  const int k_end = causal ? min(Tk, min(q0 + ROWS, Tq)) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += ROWS) {
    __syncthreads();                      // the last tile's reads are done
    stage<T, DQK, ROWS, NT>(sk, k, k0, Tk, H, h, b);
    stage<T, DV, ROWS, NT>(sv, v, k0, Tk, H, h, b);
    if (tid < ROWS) {
      const int t = k0 + tid;
      sbias[tid] = t >= Tk ? -INFINITY
                   : (kv_valid != nullptr &&
                      !kv_valid[static_cast<size_t>(b) * Tk + t])
                       ? kMasked
                       : 0.f;
    }
    __syncthreads();

    float s[KPT], dp[KPT];
#pragma unroll
    for (int c = 0; c < KPT; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DQK; ++d) {
      const float qd = sq[row * QS + d];
#pragma unroll
      for (int c = 0; c < KPT; ++c)
        s[c] = fmaf(qd, sk[(sub + TPR * c) * QS + d], s[c]);
    }
#pragma unroll 4
    for (int d = 0; d < DV; ++d) {
      const float gd = sdo[row * VS + d];
#pragma unroll
      for (int c = 0; c < KPT; ++c)
        dp[c] = fmaf(gd, sv[(sub + TPR * c) * VS + d], dp[c]);
    }
#pragma unroll
    for (int c = 0; c < KPT; ++c) {
      const int j = sub + TPR * c;
      float bias = sbias[j];
      if (causal && bias == 0.f && k0 + j > qi) bias = kMasked;
      const float p = expf((s[c] * sm_scale + bias - off) - row_lse);
      sds[row * PS + j] = p * (dp[c] - di);
    }
    __syncwarp();                         // the row's ds are in sds
#pragma unroll 4
    for (int j = 0; j < ROWS; ++j) {
      const float dsj = sds[row * PS + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        acc[c] = fmaf(dsj, sk[j * QS + sub + TPR * c], acc[c]);
    }
  }

  if (qi < Tq) {
    T* dst = dq + ((static_cast<size_t>(b) * Tq + qi) * H + h) * DQK;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      store(dst + sub + TPR * c, acc[c] * sm_scale);
  }
}

template <typename T, int DQK, int DV, int ROWS, int TPR>
__global__ void __launch_bounds__(ROWS * TPR)
flash_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ di,
                          const unsigned char* __restrict__ kv_valid,
                          T* __restrict__ dk, T* __restrict__ dv, int Tq,
                          int Tk, int H, int causal, float sm_scale) {
  constexpr int NT = ROWS * TPR;
  constexpr int QS = DQK + 1, VS = DV + 1, PS = ROWS + 1;
  constexpr int QPT = ROWS / TPR;         // queries per thread per tile
  constexpr int KCPT = DQK / TPR;         // dk columns per thread
  constexpr int VCPT = DV / TPR;          // dv columns per thread
  extern __shared__ float smem[];
  float* sk = smem;                       // ROWS x QS
  float* sq = sk + ROWS * QS;             // ROWS x QS
  float* sv = sq + ROWS * QS;             // ROWS x VS
  float* sdo = sv + ROWS * VS;            // ROWS x VS
  float* sp = sdo + ROWS * VS;            // ROWS keys x PS queries: p
  float* sds = sp + ROWS * PS;            // ROWS keys x PS queries: ds
  float* slse = sds + ROWS * PS;          // ROWS: the query tile's lse
  float* sdi = slse + ROWS;               // ROWS: its di
  float* soff = sdi + ROWS;               // ROWS: its offset (0 or -1e9)
  __shared__ int first_valid_slot;

  const int tid = threadIdx.x;
  const int key = tid / TPR, sub = tid % TPR;
  const int k0 = blockIdx.x * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kj = k0 + key;

  const int first_valid =
      first_valid_key<NT>(kv_valid, b, Tk, &first_valid_slot);
  stage<T, DQK, ROWS, NT>(sk, k, k0, Tk, H, h, b);
  stage<T, DV, ROWS, NT>(sv, v, k0, Tk, H, h, b);
  const float key_bias =
      kj >= Tk ? -INFINITY
      : (kv_valid != nullptr && !kv_valid[static_cast<size_t>(b) * Tk + kj])
          ? kMasked
          : 0.f;

  float acc_k[KCPT], acc_v[VCPT];
#pragma unroll
  for (int c = 0; c < KCPT; ++c) acc_k[c] = 0.f;
#pragma unroll
  for (int c = 0; c < VCPT; ++c) acc_v[c] = 0.f;

  // under causal a query before the key tile sees none of its keys
  const int q_begin = causal ? (k0 / ROWS) * ROWS : 0;
  for (int q0 = q_begin; q0 < Tq; q0 += ROWS) {
    __syncthreads();                      // the last tile's reads are done
    stage<T, DQK, ROWS, NT>(sq, q, q0, Tq, H, h, b);
    stage<T, DV, ROWS, NT>(sdo, dout, q0, Tq, H, h, b);
    if (tid < ROWS) {
      const int t = q0 + tid;
      const size_t at = (static_cast<size_t>(b) * H + h) * Tq + t;
      slse[tid] = t < Tq ? lse[at] : 0.f;
      sdi[tid] = t < Tq ? di[at] : 0.f;
      soff[tid] = first_valid > (causal ? t : Tk - 1) ? kMasked : 0.f;
    }
    __syncthreads();

    float s[QPT], dp[QPT];
#pragma unroll
    for (int c = 0; c < QPT; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DQK; ++d) {
      const float kd = sk[key * QS + d];
#pragma unroll
      for (int c = 0; c < QPT; ++c)
        s[c] = fmaf(sq[(sub + TPR * c) * QS + d], kd, s[c]);
    }
#pragma unroll 4
    for (int d = 0; d < DV; ++d) {
      const float vd = sv[key * VS + d];
#pragma unroll
      for (int c = 0; c < QPT; ++c)
        dp[c] = fmaf(sdo[(sub + TPR * c) * VS + d], vd, dp[c]);
    }
#pragma unroll
    for (int c = 0; c < QPT; ++c) {
      const int i = sub + TPR * c;
      float bias = key_bias;
      if (causal && bias == 0.f && kj > q0 + i) bias = kMasked;
      const float p = expf((s[c] * sm_scale + bias - soff[i]) - slse[i]);
      sp[key * PS + i] = p;
      sds[key * PS + i] = p * (dp[c] - sdi[i]);
    }
    __syncwarp();                         // the key's p and ds are in smem
#pragma unroll 4
    for (int i = 0; i < ROWS; ++i) {
      const float pi = sp[key * PS + i];
      const float dsi = sds[key * PS + i];
#pragma unroll
      for (int c = 0; c < VCPT; ++c)
        acc_v[c] = fmaf(pi, sdo[i * VS + sub + TPR * c], acc_v[c]);
#pragma unroll
      for (int c = 0; c < KCPT; ++c)
        acc_k[c] = fmaf(dsi, sq[i * QS + sub + TPR * c], acc_k[c]);
    }
  }

  if (kj < Tk) {
    const size_t at = (static_cast<size_t>(b) * Tk + kj) * H + h;
    T* dst_k = dk + at * DQK;
    T* dst_v = dv + at * DV;
#pragma unroll
    for (int c = 0; c < KCPT; ++c)
      store(dst_k + sub + TPR * c, acc_k[c] * sm_scale);
#pragma unroll
    for (int c = 0; c < VCPT; ++c) store(dst_v + sub + TPR * c, acc_v[c]);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  const unsigned char* kv_valid;
  void *dq, *dk, *dv;
  float* di;
  int B, Tq, Tk, H, causal;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int D, int ROWS, int TPR>
int launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D, D, ROWS>();
  auto* kernel = flash_attn_bwd_dq_kernel<T, D, D, ROWS, TPR>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Tq + ROWS - 1) / ROWS, a.H, a.B);
  kernel<<<grid, ROWS * TPR, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), a.lse, a.kv_valid,
      static_cast<T*>(a.dq), a.di, a.Tq, a.Tk, a.H, a.causal, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int ROWS, int TPR>
int launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<D, D, ROWS>();
  auto* kernel = flash_attn_bwd_dkv_kernel<T, D, D, ROWS, TPR>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Tk + ROWS - 1) / ROWS, a.H, a.B);
  kernel<<<grid, ROWS * TPR, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.di, a.kv_valid, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Tq,
      a.Tk, a.H, a.causal, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDq>
int dispatch(const Args& a, int D) {
  switch (D) {
    case 64:
      return kDq ? launch_dq<T, 64, 64, 4>(a) : launch_dkv<T, 64, 64, 4>(a);
    case 128:
      return kDq ? launch_dq<T, 128, 64, 4>(a)
                 : launch_dkv<T, 128, 64, 4>(a);
    case 256:
      return kDq ? launch_dq<T, 256, 32, 8>(a)
                 : launch_dkv<T, 256, 32, 8>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, const void* kv_valid,
               void* dq, void* dk, void* dv, void* di, int B, int Tq,
               int Tk, int H, int causal, float sm_scale, void* stream) {
  return Args{q, k, v, o, dout, static_cast<const float*>(lse),
              static_cast<const unsigned char*>(kv_valid), dq, dk, dv,
              static_cast<float*>(di), B, Tq, Tk, H, causal, sm_scale,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() after the launch
// (0 on success). The caller guarantees B, Tq, Tk, H >= 1, D in {64, 128,
// 256}, contiguous (B, T, H, D) device buffers q, o, dout, dq (Tq) and k,
// v, dk, dv (Tk) of one type (bf16 when is_bf16, else fp32), lse and di
// fp32 (B, H, Tq), and kv_valid null or a (B, Tk) byte mask. The dq kernel
// writes dq and di; the dkv kernel, launched after it on the same stream,
// reads di and writes dk and dv.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, const void* kv_valid,
                                 void* dq, void* di, int B, int Tq, int Tk,
                                 int H, int D, int is_bf16, int causal,
                                 float sm_scale, void* stream) {
  const Args a = make_args(q, k, v, o, dout, lse, kv_valid, dq, nullptr,
                           nullptr, di, B, Tq, Tk, H, causal, sm_scale,
                           stream);
  return is_bf16 ? dispatch<__nv_bfloat16, true>(a, D)
                 : dispatch<float, true>(a, D);
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* di,
                                  const void* kv_valid, void* dk, void* dv,
                                  int B, int Tq, int Tk, int H, int D,
                                  int is_bf16, int causal, float sm_scale,
                                  void* stream) {
  const Args a = make_args(q, k, v, nullptr, dout, lse, kv_valid, nullptr,
                           dk, dv, const_cast<void*>(di), B, Tq, Tk, H,
                           causal, sm_scale, stream);
  return is_bf16 ? dispatch<__nv_bfloat16, false>(a, D)
                 : dispatch<float, false>(a, D);
}
