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
// scratch that the dkv kernel reads. Then ds = p * (dO v^T - di) * sm_scale,
// dq = ds k, dk = ds^T q, dv = p^T dO.
//
// What bounds it on an H100: bytes. At the transformer-big encoder shape
// (B=64, H=16, Tq=Tk=64, D=64, bf16) it must read q, k, v, o and dO (8.4 MB
// each) and lse, and write dq, dk and dv: 67.4 MB, 20 us at 3.35 TB/s,
// against 10 * B*H*Tq*Tk*D = 2.7 GFLOP, 2.7 us at 989 TFLOP/s.
//
// Two designs:
//  * bf16, the main path: all five products on the tensor cores (mma.sync
//    m16n8k16, bf16 operands, fp32 accumulation), with the operands
//    rounded where JAX's stock kernels round them: p^T to dO's type for dv
//    (flash_attention.py:900), ds^T for dk (:918), ds for dq (:1251-1258);
//    p, di and ds themselves in fp32. CTA shapes, 16-byte cp.async staging
//    into padded bf16 tiles and ldmatrix fragments are flash_attn.cuh's.
//    - dq (`flash_attn_bwd_dq_mma_kernel`): a CTA owns 64 queries (32 at
//      D = 256), stages their q and dO once and streams 64-key K/V tiles,
//      double-buffered when Tk spans several; di is computed from o and dO
//      while the first tiles load. Per tile a warp computes S = q k^T and
//      dP = dO v^T for its 16 rows, ds in registers, and dq += ds k with
//      ds as the A fragments and k read transposed by ldmatrix.
//    - dkv (`flash_attn_bwd_dkv_mma_kernel`): a CTA owns 64 keys (32 at D
//      = 256), stages their k and v once and streams 64-query q/dO tiles
//      (with their lse, di and offsets), double-buffered. A warp computes
//      the transposed S^T = k q^T and dP^T = v dO^T for its 16 keys, so
//      that P^T and dS^T are A fragments in registers for dv += P^T dO and
//      dk += dS^T q, with dO and q read transposed by ldmatrix: nothing is
//      staged twice or transposed by hand.
//    P and dS never go through shared memory; the gradients are gathered
//    in the tiles that held q (or k and v) and written with 16-byte
//    stores. Under causal, tiles that a mask removes whole are skipped.
//  * fp32: fp32 FMAs on the CUDA cores (TF32 would round the operands),
//    kept for the card-against-CPU checks:
//    - dq: one CTA per (query tile, head, batch row), TPR threads per
//      query row; q and dO staged once, each K/V tile in turn, in shared
//      memory as fp32 with rows padded by one float; a thread computes the
//      scores and dO.v of ROWS/TPR keys of its row, the row's ds go through
//      shared memory, and the thread accumulates DQK/TPR columns of dq.
//      Under causal, key tiles past the tile's last query are skipped, as
//      in the forward.
//    - dkv: one CTA per (key tile, head, batch row), TPR threads per key;
//      K/V staged once, each Q/dO tile (with its lse and di) in turn; a
//      thread computes p and ds of its key for ROWS/TPR queries, the key's
//      p and ds go through shared memory, and the thread accumulates
//      DQK/TPR columns of dk and DV/TPR of dv. Under causal, query tiles
//      wholly before the key tile are skipped (their p is exactly 0).
//    - ROWS = 64 and TPR = 4 at D = 64 and 128; at D = 256 fp32 staging of
//      64-row tiles would exceed 227 KB of shared memory, so ROWS = 32 and
//      TPR = 8 there (140 KB). DQK and DV are separate template parameters
//      (instantiated equal here), so a kernel with Dqk != Dv can reuse
//      these.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_attn.cuh"

namespace {

using flash_attn::kMasked;                // -1e9

// the CUDA-core kernels' loads and stores (fp32)
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---- bf16: tensor cores ------------------------------------------------
// dq: q and dO (ROWS each), stages x (K, V) (kTile each), the key tile's
// bias and the rows' lse and di
template <int D>
size_t dq_mma_smem_bytes(int stages) {
  using C = flash_attn::Shape<D>;
  return sizeof(__nv_bfloat16) * C::S *
             (2 * static_cast<size_t>(C::ROWS) +
              2 * static_cast<size_t>(stages) * flash_attn::kTile) +
         sizeof(float) * (flash_attn::kTile + 2 * C::ROWS);
}

// dkv: k and v (ROWS each), stages x (q, dO) (kTile each), and the query
// tile's lse, di and offset
template <int D>
size_t dkv_mma_smem_bytes(int stages) {
  using C = flash_attn::Shape<D>;
  return sizeof(__nv_bfloat16) * C::S *
             (2 * static_cast<size_t>(C::ROWS) +
              2 * static_cast<size_t>(stages) * flash_attn::kTile) +
         sizeof(float) * 3 * flash_attn::kTile;
}

template <int D>
__global__ void __launch_bounds__(flash_attn::Shape<D>::THREADS)
flash_attn_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ o,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const unsigned char* __restrict__ kv_valid,
                             __nv_bfloat16* __restrict__ dq,
                             float* __restrict__ di_out, int Tq, int Tk,
                             int H, int causal, float sm_scale, int stages) {
  using namespace flash_attn;
  using C = Shape<D>;
  constexpr int S = C::S, ROWS = C::ROWS, NT = C::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* sq = reinterpret_cast<bf16*>(smem_raw);       // ROWS x S
  bf16* sdo = sq + ROWS * S;                          // ROWS x S
  bf16* skv = sdo + ROWS * S;                         // stages x (K, V)
  auto* sbias = reinterpret_cast<float*>(skv + 2 * stages * kTile * S);
  float* slse = sbias + kTile;                        // ROWS
  float* sdi = slse + ROWS;                           // ROWS

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rg = warp % C::RG, c0 = (warp / C::RG) * 64;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int r0 = rg * 16;
  const int qi[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  const int k_end = causal ? min(Tk, min(q0 + ROWS, Tq)) : Tk;
  const int n_tiles = (k_end + kTile - 1) / kTile;
  stage_rows<D, NT>(sq, q, q0, ROWS, Tq, H, h, b);
  stage_rows<D, NT>(sdo, dout, q0, ROWS, Tq, H, h, b);
  stage_rows<D, NT>(skv, k, 0, kTile, Tk, H, h, b);
  stage_rows<D, NT>(skv + kTile * S, v, 0, kTile, Tk, H, h, b);
  cp_async_commit();

  {
    // while they load: di = rowsum(dO * O), NT / ROWS threads a row, 32
    // columns each, 16-byte loads, summed in a fixed order
    constexpr int TPR = NT / ROWS;
    const int row = threadIdx.x / TPR, sub = threadIdx.x % TPR;
    const int t = q0 + row;
    float d = 0.f;
    if (t < Tq) {
      const size_t base =
          ((static_cast<size_t>(b) * Tq + t) * H + h) * D + sub * 32;
#pragma unroll
      for (int c = 0; c < 32; c += 8) {
        const uint4 gd = *reinterpret_cast<const uint4*>(dout + base + c);
        const uint4 go = *reinterpret_cast<const uint4*>(o + base + c);
        const auto* a = reinterpret_cast<const __nv_bfloat162*>(&gd);
        const auto* z = reinterpret_cast<const __nv_bfloat162*>(&go);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(a[e]);
          const float2 y = __bfloat1622float2(z[e]);
          d = fmaf(x.x, y.x, d);
          d = fmaf(x.y, y.y, d);
        }
      }
    }
#pragma unroll
    for (int w = 1; w < TPR; w <<= 1)
      d += __shfl_xor_sync(0xffffffffu, d, w);
    if (sub == 0) {
      const size_t at = (static_cast<size_t>(b) * H + h) * Tq + t;
      sdi[row] = d;
      slse[row] = t < Tq ? lse[at] : 0.f;
      if (t < Tq) di_out[at] = d;
    }
  }
  const int first_valid = flash_attn::first_valid_key(kv_valid, b, Tk);
  float off[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    off[r] = first_valid > (causal ? qi[r] : Tk - 1) ? kMasked : 0.f;

  float acc[8][4] = {};
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * kTile;
    const bf16* sk = skv + 2 * (i & 1) * kTile * S;
    const bf16* sv = sk + kTile * S;
    if (i + 1 < n_tiles) {
      bf16* nk = skv + 2 * ((i + 1) & 1) * kTile * S;
      stage_rows<D, NT>(nk, k, k0 + kTile, kTile, Tk, H, h, b);
      stage_rows<D, NT>(nk + kTile * S, v, k0 + kTile, kTile, Tk, H, h, b);
      cp_async_commit();
    }
    if (threadIdx.x < kTile)
      sbias[threadIdx.x] = key_bias(kv_valid, b, k0 + threadIdx.x, Tk);
    if (i + 1 < n_tiles)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();                      // (the first time: sdi, slse too)

    float s[8][4] = {}, dp[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      unsigned a[4];
      a_frag(a, sq, S, r0, kk);
      mma_row<true>(s, a, sk, S, 0, kk);
      a_frag(a, sdo, S, r0, kk);
      mma_row<true>(dp, a, sv, S, 0, kk);
    }
    const float row_lse[2] = {slse[r0 + g], slse[r0 + g + 8]};
    const float row_di[2] = {sdi[r0 + g], sdi[r0 + g + 8]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * n + 2 * t4 + (e & 1), r = e / 2;
        float bias = sbias[j];
        if (causal && bias == 0.f && k0 + j > qi[r]) bias = kMasked;
        const float p =
            expf((s[n][e] * sm_scale + bias - off[r]) - row_lse[r]);
        dp[n][e] = p * (dp[n][e] - row_di[r]) * sm_scale;
      }
    // dq += ds k: ds rounded to bf16 as the A fragments, k transposed
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      unsigned a[4];
      acc_frag(a, dp, ks);
      mma_row<false>(acc, a, sk, S, c0, 16 * ks);
    }
    __syncthreads();                      // this stage and sbias are free
  }

  put_acc(sq, S, r0, c0, acc, 1.f, 1.f);
  __syncthreads();
  store_rows<D, NT>(dq, sq, q0, ROWS, Tq, H, h, b);
}

template <int D>
__global__ void __launch_bounds__(flash_attn::Shape<D>::THREADS)
flash_attn_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ di,
                              const unsigned char* __restrict__ kv_valid,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int Tq, int Tk,
                              int H, int causal, float sm_scale, int stages) {
  using namespace flash_attn;
  using C = Shape<D>;
  constexpr int S = C::S, ROWS = C::ROWS, NT = C::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* sk = reinterpret_cast<bf16*>(smem_raw);       // ROWS x S
  bf16* sv = sk + ROWS * S;                           // ROWS x S
  bf16* sqd = sv + ROWS * S;                          // stages x (q, dO)
  auto* slse = reinterpret_cast<float*>(sqd + 2 * stages * kTile * S);
  float* sdi = slse + kTile;                          // kTile
  float* soff = sdi + kTile;                          // kTile

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rg = warp % C::RG, c0 = (warp / C::RG) * 64;
  const int k0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int r0 = rg * 16;
  const int kj[2] = {k0 + r0 + g, k0 + r0 + g + 8};

  // under causal a query before the key tile sees none of its keys
  const int q_begin = causal ? (k0 / kTile) * kTile : 0;
  const int n_tiles = max(0, (Tq - q_begin + kTile - 1) / kTile);
  stage_rows<D, NT>(sk, k, k0, ROWS, Tk, H, h, b);
  stage_rows<D, NT>(sv, v, k0, ROWS, Tk, H, h, b);
  if (n_tiles > 0) {
    stage_rows<D, NT>(sqd, q, q_begin, kTile, Tq, H, h, b);
    stage_rows<D, NT>(sqd + kTile * S, dout, q_begin, kTile, Tq, H, h, b);
  }
  cp_async_commit();
  const int first_valid = flash_attn::first_valid_key(kv_valid, b, Tk);
  const float kbias[2] = {key_bias(kv_valid, b, kj[0], Tk),
                          key_bias(kv_valid, b, kj[1], Tk)};

  float acc_k[8][4] = {}, acc_v[8][4] = {};
  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = q_begin + i * kTile;
    const bf16* sq = sqd + 2 * (i & 1) * kTile * S;
    const bf16* sdo = sq + kTile * S;
    if (i + 1 < n_tiles) {
      bf16* nq = sqd + 2 * ((i + 1) & 1) * kTile * S;
      stage_rows<D, NT>(nq, q, q0 + kTile, kTile, Tq, H, h, b);
      stage_rows<D, NT>(nq + kTile * S, dout, q0 + kTile, kTile, Tq, H, h, b);
      cp_async_commit();
    }
    if (threadIdx.x < kTile) {
      // a query past Tq gets lse = +inf: its weights are exactly 0
      const int t = q0 + threadIdx.x;
      const size_t at = (static_cast<size_t>(b) * H + h) * Tq + t;
      slse[threadIdx.x] = t < Tq ? lse[at] : INFINITY;
      sdi[threadIdx.x] = t < Tq ? di[at] : 0.f;
      soff[threadIdx.x] = first_valid > (causal ? t : Tk - 1) ? kMasked : 0.f;
    }
    if (i + 1 < n_tiles)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();

    // S^T = k q^T and dP^T = v dO^T for the warp's 16 keys
    float s[8][4] = {}, dp[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      unsigned a[4];
      a_frag(a, sk, S, r0, kk);
      mma_row<true>(s, a, sq, S, 0, kk);
      a_frag(a, sv, S, r0, kk);
      mma_row<true>(dp, a, sdo, S, 0, kk);
    }
    // the weights of the warp's keys (rows g, g + 8) and the tile's
    // queries (columns 8 n + 2 t4 + e % 2)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * n + 2 * t4 + (e & 1), r = e / 2;
        float bias = kbias[r];
        if (causal && bias == 0.f && kj[r] > q0 + j) bias = kMasked;
        const float p =
            expf((s[n][e] * sm_scale + bias - soff[j]) - slse[j]);
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - sdi[j]) * sm_scale;
      }
    // dv += P^T dO, dk += dS^T q: both rounded to bf16 as the A fragments,
    // dO and q transposed
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      unsigned a[4];
      acc_frag(a, s, ks);
      mma_row<false>(acc_v, a, sdo, S, c0, 16 * ks);
      acc_frag(a, dp, ks);
      mma_row<false>(acc_k, a, sq, S, c0, 16 * ks);
    }
    __syncthreads();                      // this stage and the rows' stats
  }
  if (n_tiles == 0) cp_async_wait<0>();   // k and v, never read
  __syncthreads();

  put_acc(sk, S, r0, c0, acc_k, 1.f, 1.f);
  put_acc(sv, S, r0, c0, acc_v, 1.f, 1.f);
  __syncthreads();
  store_rows<D, NT>(dk, sk, k0, ROWS, Tk, H, h, b);
  store_rows<D, NT>(dv, sv, k0, ROWS, Tk, H, h, b);
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

template <int D>
int launch_dq_mma(const Args& a) {
  using C = flash_attn::Shape<D>;
  using bf16 = __nv_bfloat16;
  const int stages = a.Tk > flash_attn::kTile ? 2 : 1;
  const size_t smem = dq_mma_smem_bytes<D>(stages);
  auto* kernel = flash_attn_bwd_dq_mma_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Tq + C::ROWS - 1) / C::ROWS, a.H, a.B);
  kernel<<<grid, C::THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.o),
      static_cast<const bf16*>(a.dout), a.lse, a.kv_valid,
      static_cast<bf16*>(a.dq), a.di, a.Tq, a.Tk, a.H, a.causal, a.sm_scale,
      stages);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_mma(const Args& a) {
  using C = flash_attn::Shape<D>;
  using bf16 = __nv_bfloat16;
  const int stages = a.Tq > flash_attn::kTile ? 2 : 1;
  const size_t smem = dkv_mma_smem_bytes<D>(stages);
  auto* kernel = flash_attn_bwd_dkv_mma_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Tk + C::ROWS - 1) / C::ROWS, a.H, a.B);
  kernel<<<grid, C::THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.di, a.kv_valid, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.Tq, a.Tk, a.H, a.causal, a.sm_scale, stages);
  return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores, fp32 on the CUDA cores (ROWS and TPR as above)
template <bool kDq>
int dispatch(const Args& a, int D, int is_bf16) {
  switch (D) {
    case 64:
      if (is_bf16) return kDq ? launch_dq_mma<64>(a) : launch_dkv_mma<64>(a);
      return kDq ? launch_dq<float, 64, 64, 4>(a)
                 : launch_dkv<float, 64, 64, 4>(a);
    case 128:
      if (is_bf16)
        return kDq ? launch_dq_mma<128>(a) : launch_dkv_mma<128>(a);
      return kDq ? launch_dq<float, 128, 64, 4>(a)
                 : launch_dkv<float, 128, 64, 4>(a);
    case 256:
      if (is_bf16)
        return kDq ? launch_dq_mma<256>(a) : launch_dkv_mma<256>(a);
      return kDq ? launch_dq<float, 256, 32, 8>(a)
                 : launch_dkv<float, 256, 32, 8>(a);
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
// v, dk, dv (Tk) of one type (bf16 when is_bf16, else fp32; bf16 ones
// 16-byte aligned), lse and di fp32 (B, H, Tq), and kv_valid null or a
// (B, Tk) byte mask. The dq kernel
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
  return dispatch<true>(a, D, is_bf16);
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
  return dispatch<false>(a, D, is_bf16);
}
