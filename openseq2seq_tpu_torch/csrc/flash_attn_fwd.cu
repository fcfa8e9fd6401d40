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
// Two kernels:
//  * bf16, the main path: `flash_attn_fwd_mma_kernel`, both products on
//    the tensor cores (mma.sync m16n8k16, bf16 operands, fp32
//    accumulation), rounding where JAX's stock kernel rounds: its key
//    block is 128 keys, kRoundBlock. Up to 64 keys (the NMT shapes) the
//    keys are one 64-key tile; past 64, one tile is a whole 128-key block,
//    scored before any of its weights is exponentiated. When the keys fit
//    one tile (Tk <= 64, or Tk <= 128), the weights are normalised first,
//    p / l, and rounded to v's type for P.V, as the stock kernel's
//    single-step variant does (flash_attention.py:547, :556); past 128 keys
//    p = exp(s - m) is rounded against the running maximum m, which moves
//    once a 128-key block, l sums it unrounded and the output is scaled by
//    1 / l at the end, as its multi-step variant does (:471). A CTA of 4
//    warps (8 at D = 256; shapes in flash_attn.cuh)
//    owns 64 queries (32 at D = 256), each warp 16 rows. The tile's q and
//    each K/V tile are copied into bf16 shared-memory tiles with
//    16-byte cp.async, K/V double-buffered when Tk spans several tiles, so
//    the next tile loads while this one is computed; fragments come from
//    the tiles by ldmatrix (v's transposed), free of bank conflicts. The
//    scores' accumulators carry the online softmax (a row in the four lanes
//    of a quad) and the rounded weights become P.V's A fragments in
//    registers: P never goes through shared memory. The output is
//    gathered in the q tile and written with 16-byte stores. Shared
//    memory 28 KB at D = 64 with one key tile (the NMT shapes), so that
//    registers rather than shared memory bound the CTAs an SM holds; the
//    128-key tiles are single-buffered where two stages would not fit
//    (D = 256).
//  * fp32: `flash_attn_fwd_kernel` on the CUDA cores (TF32 would round the
//    operands), kept for the card-against-CPU checks:
//    - one CTA per (64-query tile, head, batch row); 256 threads, four per
//      query row, so a row's online-softmax state lives in one quad of
//      lanes and is combined with two xor-shuffles;
//    - q is staged once and each 64-key K/V tile in turn in shared memory
//      as fp32, rows padded by one float so that the eight rows a warp
//      reads fall in eight banks; dynamic shared memory (66 KB at D=64,
//      214 KB at D=256) is requested with cudaFuncSetAttribute;
//    - scores and P.V are fp32 FMAs from shared memory: each thread
//      computes 16 scores of its row, then its D/4 output columns from the
//      row's 64 weights, which go through shared memory.
//    The q.k head dim DQK and the v head dim DV are separate template
//    parameters (instantiated equal here).
// In both, under `causal`, key tiles wholly above the tile's last query
// are skipped: each row keeps its diagonal key, so skipping is exact.
//
// For training the caller passes an fp32 `lse` (B, H, Tq), which receives
// each row's log-sum-exp m + log(l) (relative to the mask value for a row
// without any valid key); flash_attn_bwd.cu recomputes the weights from
// it. Inference passes null and writes nothing more.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_attn.cuh"

namespace {

constexpr int kRows = 64;                 // queries per CTA
constexpr int kKeys = 64;                 // keys per K/V tile
constexpr int kTpr = 4;                   // threads per query row
constexpr int kThreads = kRows * kTpr;    // 256
using flash_attn::kMasked;                // -1e9

// the CUDA-core kernels' loads and stores (fp32)
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---- bf16: tensor cores ------------------------------------------------
template <int D, int KB>
size_t mma_smem_bytes(int stages) {
  using C = flash_attn::Shape<D>;
  return sizeof(__nv_bfloat16) * (static_cast<size_t>(C::ROWS) * C::S +
                                  2 * static_cast<size_t>(stages) * KB *
                                      C::S) +
         sizeof(float) * KB;
}

// KB keys a streamed tile, which is the rounding block: 64 when Tk <= 64
// (the NMT shapes), else kRoundBlock = 128
template <int D, int KB>
__global__ void __launch_bounds__(flash_attn::Shape<D>::THREADS)
flash_attn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const unsigned char* __restrict__ kv_valid,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int Tq, int Tk, int H,
                          int causal, float sm_scale, int stages) {
  using namespace flash_attn;
  using C = Shape<D>;
  constexpr int S = C::S, ROWS = C::ROWS, NT = C::THREADS, NS = KB / 8;
  static_assert(NT >= KB, "one thread a key of the tile's mask");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* sq = reinterpret_cast<bf16*>(smem_raw);       // ROWS x S
  bf16* skv = sq + ROWS * S;                          // stages x (K, V)
  auto* sbias = reinterpret_cast<float*>(skv + 2 * stages * KB * S);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rg = warp % C::RG, c0 = (warp / C::RG) * 64;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int r0 = rg * 16;                 // the warp's rows in the tile
  const int qi[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  // under causal no row of this tile sees a key past its last real query
  const int k_end = causal ? min(Tk, min(q0 + ROWS, Tq)) : Tk;
  const int n_tiles = (k_end + KB - 1) / KB;
  // one block: the weights are final before they are rounded
  const bool normalized = Tk <= KB;
  stage_rows<D, NT>(sq, q, q0, ROWS, Tq, H, h, b);
  stage_rows<D, NT>(skv, k, 0, KB, Tk, H, h, b);
  stage_rows<D, NT>(skv + KB * S, v, 0, KB, Tk, H, h, b);
  cp_async_commit();

  float o[8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * KB;
    const bf16* sk = skv + 2 * (stages == 2 ? i & 1 : 0) * KB * S;
    const bf16* sv = sk + KB * S;
    const bool prefetch = stages == 2 && i + 1 < n_tiles;
    if (prefetch) {                       // the next tile, into the other stage
      bf16* nk = skv + 2 * ((i + 1) % 2) * KB * S;
      stage_rows<D, NT>(nk, k, k0 + KB, KB, Tk, H, h, b);
      stage_rows<D, NT>(nk + KB * S, v, k0 + KB, KB, Tk, H, h, b);
      cp_async_commit();
    }
    if (threadIdx.x < KB)
      sbias[threadIdx.x] = key_bias(kv_valid, b, k0 + threadIdx.x, Tk);
    if (prefetch)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();

    // S = q k^T for the warp's 16 rows and the tile's KB keys: the whole
    // rounding block is scored before any weight is exponentiated
    float s[NS][4] = {};
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      unsigned a[4];
      a_frag(a, sq, S, r0, kk);
      mma_row<true>(s, a, sk, S, 0, kk);
    }

    // the online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * n + 2 * t4 + (e & 1);
        float bias = sbias[j];
        if (causal && bias == 0.f && k0 + j > qi[e / 2]) bias = kMasked;
        s[n][e] = s[n][e] * sm_scale + bias;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float rescale[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key k0 < Tk is in every tile, so the new maximum is finite
      const float m_new = fmaxf(m[r], mx[r]);
      rescale[r] = expf(m[r] - m_new);    // 0 on the first tile
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e / 2]);   // 0 for keys past Tk
        sum[e / 2] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * rescale[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] *= rescale[0];
      o[n][1] *= rescale[0];
      o[n][2] *= rescale[1];
      o[n][3] *= rescale[1];
    }

    if (normalized)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = s[n][e] / l[e / 2];
    // O += P v over the warp's 64 columns: the weights, rounded to bf16,
    // are the A fragments of the KB / 16 key steps
#pragma unroll
    for (int ks = 0; ks < KB / 16; ++ks) {
      unsigned a[4];
      acc_frag(a, s, ks);
      mma_row<false>(o, a, sv, S, c0, 16 * ks);
    }
    __syncthreads();                      // this stage and sbias are free
    if (stages == 1 && i + 1 < n_tiles) {   // the next tile, into the stage
      bf16* nk = skv;
      stage_rows<D, NT>(nk, k, k0 + KB, KB, Tk, H, h, b);
      stage_rows<D, NT>(nk + KB * S, v, k0 + KB, KB, Tk, H, h, b);
      cp_async_commit();
    }
  }

  // the output through the q tile, then 16-byte stores
  put_acc(sq, S, r0, c0, o, normalized ? 1.f : 1.f / l[0],
          normalized ? 1.f : 1.f / l[1]);
  __syncthreads();
  store_rows<D, NT>(out, sq, q0, ROWS, Tq, H, h, b);
  // the rows' log-sum-exp, as the fp32 kernel below stores it
  if (lse != nullptr) {
    const int first_valid = first_valid_key(kv_valid, b, Tk);
    if (c0 == 0 && t4 == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (qi[r] < Tq) {
          const bool none = first_valid > (causal ? qi[r] : Tk - 1);
          lse[(static_cast<size_t>(b) * H + h) * Tq + qi[r]] =
              (none ? m[r] - kMasked : m[r]) + logf(l[r]);
        }
  }
}

// the card's shared memory a block can use
constexpr size_t kSmemLimit = 232448;

template <int D, int KB>
int launch_mma_kb(const void* q, const void* k, const void* v,
                  const unsigned char* kv_valid, void* out, float* lse,
                  int B, int Tq, int Tk, int H, int causal, float sm_scale,
                  cudaStream_t stream) {
  using C = flash_attn::Shape<D>;
  using bf16 = __nv_bfloat16;
  // double-buffered when several tiles stream and two stages fit
  const int stages =
      Tk > KB && mma_smem_bytes<D, KB>(2) <= kSmemLimit ? 2 : 1;
  const size_t smem = mma_smem_bytes<D, KB>(stages);
  auto* kernel = flash_attn_fwd_mma_kernel<D, KB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + C::ROWS - 1) / C::ROWS, H, B);
  kernel<<<grid, C::THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kv_valid, static_cast<bf16*>(out), lse,
      Tq, Tk, H, causal, sm_scale, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v,
               const unsigned char* kv_valid, void* out, float* lse, int B,
               int Tq, int Tk, int H, int causal, float sm_scale,
               cudaStream_t stream) {
  if (Tk <= flash_attn::kTile)
    return launch_mma_kb<D, flash_attn::kTile>(
        q, k, v, kv_valid, out, lse, B, Tq, Tk, H, causal, sm_scale, stream);
  return launch_mma_kb<D, mma_sync::kRoundBlock>(
      q, k, v, kv_valid, out, lse, B, Tq, Tk, H, causal, sm_scale, stream);
}

template <int D>
int launch_d(const void* q, const void* k, const void* v,
             const unsigned char* kv_valid, void* out, float* lse, int B,
             int Tq, int Tk, int H, int is_bf16, int causal, float sm_scale,
             cudaStream_t stream) {
  return is_bf16 ? launch_mma<D>(q, k, v, kv_valid, out, lse, B, Tq, Tk, H,
                                 causal, sm_scale, stream)
                 : launch<float, D>(q, k, v, kv_valid, out, lse, B, Tq, Tk,
                                    H, causal, sm_scale, stream);
}

int dispatch(const void* q, const void* k, const void* v,
             const unsigned char* kv_valid, void* out, float* lse, int B,
             int Tq, int Tk, int H, int D, int is_bf16, int causal,
             float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_d<64>(q, k, v, kv_valid, out, lse, B, Tq, Tk, H, is_bf16,
                          causal, sm_scale, stream);
    case 128:
      return launch_d<128>(q, k, v, kv_valid, out, lse, B, Tq, Tk, H,
                           is_bf16, causal, sm_scale, stream);
    case 256:
      return launch_d<256>(q, k, v, kv_valid, out, lse, B, Tq, Tk, H,
                           is_bf16, causal, sm_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success). The caller guarantees B, Tq, Tk, H >= 1, D in {64, 128, 256},
// contiguous (B, T, H, D) device buffers of one type (bf16 when is_bf16,
// else fp32; bf16 ones 16-byte aligned), kv_valid null or a (B, Tk) byte
// mask, and lse null or a (B, H, Tq) fp32 buffer, which then receives each
// row's m + log(l).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* kv_valid, void* out, void* lse,
                              int B, int Tq, int Tk, int H, int D,
                              int is_bf16, int causal, float sm_scale,
                              void* stream) {
  const auto* mask = static_cast<const unsigned char*>(kv_valid);
  auto* lse_out = static_cast<float*>(lse);
  return dispatch(q, k, v, mask, out, lse_out, B, Tq, Tk, H, D, is_bf16,
                  causal, sm_scale, static_cast<cudaStream_t>(stream));
}
