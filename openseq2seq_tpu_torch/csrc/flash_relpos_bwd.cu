// Rel-pos flash attention backward: per (batch row, head), the gradients
// of o = softmax(q~ k~^T * scale, keys j >= len masked) v with respect to
// q~ = [q+u ; A ; B], the first Dh columns of k~ = [k ; cos_j ; sin_j]
// (the rest of k~ is a constant table) and v, in the FlashAttention-2
// split: a dq kernel over query tiles, then a dkv kernel over key tiles.
// No atomics, so two calls give identical bits.
//
// Replaces `_dq_kernel` and `_dkv_kernel` in openseq2seq_tpu/ops/
// flash_relpos.py:218 and :167 (their pallas_calls at :318 and :291, run
// by `_bwd_pallas`, :253, under the VJP `_rel_vjp_bwd`, :547), at their
// precision: delta = rowsum(do * o) in fp32 over the forward's o in the
// inputs' type (JAX computes it outside its kernels; here the dq kernel
// computes it and writes a (B, H, T) scratch that the dkv kernel reads);
// p = exp(s * scale - lse) over keys t < max(len, 1) and 0 elsewhere, with
// fp32 scores; dv = p^T do with p rounded to the inputs' type; ds = p (dp -
// delta) * scale in fp32, rounded to the inputs' type for dk = ds^T q~[:,
// :Dh] and dq~ = ds k~; all sums in fp32, the gradients in the inputs'
// type. Query rows t >= len are computed like the others (they carry
// gradients); rows and keys past T are zeros.
//
// Inputs are read where the module has them, as flash_relpos_fwd.cu reads
// them: qu, k, v, o and do (B, T, H, Dh), qp (B, H, T, D) and the shared
// key table kp (T, D); q~ and k~ are never written to device memory whole.
// dq~ is written as dqu (B, T, H, Dh) and dqp (B, H, T, D), the layouts of
// qu and qp.
//
// What bounds it on an H100: bytes and operations about evenly. At
// Conformer-M (B=64, H=4, T=250, Dh=64, D=256, bf16) the dq kernel does 2
// (Dh + D) + 2 Dh + 2 (Dh + D) = 1408 FLOP per (query, valid key) pair (the
// scores, dO.v, dq~) and the dkv kernel 2 (Dh + D) + 3 x 2 Dh = 1024 (the
// scores, dO.v, dv, dk): 38.9 GFLOP over the 16.0 M pairs (39 us at 989
// TFLOP/s), against 115 MB that the dq kernel must move and 83 MB the dkv
// kernel (34 + 25 us at 3.35 TB/s).
//
// Design (a pair that is right and simple; wgmma, TMA and asynchronous
// staging are later work):
//  * bf16, the main path: tensor cores through mma.sync m16n8k16 (bf16
//    operands, fp32 accumulation, the TPU kernels' precision), tiles of 64
//    queries and 64 keys staged in shared memory in bf16, fragments read
//    straight from it at row strides (Dh + D + 8, Dh + 8 and 72 elements)
//    that put a fragment's 32 words in 32 banks, as flash_relpos_fwd.cu
//    does. The weights p and ds, rounded to bf16 as the TPU kernels round
//    them, become the next product's A fragments in place.
//    - dkv: one CTA of 4 warps per (64-key tile, head, batch row), each
//      warp 16 keys. It computes the transposed scores S^T = k~ q~^T and
//      dP^T = v dO^T of each query tile, so that P^T and dS^T are A
//      fragments for dv += P^T dO and dk += dS^T q~[:, :Dh]; dO and
//      q~[:, :Dh] are staged transposed for those B operands. 118 KB of
//      shared memory at Conformer-M, 183 KB at Conformer-L.
//    - dq: one CTA of 8 warps per (64-query tile, head, batch row). Its
//      accumulator is Dh + D columns wide (320 at Conformer-M, 576 at
//      Conformer-L), too many registers for one warp's 16 rows, so the two
//      warps of a row group split the columns, 20 n-tiles each at
//      Conformer-M (36 at -L). They split the scores' contraction the same
//      way and add the two partial scores through shared memory in a fixed
//      order, so both hold the same scores; both compute dP (over Dh) and
//      the weights. dq~'s B operand (key, column) comes from k~'s rows, two
//      16-bit loads a register. 133 KB at Conformer-M, 197 KB at -L.
//  * fp32: fp32 FMAs on the CUDA cores (TF32 would round the operands),
//    256 threads a CTA, four per row, operands staged in shared memory as
//    fp32 and read with 16-byte loads; the scores summed over Dh + D in
//    chunks of 32 columns of q~ and k~ staged together; dq~'s accumulator
//    in shared memory as fp32, each thread adding its row's 8 columns of a
//    32-column chunk of ds k~; dk and dv in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_sync.cuh"

namespace {

using namespace mma_sync;

constexpr int kRows = 64;                 // queries (dq) or keys (dkv) a CTA
constexpr int kTpr = 4;                   // threads per row
constexpr int kThreads = kRows * kTpr;    // 256
constexpr int kPer = kRows / kTpr;        // scores a thread per tile: 16
constexpr int kChunk = 32;                // q~ / k~ columns staged at once
constexpr int kCS = kChunk + 4;           // chunk row stride (floats)
constexpr int kPS = kRows + 4;            // p / ds row stride (floats)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows t0 .. t0 + 63, columns c0 .. c0 + 31 of an augmented matrix [head |
// pos] into dst (kRows x kCS floats): head (B, T, H, Dh) for c0 < Dh, else
// pos_bh, the (T, D) rows of this (batch row, head) (qp's, or the shared
// table kp). Dh and D are multiples of 32, so a chunk lies in one part.
__device__ __forceinline__ void stage_chunk(float* dst, const float* head,
                                            const float* pos_bh, int t0,
                                            int c0,
                                            int Tn, int H, int h, int b,
                                            int DV, int D) {
  for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
    const int r = i / kChunk, d = i % kChunk, t = t0 + r, col = c0 + d;
    float x = 0.f;
    if (t < Tn)
      x = col < DV ? head[((static_cast<size_t>(b) * Tn + t) * H + h) * DV +
                          col]
                   : pos_bh[static_cast<size_t>(t) * D + col - DV];
    dst[r * kCS + d] = x;
  }
}

// rows t0 .. t0 + 63 of a (B, T, H, DV) tensor into dst (kRows x (DV + 4))
template <int DV>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int t0,
                                           int Tn, int H, int h, int b) {
  for (int i = threadIdx.x; i < kRows * DV; i += kThreads) {
    const int r = i / DV, d = i % DV, t = t0 + r;
    dst[r * (DV + 4) + d] =
        t < Tn ? src[((static_cast<size_t>(b) * Tn + t) * H + h) * DV + d]
               : 0.f;
  }
}

// s[c] += (row `mine` of the first chunk) . (row sub + 4 c of the second),
// summed over the whole q~ . k~ width, chunk by chunk; `kQMine` says
// whether the thread's own row is a query (dq) or a key (dkv). Ends with
// the last chunk's reads pending: callers sync before restaging.
template <bool kQMine>
__device__ __forceinline__ void scores(float (&s)[kPer], float* sqc,
                                       float* skc, const float* qu,
                                       const float* qp_bh, const float* k,
                                       const float* kp, int q0, int k0, int Tn,
                                       int H, int h, int b, int DV, int D,
                                       int mine, int sub) {
#pragma unroll
  for (int c = 0; c < kPer; ++c) s[c] = 0.f;
  const float* own = (kQMine ? sqc : skc) + mine * kCS;
  const float* other = kQMine ? skc : sqc;
  for (int c0 = 0; c0 < DV + D; c0 += kChunk) {
    __syncthreads();                      // the last chunk's reads are done
    stage_chunk(sqc, qu, qp_bh, q0, c0, Tn, H, h, b, DV, D);
    stage_chunk(skc, k, kp, k0, c0, Tn, H, h, b, DV, D);
    __syncthreads();
#pragma unroll 2
    for (int d = 0; d < kChunk; d += 4) {
      const float4 a = load4(own + d);
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const float4 o = load4(other + (sub + kTpr * c) * kCS + d);
        s[c] = fmaf(a.x, o.x, s[c]);
        s[c] = fmaf(a.y, o.y, s[c]);
        s[c] = fmaf(a.z, o.z, s[c]);
        s[c] = fmaf(a.w, o.w, s[c]);
      }
    }
  }
}

// dp[c] = (row `mine` of a) . (row sub + 4 c of o), DV columns, both
// (kRows x (DV + 4)) tiles
template <int DV>
__device__ __forceinline__ void row_dots(float (&dp)[kPer], const float* a,
                                         const float* o, int mine, int sub) {
#pragma unroll
  for (int c = 0; c < kPer; ++c) dp[c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DV; d += 4) {
    const float4 x = load4(a + mine * (DV + 4) + d);
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const float4 y = load4(o + (sub + kTpr * c) * (DV + 4) + d);
      dp[c] = fmaf(x.x, y.x, dp[c]);
      dp[c] = fmaf(x.y, y.y, dp[c]);
      dp[c] = fmaf(x.z, y.z, dp[c]);
      dp[c] = fmaf(x.w, y.w, dp[c]);
    }
  }
}

template <int DV>
size_t dq_smem_bytes(int D) {
  return sizeof(float) *
         (2 * static_cast<size_t>(kRows) * kCS +
          2 * static_cast<size_t>(kRows) * (DV + 4) +
          static_cast<size_t>(kRows) * kPS +
          static_cast<size_t>(kRows) * (DV + D + 4));
}

template <int DV>
size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * static_cast<size_t>(kRows) * kCS +
                          3 * static_cast<size_t>(kRows) * (DV + 4) +
                          2 * static_cast<size_t>(kRows) * kPS + 2 * kRows);
}

template <int DV>
__global__ void __launch_bounds__(kThreads)
flash_relpos_bwd_dq_kernel(const float* __restrict__ qu,
                           const float* __restrict__ qp,
                           const float* __restrict__ k,
                           const float* __restrict__ kp,
                           const float* __restrict__ v,
                           const int* __restrict__ lens,
                           const float* __restrict__ o,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           float* __restrict__ delta_out,
                           float* __restrict__ dqu, float* __restrict__ dqp,
                           int Tn, int H, int D, float scale) {
  constexpr int VS = DV + 4;
  const int DQK = DV + D, AS = DQK + 4;
  extern __shared__ __align__(16) float smem[];
  float* sqc = smem;                       // kRows x kCS: a q~ chunk
  float* skc = sqc + kRows * kCS;          // kRows x kCS: a k~ chunk
  float* sdo = skc + kRows * kCS;          // kRows x VS: the tile's do
  float* sv = sdo + kRows * VS;            // kRows x VS: a key tile's v
  float* sds = sv + kRows * VS;            // kRows x kPS: ds [query][key]
  float* sacc = sds + kRows * kPS;         // kRows x AS: dq~ accumulator

  const int tid = threadIdx.x, row = tid / kTpr, sub = tid % kTpr;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int qi = q0 + row;
  const int valid = min(max(lens[b], 1), Tn);
  const float* qp_bh = qp + (static_cast<size_t>(b) * H + h) * Tn * D;
  const size_t row_stat = (static_cast<size_t>(b) * H + h) * Tn + qi;

  stage_rows<DV>(sdo, dout, q0, Tn, H, h, b);
  for (int i = tid; i < kRows * AS; i += kThreads) sacc[i] = 0.f;
  // delta = rowsum(do * o) over the row's four threads
  float delta = 0.f;
  if (qi < Tn) {
    const size_t base = ((static_cast<size_t>(b) * Tn + qi) * H + h) * DV;
    for (int d = sub; d < DV; d += kTpr)
      delta = fmaf(dout[base + d], o[base + d], delta);
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  delta += __shfl_xor_sync(0xffffffffu, delta, 2);
  if (qi < Tn && sub == 0) delta_out[row_stat] = delta;
  const float row_lse = qi < Tn ? lse[row_stat] : 0.f;

  for (int k0 = 0; k0 < Tn; k0 += kRows) {
    float s[kPer], dp[kPer];
    scores<true>(s, sqc, skc, qu, qp_bh, k, kp, q0, k0, Tn, H, h, b, DV,
                    D, row, sub);
    stage_rows<DV>(sv, v, k0, Tn, H, h, b);
    __syncthreads();                       // v staged (and sdo, sacc)
    row_dots<DV>(dp, sdo, sv, row, sub);
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int j = sub + kTpr * c;
      const float p = k0 + j < valid ? expf(s[c] * scale - row_lse) : 0.f;
      sds[row * kPS + j] = p * (dp[c] - delta) * scale;
    }
    __syncwarp();                          // the row's ds are in sds
    // dq~ += ds k~, 32 columns at a time; the thread's 8 columns of a
    // chunk are 4 sub + 16 g + e
    for (int c0 = 0; c0 < DQK; c0 += kChunk) {
      __syncthreads();                     // the last chunk's reads are done
      stage_chunk(skc, k, kp, k0, c0, Tn, H, h, b, DV, D);
      __syncthreads();
      float acc[8] = {};
#pragma unroll 4
      for (int j = 0; j < kRows; ++j) {
        const float dsj = sds[row * kPS + j];
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const float4 kd = load4(skc + j * kCS + 4 * sub + 16 * g);
          acc[4 * g] = fmaf(dsj, kd.x, acc[4 * g]);
          acc[4 * g + 1] = fmaf(dsj, kd.y, acc[4 * g + 1]);
          acc[4 * g + 2] = fmaf(dsj, kd.z, acc[4 * g + 2]);
          acc[4 * g + 3] = fmaf(dsj, kd.w, acc[4 * g + 3]);
        }
      }
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[row * AS + c0 + 4 * sub + 16 * g + e] += acc[4 * g + e];
    }
  }

  __syncwarp();
  if (qi < Tn) {
    float* dst_u = dqu + ((static_cast<size_t>(b) * Tn + qi) * H + h) * DV;
    float* dst_p = dqp + row_stat * D;
    for (int c = sub; c < DQK; c += kTpr) {
      const float x = sacc[row * AS + c];
      if (c < DV)
        dst_u[c] = x;
      else
        dst_p[c - DV] = x;
    }
  }
}

template <int DV>
__global__ void __launch_bounds__(kThreads)
flash_relpos_bwd_dkv_kernel(const float* __restrict__ qu,
                            const float* __restrict__ qp,
                            const float* __restrict__ k,
                            const float* __restrict__ kp,
                            const float* __restrict__ v,
                            const int* __restrict__ lens,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int Tn, int H, int D, float scale) {
  constexpr int VS = DV + 4;
  constexpr int CPT = DV / kTpr;           // dk and dv columns a thread
  extern __shared__ __align__(16) float smem[];
  float* sqc = smem;                       // kRows x kCS: a q~ chunk
  float* skc = sqc + kRows * kCS;          // kRows x kCS: a k~ chunk
  float* sv = skc + kRows * kCS;           // kRows x VS: the tile's v
  float* sdo = sv + kRows * VS;            // kRows x VS: a query tile's do
  float* sqh = sdo + kRows * VS;           // kRows x VS: its q~[:, :Dh]
  float* sp = sqh + kRows * VS;            // kRows x kPS: p [key][query]
  float* sds = sp + kRows * kPS;           // kRows x kPS: ds [key][query]
  float* slse = sds + kRows * kPS;         // kRows: the query tile's lse
  float* sdelta = slse + kRows;            // kRows: its delta

  const int tid = threadIdx.x, key = tid / kTpr, sub = tid % kTpr;
  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int kj = k0 + key;
  const bool key_valid = kj < min(max(lens[b], 1), Tn);
  const float* qp_bh = qp + (static_cast<size_t>(b) * H + h) * Tn * D;

  stage_rows<DV>(sv, v, k0, Tn, H, h, b);
  float acc_k[CPT], acc_v[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc_k[c] = acc_v[c] = 0.f;

  for (int q0 = 0; q0 < Tn; q0 += kRows) {
    float s[kPer], dp[kPer];
    scores<false>(s, sqc, skc, qu, qp_bh, k, kp, q0, k0, Tn, H, h, b, DV,
                     D, key, sub);
    stage_rows<DV>(sdo, dout, q0, Tn, H, h, b);
    stage_rows<DV>(sqh, qu, q0, Tn, H, h, b);
    if (tid < kRows) {
      const int t = q0 + tid;
      const size_t at = (static_cast<size_t>(b) * H + h) * Tn + t;
      slse[tid] = t < Tn ? lse[at] : 0.f;
      sdelta[tid] = t < Tn ? delta[at] : 0.f;
    }
    __syncthreads();
    row_dots<DV>(dp, sv, sdo, key, sub);
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int i = sub + kTpr * c;
      const float p = key_valid && q0 + i < Tn
                          ? expf(s[c] * scale - slse[i]) : 0.f;
      sp[key * kPS + i] = p;
      sds[key * kPS + i] = p * (dp[c] - sdelta[i]) * scale;
    }
    __syncwarp();                          // the key's p and ds are in smem
    // the thread's columns: 4 sub + 16 g + e
#pragma unroll 2
    for (int i = 0; i < kRows; ++i) {
      const float pi = sp[key * kPS + i], dsi = sds[key * kPS + i];
#pragma unroll
      for (int g = 0; g < CPT / 4; ++g) {
        const float4 dd = load4(sdo + i * VS + 4 * sub + 16 * g);
        const float4 qd = load4(sqh + i * VS + 4 * sub + 16 * g);
        acc_v[4 * g] = fmaf(pi, dd.x, acc_v[4 * g]);
        acc_v[4 * g + 1] = fmaf(pi, dd.y, acc_v[4 * g + 1]);
        acc_v[4 * g + 2] = fmaf(pi, dd.z, acc_v[4 * g + 2]);
        acc_v[4 * g + 3] = fmaf(pi, dd.w, acc_v[4 * g + 3]);
        acc_k[4 * g] = fmaf(dsi, qd.x, acc_k[4 * g]);
        acc_k[4 * g + 1] = fmaf(dsi, qd.y, acc_k[4 * g + 1]);
        acc_k[4 * g + 2] = fmaf(dsi, qd.z, acc_k[4 * g + 2]);
        acc_k[4 * g + 3] = fmaf(dsi, qd.w, acc_k[4 * g + 3]);
      }
    }
  }

  if (kj < Tn) {
    const size_t at = ((static_cast<size_t>(b) * Tn + kj) * H + h) * DV;
#pragma unroll
    for (int g = 0; g < CPT / 4; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[at + 4 * sub + 16 * g + e] = acc_k[4 * g + e];
        dv[at + 4 * sub + 16 * g + e] = acc_v[4 * g + e];
      }
  }
}

// ---- bf16: tensor cores ------------------------------------------------
constexpr int kTS = kRows + 8;            // transposed tiles' row stride
constexpr int kDqWarps = 8;               // dq: 4 row groups x 2 column halves
constexpr int kDkvWarps = 4;              // dkv: 16 keys each

// two bf16 of one column in consecutive rows, low half first
__device__ __forceinline__ unsigned ld_pair(const __nv_bfloat16* p,
                                            int stride) {
  return static_cast<unsigned>(
             *reinterpret_cast<const unsigned short*>(p)) |
         (static_cast<unsigned>(
              *reinterpret_cast<const unsigned short*>(p + stride))
          << 16);
}

// the A fragment of rows g, g + 8 and columns kk + 2 t4 (+ 8) of a
// row-major tile, `a` pointing at row g, column 2 t4
__device__ __forceinline__ void a_frag(unsigned (&f)[4],
                                       const __nv_bfloat16* a, int stride,
                                       int kk) {
  f[0] = ld32(a + kk);
  f[1] = ld32(a + 8 * stride + kk);
  f[2] = ld32(a + kk + 8);
  f[3] = ld32(a + 8 * stride + kk + 8);
}

// the accumulators of n-tiles 2 ks and 2 ks + 1, rounded to bf16, as the A
// fragment of the next product's k-step ks
__device__ __forceinline__ void acc_frag(unsigned (&f)[4],
                                         const float (&c)[8][4], int ks) {
  f[0] = pack_bf16(c[2 * ks][0], c[2 * ks][1]);
  f[1] = pack_bf16(c[2 * ks][2], c[2 * ks][3]);
  f[2] = pack_bf16(c[2 * ks + 1][0], c[2 * ks + 1][1]);
  f[3] = pack_bf16(c[2 * ks + 1][2], c[2 * ks + 1][3]);
}

// rows t0 .. t0 + 63 of q~ or k~ into dst (kRows x (Dh + D + 8) bf16): head
// (B, T, H, Dh) and the (T, D) rows pos_bh, 8 elements a load; zeros past T
__device__ __forceinline__ void stage_aug(__nv_bfloat16* dst,
                                          const __nv_bfloat16* head,
                                          const __nv_bfloat16* pos_bh,
                                          int t0, int Tn, int H, int h, int b,
                                          int DV, int D, int nthreads) {
  const int DQK = DV + D, vecs = DQK / 8;
  for (int i = threadIdx.x; i < kRows * vecs; i += nthreads) {
    const int r = i / vecs, c = (i % vecs) * 8, t = t0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (t < Tn)
      x = *reinterpret_cast<const uint4*>(
          c < DV ? head + ((static_cast<size_t>(b) * Tn + t) * H + h) * DV + c
                 : pos_bh + static_cast<size_t>(t) * D + c - DV);
    *reinterpret_cast<uint4*>(dst + r * (DQK + 8) + c) = x;
  }
}

// rows t0 .. t0 + 63 of a (B, T, H, DV) bf16 tensor into dst (kRows x (DV +
// 8)), and with `dst_t` also transposed (DV x kTS)
template <int DV>
__device__ __forceinline__ void stage_head(__nv_bfloat16* dst,
                                           __nv_bfloat16* dst_t,
                                           const __nv_bfloat16* src, int t0,
                                           int Tn, int H, int h, int b,
                                           int nthreads) {
  for (int i = threadIdx.x; i < kRows * DV / 8; i += nthreads) {
    const int r = i / (DV / 8), c = (i % (DV / 8)) * 8, t = t0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (t < Tn)
      x = *reinterpret_cast<const uint4*>(
          src + ((static_cast<size_t>(b) * Tn + t) * H + h) * DV + c);
    if (dst != nullptr)
      *reinterpret_cast<uint4*>(dst + r * (DV + 8) + c) = x;
    if (dst_t != nullptr) {
      const auto* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int q = 0; q < 8; ++q) dst_t[(c + q) * kTS + r] = e[q];
    }
  }
}

template <int DV>
size_t dq_mma_smem_bytes(int D) {
  return sizeof(__nv_bfloat16) *
             (2 * static_cast<size_t>(kRows) * (DV + D + 8) +
              2 * static_cast<size_t>(kRows) * (DV + 8)) +
         sizeof(float) * (static_cast<size_t>(kDqWarps) * 32 * 32 +
                          2 * kRows);
}

template <int DV>
size_t dkv_mma_smem_bytes(int D) {
  return sizeof(__nv_bfloat16) *
             (2 * static_cast<size_t>(kRows) * (DV + D + 8) +
              2 * static_cast<size_t>(kRows) * (DV + 8) +
              2 * static_cast<size_t>(DV) * kTS) +
         sizeof(float) * 2 * kRows;
}

// dq on the tensor cores: 8 warps, warp (wr, wc) = (warp % 4, warp / 4)
// for queries q0 + 16 wr .. + 15. The dq~ accumulator of 16 rows x (Dh +
// D) columns is split between the two warps of a row group, each holding
// the n-tiles of one column half in registers (MAXNT of them at most); the
// scores are split the same way over the contraction and the two partial
// sums added through shared memory in a fixed order, so both warps hold the
// same scores. dP (over Dh) and the weights are computed by both.
template <int DV, int MAXNT>
__global__ void __launch_bounds__(kDqWarps * 32)
flash_relpos_bwd_dq_mma_kernel(
    const __nv_bfloat16* __restrict__ qu, const __nv_bfloat16* __restrict__ qp,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lens,
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta_out,
    __nv_bfloat16* __restrict__ dqu, __nv_bfloat16* __restrict__ dqp, int Tn,
    int H, int D, float scale) {
  constexpr int NT = kDqWarps * 32, VS = DV + 8;
  const int DQK = DV + D, QS = DQK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kRows x QS
  __nv_bfloat16* sk = sq + kRows * QS;                    // kRows x QS
  __nv_bfloat16* sdo = sk + kRows * QS;                   // kRows x VS
  __nv_bfloat16* sv = sdo + kRows * VS;                   // kRows x VS
  auto* spart = reinterpret_cast<float*>(sv + kRows * VS);  // 8 x 32 x 32
  float* slse = spart + kDqWarps * 32 * 32;               // kRows
  float* sdelta = slse + kRows;                           // kRows

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4, wr = warp % 4, wc = warp / 4;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int valid = min(max(lens[b], 1), Tn);
  const __nv_bfloat16* qp_bh = qp + (static_cast<size_t>(b) * H + h) * Tn * D;

  stage_aug(sq, qu, qp_bh, q0, Tn, H, h, b, DV, D, NT);
  stage_head<DV>(sdo, nullptr, dout, q0, Tn, H, h, b, NT);
  {
    // delta = rowsum(do * o), four threads a row
    const int row = tid / 4, sub = tid % 4, t = q0 + row;
    float d = 0.f;
    if (t < Tn) {
      const size_t base = ((static_cast<size_t>(b) * Tn + t) * H + h) * DV;
      for (int c = sub; c < DV; c += 4)
        d = fmaf(__bfloat162float(dout[base + c]),
                 __bfloat162float(o[base + c]), d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (sub == 0) {
      const size_t at = (static_cast<size_t>(b) * H + h) * Tn + t;
      sdelta[row] = d;
      slse[row] = t < Tn ? lse[at] : 0.f;
      if (t < Tn) delta_out[at] = d;
    }
  }
  // this warp's n-tiles of dq~ and k-steps of the scores
  const int nt_half = (DQK / 8 + 1) / 2, ks_half = (DQK / 16 + 1) / 2;
  const int n_begin = wc * nt_half;
  const int n_count = min(DQK / 8 - n_begin, nt_half);
  const int ks_begin = wc * ks_half, ks_end = min(DQK / 16, ks_begin + ks_half);
  float acc[MAXNT][4];
#pragma unroll
  for (int i = 0; i < MAXNT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const __nv_bfloat16* qa = sq + (wr * 16 + g) * QS + 2 * t4;
  const __nv_bfloat16* da = sdo + (wr * 16 + g) * VS + 2 * t4;

  for (int k0 = 0; k0 < Tn; k0 += kRows) {
    __syncthreads();                      // the last tile's reads are done
    stage_aug(sk, k, kp, k0, Tn, H, h, b, DV, D, NT);
    stage_head<DV>(sv, nullptr, v, k0, Tn, H, h, b, NT);
    __syncthreads();
    float s[8][4] = {}, dp[8][4] = {};
    for (int ks = ks_begin; ks < ks_end; ++ks) {
      unsigned a[4];
      a_frag(a, qa, QS, 16 * ks);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kb = sk + (8 * n + g) * QS + 16 * ks + 2 * t4;
        mma_bf16(s[n], a, ld32(kb), ld32(kb + 8));
      }
    }
    float* mine = spart + (wc * 4 + wr) * 32 * 32;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(4 * n + e) * 32 + lane] = s[n][e];
#pragma unroll
    for (int kk = 0; kk < DV; kk += 16) {
      unsigned a[4];
      a_frag(a, da, VS, kk);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* vb = sv + (8 * n + g) * VS + kk + 2 * t4;
        mma_bf16(dp[n], a, ld32(vb), ld32(vb + 8));
      }
    }
    __syncthreads();                      // both partial scores are written
    const float* p0 = spart + wr * 32 * 32;
    const float* p1 = spart + (4 + wr) * 32 * 32;
    unsigned dsa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = (4 * n + e) * 32 + lane;
        const int r = wr * 16 + g + 8 * (e / 2);
        const float sc = p0[idx] + p1[idx];
        const float p = k0 + 8 * n + 2 * t4 + (e & 1) < valid
                            ? expf(sc * scale - slse[r]) : 0.f;
        dp[n][e] = p * (dp[n][e] - sdelta[r]) * scale;
      }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) acc_frag(dsa[ks], dp, ks);
    // dq~ += ds k~: B (key, column) from k~'s rows, two keys a register
#pragma unroll
    for (int i = 0; i < MAXNT; ++i)
      if (i < n_count) {
        const int col = 8 * (n_begin + i) + g;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const __nv_bfloat16* kb = sk + (16 * ks + 2 * t4) * QS + col;
          mma_bf16(acc[i], dsa[ks], ld_pair(kb, QS),
                   ld_pair(kb + 8 * QS, QS));
        }
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + wr * 16 + g + 8 * r;
    if (t >= Tn) continue;
    __nv_bfloat16* dst_u =
        dqu + ((static_cast<size_t>(b) * Tn + t) * H + h) * DV;
    __nv_bfloat16* dst_p =
        dqp + ((static_cast<size_t>(b) * H + h) * Tn + t) * D;
#pragma unroll
    for (int i = 0; i < MAXNT; ++i)
      if (i < n_count) {
        const int c = 8 * (n_begin + i) + 2 * t4;
        const unsigned x = pack_bf16(acc[i][2 * r], acc[i][2 * r + 1]);
        *reinterpret_cast<unsigned*>(c < DV ? dst_u + c : dst_p + c - DV) =
            x;
      }
  }
}

// dkv on the tensor cores: 4 warps of 16 keys, each computing its keys'
// transposed scores S^T = k~ q~^T and dP^T = v dO^T against a 64-query
// tile, then dv += P^T dO and dk += dS^T q~[:, :Dh] from the weights in
// registers, with dO and q~[:, :Dh] staged transposed as their B operands.
template <int DV>
__global__ void __launch_bounds__(kDkvWarps * 32)
flash_relpos_bwd_dkv_mma_kernel(
    const __nv_bfloat16* __restrict__ qu, const __nv_bfloat16* __restrict__ qp,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lens,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Tn, int H, int D, float scale) {
  constexpr int NT = kDkvWarps * 32, VS = DV + 8, NV = DV / 8;
  const int DQK = DV + D, QS = DQK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kRows x QS
  __nv_bfloat16* sq = sk + kRows * QS;                    // kRows x QS
  __nv_bfloat16* sv = sq + kRows * QS;                    // kRows x VS
  __nv_bfloat16* sdo = sv + kRows * VS;                   // kRows x VS
  __nv_bfloat16* sdot = sdo + kRows * VS;                 // DV x kTS
  __nv_bfloat16* sqht = sdot + DV * kTS;                  // DV x kTS
  auto* slse = reinterpret_cast<float*>(sqht + DV * kTS);  // kRows
  float* sdelta = slse + kRows;                            // kRows

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int valid = min(max(lens[b], 1), Tn);
  const bool key_ok[2] = {k0 + warp * 16 + g < valid,
                          k0 + warp * 16 + g + 8 < valid};
  const __nv_bfloat16* qp_bh = qp + (static_cast<size_t>(b) * H + h) * Tn * D;

  stage_aug(sk, k, kp, k0, Tn, H, h, b, DV, D, NT);
  stage_head<DV>(sv, nullptr, v, k0, Tn, H, h, b, NT);
  float acc_k[NV][4] = {}, acc_v[NV][4] = {};
  const __nv_bfloat16* ka = sk + (warp * 16 + g) * QS + 2 * t4;
  const __nv_bfloat16* va = sv + (warp * 16 + g) * VS + 2 * t4;

  for (int q0 = 0; q0 < Tn; q0 += kRows) {
    __syncthreads();                      // the last tile's reads are done
    stage_aug(sq, qu, qp_bh, q0, Tn, H, h, b, DV, D, NT);
    stage_head<DV>(sdo, sdot, dout, q0, Tn, H, h, b, NT);
    stage_head<DV>(nullptr, sqht, qu, q0, Tn, H, h, b, NT);
    if (tid < kRows) {
      const int t = q0 + tid;
      const size_t at = (static_cast<size_t>(b) * H + h) * Tn + t;
      slse[tid] = t < Tn ? lse[at] : 0.f;
      sdelta[tid] = t < Tn ? delta[at] : 0.f;
    }
    __syncthreads();
    float s[8][4] = {}, dp[8][4] = {};
    for (int kk = 0; kk < DQK; kk += 16) {
      unsigned a[4];
      a_frag(a, ka, QS, kk);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* qb = sq + (8 * n + g) * QS + kk + 2 * t4;
        mma_bf16(s[n], a, ld32(qb), ld32(qb + 8));
      }
    }
#pragma unroll
    for (int kk = 0; kk < DV; kk += 16) {
      unsigned a[4];
      a_frag(a, va, VS, kk);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* db = sdo + (8 * n + g) * VS + kk + 2 * t4;
        mma_bf16(dp[n], a, ld32(db), ld32(db + 8));
      }
    }
    // the weights of the warp's keys (rows g, g + 8) and the tile's
    // queries (columns 8 n + 2 t4 + e % 2)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * n + 2 * t4 + (e & 1);
        const float p = key_ok[e / 2] && q0 + i < Tn
                            ? expf(s[n][e] * scale - slse[i]) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - sdelta[i]) * scale;
      }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      unsigned pa[4], dsa[4];
      acc_frag(pa, s, ks);
      acc_frag(dsa, dp, ks);
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const __nv_bfloat16* ob = sdot + (8 * n + g) * kTS + 16 * ks + 2 * t4;
        mma_bf16(acc_v[n], pa, ld32(ob), ld32(ob + 8));
        const __nv_bfloat16* hb = sqht + (8 * n + g) * kTS + 16 * ks + 2 * t4;
        mma_bf16(acc_k[n], dsa, ld32(hb), ld32(hb + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = k0 + warp * 16 + g + 8 * r;
    if (t >= Tn) continue;
    const size_t at = ((static_cast<size_t>(b) * Tn + t) * H + h) * DV + 2 * t4;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      *reinterpret_cast<unsigned*>(dk + at + 8 * n) =
          pack_bf16(acc_k[n][2 * r], acc_k[n][2 * r + 1]);
      *reinterpret_cast<unsigned*>(dv + at + 8 * n) =
          pack_bf16(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

struct Args {
  const void *qu, *qp, *k, *kp, *v;
  const int* lens;
  const void *o, *dout;
  const float* lse;
  float* delta;
  void *dqu, *dqp, *dk, *dv;
  int B, Tn, H, D;
  float scale;
  cudaStream_t stream;
};

template <int DV>
int launch_dq(const Args& a) {
  const size_t smem = dq_smem_bytes<DV>(a.D);
  auto* kernel = flash_relpos_bwd_dq_kernel<DV>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Tn + kRows - 1) / kRows, a.H, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.qu), static_cast<const float*>(a.qp),
      static_cast<const float*>(a.k), static_cast<const float*>(a.kp),
      static_cast<const float*>(a.v), a.lens, static_cast<const float*>(a.o),
      static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dqu), static_cast<float*>(a.dqp), a.Tn, a.H, a.D,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DV>
int launch_dkv(const Args& a) {
  const size_t smem = dkv_smem_bytes<DV>();
  auto* kernel = flash_relpos_bwd_dkv_kernel<DV>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Tn + kRows - 1) / kRows, a.H, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.qu), static_cast<const float*>(a.qp),
      static_cast<const float*>(a.k), static_cast<const float*>(a.kp),
      static_cast<const float*>(a.v), a.lens,
      static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.Tn, a.H, a.D, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// the dq kernel's accumulator n-tiles a warp: buckets of MAXNT
template <int DV, int MAXNT>
int launch_dq_mma_as(const Args& a, size_t smem) {
  auto* kernel = flash_relpos_bwd_dq_mma_kernel<DV, MAXNT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf16 = __nv_bfloat16;
  const dim3 grid((a.Tn + kRows - 1) / kRows, a.H, a.B);
  kernel<<<grid, kDqWarps * 32, smem, a.stream>>>(
      static_cast<const bf16*>(a.qu), static_cast<const bf16*>(a.qp),
      static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.kp),
      static_cast<const bf16*>(a.v), a.lens, static_cast<const bf16*>(a.o),
      static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.dqu), static_cast<bf16*>(a.dqp), a.Tn, a.H, a.D,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

// the largest Dh + D whose n-tiles a dq warp holds in registers
constexpr int kMaxMmaDqk = 2 * 8 * 44;

template <int DV>
int launch_dq_mma(const Args& a) {
  const size_t smem = dq_mma_smem_bytes<DV>(a.D);
  const int nt_half = ((DV + a.D) / 8 + 1) / 2;
  if (nt_half <= 20) return launch_dq_mma_as<DV, 20>(a, smem);
  if (nt_half <= 36) return launch_dq_mma_as<DV, 36>(a, smem);
  if (nt_half <= 44) return launch_dq_mma_as<DV, 44>(a, smem);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int DV>
int launch_dkv_mma(const Args& a) {
  const size_t smem = dkv_mma_smem_bytes<DV>(a.D);
  auto* kernel = flash_relpos_bwd_dkv_mma_kernel<DV>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf16 = __nv_bfloat16;
  const dim3 grid((a.Tn + kRows - 1) / kRows, a.H, a.B);
  kernel<<<grid, kDkvWarps * 32, smem, a.stream>>>(
      static_cast<const bf16*>(a.qu), static_cast<const bf16*>(a.qp),
      static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.kp),
      static_cast<const bf16*>(a.v), a.lens, static_cast<const bf16*>(a.dout),
      a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.Tn, a.H, a.D, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores, fp32 on the CUDA cores
template <bool kDq, int DV>
int dispatch_type(const Args& a, int is_bf16) {
  if (is_bf16) return kDq ? launch_dq_mma<DV>(a) : launch_dkv_mma<DV>(a);
  return kDq ? launch_dq<DV>(a) : launch_dkv<DV>(a);
}

template <bool kDq>
int dispatch(const Args& a, int Dh, int is_bf16) {
  switch (Dh) {
    case 32: return dispatch_type<kDq, 32>(a, is_bf16);
    case 64: return dispatch_type<kDq, 64>(a, is_bf16);
    case 128: return dispatch_type<kDq, 128>(a, is_bf16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int DV>
long long smem_bytes_dh(bool dq, int D, int is_bf16) {
  if (!is_bf16) return dq ? dq_smem_bytes<DV>(D) : dkv_smem_bytes<DV>();
  // a width the dq kernel's registers cannot hold takes no shared memory
  // that fits: the wrapper refuses it
  if (DV + D > kMaxMmaDqk) return 1LL << 40;
  return dq ? dq_mma_smem_bytes<DV>(D) : dkv_mma_smem_bytes<DV>(D);
}

long long smem_bytes(bool dq, int Dh, int D, int is_bf16) {
  switch (Dh) {
    case 32: return smem_bytes_dh<32>(dq, D, is_bf16);
    case 64: return smem_bytes_dh<64>(dq, D, is_bf16);
    case 128: return smem_bytes_dh<128>(dq, D, is_bf16);
    default: return -1;
  }
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() after the launch
// (0 on success). The caller guarantees B, T, H >= 1, Dh in {32, 64, 128},
// D a multiple of 32 with the kernel's shared memory (the *_smem entries)
// within the card's 227 KB, and contiguous device buffers of one type
// (bf16 when is_bf16, else fp32): qu, k, v, o, dout, dqu, dk, dv (B, T, H,
// Dh), qp and dqp (B, H, T, D), kp (T, D); lens (B,) int32; lse and delta
// (B, H, T) fp32. The dq kernel writes dqu, dqp and delta; the dkv kernel,
// launched after it on the same stream, reads delta and writes dk and dv.
extern "C" int flash_relpos_bwd_dq(const void* qu, const void* qp,
                                   const void* k, const void* kp,
                                   const void* v, const void* lens,
                                   const void* o, const void* dout,
                                   const void* lse, void* delta, void* dqu,
                                   void* dqp, int B, int Tn, int H, int Dh,
                                   int D, int is_bf16, float scale,
                                   void* stream) {
  const Args a{qu, qp, k, kp, v, static_cast<const int*>(lens), o, dout,
               static_cast<const float*>(lse), static_cast<float*>(delta),
               dqu, dqp, nullptr, nullptr, B, Tn, H, D, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, Dh, is_bf16);
}

extern "C" int flash_relpos_bwd_dkv(const void* qu, const void* qp,
                                    const void* k, const void* kp,
                                    const void* v, const void* lens,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv,
                                    int B, int Tn, int H, int Dh, int D,
                                    int is_bf16, float scale, void* stream) {
  const Args a{qu, qp, k, kp, v, static_cast<const int*>(lens), nullptr,
               dout, static_cast<const float*>(lse),
               const_cast<float*>(static_cast<const float*>(delta)), nullptr,
               nullptr, dk, dv, B, Tn, H, D, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, Dh, is_bf16);
}

// The dynamic shared memory each kernel for (Dh, D, type) asks for, so
// that the wrapper can refuse a shape that would not fit before it
// launches.
extern "C" long long flash_relpos_bwd_dq_smem(int Dh, int D, int is_bf16) {
  return smem_bytes(true, Dh, D, is_bf16);
}

extern "C" long long flash_relpos_bwd_dkv_smem(int Dh, int D, int is_bf16) {
  return smem_bytes(false, Dh, D, is_bf16);
}
