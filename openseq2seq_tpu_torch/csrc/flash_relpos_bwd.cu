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
// Design:
//  * bf16, the main path (flash_relpos.cuh): bf16 operands and fp32
//    accumulation on the tensor cores (the TPU kernels' precision),
//    fragments by ldmatrix and ldmatrix.trans from shared memory (nothing
//    is transposed by hand), p and ds rounded to bf16 in registers where
//    the TPU kernels round them and used as the next product's A
//    fragments. The CTA's own tile (q~ and dO in dq, k~ and v in dkv) is
//    copied once with 16-byte cp.async; the other side streams through a
//    ring of 64 x 64 slots, two chunks copied ahead of the products. The
//    key table's chunks are the same for every batch row and head and come
//    from L2. Tiles at or past a row's length are not read: their weights
//    are exactly 0.
//    - dq: one CTA per (48-query tile at Conformer-M, 64 at Conformer-L;
//      head; batch row), two warps a 16-row group; warp (wr, wc) scores
//      rows 16 wr .. + 15 against keys 32 wc .. + 31 of each key tile over
//      the whole Dh + D, so no partial sums are exchanged; the warps' ds
//      go, rounded, into one shared tile, and each warp adds ds k~ to its
//      half of every 64-column chunk of dq~, held in registers (80 at
//      Conformer-M, 144 at Conformer-L). k~ streams twice a key tile, for
//      the scores and for dq~, its second pass from L2; v once between.
//      The 48-row tile is what lets two CTAs (12 warps) share an SM at
//      Conformer-M with nothing spilled: a 64-row CTA of 8 warps needs
//      more registers than two CTAs an SM leave it, and spills when held
//      to them. 74 KB of shared memory at Conformer-M, 118 KB at
//      Conformer-L (one CTA an SM).
//    - dkv: one CTA of 4 warps, one warpgroup, per (64-key tile, head,
//      batch row), each warp 16 keys. It computes the transposed scores
//      S^T = k~ q~^T and dP^T = v dO^T of each query tile by wgmma
//      m64n64k16 from shared memory in the 128-byte swizzled layout (k~
//      and v its own tiles, q~'s pos chunks, its head chunks and dO's
//      chunks from the ring), then dv += P^T dO and dk += dS^T q~[:, :Dh]
//      by mma.sync with the head and dO chunks, still in their slots, as B
//      operands through ldmatrix.trans. 81 KB at Conformer-M, 113 KB at
//      Conformer-L (two CTAs an SM). A key tile wholly at or past the
//      length writes zeros and reads nothing.
//    The dq kernel stays on mma.sync: its 48-row tile is not a 64-row
//    warpgroup tile, and a 64-row one would need 80 KB of registers for
//    the dq~ accumulator alone.
//  * fp32: fp32 FMAs on the CUDA cores (TF32 would round the operands),
//    256 threads a CTA, four per row, operands staged in shared memory as
//    fp32 and read with 16-byte loads; the scores summed over Dh + D in
//    chunks of 32 columns of q~ and k~ staged together; dq~'s accumulator
//    in shared memory as fp32, each thread adding its row's 8 columns of a
//    32-column chunk of ds k~; dk and dv in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_relpos.cuh"

namespace {

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

}  // namespace

// ---- bf16: tensor cores ------------------------------------------------
namespace flash_relpos {

constexpr int kDqStages = 3, kDqAhead = 2;
constexpr int kDkvThreads = 128;          // 4 warps of 16 keys
constexpr int kDkvAhead = 2;
// the dq kernel keeps its half of each 64-column chunk of dq~ in
// registers: at most this many chunks of Dh + D
constexpr int kMaxDqChunks = 9;

// the dkv kernel's ring: its last tile's q~ head chunks and dO chunks
// stay valid until dk and dv are added
template <int DV>
__host__ __device__ constexpr int dkv_stages() {
  return kDkvAhead + 2 * head_chunks(DV);
}

template <int DV>
size_t dkv_smem_bytes(int D) {
  return sizeof(bf16) * static_cast<size_t>(panels(DV + D) + panels(DV) +
                                            dkv_stages<DV>()) *
             kPanel + kAlignPad;
}

// dq: RG row groups of 16 queries, two warps each; warp (wr, wc) =
// (warp % RG, warp / RG) for queries q0 + 16 wr .. + 15. Per 64-key tile
// it scores its rows against keys 32 wc .. 32 wc + 31 over the whole Dh +
// D (and dP over Dh), writes their ds, rounded to bf16, into a shared tile
// of the CTA's rows by 64 keys, and then adds ds k~ to the columns of dq~
// it owns: in each chunk of k~'s columns, the wc-th half. The key tile's
// k~ chunks stream through the ring twice (once for the scores, once for
// dq~; the second time from L2), v's once between. Its dq~ share stays in
// registers: 80 of them at Conformer-M's 320 columns, 144 at Conformer-L's
// 576. At Conformer-M the CTA owns 48 queries (RG 3, 6 warps) so that two
// CTAs an SM fit 168 registers a thread with nothing spilled; at
// Conformer-L 64 (RG 4), one CTA an SM.
template <int MAXCH>
__host__ __device__ constexpr int dq_row_groups() {
  return MAXCH <= 5 ? 3 : 4;
}
template <int MAXCH>
__host__ __device__ constexpr int dq_threads() {
  return 64 * dq_row_groups<MAXCH>();
}

template <int DV, int MAXCH>
size_t dq_smem_bytes(int D) {
  constexpr int QR = 16 * dq_row_groups<MAXCH>();
  return sizeof(bf16) * (static_cast<size_t>(QR) * (DV + D + 8) +
                         static_cast<size_t>(QR) * (DV + 8) +
                         static_cast<size_t>(1 + kDqStages) * kSlot) +
         sizeof(float) * 2 * QR;
}

template <int DV, int MAXCH>
__global__ void __launch_bounds__(dq_threads<MAXCH>(), MAXCH <= 5 ? 2 : 1)
flash_relpos_bwd_dq_mma_kernel(
    const bf16* __restrict__ qu, const bf16* __restrict__ qp,
    const bf16* __restrict__ k, const bf16* __restrict__ kp,
    const bf16* __restrict__ v, const int* __restrict__ lens,
    const bf16* __restrict__ o, const bf16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta_out,
    bf16* __restrict__ dqu, bf16* __restrict__ dqp, int Tn, int H, int D,
    float scale) {
  constexpr int RG = dq_row_groups<MAXCH>(), NT = dq_threads<MAXCH>();
  constexpr int QR = 16 * RG;             // the CTA's query rows
  constexpr int NVC = head_chunks(DV), VW = DV < 64 ? DV : 64;
  constexpr int DS = DV + 8;
  const int QS = DV + D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* sq = reinterpret_cast<bf16*>(smem_raw);   // QR x QS: q~
  bf16* sdo = sq + QR * QS;                       // QR x DS: dO
  bf16* sds = sdo + QR * DS;                      // kSlot: ds [query][key]
  bf16* slots = sds + kSlot;                      // kDqStages x kSlot
  auto* slse = reinterpret_cast<float*>(slots + kDqStages * kSlot);
  float* sdelta = slse + QR;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wr = warp % RG, wc = warp / RG;
  const int r0 = 16 * wr;
  const int q0 = blockIdx.x * QR, h = blockIdx.y, b = blockIdx.z;
  const int len = min(max(lens[b], 1), Tn);
  const int nkc = aug_chunks(DV, D);
  const int per_tile = 2 * nkc + NVC;
  const int total = (len + kRows - 1) / kRows * per_tile;
  const bf16* qp_bh = qp + (static_cast<size_t>(b) * H + h) * Tn * D;
  auto src = [=](int i) {
    const int r = i % per_tile, t0 = i / per_tile * kRows;
    if (r < nkc) return aug_chunk(k, kp, b, t0, h, r, Tn, H, DV, D);
    if (r < nkc + NVC)
      return head_chunk(v, b, t0, h, (r - nkc) * 64, VW, Tn, H, DV);
    return aug_chunk(k, kp, b, t0, h, r - nkc - NVC, Tn, H, DV, D);
  };

  stage_aug<NT, QR>(sq, qu, qp_bh, b, q0, h, Tn, H, DV, D);
  for (int i = tid; i < QR * DV / 8; i += NT) {
    const int r = i / (DV / 8), c = i % (DV / 8) * 8, t = q0 + r;
    const bool live = t < Tn;
    cp_async16(sdo + r * DS + c,
               dout + ((static_cast<size_t>(b) * Tn + (live ? t : 0)) * H +
                       h) * DV + c,
               live ? 16 : 0);
  }
  cp_async_commit();
  if (tid < 4 * QR) {
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
  auto ring = make_ring<kDqStages, kDqAhead, NT>(slots, total, src);
  ring.start();

  float acc[MAXCH][4][4] = {};
  for (int k0 = 0; k0 < len; k0 += kRows) {
    // the scores and dP of the warp's 16 rows and 32 keys
    float s[4][4] = {}, dp[4][4] = {};
    for (int j = 0; j < nkc; ++j) {
      const bf16* slot = ring.acquire();
      const AugCol c = aug_col(j, DV, D);
      const int qc = c.head ? c.col : DV + c.col;
      for (int kk = 0; kk < c.width; kk += 16) {
        unsigned a[4];
        a_frag(a, sq, QS, r0, qc + kk);
        mma_row<true>(s, a, slot, kCS, 32 * wc, kk);
      }
    }
#pragma unroll
    for (int jv = 0; jv < NVC; ++jv) {
      const bf16* slot = ring.acquire();
#pragma unroll
      for (int kk = 0; kk < VW; kk += 16) {
        unsigned a[4];
        a_frag(a, sdo, DS, r0, 64 * jv + kk);
        mma_row<true>(dp, a, slot, kCS, 32 * wc, kk);
      }
    }
    // p = exp(s scale - lse) over the valid keys, ds = p (dP - delta)
    // scale, rounded to bf16 into the shared ds tile
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r, key = 32 * wc + 8 * n + 2 * t4;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = k0 + key + e < len
                              ? expf(s[n][2 * r + e] * scale - slse[row])
                              : 0.f;
          ds[e] = p * (dp[n][2 * r + e] - sdelta[row]) * scale;
        }
        *reinterpret_cast<unsigned*>(sds + row * kCS + key) =
            pack_bf16(ds[0], ds[1]);
      }
    // dq~ += ds k~ over the warp's half of each chunk's columns (its
    // n-tiles: 4, or 2 of a 32-column chunk); the ring's next barrier
    // makes every warp's ds visible
#pragma unroll
    for (int j = 0; j < MAXCH; ++j) {
      if (j >= nkc) break;
      const bf16* slot = ring.acquire();
      const int half = aug_col(j, DV, D).width / 16;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        unsigned a[4];
        a_frag(a, sds, kCS, r0, 16 * ks);
#pragma unroll
        for (int n = 0; n < 4; n += 2) {
          if (n >= half) break;
          unsigned r[4];
          b_frag_kn(r, slot, kCS, 16 * ks, 8 * (wc * half + n));
          mma_bf16(acc[j][n], a, r[0], r[1]);
          mma_bf16(acc[j][n + 1], a, r[2], r[3]);
        }
      }
    }
  }

  // dq~ through the q~ tile, then 16-byte stores of dqu and dqp
  __syncthreads();                        // every warp is done with q~
#pragma unroll
  for (int j = 0; j < MAXCH; ++j) {
    if (j >= nkc) break;
    const AugCol c = aug_col(j, DV, D);
    const int half = c.width / 16;
    const int col0 = (c.head ? c.col : DV + c.col) + 8 * wc * half + 2 * t4;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (n >= half) break;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<unsigned*>(sq + (r0 + g + 8 * r) * QS + col0 +
                                     8 * n) =
            pack_bf16(acc[j][n][2 * r], acc[j][n][2 * r + 1]);
    }
  }
  __syncthreads();
  const int units = (DV + D) / 8;
  for (int i = tid; i < QR * units; i += NT) {
    const int r = i / units, c = i % units * 8, t = q0 + r;
    if (t >= Tn) continue;
    bf16* dst = c < DV
        ? dqu + ((static_cast<size_t>(b) * Tn + t) * H + h) * DV + c
        : dqp + ((static_cast<size_t>(b) * H + h) * Tn + t) * D + c - DV;
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(sq + r * QS + c);
  }
}

// dkv: 4 warps of 16 keys (k~ and v of the CTA's 64 keys stay in shared
// memory as the A operands), each computing its keys' transposed scores
// S^T = k~ q~^T and dP^T = v dO^T against every 64-query tile, whose q~
// and dO chunks stream through the ring, then dv += P^T dO and dk += dS^T
// q~[:, :Dh] from the weights in registers, with dO and q~[:, :Dh] read as
// B operands by ldmatrix.trans from the chunks the scores used.
template <int DV>
__global__ void __launch_bounds__(kDkvThreads)
flash_relpos_bwd_dkv_mma_kernel(
    const bf16* __restrict__ qu, const bf16* __restrict__ qp,
    const bf16* __restrict__ k, const bf16* __restrict__ kp,
    const bf16* __restrict__ v, const int* __restrict__ lens,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int Tn, int H, int D, float scale) {
  constexpr int NHC = head_chunks(DV), VW = DV < 64 ? DV : 64;
  constexpr int NVT = DV / 8, NS = dkv_stages<DV>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // k~, v and the slots in the swizzled layout that wgmma reads
  auto* sk = reinterpret_cast<bf16*>(aligned_smem(smem_raw));  // k~ panels
  bf16* sv = sk + panels(DV + D) * kPanel;        // v's panels
  bf16* slots = sv + panels(DV) * kPanel;         // NS panels

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4, r0 = 16 * warp;
  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int len = min(max(lens[b], 1), Tn);
  const size_t bh = static_cast<size_t>(b) * H + h;
  if (k0 >= len) {
    // keys at or past the length weigh 0 for every query: zero gradients
    for (int i = tid; i < kRows * DV / 8; i += kDkvThreads) {
      const int r = i / (DV / 8), c = i % (DV / 8) * 8, t = k0 + r;
      if (t >= Tn) continue;
      const size_t at = ((static_cast<size_t>(b) * Tn + t) * H + h) * DV + c;
      *reinterpret_cast<uint4*>(dk + at) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dv + at) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int npc = (D + 63) / 64;          // q~'s pos chunks
  const int per_tile = npc + 2 * NHC;
  const int total = (Tn + kRows - 1) / kRows * per_tile;
  const bf16* qp_bh = qp + bh * Tn * D;
  // a query tile: q~'s pos chunks, its head chunks, dO's chunks
  auto src = [=](int i) {
    const int r = i % per_tile, t0 = i / per_tile * kRows;
    if (r < npc) return aug_chunk(qu, qp_bh, b, t0, h, NHC + r, Tn, H, DV, D);
    if (r < npc + NHC)
      return head_chunk(qu, b, t0, h, (r - npc) * 64, VW, Tn, H, DV);
    return head_chunk(dout, b, t0, h, (r - npc - NHC) * 64, VW, Tn, H, DV);
  };

  stage_aug<kDkvThreads, kRows, true>(sk, k, kp, b, k0, h, Tn, H, DV, D);
  stage_head_sw<kDkvThreads, DV>(sv, v, b, k0, h, Tn, H);
  cp_async_commit();
  auto ring = make_ring<NS, kDkvAhead, kDkvThreads, true>(slots, total, src);
  ring.start();

  const bool key_ok[2] = {k0 + r0 + g < len, k0 + r0 + g + 8 < len};
  float acc_k[NVT][4] = {}, acc_v[NVT][4] = {};
  for (int q0 = 0; q0 < Tn; q0 += kRows) {
    // S^T and dP^T of the CTA's 64 keys (the warp's 16 in its registers)
    // and the tile's 64 queries, by wgmma from shared memory
    float s[8][4] = {}, dp[8][4] = {};
    for (int j = 0; j < npc; ++j) {
      const bf16* slot = ring.acquire();
      const AugCol c = aug_col(NHC + j, DV, D);
      wgmma_chunk(s, sk, DV + c.col, slot, c.width);
      wgmma_wait<1>();
    }
    const bf16* qh[NHC];
    const bf16* dos[NHC];
#pragma unroll
    for (int j = 0; j < NHC; ++j) {
      qh[j] = ring.acquire();
      wgmma_chunk(s, sk, 64 * j, qh[j], VW);
      wgmma_wait<1>();
    }
#pragma unroll
    for (int j = 0; j < NHC; ++j) {
      dos[j] = ring.acquire();
      wgmma_chunk(dp, sv, 64 * j, dos[j], VW);
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    // the weights of the warp's keys (rows g, g + 8) and the tile's
    // queries (columns 8 n + 2 t4 + e % 2)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = q0 + 8 * n + 2 * t4 + (e & 1);
        float p = 0.f, d = 0.f;
        if (t < Tn) {
          const size_t at = bh * Tn + t;
          d = __ldg(delta + at);
          if (key_ok[e / 2]) p = expf(s[n][e] * scale - __ldg(lse + at));
        }
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - d) * scale;
      }
    // dv += P^T dO and dk += dS^T q~[:, :Dh], 16 queries a step
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      unsigned pa[4], dsa[4];
      acc_frag(pa, s, ks);
      acc_frag(dsa, dp, ks);
#pragma unroll
      for (int j = 0; j < NHC; ++j)
#pragma unroll
        for (int n = 0; n < VW / 8; n += 2) {
          unsigned r[4];
          b_frag_kn_sw(r, dos[j], 16 * ks, 8 * n);
          mma_bf16(acc_v[8 * j + n], pa, r[0], r[1]);
          mma_bf16(acc_v[8 * j + n + 1], pa, r[2], r[3]);
          b_frag_kn_sw(r, qh[j], 16 * ks, 8 * n);
          mma_bf16(acc_k[8 * j + n], dsa, r[0], r[1]);
          mma_bf16(acc_k[8 * j + n + 1], dsa, r[2], r[3]);
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = k0 + r0 + g + 8 * r;
    if (t >= Tn) continue;
    const size_t at = ((static_cast<size_t>(b) * Tn + t) * H + h) * DV + 2 * t4;
#pragma unroll
    for (int n = 0; n < NVT; ++n) {
      *reinterpret_cast<unsigned*>(dk + at + 8 * n) =
          pack_bf16(acc_k[n][2 * r], acc_k[n][2 * r + 1]);
      *reinterpret_cast<unsigned*>(dv + at + 8 * n) =
          pack_bf16(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

}  // namespace flash_relpos

namespace {

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

// the dq kernel's chunks of Dh + D a warp holds in registers: buckets of
// MAXCH
template <int DV, int MAXCH>
int launch_dq_mma_as(const Args& a) {
  using flash_relpos::bf16;
  const size_t smem = flash_relpos::dq_smem_bytes<DV, MAXCH>(a.D);
  auto* kernel = flash_relpos::flash_relpos_bwd_dq_mma_kernel<DV, MAXCH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int rows = 16 * flash_relpos::dq_row_groups<MAXCH>();
  const dim3 grid((a.Tn + rows - 1) / rows, a.H, a.B);
  kernel<<<grid, flash_relpos::dq_threads<MAXCH>(), smem, a.stream>>>(
      static_cast<const bf16*>(a.qu), static_cast<const bf16*>(a.qp),
      static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.kp),
      static_cast<const bf16*>(a.v), a.lens, static_cast<const bf16*>(a.o),
      static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.dqu), static_cast<bf16*>(a.dqp), a.Tn, a.H, a.D,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

// the bucket of the dq kernel for (Dh, D): 5 chunks or kMaxDqChunks, 0
// past that
template <int DV>
int dq_bucket(int D) {
  const int chunks = flash_relpos::aug_chunks(DV, D);
  return chunks <= 5 ? 5
         : chunks <= flash_relpos::kMaxDqChunks ? flash_relpos::kMaxDqChunks
                                                : 0;
}

template <int DV>
int launch_dq_mma(const Args& a) {
  switch (dq_bucket<DV>(a.D)) {
    case 5: return launch_dq_mma_as<DV, 5>(a);
    case flash_relpos::kMaxDqChunks:
      return launch_dq_mma_as<DV, flash_relpos::kMaxDqChunks>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int DV>
int launch_dkv_mma(const Args& a) {
  using flash_relpos::bf16;
  const size_t smem = flash_relpos::dkv_smem_bytes<DV>(a.D);
  auto* kernel = flash_relpos::flash_relpos_bwd_dkv_mma_kernel<DV>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Tn + kRows - 1) / kRows, a.H, a.B);
  kernel<<<grid, flash_relpos::kDkvThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.qu), static_cast<const bf16*>(a.qp),
      static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.kp),
      static_cast<const bf16*>(a.v), a.lens, static_cast<const bf16*>(a.dout),
      a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.Tn, a.H, a.D, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// CTAs an SM holds of a kernel with `threads` threads and `smem` bytes of
// dynamic shared memory, or a negative CUDA error
template <class K>
int occupancy(K* kernel, int threads, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                        smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <int DV>
int ctas_per_sm_dh(bool dq, int D) {
  namespace fr = flash_relpos;
  if (!dq)
    return occupancy(fr::flash_relpos_bwd_dkv_mma_kernel<DV>,
                     fr::kDkvThreads, fr::dkv_smem_bytes<DV>(D));
  switch (dq_bucket<DV>(D)) {
    case 5:
      return occupancy(fr::flash_relpos_bwd_dq_mma_kernel<DV, 5>,
                       fr::dq_threads<5>(), fr::dq_smem_bytes<DV, 5>(D));
    case fr::kMaxDqChunks:
      return occupancy(
          fr::flash_relpos_bwd_dq_mma_kernel<DV, fr::kMaxDqChunks>,
          fr::dq_threads<fr::kMaxDqChunks>(),
          fr::dq_smem_bytes<DV, fr::kMaxDqChunks>(D));
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (!dq) return flash_relpos::dkv_smem_bytes<DV>(D);
  switch (dq_bucket<DV>(D)) {
    case 5: return flash_relpos::dq_smem_bytes<DV, 5>(D);
    case flash_relpos::kMaxDqChunks:
      return flash_relpos::dq_smem_bytes<DV, flash_relpos::kMaxDqChunks>(D);
    // a width the dq kernel's registers cannot hold takes no shared
    // memory that fits: the wrapper refuses it
    default: return 1LL << 40;
  }
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

// The CTAs of the bf16 dq or dkv kernel for (Dh, D) that one SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negative CUDA error.
extern "C" int flash_relpos_bwd_ctas_per_sm(int dq, int Dh, int D) {
  switch (Dh) {
    case 32: return ctas_per_sm_dh<32>(dq != 0, D);
    case 64: return ctas_per_sm_dh<64>(dq != 0, D);
    case 128: return ctas_per_sm_dh<128>(dq != 0, D);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
