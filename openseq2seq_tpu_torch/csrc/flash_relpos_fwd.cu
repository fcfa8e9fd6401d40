// Rel-pos flash attention forward: per (batch row, head),
//   o = softmax(q~ k~^T * scale, keys j >= len masked) v
// with fp32 scores, softmax and accumulation, where q~ = [q+u ; A ; B]
// and k~ = [k ; cos_j ; sin_j] (the Transformer-XL position term folded
// into the q.k product, see ops/flash_relpos.py), so the q.k head dim
// Dh + D differs from v's Dh.
//
// Replaces `_fwd_kernel` in openseq2seq_tpu/ops/flash_relpos.py:70 (its
// pallas_call at :123), which `rel_flash_attention` (:497) runs under the
// Conformer's RelPosSelfAttention. As there: a masked key's score is
// replaced by -1e30 (not added to), the lengths are clamped to at least
// 1 so that key 0 is always valid and a masked key's weight is exactly
// 0; query rows t >= len are computed like the others (finite outputs
// over the valid keys, masked later by the caller); p is rounded to v's
// type before P.V while l sums the unrounded p; the output has the
// inputs' type and, when asked, each row's lse = m + log(l) in fp32.
//
// Inputs are read where the module has them, so q~ and k~ are never
// written to device memory whole: qu = q + u (B, T, H, Dh) and k, v
// (B, T, H, Dh) in the module's layout, the position queries qp = [A | B]
// (B, H, T, D), and the shared key table kp = [cos | sin] (T, D), the
// same for every row and head. The output is the context in (B, T, H, Dh).
//
// What bounds it on an H100: bytes. At Conformer-M (B=64, H=4, T=250,
// Dh=64, D=256, bf16) it does 2 B H T^2 (Dh + D + Dh) = 12.3 GFLOP (12.4 us
// at 989 TFLOP/s) and must move qu, qp, k, v and o, 65.7 MB (19.6 us at
// 3.35 TB/s); materialised (B, H, T, Dh + D) q~ and k~ would be 98 MB.
//
// Design, two kernels over the same inputs (a simple pair that is right;
// wgmma, TMA and warp specialisation are later work):
//  * bf16, the main path: `flash_relpos_fwd_mma_kernel`, tensor cores
//    through mma.sync m16n8k16 (bf16 operands, fp32 accumulation, the
//    TPU kernel's own precision). One CTA of four warps per (64-query
//    tile, head, batch row), each warp 16 query rows. The tile's q~ rows
//    stay in shared memory for the whole key loop; each 64-key tile's k~
//    rows and v (transposed, so that a B fragment is one 32-bit load) are
//    staged beside them with 16-byte loads. Fragments are read straight
//    from shared memory, whose row strides (Dh + D + 8 and 72 elements)
//    put a fragment's 32 words in 32 banks. The scores' accumulators are
//    the online softmax's state: a row lives in the four lanes of a quad,
//    combined with two xor-shuffles, and the weights, rounded to bf16,
//    become P.V's A fragments in place. 41 + 41 + 9 KB of shared memory
//    at Conformer-M (two CTAs an SM), 159 KB at Conformer-L's Dh + D =
//    576.
//  * fp32: `flash_relpos_fwd_kernel`, fp32 FMAs on the CUDA cores (TF32
//    would round the operands): 256 threads, four per query row; q~ in
//    shared memory, each key tile's k~ staged in chunks of 32 columns so
//    that shared memory does not grow with D; 16-byte shared-memory loads
//    of q~, k~, p and v.
//  * key tiles past T are skipped; keys past T in the last tile get
//    weight 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_sync.cuh"

namespace {

using namespace mma_sync;

constexpr int kRows = 64;                 // queries per CTA
constexpr int kKeys = 64;                 // keys per tile
constexpr int kTpr = 4;                   // threads per query row
constexpr int kThreads = kRows * kTpr;    // 256
constexpr int kChunk = 32;                // k~ columns staged at once
constexpr int kCS = kChunk + 4;           // k~ chunk row stride (floats)
constexpr int kPS = kKeys + 4;            // weights row stride (floats)
constexpr float kMasked = -1e30f;

// four consecutive floats of shared memory
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// fp32 kernel: q~ row stride in elements, a multiple of 4 (16-byte loads)
// whose offset spreads the quads' eight rows over the banks
__host__ __device__ constexpr int q_stride(int dqk) { return dqk + 4; }

template <int DV>
size_t fma_smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kRows) * q_stride(DV + D) +
                          static_cast<size_t>(kKeys) * kCS +
                          static_cast<size_t>(kKeys) * (DV + 4) +
                          static_cast<size_t>(kRows) * kPS);
}

template <int DV>
__global__ void __launch_bounds__(kThreads)
flash_relpos_fwd_kernel(const float* __restrict__ qu,
                        const float* __restrict__ qp,
                        const float* __restrict__ k,
                        const float* __restrict__ kp,
                        const float* __restrict__ v,
                        const int* __restrict__ lens,
                        float* __restrict__ out, float* __restrict__ lse,
                        int Tn, int H, int D, float scale) {
  constexpr int VS = DV + 4;
  constexpr int KPT = kKeys / kTpr;       // scores per thread
  constexpr int OPT = DV / kTpr;          // output columns per thread
  const int DQK = DV + D;
  const int QS = q_stride(DQK);
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                        // kRows x QS
  float* sk = sq + kRows * QS;             // kKeys x kCS
  float* sv = sk + kKeys * kCS;            // kKeys x VS
  float* sp = sv + kKeys * VS;             // kRows x kPS

  const int tid = threadIdx.x;
  const int row = tid / kTpr, sub = tid % kTpr;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int qi = q0 + row;
  const int len = max(lens[b], 1);

  // the tile's q~ rows: [q + u | A | B], zero past T
  for (int i = tid; i < kRows * DV; i += kThreads) {
    const int r = i / DV, d = i % DV, t = q0 + r;
    sq[r * QS + d] =
        t < Tn ? qu[((static_cast<size_t>(b) * Tn + t) * H + h) * DV + d]
               : 0.f;
  }
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    sq[r * QS + DV + d] =
        t < Tn ? qp[((static_cast<size_t>(b) * H + h) * Tn + t) * D + d]
               : 0.f;
  }

  float o[OPT];
#pragma unroll
  for (int c = 0; c < OPT; ++c) o[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < Tn; k0 += kKeys) {
    __syncthreads();                      // the last tile's P.V is done
    for (int i = tid; i < kKeys * DV; i += kThreads) {
      const int j = i / DV, d = i % DV, t = k0 + j;
      sv[j * VS + d] =
          t < Tn ? v[((static_cast<size_t>(b) * Tn + t) * H + h) * DV + d]
                 : 0.f;
    }
    float s[KPT];
#pragma unroll
    for (int c = 0; c < KPT; ++c) s[c] = 0.f;
    for (int c0 = 0; c0 < DQK; c0 += kChunk) {
      __syncthreads();                    // the last chunk's reads are done
      // k~ columns c0 .. c0 + 31: from k (c0 < Dh) or from the table
      for (int i = tid; i < kKeys * kChunk; i += kThreads) {
        const int j = i / kChunk, d = i % kChunk, t = k0 + j, col = c0 + d;
        float x = 0.f;
        if (t < Tn)
          x = col < DV
                  ? k[((static_cast<size_t>(b) * Tn + t) * H + h) * DV + col]
                  : kp[static_cast<size_t>(t) * D + col - DV];
        sk[j * kCS + d] = x;
      }
      __syncthreads();
#pragma unroll 2
      for (int d = 0; d < kChunk; d += 4) {
        const float4 qd = load4(sq + row * QS + c0 + d);
#pragma unroll
        for (int c = 0; c < KPT; ++c) {
          const float4 kd = load4(sk + (sub + kTpr * c) * kCS + d);
          s[c] = fmaf(qd.x, kd.x, s[c]);
          s[c] = fmaf(qd.y, kd.y, s[c]);
          s[c] = fmaf(qd.z, kd.z, s[c]);
          s[c] = fmaf(qd.w, kd.w, s[c]);
        }
      }
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int c = 0; c < KPT; ++c) {
      const int t = k0 + sub + kTpr * c;
      s[c] = t >= Tn ? -INFINITY : t >= len ? kMasked : s[c] * scale;
      tile_max = fmaxf(tile_max, s[c]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    // key k0 < Tn is in every tile, so tile_max and m_new are finite
    const float m_new = fmaxf(m, tile_max);
    const float rescale = expf(m - m_new);   // 0 on the first tile
    float row_sum = 0.f;
#pragma unroll
    for (int c = 0; c < KPT; ++c) {
      const float p = expf(s[c] - m_new);    // 0 for masked keys
      sp[row * kPS + sub + kTpr * c] = p;
      row_sum += p;
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    l = l * rescale + row_sum;
    m = m_new;
    __syncwarp();                           // the row's weights are in sp
#pragma unroll
    for (int c = 0; c < OPT; ++c) o[c] *= rescale;
    // the thread's columns: four at a time, 4 sub + 16 g + (0..3)
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      const float4 pj = load4(sp + row * kPS + j);
      const float pw[4] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int g = 0; g < OPT / 4; ++g) {
          const float4 vd = load4(sv + (j + jj) * VS + 4 * sub + 16 * g);
          o[4 * g] = fmaf(pw[jj], vd.x, o[4 * g]);
          o[4 * g + 1] = fmaf(pw[jj], vd.y, o[4 * g + 1]);
          o[4 * g + 2] = fmaf(pw[jj], vd.z, o[4 * g + 2]);
          o[4 * g + 3] = fmaf(pw[jj], vd.w, o[4 * g + 3]);
        }
    }
  }

  if (qi < Tn) {
    const float inv = 1.f / l;
    float* dst = out + ((static_cast<size_t>(b) * Tn + qi) * H + h) * DV;
#pragma unroll
    for (int g = 0; g < OPT / 4; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[4 * sub + 16 * g + e] = o[4 * g + e] * inv;
    if (lse != nullptr && sub == 0)
      lse[(static_cast<size_t>(b) * H + h) * Tn + qi] = m + logf(l);
  }
}

// ---- bf16: tensor cores ------------------------------------------------
constexpr int kMmaWarps = 4;               // 16 query rows each
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kVS = kKeys + 8;             // v^T row stride (elements)

// q~ and k~ row stride in elements: (Dh + D) / 2 + 4 words, 4 or 20 mod 32,
// puts the 8 x 4 words of a fragment in 32 banks
__host__ __device__ constexpr int mma_stride(int dqk) { return dqk + 8; }

template <int DV>
size_t mma_smem_bytes(int D) {
  return sizeof(__nv_bfloat16) *
         (2 * static_cast<size_t>(kRows) * mma_stride(DV + D) +
          static_cast<size_t>(DV) * kVS);
}

// one row of q~ or k~ (Dh + D bf16) from the module's tensors into shared
// memory, 8 elements a load; zeros for t past T
__device__ __forceinline__ void stage_row(__nv_bfloat16* dst,
                                          const __nv_bfloat16* head,
                                          const __nv_bfloat16* pos, int DV,
                                          int D, bool live, int c) {
  uint4 x = make_uint4(0u, 0u, 0u, 0u);
  if (live)
    x = *reinterpret_cast<const uint4*>(c < DV ? head + c : pos + c - DV);
  *reinterpret_cast<uint4*>(dst + c) = x;
}

template <int DV>
__global__ void __launch_bounds__(kMmaThreads)
flash_relpos_fwd_mma_kernel(const __nv_bfloat16* __restrict__ qu,
                            const __nv_bfloat16* __restrict__ qp,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ kp,
                            const __nv_bfloat16* __restrict__ v,
                            const int* __restrict__ lens,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int Tn, int H, int D,
                            float scale) {
  constexpr int NV = DV / 8;              // P.V's n-tiles
  const int DQK = DV + D;
  const int QS = mma_stride(DQK);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // kRows x QS
  __nv_bfloat16* sk = sq + kRows * QS;                     // kKeys x QS
  __nv_bfloat16* svt = sk + kKeys * QS;                    // DV x kVS

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;  // fragment row and column pair
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int len = max(lens[b], 1);
  const int vecs = DQK / 8;

  // the tile's q~ rows: [q + u | A | B], zero past T
  for (int i = tid; i < kRows * vecs; i += kMmaThreads) {
    const int r = i / vecs, c = (i % vecs) * 8, t = q0 + r;
    const bool live = t < Tn;
    const size_t tt = live ? t : 0;
    stage_row(sq + r * QS, qu + ((b * Tn + tt) * H + h) * DV,
              qp + ((static_cast<size_t>(b) * H + h) * Tn + tt) * D, DV, D,
              live, c);
  }

  float o[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const __nv_bfloat16* qa = sq + (warp * 16 + g) * QS + 2 * t4;

  for (int k0 = 0; k0 < Tn; k0 += kKeys) {
    __syncthreads();                      // the last tile's reads are done
    for (int i = tid; i < kKeys * vecs; i += kMmaThreads) {
      const int j = i / vecs, c = (i % vecs) * 8, t = k0 + j;
      const bool live = t < Tn;
      const size_t tt = live ? t : 0;
      stage_row(sk + j * QS, k + ((b * Tn + tt) * H + h) * DV, kp + tt * D,
                DV, D, live, c);
    }
    for (int i = tid; i < kKeys * DV; i += kMmaThreads) {
      const int j = i / DV, d = i % DV, t = k0 + j;
      svt[d * kVS + j] =
          t < Tn ? v[((static_cast<size_t>(b) * Tn + t) * H + h) * DV + d]
                 : __float2bfloat16(0.f);
    }
    __syncthreads();

    // S = q~ k~^T for the warp's 16 rows and the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int kk = 0; kk < DQK; kk += 16) {
      const unsigned a[4] = {ld32(qa + kk), ld32(qa + 8 * QS + kk),
                             ld32(qa + kk + 8), ld32(qa + 8 * QS + kk + 8)};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kb = sk + (8 * n + g) * QS + kk + 2 * t4;
        mma_bf16(s[n], a, ld32(kb), ld32(kb + 8));
      }
    }

    // the online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = k0 + 8 * n + 2 * t4 + (e & 1);
        s[n][e] = t >= Tn ? -INFINITY : t >= len ? kMasked : s[n][e] * scale;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float rescale[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key k0 < Tn is in every tile, so the new maximum is finite
      const float m_new = fmaxf(m[r], mx[r]);
      rescale[r] = expf(m[r] - m_new);    // 0 on the first tile
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e / 2]);   // 0 for masked keys
        sum[e / 2] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * rescale[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      o[n][0] *= rescale[0];
      o[n][1] *= rescale[0];
      o[n][2] *= rescale[1];
      o[n][3] *= rescale[1];
    }

    // O += P v: the weights, rounded to bf16, are the A fragments of the
    // four 16-key steps (n-tiles 2 ks and 2 ks + 1)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const unsigned a[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                             pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                             pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                             pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const __nv_bfloat16* vb = svt + (8 * n + g) * kVS + 16 * ks + 2 * t4;
        mma_bf16(o[n], a, ld32(vb), ld32(vb + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + warp * 16 + g + 8 * r;
    if (t >= Tn) continue;
    const float inv = 1.f / l[r];
    __nv_bfloat16* dst =
        out + ((static_cast<size_t>(b) * Tn + t) * H + h) * DV + 2 * t4;
#pragma unroll
    for (int n = 0; n < NV; ++n)
      *reinterpret_cast<unsigned*>(dst + 8 * n) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (lse != nullptr && t4 == 0)
      lse[(static_cast<size_t>(b) * H + h) * Tn + t] = m[r] + logf(l[r]);
  }
}

template <int DV>
int launch_mma(const void* qu, const void* qp, const void* k, const void* kp,
               const void* v, const int* lens, void* out, float* lse, int B,
               int Tn, int H, int D, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const size_t smem = mma_smem_bytes<DV>(D);
  auto* kernel = flash_relpos_fwd_mma_kernel<DV>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tn + kRows - 1) / kRows, H, B);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(qu), static_cast<const bf16*>(qp),
      static_cast<const bf16*>(k), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(v), lens, static_cast<bf16*>(out), lse, Tn, H,
      D, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DV>
int launch_fma(const void* qu, const void* qp, const void* k, const void* kp,
               const void* v, const int* lens, void* out, float* lse, int B,
               int Tn, int H, int D, float scale, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes<DV>(D);
  auto* kernel = flash_relpos_fwd_kernel<DV>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tn + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qu), static_cast<const float*>(qp),
      static_cast<const float*>(k), static_cast<const float*>(kp),
      static_cast<const float*>(v), lens, static_cast<float*>(out), lse, Tn,
      H, D, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DV>
int launch(const void* qu, const void* qp, const void* k, const void* kp,
           const void* v, const int* lens, void* out, float* lse, int B,
           int Tn, int H, int D, int is_bf16, float scale,
           cudaStream_t stream) {
  return is_bf16 ? launch_mma<DV>(qu, qp, k, kp, v, lens, out, lse, B, Tn, H,
                                  D, scale, stream)
                 : launch_fma<DV>(qu, qp, k, kp, v, lens, out, lse, B, Tn, H,
                                  D, scale, stream);
}

template <int DV>
long long smem_bytes(int D, int is_bf16) {
  return static_cast<long long>(is_bf16 ? mma_smem_bytes<DV>(D)
                                        : fma_smem_bytes<DV>(D));
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success). The caller guarantees B, T, H >= 1, Dh in {32, 64, 128}, D a
// multiple of 32 with flash_relpos_fwd_smem's shared memory within the
// card's 227 KB, contiguous device buffers of one type (bf16 when is_bf16,
// else fp32): qu, k, v and out (B, T, H, Dh), qp (B, H, T, D), kp (T, D);
// lens (B,) int32; lse null or a (B, H, T) fp32 buffer.
extern "C" int flash_relpos_fwd(const void* qu, const void* qp,
                                const void* k, const void* kp,
                                const void* v, const void* lens, void* out,
                                void* lse, int B, int Tn, int H, int Dh,
                                int D, int is_bf16, float scale,
                                void* stream) {
  const auto* n = static_cast<const int*>(lens);
  auto* lse_out = static_cast<float*>(lse);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32:
      return launch<32>(qu, qp, k, kp, v, n, out, lse_out, B, Tn, H, D,
                        is_bf16, scale, s);
    case 64:
      return launch<64>(qu, qp, k, kp, v, n, out, lse_out, B, Tn, H, D,
                        is_bf16, scale, s);
    case 128:
      return launch<128>(qu, qp, k, kp, v, n, out, lse_out, B, Tn, H, D,
                         is_bf16, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory the kernel for (Dh, D, type) asks for, so that
// the wrapper can refuse a shape that would not fit before it launches.
extern "C" long long flash_relpos_fwd_smem(int Dh, int D, int is_bf16) {
  switch (Dh) {
    case 32: return smem_bytes<32>(D, is_bf16);
    case 64: return smem_bytes<64>(D, is_bf16);
    case 128: return smem_bytes<128>(D, is_bf16);
    default: return -1;
  }
}
