// Rel-pos flash attention forward: per (batch row, head),
//   o = softmax(q~ k~^T * scale, keys j >= len masked) v
// with fp32 scores, softmax and accumulation, where q~ = [q+u ; A ; B]
// and k~ = [k ; cos_j ; sin_j] (the Transformer-XL position term folded
// into the q.k product, see ops/flash_relpos.py), so the q.k head dim
// Dh + D differs from v's Dh.
//
// Replaces `_fwd_kernel` in openseq2seq_tpu/ops/flash_relpos.py:70 (its
// pallas_call at :123), which `rel_flash_attention` (:497) runs under the
// Conformer's RelPosSelfAttention with 128-key blocks (:497, and the
// encoder's call, encoders/conformer_encoder.py:74). As there: a masked
// key's score is replaced by -1e30 (not added to), the lengths are clamped
// to at least 1 so that key 0 is always valid and a masked key's weight is
// exactly 0; query rows t >= len are computed like the others (finite
// outputs over the valid keys, masked later by the caller); the weights
// are rounded where the TPU kernel rounds them: p = exp(s - m) against the
// running maximum m, which moves once a 128-key block, rounded to v's type
// before P.V, while l sums the unrounded p and the output is acc / l; the
// output has the inputs' type and, when asked, each row's lse = m + log(l)
// in fp32.
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
// Design, two kernels over the same inputs:
//  * bf16, the main path: `flash_relpos_fwd_mma_kernel` (flash_relpos.cuh),
//    bf16 operands and fp32 accumulation on the tensor cores, the TPU
//    kernel's own precision. One CTA of four warps, one warpgroup, per
//    (64-query tile, head, batch row); q~'s 64 rows are copied once into
//    shared memory with 16-byte cp.async. The keys stream through a ring
//    of four 64 x 64 slots, two chunks copied ahead of the products, so
//    that the copies overlap the tensor cores: for each 128-key block, the
//    k~ chunks (64 keys by 64 columns of k or of the key table) of its two
//    64-key tiles, then their v chunks. The key table's chunks are the same
//    for every batch row and head: at Conformer-M it is 128 KB and stays in
//    the 50 MB L2, so its share of the copies comes from L2, not device
//    memory. The scores are wgmma m64n64k16 products of q~ and a k~ chunk,
//    both read from shared memory in the 128-byte swizzled layout, one
//    chunk's products in flight while the next chunk arrives; the
//    warpgroup keeps the scores of its 64 rows and the block's 128 keys in
//    registers (a warp's 16 rows, a row in the four lanes of a quad) until
//    the block is scored whole, then runs the online softmax and uses the
//    rounded weights as the A fragments of P.V (mma.sync m16n8k16), whose
//    B fragments come from v's chunk by ldmatrix.trans: nothing is
//    transposed by hand and P never leaves the registers. Keys at or past
//    the row's length weigh exactly 0 and do not move the maximum, so the
//    tiles past it are not read. Shared memory 40 KB of q~ and 32 KB of
//    slots at Conformer-M (three CTAs an SM), 72 + 32 KB at Conformer-L's
//    Dh + D = 576 (two), each with 1 KB to align the panels.
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

#include "flash_relpos.cuh"

namespace {

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

}  // namespace

// ---- bf16: tensor cores ------------------------------------------------
namespace flash_relpos {

constexpr int kFwdThreads = 128;          // 4 warps of 16 query rows
constexpr int kFwdStages = 4;             // ring slots
constexpr int kFwdAhead = 2;              // chunks copied ahead

template <int DV>
size_t fwd_smem_bytes(int D) {
  return sizeof(bf16) * static_cast<size_t>(panels(DV + D) + kFwdStages) *
             kPanel + kAlignPad;
}

template <int DV>
__global__ void __launch_bounds__(kFwdThreads)
flash_relpos_fwd_mma_kernel(const bf16* __restrict__ qu,
                            const bf16* __restrict__ qp,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ kp,
                            const bf16* __restrict__ v,
                            const int* __restrict__ lens,
                            bf16* __restrict__ out, float* __restrict__ lse,
                            int Tn, int H, int D, float scale) {
  constexpr int NVT = DV / 8;             // P.V's n-tiles
  constexpr int NVC = head_chunks(DV);    // v's chunks a key tile
  constexpr int VW = DV < 64 ? DV : 64;   // their width
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // q~ and the slots in the swizzled layout that wgmma reads
  auto* sq = reinterpret_cast<bf16*>(aligned_smem(smem_raw));  // panels
  bf16* slots = sq + panels(DV + D) * kPanel;     // kFwdStages panels

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4, r0 = 16 * warp;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  // keys past the row's length weigh exactly 0 and leave the running
  // maximum where it is: only the 64-key tiles below it are read
  const int len = min(max(lens[b], 1), Tn);
  const int n_sub = (len + kRows - 1) / kRows;
  const int nkc = aug_chunks(DV, D);
  // a 128-key block streams the k~ chunks of its (one or two) 64-key
  // tiles, then their v chunks
  const int per_blk = 2 * (nkc + NVC);
  const int n_blk = (n_sub + 1) / 2;
  const int total =
      (n_blk - 1) * per_blk + (n_sub - 2 * (n_blk - 1)) * (nkc + NVC);
  auto src = [=](int i) {
    const int blk = i / per_blk, r = i % per_blk;
    const int ns = min(2, n_sub - 2 * blk), k0 = blk * kRoundBlock;
    if (r < ns * nkc)
      return aug_chunk(k, kp, b, k0 + r / nkc * kRows, h, r % nkc, Tn, H, DV,
                       D);
    const int rv = r - ns * nkc;
    return head_chunk(v, b, k0 + rv / NVC * kRows, h, rv % NVC * 64, VW, Tn,
                      H, DV);
  };

  stage_aug<kFwdThreads, kRows, true>(
      sq, qu, qp + (static_cast<size_t>(b) * H + h) * Tn * D, b, q0, h, Tn,
      H, DV, D);
  cp_async_commit();
  auto ring = make_ring<kFwdStages, kFwdAhead, kFwdThreads, true>(
      slots, total, src);
  ring.start();

  float o[NVT][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int blk = 0; blk < n_blk; ++blk) {
    const int ns = min(2, n_sub - 2 * blk), k0 = blk * kRoundBlock;
    // S = q~ k~^T for the CTA's 64 rows (the warp's 16 in its registers)
    // and the block's 128 keys, chunk by chunk of the contraction, by
    // wgmma from shared memory: the whole rounding block is scored before
    // any of its weights is exponentiated
    float s[16][4] = {};
#pragma unroll
    for (int sub = 0; sub < 2; ++sub) {
      if (sub >= ns) continue;
      for (int j = 0; j < nkc; ++j) {
        const bf16* slot = ring.acquire();
        const AugCol c = aug_col(j, DV, D);
        wgmma_chunk(tiles8(s, 8 * sub), sq, c.head ? c.col : DV + c.col,
                    slot, c.width);
        // the last chunk's products are done, so its slot may be copied
        // over after the next barrier; this one's run on
        wgmma_wait<1>();
      }
    }
    wgmma_wait<0>();

    // the online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3), its
    // maximum moved once a block, as `_fwd_kernel` moves it
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = k0 + 8 * n + 2 * t4 + (e & 1);
        s[n][e] = t < len ? s[n][e] * scale : kMasked;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float rescale[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key k0 < len is in every block, so the new maximum is finite
      const float m_new = fmaxf(m[r], mx[r]);
      rescale[r] = expf(m[r] - m_new);    // 0 on the first block
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 16; ++n)
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
    for (int n = 0; n < NVT; ++n) {
      o[n][0] *= rescale[0];
      o[n][1] *= rescale[0];
      o[n][2] *= rescale[1];
      o[n][3] *= rescale[1];
    }

    // O += P v: the weights, rounded to bf16, are the A fragments of the
    // 16-key steps, straight from the scores' registers; v's chunks give
    // the B fragments through ldmatrix.trans
#pragma unroll
    for (int sub = 0; sub < 2; ++sub) {
      if (sub >= ns) continue;
#pragma unroll
      for (int jv = 0; jv < NVC; ++jv) {
        const bf16* slot = ring.acquire();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          unsigned a[4];
          acc_frag(a, s, 4 * sub + ks);
#pragma unroll
          for (int n = 0; n < VW / 8; n += 2) {
            unsigned r[4];
            b_frag_kn_sw(r, slot, 16 * ks, 8 * n);
            mma_bf16(o[8 * jv + n], a, r[0], r[1]);
            mma_bf16(o[8 * jv + n + 1], a, r[2], r[3]);
          }
        }
      }
    }
  }

  // the output o / l through the q~ tile, then 16-byte stores
  __syncthreads();                        // every warp is done with q~
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < NVT; ++n)
      *reinterpret_cast<unsigned*>(sq + sw_off(r0 + g + 8 * r,
                                               8 * n + 2 * t4)) =
          pack_bf16(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * DV / 8; i += kFwdThreads) {
    const int r = i / (DV / 8), c = i % (DV / 8) * 8, t = q0 + r;
    if (t < Tn)
      *reinterpret_cast<uint4*>(
          out + ((static_cast<size_t>(b) * Tn + t) * H + h) * DV + c) =
          *reinterpret_cast<const uint4*>(sq + sw_off(r, c));
  }
  if (lse != nullptr && t4 == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = q0 + r0 + g + 8 * r;
      if (t < Tn)
        lse[(static_cast<size_t>(b) * H + h) * Tn + t] = m[r] + logf(l[r]);
    }
}

template <int DV>
int launch_mma(const void* qu, const void* qp, const void* k, const void* kp,
               const void* v, const int* lens, void* out, float* lse, int B,
               int Tn, int H, int D, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<DV>(D);
  auto* kernel = flash_relpos_fwd_mma_kernel<DV>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tn + kRows - 1) / kRows, H, B);
  kernel<<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const bf16*>(qu), static_cast<const bf16*>(qp),
      static_cast<const bf16*>(k), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(v), lens, static_cast<bf16*>(out), lse, Tn, H,
      D, scale);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the kernel for (Dh, D) an SM holds, or a negative CUDA error
template <int DV>
int ctas_per_sm(int D) {
  const size_t smem = fwd_smem_bytes<DV>(D);
  auto* kernel = flash_relpos_fwd_mma_kernel<DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                        kFwdThreads, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace flash_relpos

namespace {

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
  return is_bf16 ? flash_relpos::launch_mma<DV>(qu, qp, k, kp, v, lens, out,
                                                lse, B, Tn, H, D, scale,
                                                stream)
                 : launch_fma<DV>(qu, qp, k, kp, v, lens, out, lse, B, Tn, H,
                                  D, scale, stream);
}

template <int DV>
long long smem_bytes(int D, int is_bf16) {
  return static_cast<long long>(is_bf16 ? flash_relpos::fwd_smem_bytes<DV>(D)
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

// The CTAs of the bf16 kernel for (Dh, D) that one SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negative CUDA error.
extern "C" int flash_relpos_fwd_ctas_per_sm(int Dh, int D) {
  switch (Dh) {
    case 32: return flash_relpos::ctas_per_sm<32>(D);
    case 64: return flash_relpos::ctas_per_sm<64>(D);
    case 128: return flash_relpos::ctas_per_sm<128>(D);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
