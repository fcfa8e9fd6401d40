// The bf16 tensor-core helpers shared by the kernels that run their
// products through mma.sync (flash_relpos.cuh, conformer_conv.cuh,
// flash_attn.cuh): a 32-bit load of two bf16, two fp32 rounded and packed,
// the m16n8k16 product with fp32 accumulation, ldmatrix's four 8 x 8
// matrices from shared memory, plain or transposed, the A and B fragments
// read with it from row-major tiles (A also from a transposed one), a row
// of products, accumulators as the next product's A fragments, and
// 16-byte cp.async staging.
#pragma once

#include <cuda_bf16.h>

namespace mma_sync {

// keys of one rounding block of the bf16 flash forwards: the key block of
// the TPU kernels they replace, whose running maximum, and so the value
// each weight is rounded at, moves once a block
constexpr int kRoundBlock = 128;

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices: lanes 8 i .. 8 i + 7 give the row addresses
// (16 bytes each) of matrix i, and r[i] holds the lane's pair of it (row
// lane / 4, columns 2 (lane % 4) and + 1; with `trans` the pair of column
// lane / 4 in rows 2 (lane % 4) and + 1)
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4],
                                        const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0
// zero-fills the destination
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

// A fragment: rows r0 .. r0 + 15, columns kk .. kk + 15 of a row-major tile
__device__ __forceinline__ void a_frag(unsigned (&a)[4],
                                       const __nv_bfloat16* tile, int stride,
                                       int r0, int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, tile + (r0 + lane % 16) * stride + kk + (lane / 16) * 8);
}

// the same from a tile stored [k][m] (A = the tile transposed), transposed
// by ldmatrix
__device__ __forceinline__ void a_frag_km(unsigned (&a)[4],
                                          const __nv_bfloat16* tile,
                                          int stride, int m0, int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(a, tile + (kk + lane % 8 + (lane / 16) * 8) * stride + m0 +
                       ((lane / 8) % 2) * 8);
}

// B fragments of n-tiles n0 and n0 + 8 over k = kk .. kk + 15 from a tile
// stored [n][k] (B = the tile's rows transposed): {b0, b1} of n0 in r[0],
// r[1], of n0 + 8 in r[2], r[3]
__device__ __forceinline__ void b_frag_nk(unsigned (&r)[4],
                                          const __nv_bfloat16* tile,
                                          int stride, int n0, int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(r, tile + (n0 + lane % 8 + (lane / 16) * 8) * stride + kk +
                 ((lane / 8) % 2) * 8);
}

// the same from a tile stored [k][n] (B = the tile itself), transposed by
// ldmatrix
__device__ __forceinline__ void b_frag_kn(unsigned (&r)[4],
                                          const __nv_bfloat16* tile,
                                          int stride, int kk, int n0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(r, tile + (kk + lane % 8 + ((lane / 8) % 2) * 8) * stride +
                       n0 + (lane / 16) * 8);
}

// c[0..N-1] += a (16 x 16) . (the 8 N columns from n0 of B over k = kk ..
// kk + 15), B read by b_frag_nk (kNK) or b_frag_kn
template <bool kNK, int N>
__device__ __forceinline__ void mma_row(float (&c)[N][4],
                                        const unsigned (&a)[4],
                                        const __nv_bfloat16* tile,
                                        int stride, int n0, int kk) {
#pragma unroll
  for (int n = 0; n < N; n += 2) {
    unsigned r[4];
    if (kNK)
      b_frag_nk(r, tile, stride, n0 + 8 * n, kk);
    else
      b_frag_kn(r, tile, stride, kk, n0 + 8 * n);
    mma_bf16(c[n], a, r[0], r[1]);
    mma_bf16(c[n + 1], a, r[2], r[3]);
  }
}

// the accumulators of n-tiles 2 ks and 2 ks + 1, rounded to bf16, as the A
// fragment of the next product's k-step ks
template <int N>
__device__ __forceinline__ void acc_frag(unsigned (&f)[4],
                                         const float (&c)[N][4], int ks) {
  f[0] = pack_bf16(c[2 * ks][0], c[2 * ks][1]);
  f[1] = pack_bf16(c[2 * ks][2], c[2 * ks][3]);
  f[2] = pack_bf16(c[2 * ks + 1][0], c[2 * ks + 1][1]);
  f[3] = pack_bf16(c[2 * ks + 1][2], c[2 * ks + 1][3]);
}

}  // namespace mma_sync
