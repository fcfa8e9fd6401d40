// The bf16 tensor-core helpers shared by the kernels that run their
// products through mma.sync (flash_relpos_fwd.cu, flash_relpos_bwd.cu,
// conformer_conv.cuh, flash_attn.cuh): a 32-bit load of two bf16, two fp32
// rounded and packed, the m16n8k16 product with fp32 accumulation, and
// ldmatrix's four 8 x 8 matrices from shared memory, plain or transposed.
#pragma once

#include <cuda_bf16.h>

namespace mma_sync {

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

}  // namespace mma_sync
