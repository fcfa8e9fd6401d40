// What the bf16 rel-pos flash attention kernels on the tensor cores share
// (flash_relpos_fwd.cu and flash_relpos_bwd.cu): the augmented rows' column
// chunks, a ring of shared-memory slots that cp.async fills ahead of the
// products, the staging of a whole augmented tile, the swizzled layout and
// the wgmma products that read it, and the shapes.
//
// An augmented row is [head | pos]: q~ = [q + u | A | B] with the head part
// from qu (B, T, H, Dh) and the pos part from qp (B, H, T, D); k~ = [k | cos
// | sin] with the pos part from the key table kp (T, D), the same rows for
// every batch row and head. The operands that stream through a CTA (k~ and
// v in the forward and the dq kernel; q~ and dO in the dkv kernel) are cut
// into chunks of 64 rows by at most 64 columns, each from one tensor: the
// head part in chunks of 64 columns (one of 32 at Dh = 32), the pos part in
// chunks of 64 with one of 32 last where D is an odd multiple of 32. Every
// chunk lands in one slot: for the mma.sync products (the dq kernel) 64
// rows of kCS = 72 bf16, 9 16-byte units, an odd count, so that the eight
// rows an ldmatrix matrix reads fall in eight different 16-byte bank
// groups; for wgmma (the forward's and the dkv kernel's scores) one
// 64 x 64 panel of the 128-byte swizzled layout (sw_off), which wgmma
// reads without bank conflicts. On an H100 the same wgmma products read
// from the unswizzled core-matrix layout ran slower than mma.sync, from
// the swizzled one faster; the dq kernel's mma.sync operands ran faster
// from the padded rows than from swizzled panels (their addresses cost
// more), so both layouts stay.
//
// The ring: NS slots; chunk c is copied PD chunks before it is used, so up
// to PD copies are in flight while the tensor cores work, and a chunk's
// slot stays valid for NS - PD - 1 chunks after it (KEEP), for a kernel
// that reads a chunk again later (the dkv kernel's q~ head and dO, and one
// chunk whose wgmma products may still be running). Each acquire waits for
// its chunk's copy, passes one CTA barrier (which also frees the slot the
// next copy overwrites) and issues the next copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_sync.cuh"

namespace flash_relpos {

using namespace mma_sync;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                 // rows of a chunk, a CTA's tile
constexpr int kCS = 72;                   // slot row stride (elements)
constexpr int kSlot = kRows * kCS;        // elements of a slot
constexpr int kPanel = kRows * 64;        // elements of a 64 x 64 panel
constexpr float kMasked = -1e30f;         // a masked key's score

// The swizzled layout, which wgmma reads from shared memory with its
// 128-byte swizzle: a tile of 64 rows is cut into panels of 64 columns, 8
// KB each; a panel's row r is 128 bytes at 128 r, and its 16-byte unit u
// sits at unit u ^ (r % 8) of the row. The eight rows that an ldmatrix
// matrix or the tensor core read at one logical unit fall in eight
// different units: no bank conflicts. Panels start on 1024-byte
// boundaries.
__device__ __forceinline__ int sw_off(int r, int c) {
  return (c >> 6) * kPanel + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) +
         (c & 7);
}
// the panels of a tile of `cols` columns
__host__ __device__ constexpr int panels(int cols) { return (cols + 63) / 64; }

// rows t0 .. t0 + 63 of a column block: src points at row t0's first
// column, stride is the distance between rows (elements), width 32 or 64
// columns; rows from `live` on are zero-filled
struct Chunk {
  const bf16* src;
  int stride, width, live;
};

// a chunk into a slot: rows of kCS elements, or (kSwizzled) the swizzled
// layout of one 64 x 64 panel
template <int NT, bool kSwizzled = false>
__device__ __forceinline__ void stage_chunk(bf16* slot, const Chunk& c) {
  const int shift = c.width == 64 ? 3 : 2;   // 16-byte units a row: 8 or 4
  for (int i = threadIdx.x; i < kRows << shift; i += NT) {
    const int r = i >> shift, col = (i & ((1 << shift) - 1)) * 8;
    const bool live = r < c.live;
    cp_async16(slot + (kSwizzled ? sw_off(r, col) : r * kCS + col),
               c.src + (live ? static_cast<size_t>(r) * c.stride + col : 0),
               live ? 16 : 0);
  }
}

// chunks of a Dh-wide head part and of a D-wide pos part
__host__ __device__ constexpr int head_chunks(int Dh) {
  return (Dh + 63) / 64;
}
__host__ __device__ constexpr int aug_chunks(int Dh, int D) {
  return head_chunks(Dh) + (D + 63) / 64;
}

// chunk j of an augmented row: its first column within the part, its
// width, and whether it lies in the head part
struct AugCol {
  int col, width;
  bool head;
};
__device__ __forceinline__ AugCol aug_col(int j, int Dh, int D) {
  const int nh = head_chunks(Dh);
  if (j < nh) return {64 * j, min(64, Dh - 64 * j), true};
  return {64 * (j - nh), min(64, D - 64 * (j - nh)), false};
}

// the chunk of rows t0 .. t0 + 63 of a (B, T, H, Dh) tensor, columns c0 ..
// c0 + width - 1, of head h of batch row b
__device__ __forceinline__ Chunk head_chunk(const bf16* x, int b, int t0,
                                            int h, int c0, int width,
                                            int Tn, int H, int Dh) {
  return {x + ((static_cast<size_t>(b) * Tn + t0) * H + h) * Dh + c0, H * Dh,
          width, min(kRows, Tn - t0)};
}

// the chunk of rows t0 .. t0 + 63 of a (T, D) table (pos_bh: the rows of
// one batch row and head, or the shared key table), columns c0 ..
__device__ __forceinline__ Chunk pos_chunk(const bf16* pos_bh, int t0,
                                           int c0, int width, int Tn, int D) {
  return {pos_bh + static_cast<size_t>(t0) * D + c0, D, width,
          min(kRows, Tn - t0)};
}

// chunk j (aug_col) of rows t0 .. of an augmented matrix [head | pos]
__device__ __forceinline__ Chunk aug_chunk(const bf16* head,
                                           const bf16* pos_bh, int b, int t0,
                                           int h, int j, int Tn, int H,
                                           int Dh, int D) {
  const AugCol a = aug_col(j, Dh, D);
  return a.head ? head_chunk(head, b, t0, h, a.col, a.width, Tn, H, Dh)
                : pos_chunk(pos_bh, t0, a.col, a.width, Tn, D);
}

// starts copying rows t0 .. t0 + ROWS - 1 of an augmented matrix into a
// tile of ROWS x (Dh + D + 8) bf16, or (kSwizzled, ROWS = 64) into
// panels of the swizzled layout, 16 bytes a copy; rows past T are
// zero-filled
template <int NT, int ROWS = kRows, bool kSwizzled = false>
__device__ __forceinline__ void stage_aug(bf16* tile, const bf16* head,
                                          const bf16* pos_bh, int b, int t0,
                                          int h, int Tn, int H, int Dh,
                                          int D) {
  const int units = (Dh + D) / 8, stride = Dh + D + 8;
  for (int i = threadIdx.x; i < ROWS * units; i += NT) {
    const int r = i / units, c = (i % units) * 8, t = t0 + r;
    const bool live = t < Tn;
    const size_t tt = live ? t : 0;
    const bf16* from =
        c < Dh ? head + ((static_cast<size_t>(b) * Tn + tt) * H + h) * Dh + c
               : pos_bh + tt * D + c - Dh;
    cp_async16(tile + (kSwizzled ? sw_off(r, c) : r * stride + c), from,
               live ? 16 : 0);
  }
}

// starts copying rows t0 .. t0 + 63 of head h of batch row b of a (B, T,
// H, Dh) tensor into panels of the swizzled layout; rows past T are
// zero-filled
template <int NT, int DH>
__device__ __forceinline__ void stage_head_sw(bf16* tile, const bf16* x,
                                              int b, int t0, int h, int Tn,
                                              int H) {
  for (int i = threadIdx.x; i < kRows * DH / 8; i += NT) {
    const int r = i / (DH / 8), c = i % (DH / 8) * 8, t = t0 + r;
    const bool live = t < Tn;
    cp_async16(tile + sw_off(r, c),
               x + ((static_cast<size_t>(b) * Tn + (live ? t : 0)) * H + h) *
                       DH + c,
               live ? 16 : 0);
  }
}

// NS slots, copies issued PD chunks ahead; src(i) describes chunk i of
// `total`; kSwizzled: each slot is one panel of the swizzled layout that
// wgmma reads
template <int NS, int PD, int NT, class Src, bool kSwizzled = false>
struct Ring {
  static_assert(PD >= 1 && PD < NS, "prefetch distance");
  static constexpr int kSize = kSwizzled ? kPanel : kSlot;
  bf16* base;
  int total, issued, used;
  Src src;

  __device__ Ring(bf16* base_, int total_, Src src_)
      : base(base_), total(total_), issued(0), used(0), src(src_) {}

  // the first PD copies, one commit group each
  __device__ void start() {
    for (; issued < PD; ++issued) {
      if (issued < total)
        stage_chunk<NT, kSwizzled>(base + issued % NS * kSize, src(issued));
      cp_async_commit();
    }
  }

  // the next chunk's slot, once every thread's copies of it have landed
  // and every warp is done with the chunk whose slot the next copy takes
  __device__ const bf16* acquire() {
    cp_async_wait<PD - 1>();
    // the copies are the generic proxy's writes; wgmma reads through the
    // async proxy
    if (kSwizzled)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (issued < total)
      stage_chunk<NT, kSwizzled>(base + issued % NS * kSize, src(issued));
    cp_async_commit();
    ++issued;
    return base + used++ % NS * kSize;
  }
};

template <int NS, int PD, int NT, bool kSwizzled = false, class Src>
__device__ Ring<NS, PD, NT, Src, kSwizzled> make_ring(bf16* base, int total,
                                                  Src src) {
  return Ring<NS, PD, NT, Src, kSwizzled>(base, total, src);
}

// ---- wgmma on swizzled tiles ---------------------------------------------

// the shared-memory descriptor of the K-major operand of a wgmma k-step
// at column `col` of a 64-row swizzled tile: the panel's rows from `col`
// on (the hardware applies the swizzle to the address), 128-byte swizzle
// (layout type 1), 8-row groups 1024 bytes apart; the leading offset is
// not read for a K-major swizzled operand
__device__ __forceinline__ unsigned long long sw_desc(const bf16* tile,
                                                      int col) {
  const unsigned a = static_cast<unsigned>(
      __cvta_generic_to_shared(tile + (col >> 6) * kPanel + (col & 63)));
  return static_cast<unsigned long long>((a & 0x3FFFF) >> 4) |
         (1ull << 16) | (static_cast<unsigned long long>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N groups of this warpgroup's products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (the warpgroup's 64 x 64 fp32 accumulator; a warp's 16 rows as 8
// n-tiles in mma.sync's accumulator layout) += a (64 x 16) b (64 x 16)^T,
// both K-major bf16 in shared memory
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[8][4],
                                               unsigned long long a,
                                               unsigned long long b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

// issues d += a[:, a_col .. a_col + width) b[:, :width)^T for one
// warpgroup as one commit group: a is a 64-row tile, b a 64 x 64 slot,
// both swizzled. The caller waits (wgmma_wait) before it reads d or lets
// b's slot be copied over.
__device__ __forceinline__ void wgmma_chunk(float (&d)[8][4], const bf16* a,
                                            int a_col, const bf16* b,
                                            int width) {
  wgmma_fence();
  for (int kk = 0; kk < width; kk += 16)
    wgmma_64x64x16(d, sw_desc(a, a_col + kk), sw_desc(b, kk));
  wgmma_commit();
}

// the B fragments of n-tiles n0 and n0 + 8 over k = kk .. kk + 15 from a
// swizzled tile stored [k][n], transposed by ldmatrix
__device__ __forceinline__ void b_frag_kn_sw(unsigned (&r)[4], const bf16* t,
                                             int kk, int n0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(r, t + sw_off(kk + lane % 8 + ((lane / 8) % 2) * 8,
                              n0 + (lane / 16) * 8));
}

// the dynamic shared memory of a kernel, from its first 1024-byte
// boundary (a kernel asks for kAlignPad bytes more): swizzled panels must
// start on one
constexpr int kAlignPad = 1024;
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(raw));
  return raw + ((1024 - (a & 1023)) & 1023);
}

// n-tiles n0 .. n0 + 7 of an accumulator, as a reference to 8 of them
template <int N>
__device__ __forceinline__ float (&tiles8(float (&c)[N][4], int n0))[8][4] {
  return *reinterpret_cast<float(*)[8][4]>(&c[n0]);
}

}  // namespace flash_relpos
