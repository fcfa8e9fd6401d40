// What the bf16 flash attention kernels on the tensor cores share
// (flash_attn_fwd.cu and flash_attn_bwd.cu): the CTA's shape for a head
// dim, 16-byte asynchronous staging of (B, T, H, D) rows into padded
// shared-memory tiles, the mma.sync fragments read from those tiles with
// ldmatrix, the masks, and the 16-byte store of an accumulator tile.
//
// Tiles: a CTA owns ROWS rows (queries in the forward and the dq kernel,
// keys in the dkv kernel) and streams the other side in tiles of kTile = 64
// rows (the forward past 64 keys: of kRoundBlock = 128, its rounding
// block), double-buffered when there is more than one. A warp computes the
// scores of 16 own rows against a whole streamed tile (8 n-tiles of 8) and
// accumulates 64 columns of its output; at D > 64 the WC = D / 64 warps of
// a row group split the output's columns and each computes the (same)
// scores. At D = 256 a CTA owns 32 rows, so that its 8 warps fit 256
// threads.
//
// Shared memory: bf16 rows of D + 8 elements, (D + 8) / 8 = 9, 17 or 33
// 16-byte units: odd, so the eight rows an ldmatrix matrix or a row of
// 32-bit accumulator stores touches fall in eight different 16-byte bank
// groups (no conflicts) and cp.async writes whole 16-byte units.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_sync.cuh"

namespace flash_attn {

using namespace mma_sync;
using bf16 = __nv_bfloat16;

constexpr float kMasked = -1e9f;
constexpr int kTile = 64;                  // streamed rows a step

template <int D>
struct Shape {
  static constexpr int WC = D / 64;        // warps of a row group: 64 columns each
  static constexpr int RG = WC == 4 ? 2 : 4;   // row groups of 16 rows
  static constexpr int ROWS = 16 * RG;     // the CTA's own rows
  static constexpr int THREADS = 32 * RG * WC;
  static constexpr int S = D + 8;          // tile row stride (elements)
};

// starts copying rows t0 .. t0 + rows - 1 of head h of batch row b of a
// (B, T, H, D) tensor into dst (rows x (D + 8)), 16 bytes a copy; rows past
// T are zero-filled
template <int D, int NT>
__device__ __forceinline__ void stage_rows(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int t0, int rows, int T, int H,
                                           int h, int b) {
  constexpr int VECS = D / 8;
  for (int i = threadIdx.x; i < rows * VECS; i += NT) {
    const int r = i / VECS, c = (i % VECS) * 8, t = t0 + r;
    const bool live = t < T;
    const bf16* from =
        src + ((static_cast<size_t>(b) * T + (live ? t : t0)) * H + h) * D +
        c;
    cp_async16(dst + r * (D + 8) + c, from, live ? 16 : 0);
  }
}

// the first valid key of batch row b (Tk when none; 0 without a mask),
// which tells the rows without any valid key; one warp, by ballots
__device__ __forceinline__ int first_valid_key(
    const unsigned char* __restrict__ kv_valid, int b, int Tk) {
  if (kv_valid == nullptr) return 0;
  const int lane = threadIdx.x % 32;
  for (int t0 = 0; t0 < Tk; t0 += 32) {
    const int t = t0 + lane;
    const unsigned any = __ballot_sync(
        0xffffffffu, t < Tk && kv_valid[static_cast<size_t>(b) * Tk + t]);
    if (any != 0u) return t0 + __ffs(any) - 1;
  }
  return Tk;
}

// the additive mask of key t: -inf past Tk (not a key), the finite -1e9
// on a masked key, else 0
__device__ __forceinline__ float key_bias(
    const unsigned char* __restrict__ kv_valid, int b, int t, int Tk) {
  return t >= Tk ? -INFINITY
         : (kv_valid != nullptr && !kv_valid[static_cast<size_t>(b) * Tk + t])
             ? kMasked
             : 0.f;
}

// a warp's accumulator (rows r0 + g and r0 + g + 8, columns c0 + 8 n + 2 t4
// and + 1), times the rows' scales, rounded into a bf16 tile
__device__ __forceinline__ void put_acc(bf16* tile, int stride, int r0,
                                        int c0, const float (&c)[8][4],
                                        float scale0, float scale1) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    bf16* at = tile + (r0 + g) * stride + c0 + 8 * n + 2 * t4;
    *reinterpret_cast<unsigned*>(at) =
        pack_bf16(c[n][0] * scale0, c[n][1] * scale0);
    *reinterpret_cast<unsigned*>(at + 8 * stride) =
        pack_bf16(c[n][2] * scale1, c[n][3] * scale1);
  }
}

// rows t0 .. t0 + rows - 1 of a bf16 tile (rows x (D + 8)) to head h of
// batch row b of a (B, T, H, D) tensor, 16 bytes a store; rows past T are
// not written
template <int D, int NT>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const bf16* tile, int t0, int rows,
                                           int T, int H, int h, int b) {
  constexpr int VECS = D / 8;
  for (int i = threadIdx.x; i < rows * VECS; i += NT) {
    const int r = i / VECS, c = (i % VECS) * 8, t = t0 + r;
    if (t < T)
      *reinterpret_cast<uint4*>(
          dst + ((static_cast<size_t>(b) * T + t) * H + h) * D + c) =
          *reinterpret_cast<const uint4*>(tile + r * (D + 8) + c);
  }
}

}  // namespace flash_attn
