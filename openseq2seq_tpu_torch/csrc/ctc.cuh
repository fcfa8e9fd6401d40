// Shared pieces of the CTC kernels (ctc_alpha_fwd.cu, ctc_beta_bwd.cu):
// the TPU kernel's NEG and logaddexp, the thread layout of the two
// recursions, and the staging of their inputs in chunks of frames.
//
// Layout. Each recursion runs one CTA per batch row. The row's 2L+1
// extended states are split by parity: the L+1 blank states s = 2j on the
// first `blank_threads` threads and the L label states s = 2j+1 on the
// rest, each thread owning K states of one parity (j = i + k n, i its index
// among the n threads of its parity). A thread keeps its states' label
// ids, skip flags and last values in registers; a column of the lattice
// sits in shared memory split the same way (the blanks at [0, L], the
// labels at L+1 + j), so every neighbour read is a stride-1 read. A blank
// state never takes the skip transition, so the blank warps run one
// logaddexp a frame and the label warps two: no lane waits on the other
// parity's work. More states a thread serve longer labels only: at L 160
// two or four ran slower than one.
#pragma once

#include <cuda_runtime.h>

namespace ctc {

constexpr float kNeg = -1e30f;       // ctc_pallas.py:48
constexpr int kMaxThreads = 1024;
constexpr int kMaxStates = 4;        // extended states a thread, at most

// ctc_pallas.py:57-59, with the same expf and log1pf as the port's plain
// version on the card, so the recursions give its bits.
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float mx = fmaxf(fmaxf(a, b), kNeg);
  return mx + log1pf(expf(fminf(a, b) - mx));
}

// Frames a chunk, at most: the recursions stage their inputs (the
// log-probs and, in the backward, the lattice) a chunk of frames at a time
// in shared memory, two chunks in flight, so that no frame waits on device
// memory; a chunk is the most frames of 32, 16, 8, 4, 2, 1 that fit
// (32 ran faster than 16 and 8 at the main shapes: a chunk's edge costs
// a fixed wait).
constexpr int kMaxChunk = 32;

struct Layout {
  int states;          // K, states a thread; 0 where L does not fit a CTA
  int blank_threads;   // threads of the blank states, whole warps
  int label_threads;   // threads of the label states, whole warps
  int threads() const { return blank_threads + label_threads; }
};

inline int round_warp(int x) { return (x + 31) / 32 * 32; }

// The fewest states a thread (1, 2 or 4) at which a CTA of at most 1024
// threads holds the row's 2L+1 states; states 0 where that does not fit.
inline Layout layout(int L) {
  for (int k = 1; k <= kMaxStates; k *= 2) {
    const Layout l{k, round_warp((L + 1 + k - 1) / k),
                   round_warp((L + k - 1) / k)};
    if (l.threads() <= kMaxThreads) return l;
  }
  return Layout{0, 0, 0};
}

// 16- and 4-byte cp.async, and the waits.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Stage the n floats at src (global, 4-byte aligned) into shared memory:
// element i lands at dst[lead + i], lead = (src's offset in its 16-byte
// block) / 4, so that the aligned interior goes by 16-byte copies and
// only the ragged ends by 4-byte ones (a frame of V = 29 fp32 values
// starts 4-byte aligned only). dst is 16-byte aligned with room for
// n + 3 floats. All threads of the CTA take part; returns lead.
__device__ __forceinline__ int stage(float* dst, const float* src, int n) {
  const int lead =
      static_cast<int>((reinterpret_cast<size_t>(src) & 15) >> 2);
  const int head = min((4 - lead) & 3, n);     // floats before a boundary
  const int n16 = (n - head) >> 2;
  const int tail = n - head - 4 * n16;
  for (int i = threadIdx.x; i < head + tail; i += blockDim.x) {
    const int e = i < head ? i : head + 4 * n16 + (i - head);
    copy4(dst + lead + e, src + e);
  }
  for (int i = threadIdx.x; i < n16; i += blockDim.x) {
    copy16(dst + lead + head + 4 * i, src + head + 4 * i);
  }
  return lead;
}

// Floats a staged chunk of `frames` frames of `width` values needs.
__host__ __device__ inline int staged_floats(int frames, int width) {
  return (frames * width + 3 + 3) & ~3;        // + lead, 16-byte multiple
}

inline int max_smem_optin(int* max_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  return static_cast<int>(err);
}

// The most frames a chunk (kMaxChunk, halved down to 1) whose dynamic
// shared memory `smem_of(chunk)` fits `max_smem`; 0 where none does.
template <typename SmemOf>
int fit_chunk(SmemOf smem_of, int max_smem) {
  for (int c = kMaxChunk; c >= 1; c /= 2) {
    if (smem_of(c) <= static_cast<size_t>(max_smem)) return c;
  }
  return 0;
}

// out[0..4] = threads, states a thread, frames a chunk, dynamic shared
// memory, CTAs an SM (0 where the CTA does not fit), for a recursion
// kernel at `chunk` frames a chunk (0: none fits); nothing is launched.
// Returns a CUDA error, 0 on success.
template <typename Kernel>
int recursion_fit(Kernel kernel, const Layout& l, int chunk, size_t smem,
                  int* out) {
  out[0] = l.threads();
  out[1] = l.states;
  out[2] = chunk;
  out[3] = static_cast<int>(smem);
  out[4] = 0;
  if (l.states == 0 || chunk == 0) return 0;
  cudaError_t err = cudaSuccess;
  // raised past the default 48 KB only, as the launches do: lowered, it
  // would refuse a later launch at a longer L
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], kernel,
                                                        l.threads(), smem);
  return static_cast<int>(err);
}

}  // namespace ctc
