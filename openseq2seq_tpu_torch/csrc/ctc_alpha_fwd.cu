// CTC forward (alpha) recursion: per-row negative log likelihood from
// fp32 log-softmax probabilities.
//
// Replaces the TPU kernel `_alpha_kernel` in
// openseq2seq_tpu/ops/ctc_pallas.py: the `with_ckpt=False` forward that
// `ctc_loss_pallas` runs outside of a gradient and, with a lattice
// pointer, the `with_ckpt=True` forward of its custom VJP. Where the TPU
// kernel saves alpha every 128 frames and the backward recomputes each
// chunk in VMEM, this kernel writes the whole lattice alpha[b, t, s]
// (t < len_b, s < 2 len_b + 1, fp32) for `ctc_beta_bwd.cu` to read:
// 20.5 MB at the Jasper train shape (B=32, T=500, L=160), against the
// card's 80 GB, and each value is written once and read once.
//
// What bounds it on an H100: latency, not bytes or FLOPs. Row b needs
// len_b - 1 dependent frames, and the whole input (32*500*29*4 B, 1.9 MB
// at the Jasper eval shape) is read once. So what counts is the time from
// one frame's barrier to the next.
//
// Design, against that bound (ctc.cuh has the thread layout):
//  * one CTA per row; each thread owns 1 to 4 extended states of one
//    parity, with their label ids and skip flags in registers and its
//    own last alpha in a register;
//  * the row's log-probs stream into shared memory a chunk of up to 32
//    frames at a time by cp.async (16-byte copies from the 16-byte floor
//    of a frame, which starts 4-byte aligned only), the next chunk in
//    flight while this one is used, one wait a chunk; so no frame waits
//    on device memory: a frame is three shared-memory reads issued
//    together (the emission and both neighbours), the logaddexps, one
//    store and one __syncthreads() (a ring of loads a frame into
//    registers or by 4-byte cp.async was slower, and so was reading a
//    frame's emission during the frame before);
//  * the lattice, where asked for, is written with plain stores, which
//    nothing waits on;
//  * rows stop at their own length (the TPU kernel's freeze at
//    ctc_pallas.py:113), and only the 2*len+1 reachable states are
//    computed.
// NEG and logaddexp are the TPU kernel's (ctc_pallas.py:48, :57-59), in
// the plain version's order, so the lattice carries the plain version's
// bits: at |alpha| ~ 1500 a lattice value's ulp is 1.2e-4, and another
// rounding of the logaddexp would move whole ulps of it.
//
// `ctc_alpha_floor` runs the same recursion with each state's emission
// taken once into a register and no lattice: the per-frame floor that
// scripts_torch/bench_ctc.py holds the kernel to.
#include <cuda_runtime.h>

#include "ctc.cuh"

namespace {

using ctc::kNeg;
using ctc::logaddexp;

// lp: (B, T, V) fp32 log-probs; labels: (B, L) int32; lengths: (B,)
// int32; nll: (B,) fp32 out; alpha: (B, T, S) fp32 out, or null for the
// NLL alone (the eval path). Dynamic shared memory: two alpha columns of
// S = 2L+1, each split by parity (ctc.cuh), then two chunks of `chunk`
// frames of log-probs.
template <int K, bool kFloor>
__global__ void __launch_bounds__(ctc::kMaxThreads)
ctc_alpha_fwd_kernel(const float* __restrict__ lp,
                     const int* __restrict__ logit_len,
                     const int* __restrict__ labels,
                     const int* __restrict__ label_len,
                     float* __restrict__ nll, float* __restrict__ alpha,
                     int T, int V, int L, int blank, int blank_threads,
                     int label_threads, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int S = 2 * L + 1;
  const int chunk_floats = ctc::staged_floats(chunk, V);
  float* chunks = smem + ((2 * S + 3) & ~3);
  const int b = blockIdx.x;
  const int ll = min(max(label_len[b], 0), L);
  const int len = min(logit_len[b], T);
  const float* lpb = lp + static_cast<size_t>(b) * T * V;
  const int* lab = labels + static_cast<size_t>(b) * L;
  float* alpha_b = alpha ? alpha + static_cast<size_t>(b) * T * S : nullptr;
  const bool is_label = threadIdx.x >= blank_threads;
  const int i = is_label ? threadIdx.x - blank_threads : threadIdx.x;
  const int n = is_label ? label_threads : blank_threads;

  // per owned state: s, its slot in a column, its left neighbour's slot
  // (s - 1; the blank 0 reads slot 0 and takes NEG), whether it takes the
  // skip from s - 2 (the label j - 1, one slot left of own), and the
  // vocabulary id it emits (-1: none)
  int s[K], own[K], left[K], emit_id[K];
  bool live[K], has_left[K], skip[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = i + k * n;
    if (is_label) {
      live[k] = j < ll;
      s[k] = 2 * j + 1;
      own[k] = L + 1 + j;
      left[k] = j;                              // blank j
      has_left[k] = true;
      skip[k] = live[k] && j >= 1 && lab[j] != lab[j - 1];
      emit_id[k] = live[k] ? lab[j] : -1;
    } else {
      live[k] = j <= ll;
      s[k] = 2 * j;
      own[k] = j;
      left[k] = j >= 1 ? L + j : 0;             // label j - 1
      has_left[k] = j >= 1;
      skip[k] = false;
      emit_id[k] = blank;
    }
    // a label outside [0, V) can never be emitted
    if (!(emit_id[k] >= 0 && emit_id[k] < V)) emit_id[k] = -1;
  }
  // chunk c holds frames [1 + c chunk, 1 + (c + 1) chunk) of the row
  auto stage_chunk = [&](int c) -> int {
    const int f0 = 1 + c * chunk;
    const int frames = min(chunk, len - f0);
    if (frames <= 0) return 0;
    return ctc::stage(chunks + (c & 1) * chunk_floats,
                      lpb + static_cast<size_t>(f0) * V, frames * V);
  };

  float* cur = smem;
  float* nxt = smem + S;
  float a[K], held[K];
  // t = 0: only the leading blank and the first label are reachable
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!live[k]) continue;
    held[k] = emit_id[k] >= 0 ? lpb[emit_id[k]] : kNeg;
    a[k] = s[k] <= 1 ? held[k] : kNeg;
    cur[own[k]] = a[k];
    if (!kFloor && alpha_b && len > 0) alpha_b[s[k]] = a[k];
  }
  int lead = kFloor ? 0 : stage_chunk(0);
  ctc::commit();
  ctc::wait_all();
  __syncthreads();

  for (int c = 0, f0 = 1; f0 < len; ++c, f0 += chunk) {
    // the next chunk streams in while this one is used
    const int next_lead = kFloor ? 0 : stage_chunk(c + 1);
    ctc::commit();
    const int f1 = min(f0 + chunk, len);
    const float* row = chunks + (c & 1) * chunk_floats + lead;
    for (int t = f0; t < f1; ++t, row += V) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!live[k]) continue;
        // the emission and both neighbours read before any arithmetic
        const float e = kFloor ? held[k]
                        : emit_id[k] >= 0 ? row[emit_id[k]] : kNeg;
        const float lft = cur[left[k]];
        const float two = is_label ? cur[own[k] - 1] : kNeg;
        float c1 = logaddexp(a[k], has_left[k] ? lft : kNeg);
        // a label without the skip adds NEG, which leaves c1's bits as
        // they are: label warps run the same two logaddexps on every lane
        if (is_label) c1 = logaddexp(c1, skip[k] ? two : kNeg);
        a[k] = c1 + e;
        nxt[own[k]] = a[k];
        if (!kFloor && alpha_b) {
          alpha_b[static_cast<size_t>(t) * S + s[k]] = a[k];
        }
      }
      if (t == f1 - 1) ctc::wait_all();         // the next chunk is in
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    lead = next_lead;
  }

  if (threadIdx.x == 0) {
    // -logsumexp over the last blank and the last label (ctc_pallas.py
    // _finalize: max-shifted sum of exps)
    const float a_end = cur[ll];
    const float c_end = ll >= 1 ? cur[L + ll] : kNeg;
    const float m = fmaxf(a_end, c_end);
    nll[b] = -(m + logf(expf(a_end - m) + expf(c_end - m)));
  }
}

size_t smem_bytes(int L, int V, int chunk) {
  return (((2 * static_cast<size_t>(2 * L + 1) + 3) & ~size_t{3}) +
          2 * static_cast<size_t>(ctc::staged_floats(chunk, V))) *
         sizeof(float);
}

// The most frames a chunk that fit (0: none), with its shared memory.
int fit(int L, int V, size_t* smem) {
  int max_smem = 0;
  if (ctc::max_smem_optin(&max_smem) != 0) return 0;
  const int chunk = ctc::fit_chunk(
      [&](int c) { return smem_bytes(L, V, c); }, max_smem);
  *smem = smem_bytes(L, V, chunk ? chunk : 1);
  return chunk;
}

template <int K, bool kFloor>
int launch(const float* lp, const int* logit_len, const int* labels,
           const int* label_len, float* nll, float* alpha, int B, int T,
           int V, int L, int blank, const ctc::Layout& l,
           cudaStream_t stream) {
  auto kernel = ctc_alpha_fwd_kernel<K, kFloor>;
  size_t smem = 0;
  const int chunk = fit(L, V, &smem);
  if (chunk == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, l.threads(), smem, stream>>>(
      lp, logit_len, labels, label_len, nll, alpha, T, V, L, blank,
      l.blank_threads, l.label_threads, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFloor>
int dispatch(const float* lp, const int* logit_len, const int* labels,
             const int* label_len, float* nll, float* alpha, int B, int T,
             int V, int L, int blank, void* stream) {
  const ctc::Layout l = ctc::layout(L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (l.states) {
    case 1: return launch<1, kFloor>(lp, logit_len, labels, label_len, nll,
                                     alpha, B, T, V, L, blank, l, s);
    case 2: return launch<2, kFloor>(lp, logit_len, labels, label_len, nll,
                                     alpha, B, T, V, L, blank, l, s);
    case 4: return launch<4, kFloor>(lp, logit_len, labels, label_len, nll,
                                     alpha, B, T, V, L, blank, l, s);
    default: return static_cast<int>(cudaErrorInvalidConfiguration);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch
// (0 on success). The caller guarantees B >= 1, T >= 1, 0 <= L, V >= 1,
// a shape that ctc_alpha_fwd_resources says fits, and contiguous device
// buffers of the documented shapes; `alpha` may be null.
extern "C" int ctc_alpha_fwd(const float* lp, const int* logit_len,
                             const int* labels, const int* label_len,
                             float* nll, float* alpha, int B, int T, int V,
                             int L, int blank, void* stream) {
  return dispatch<false>(lp, logit_len, labels, label_len, nll, alpha, B, T,
                         V, L, blank, stream);
}

// The per-frame floor: the same recursion and NLL with every frame's
// emission the frame-0 one, held in a register, and no lattice. Its NLL
// is of no use but to be written.
extern "C" int ctc_alpha_floor(const float* lp, const int* logit_len,
                               const int* labels, const int* label_len,
                               float* nll, int B, int T, int V, int L,
                               int blank, void* stream) {
  return dispatch<true>(lp, logit_len, labels, label_len, nll, nullptr, B, T,
                        V, L, blank, stream);
}

// The forward kernel's resources at label length L and vocabulary V,
// nothing launched: out = [threads, states a thread, frames a chunk,
// dynamic shared memory in bytes, CTAs an SM (0 where the CTA does not
// fit)]. Returns a CUDA error, 0 on success.
extern "C" int ctc_alpha_fwd_resources(int L, int V, int* out) {
  const ctc::Layout l = ctc::layout(L);
  size_t smem = 0;
  const int chunk = fit(L, V, &smem);
  switch (l.states) {
    case 2: return ctc::recursion_fit(ctc_alpha_fwd_kernel<2, false>, l,
                                      chunk, smem, out);
    case 4: return ctc::recursion_fit(ctc_alpha_fwd_kernel<4, false>, l,
                                      chunk, smem, out);
    default: return ctc::recursion_fit(ctc_alpha_fwd_kernel<1, false>, l,
                                       chunk, smem, out);
  }
}
