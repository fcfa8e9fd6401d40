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
// len_b - 1 dependent steps (one per frame), each a handful of exp/log1p
// per extended state. At the Jasper eval shape (B=32, T=500, V=29) the
// whole input is 32*500*29*4 B ~ 1.9 MB, read once.
//
// Design, against that bound:
//  * one CTA per row; threads stride over the extended states s (so
//    each thread owns ceil(S / blockDim) states and S > 1024 works);
//  * the alpha column lives in a shared-memory ping-pong pair, so one
//    __syncthreads() per frame is the only barrier;
//  * the emission is read straight from the row's V log-probs at
//    ext[s] (no one-hot matmul: that gather was a device for the TPU's
//    matrix unit) and is loaded before the barrier-bound part of the step;
//  * rows stop at their own length (the TPU kernel's freeze at
//    ctc_pallas.py:113 is the same thing), and only the 2*len+1 states a
//    row can reach are computed.
// NEG and logaddexp are the TPU kernel's (ctc_pallas.py:48, :57-59), so
// infeasible and empty-label rows give the same numbers before masking.
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float mx = fmaxf(fmaxf(a, b), kNeg);
  return mx + log1pf(expf(fminf(a, b) - mx));
}

// lp: (B, T, V) fp32 log-probs; labels: (B, L) int32; lengths: (B,)
// int32; nll: (B,) fp32 out; alpha: (B, T, S) fp32 out, or null for
// the NLL alone (the eval path, unchanged by the lattice). Dynamic
// shared memory holds two alpha columns, the extended label ids and the
// skip flags, each of S = 2L+1.
__global__ void ctc_alpha_fwd_kernel(const float* __restrict__ lp,
                                     const int* __restrict__ logit_len,
                                     const int* __restrict__ labels,
                                     const int* __restrict__ label_len,
                                     float* __restrict__ nll,
                                     float* __restrict__ alpha, int T,
                                     int V, int L, int blank) {
  extern __shared__ float smem[];
  const int S = 2 * L + 1;
  float* cur = smem;
  float* nxt = smem + S;
  int* ext = reinterpret_cast<int*>(smem + 2 * S);
  unsigned char* skip = reinterpret_cast<unsigned char*>(ext + S);

  const int b = blockIdx.x;
  const int ll = min(max(label_len[b], 0), L);
  const int Sb = 2 * ll + 1;                 // states this row can reach
  const int len = min(logit_len[b], T);
  const float* lpb = lp + static_cast<size_t>(b) * T * V;
  const int* lab = labels + static_cast<size_t>(b) * L;
  float* alpha_b =
      alpha ? alpha + static_cast<size_t>(b) * T * S : nullptr;

  for (int s = threadIdx.x; s < Sb; s += blockDim.x) {
    ext[s] = (s & 1) ? lab[s >> 1] : blank;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < Sb; s += blockDim.x) {
    skip[s] = (s & 1) && s >= 2 && ext[s] != ext[s - 2];
  }

  // A label outside [0, V) can never be emitted.
  auto emit = [&](int t, int s) -> float {
    const int e = ext[s];
    return (e >= 0 && e < V) ? lpb[static_cast<size_t>(t) * V + e] : kNeg;
  };

  // t = 0: only the leading blank and the first label are reachable.
  for (int s = threadIdx.x; s < Sb; s += blockDim.x) {
    cur[s] = (s <= min(Sb - 1, 1)) ? emit(0, s) : kNeg;
    if (alpha_b && len > 0) alpha_b[s] = cur[s];
  }
  __syncthreads();

  for (int t = 1; t < len; ++t) {
    for (int s = threadIdx.x; s < Sb; s += blockDim.x) {
      const float e = emit(t, s);
      float c = logaddexp(cur[s], s >= 1 ? cur[s - 1] : kNeg);
      if (skip[s]) c = logaddexp(c, cur[s - 2]);
      nxt[s] = c + e;
      if (alpha_b) alpha_b[static_cast<size_t>(t) * S + s] = c + e;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  if (threadIdx.x == 0) {
    // -logsumexp over the last blank and the last label (ctc_pallas.py
    // _finalize: max-shifted sum of exps)
    const float a = cur[Sb - 1];
    const float c = Sb >= 2 ? cur[Sb - 2] : kNeg;
    const float m = fmaxf(a, c);
    nll[b] = -(m + logf(expf(a - m) + expf(c - m)));
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch
// (0 on success). The caller guarantees B >= 1, T >= 1, L >= 0, V >= 1
// and contiguous device buffers of the documented shapes; `alpha` may be
// null.
extern "C" int ctc_alpha_fwd(const float* lp, const int* logit_len,
                             const int* labels, const int* label_len,
                             float* nll, float* alpha, int B, int T, int V,
                             int L, int blank, void* stream) {
  const int S = 2 * L + 1;
  const int threads = min(1024, ((S + 31) / 32) * 32);
  const size_t smem = static_cast<size_t>(S) *
                      (2 * sizeof(float) + sizeof(int) + sizeof(unsigned char));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ctc_alpha_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ctc_alpha_fwd_kernel<<<B, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      lp, logit_len, labels, label_len, nll, alpha, T, V, L, blank);
  return static_cast<int>(cudaGetLastError());
}
