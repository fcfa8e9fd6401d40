// CTC backward (beta) recursion: the gradient of the per-row negative log
// likelihood with respect to the fp32 log-softmax probabilities.
//
// Replaces the TPU kernel `_beta_chunk_kernel` in
// openseq2seq_tpu/ops/ctc_pallas.py (the backward of `ctc_loss_pallas`'s
// custom VJP). It reads the alpha lattice that `ctc_alpha_fwd.cu` writes
// when given a lattice pointer, where the TPU kernel recomputed each
// 128-frame chunk's alphas from a checkpoint in VMEM.
//
// What bounds it on an H100: latency, as in the forward. Row b needs
// len_b dependent steps in reverse, each a few exp/log1p per extended
// state, one lattice read per state (the lattice, 20.5 MB at the Jasper
// train shape B=32, T=500, L=160, was just written by the forward and is
// mostly L2-resident) and a V-wide gradient row to write.
//
// Design, against that bound:
//  * one CTA per row; threads stride over the row's 2*len+1 extended
//    states, so S > 1024 works;
//  * z = beta + emit sits in a shared-memory ping-pong, as do the
//    per-state posteriors of the frame and their per-vocabulary sums, so
//    one __syncthreads() per frame is the only barrier (a frame's
//    gradient row is written after the next frame's barrier);
//  * the vocabulary scatter (a one-hot matmul on the TPU) is a gather:
//    warp w sums the states of vocabulary entries v = w, w + warps, ...
//    with each lane taking every 32nd state and a fixed shuffle tree
//    after, so the sum order is fixed and repeated calls give
//    bit-identical gradients (no float atomicAdd);
//  * frames t >= len_b and rows whose labels cannot fit (the port's
//    `feasible_rows`) are written as exact zeros.
// NEG, logaddexp and the max(gamma, -80) clamp are the TPU kernel's
// (ctc_pallas.py:48, :57-59, :200). Unlike the TPU kernel, each frame's
// row is divided by the frame's posterior mass, 1 in exact arithmetic:
// gamma = alpha + beta - logZ subtracts log-values of the size of logZ
// (about 1500 at the train shape), and undivided, a frame's posteriors
// sum to 1 only within about 1.6e-3 in fp32 there. The plain twin,
// ops/ctc.py:ctc_nll_grad, does the same.
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float mx = fmaxf(fmaxf(a, b), kNeg);
  return mx + log1pf(expf(fminf(a, b) - mx));
}

// lp: (B, T, V) fp32 log-probs; labels: (B, L) int32; lengths (B,) int32;
// nll: (B,) fp32 from the forward; alpha: (B, T, S) fp32 lattice from the
// forward; dlp: (B, T, V) fp32 out. Dynamic shared memory: two z columns
// and two posterior columns of S = 2L+1, two per-vocabulary sums of V,
// the extended label ids and the skip flags (S each).
__global__ void ctc_beta_bwd_kernel(const float* __restrict__ lp,
                                    const int* __restrict__ logit_len,
                                    const int* __restrict__ labels,
                                    const int* __restrict__ label_len,
                                    const float* __restrict__ nll,
                                    const float* __restrict__ alpha,
                                    float* __restrict__ dlp, int T, int V,
                                    int L, int blank) {
  extern __shared__ float smem[];
  const int S = 2 * L + 1;
  // ping-pong buffers: z at smem + p*S, posteriors at smem + (2+p)*S,
  // per-vocabulary sums at smem + 4*S + p*V
  float* const mass = smem + 4 * S;
  int* ext = reinterpret_cast<int*>(smem + 4 * S + 2 * V);
  unsigned char* skip = reinterpret_cast<unsigned char*>(ext + S);

  const int b = blockIdx.x;
  const int raw_ll = label_len[b];
  const int ll = min(max(raw_ll, 0), L);
  const int Sb = 2 * ll + 1;                 // states this row can reach
  const int len = min(logit_len[b], T);
  const float* lpb = lp + static_cast<size_t>(b) * T * V;
  const float* ab = alpha + static_cast<size_t>(b) * T * S;
  float* db = dlp + static_cast<size_t>(b) * T * V;
  const int* lab = labels + static_cast<size_t>(b) * L;

  // feasible_rows: one frame per label plus one per adjacent repeat
  int repeats = 0;
  for (int i0 = 0; i0 < ll; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool rep = i < ll && lab[i] == (i > 0 ? lab[i - 1] : -1);
    repeats += __syncthreads_count(rep);
  }
  const bool feasible = logit_len[b] >= raw_ll + repeats;
  const int live = feasible ? max(len, 0) : 0;   // frames with a gradient

  // zeros past the row's live frames
  for (size_t i = static_cast<size_t>(live) * V + threadIdx.x;
       i < static_cast<size_t>(T) * V; i += blockDim.x) {
    db[i] = 0.0f;
  }
  if (live == 0) return;

  for (int s = threadIdx.x; s < Sb; s += blockDim.x) {
    ext[s] = (s & 1) ? lab[s >> 1] : blank;
  }
  __syncthreads();
  // skip[s]: the transition s -> s + 2 is allowed (the forward's skip
  // into s + 2)
  for (int s = threadIdx.x; s < Sb; s += blockDim.x) {
    skip[s] = s + 2 < Sb && ((s + 2) & 1) && ext[s + 2] != ext[s];
  }
  __syncthreads();

  auto emit = [&](int t, int s) -> float {
    const int e = ext[s];
    return (e >= 0 && e < V) ? lpb[static_cast<size_t>(t) * V + e] : kNeg;
  };
  const float logz = -nll[b];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  // dlp[t, v] = -mass[v] / sum of mass, in one fixed order for all
  auto write_row = [&](int t) {
    const float* m = mass + (t & 1) * V;
    float total = 0.0f;
    for (int v = 0; v < V; ++v) total += m[v];
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      db[static_cast<size_t>(t) * V + v] = -m[v] / total;
    }
  };

  for (int t = len - 1; t >= 0; --t) {
    const int p = t & 1;
    const float* zn = smem + (p ^ 1) * S;    // beta_{t+1} + emit_{t+1}
    float* zt = smem + p * S;
    float* gt = smem + (2 + p) * S;
    const float* a = ab + static_cast<size_t>(t) * S;
    for (int s = threadIdx.x; s < Sb; s += blockDim.x) {
      const float e = emit(t, s);
      const float at = a[s];
      float beta;
      if (t == len - 1) {
        beta = (s >= Sb - 2) ? 0.0f : kNeg;
      } else {
        beta = logaddexp(zn[s], s + 1 < Sb ? zn[s + 1] : kNeg);
        if (skip[s]) beta = logaddexp(beta, zn[s + 2]);
      }
      gt[s] = expf(fmaxf(at + beta - logz, -80.0f));
      zt[s] = beta + e;
    }
    __syncthreads();
    if (t + 1 < len) write_row(t + 1);
    // scatter the frame's state posteriors onto the vocabulary
    for (int v = warp; v < V; v += warps) {
      float sum = 0.0f;
      for (int s = lane; s < Sb; s += 32) {
        if (ext[s] == v) sum += gt[s];
      }
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      if (lane == 0) mass[p * V + v] = sum;
    }
  }
  __syncthreads();
  write_row(0);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch
// (0 on success). The caller guarantees B >= 1, T >= 1, L >= 0, V >= 1,
// contiguous device buffers of the documented shapes, and `alpha` and
// `nll` written by ctc_alpha_fwd on the same inputs.
extern "C" int ctc_beta_bwd(const float* lp, const int* logit_len,
                            const int* labels, const int* label_len,
                            const float* nll, const float* alpha, float* dlp,
                            int B, int T, int V, int L, int blank,
                            void* stream) {
  const int S = 2 * L + 1;
  // whole warps, for the shuffle reduction of the scatter
  const int threads = min(1024, ((S + 31) / 32) * 32);
  const size_t smem = static_cast<size_t>(S) *
                          (4 * sizeof(float) + sizeof(int) +
                           sizeof(unsigned char)) +
                      2 * static_cast<size_t>(V) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ctc_beta_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ctc_beta_bwd_kernel<<<B, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      lp, logit_len, labels, label_len, nll, alpha, dlp, T, V, L, blank);
  return static_cast<int>(cudaGetLastError());
}
