// CTC backward: the gradient of the per-row negative log likelihood with
// respect to the fp32 log-softmax probabilities, in two launches.
//
// Replaces the TPU kernel `_beta_chunk_kernel` in
// openseq2seq_tpu/ops/ctc_pallas.py (the backward of `ctc_loss_pallas`'s
// custom VJP). It reads the alpha lattice that `ctc_alpha_fwd.cu` writes
// when given a lattice pointer, where the TPU kernel recomputed each
// 128-frame chunk's alphas from a checkpoint in VMEM.
//
// What bounds it on an H100: latency, as in the forward. Row b needs
// len_b dependent frames in reverse. Nothing else has to wait on that
// chain, so the work is split:
//  (a) ctc_beta_bwd_kernel, the beta recursion: one CTA per row, the
//      forward's thread layout (ctc.cuh). The row's lattice and log-probs
//      stream into shared memory up to 32 frames at a time, as in the
//      forward, and a thread keeps its own z = beta + emit in a register;
//      a frame is four shared-memory reads issued together, the
//      logaddexps, one store and one __syncthreads(). Each frame's
//      posteriors exp(max(alpha + beta - logZ, -80)) (s < 2 len + 1) go to
//      a (B, T, S) fp32 buffer with plain stores, in a pipeline two frames
//      deep: the exp of frame t taken at frame t - 1 while it waits on its
//      shared-memory reads, the store at frame t - 2, so that no store
//      waits on its exp. Before the recursion the CTA writes the row's
//      work record: its live frames (0 on rows the port's `feasible_rows`
//      rejects) and its label positions grouped by vocabulary id, in
//      increasing position.
//  (b) ctc_beta_bwd_scatter_kernel, the vocabulary scatter (a one-hot
//      matmul on the TPU): one warp per (row, frame), all frames of all
//      rows spread over the card. The warp stages the frame's posteriors
//      in shared memory; the blank's mass is the even states' sum, lane l
//      taking j = l, l + 32, ... and a fixed shuffle tree after; lane v
//      adds the label states of id v in increasing position (from the
//      work record); the frame's total is the masses' sum by lane and a
//      fixed shuffle tree; dlp[t, v] = -mass[v] / total. Frames past the
//      live ones get exact zeros. Every sum runs in one fixed order (no
//      float atomicAdd), so repeated calls give bit-identical gradients.
// NEG, logaddexp and the max(gamma, -80) clamp are the TPU kernel's
// (ctc_pallas.py:48, :57-59, :200), in the plain version's order, so the
// posteriors carry the plain version's bits. Unlike the TPU kernel, each
// frame's row is divided by the frame's posterior mass, 1 in exact
// arithmetic: gamma = alpha + beta - logZ subtracts log-values of the size
// of logZ (about 1500 at the train shape), and undivided, a frame's
// posteriors sum to 1 only within about 1.6e-3 in fp32 there. The plain
// twins, ops/ctc.py:ctc_posteriors and ctc_scatter, do the same.
#include <cuda_runtime.h>

#include "ctc.cuh"

namespace {

using ctc::kNeg;
using ctc::logaddexp;

constexpr int kScatterFrames = 32;     // frames a scatter CTA
constexpr int kScatterWarps = 8;       // at most; fewer where S is large

// ints of a row's work record: live frames, label length, V + 1 offsets
// into the positions grouped by id, L positions
__host__ __device__ inline int work_ints(int L, int V) { return L + V + 3; }

// (a). lp: (B, T, V) fp32 log-probs; labels: (B, L) int32; lengths (B,)
// int32; nll: (B,) fp32 from the forward; alpha: (B, T, S) fp32 lattice
// from the forward; post: (B, T, S) fp32 out (only t < live, s < 2 ll + 1
// written); work: (B, L + V + 3) int32 out. Dynamic shared memory: two z
// columns of S = 2L+1 split by parity (ctc.cuh), the row's L labels, then
// two chunks of `chunk` frames, each of lattice values and of log-probs.
template <int K>
__global__ void __launch_bounds__(ctc::kMaxThreads)
ctc_beta_bwd_kernel(const float* __restrict__ lp,
                    const int* __restrict__ logit_len,
                    const int* __restrict__ labels,
                    const int* __restrict__ label_len,
                    const float* __restrict__ nll,
                    const float* __restrict__ alpha,
                    float* __restrict__ post, int* __restrict__ work, int T,
                    int V, int L, int blank, int blank_threads,
                    int label_threads, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int S = 2 * L + 1;
  int* lab_s = reinterpret_cast<int*>(smem + 2 * S);
  const int lat_floats = ctc::staged_floats(chunk, S);
  const int lp_floats = ctc::staged_floats(chunk, V);
  float* chunks = smem + ((2 * S + L + 3) & ~3);
  const int b = blockIdx.x;
  const int raw_ll = label_len[b];
  const int ll = min(max(raw_ll, 0), L);
  const int len = min(logit_len[b], T);
  const float* lpb = lp + static_cast<size_t>(b) * T * V;
  const float* ab = alpha + static_cast<size_t>(b) * T * S;
  float* pb = post + static_cast<size_t>(b) * T * S;
  const int* lab = labels + static_cast<size_t>(b) * L;
  int* wb = work + static_cast<size_t>(b) * work_ints(L, V);

  // feasible_rows: one frame per label plus one per adjacent repeat
  int repeats = 0;
  for (int i0 = 0; i0 < ll; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool rep = i < ll && lab[i] == (i > 0 ? lab[i - 1] : -1);
    repeats += __syncthreads_count(rep);
  }
  const bool feasible = logit_len[b] >= raw_ll + repeats;
  const int live_frames = feasible ? max(len, 0) : 0;
  if (threadIdx.x == 0) {
    wb[0] = live_frames;
    wb[1] = ll;
  }
  if (live_frames == 0) return;

  // chunk c holds frames [lo, hi), hi = len - c chunk, in the buffers of
  // its parity: the lattice values, then the log-probs
  auto stage_chunk = [&](int c, int* lead_a, int* lead_e) {
    const int hi = len - c * chunk;
    const int lo = max(hi - chunk, 0);
    if (hi <= 0) return;
    float* buf = chunks + (c & 1) * (lat_floats + lp_floats);
    *lead_a = ctc::stage(buf, ab + static_cast<size_t>(lo) * S,
                         (hi - lo) * S);
    *lead_e = ctc::stage(buf + lat_floats, lpb + static_cast<size_t>(lo) * V,
                         (hi - lo) * V);
  };
  int lead_a = 0, lead_e = 0;
  stage_chunk(0, &lead_a, &lead_e);
  ctc::commit();

  const bool is_label = threadIdx.x >= blank_threads;
  const int i = is_label ? threadIdx.x - blank_threads : threadIdx.x;
  const int n = is_label ? label_threads : blank_threads;
  // per owned state: s, its slot in a column, its s + 1 neighbour's slot
  // (the last blank reads its own slot and takes NEG), whether it takes
  // the skip to s + 2 (the label j + 1, one slot right of own), whether
  // beta starts at 0 (s >= 2 ll - 1), and the vocabulary id it emits
  // (-1: none)
  int s[K], own[K], right[K], emit_id[K];
  bool live[K], has_right[K], skip[K], last[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = i + k * n;
    if (is_label) {
      live[k] = j < ll;
      s[k] = 2 * j + 1;
      own[k] = L + 1 + j;
      right[k] = j + 1;                         // blank j + 1
      has_right[k] = true;
      skip[k] = live[k] && j + 1 < ll && lab[j + 1] != lab[j];
      emit_id[k] = live[k] ? lab[j] : -1;
    } else {
      live[k] = j <= ll;
      s[k] = 2 * j;
      own[k] = j;
      right[k] = j < ll ? L + 1 + j : j;        // label j
      has_right[k] = j < ll;
      skip[k] = false;
      emit_id[k] = blank;
    }
    last[k] = s[k] >= 2 * ll - 1;
    if (!(emit_id[k] >= 0 && emit_id[k] < V)) emit_id[k] = -1;
  }

  // the row's work record for the scatter: offsets seg[v] = the labels
  // with an id in [0, v), and each label's place among them (ties by
  // position), from the labels staged in shared memory
  for (int j = threadIdx.x; j < ll; j += blockDim.x) lab_s[j] = lab[j];
  __syncthreads();
  int* seg = wb + 2;
  int* order = wb + V + 3;
  for (int v = threadIdx.x; v <= V; v += blockDim.x) {
    int c = 0;
    for (int j = 0; j < ll; ++j) c += lab_s[j] >= 0 && lab_s[j] < v;
    seg[v] = c;
  }
  for (int j = threadIdx.x; j < ll; j += blockDim.x) {
    const int v = lab_s[j];
    if (v < 0 || v >= V) continue;              // no column
    int place = 0;
    for (int q = 0; q < ll; ++q) {
      const int u = lab_s[q];
      place += (u >= 0 && u < v) || (u == v && q < j);
    }
    order[place] = j;
  }
  ctc::wait_all();
  __syncthreads();

  const float logz = -nll[b];
  // the posteriors in a pipeline two frames deep, so that no store waits
  // on its exp: gamma of frame t + 1, its posterior (frame t + 2's at
  // first) taken at frame t and stored at frame t - 1
  float z[K], gamma[K], ready[K];
  for (int c = 0, hi = len; hi > 0; ++c, hi -= chunk) {
    // the next chunk streams in while this one is used
    int next_a = 0, next_e = 0;
    stage_chunk(c + 1, &next_a, &next_e);
    ctc::commit();
    const int lo = max(hi - chunk, 0);
    const float* buf = chunks + (c & 1) * (lat_floats + lp_floats);
    const float* lat = buf + lead_a + (hi - 1 - lo) * S;
    const float* row = buf + lat_floats + lead_e + (hi - 1 - lo) * V;
    for (int t = hi - 1; t >= lo; --t, lat -= S, row -= V) {
      const float* zn = smem + ((t + 1) & 1) * S;   // beta_{t+1} + emit_{t+1}
      float* zt = smem + (t & 1) * S;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!live[k]) continue;
        const float e = emit_id[k] >= 0 ? row[emit_id[k]] : kNeg;
        const float at = lat[s[k]];
        float beta;
        if (t == len - 1) {
          beta = last[k] ? 0.0f : kNeg;
        } else {
          // both neighbours read before any arithmetic
          const float r1 = zn[right[k]];
          const float r2 = is_label ? zn[own[k] + 1] : kNeg;
          if (t + 2 < len) {
            pb[static_cast<size_t>(t + 2) * S + s[k]] = ready[k];
          }
          ready[k] = expf(fmaxf(gamma[k], -80.0f));      // frame t + 1's
          beta = logaddexp(z[k], has_right[k] ? r1 : kNeg);
          // a label without the skip adds NEG, which leaves beta's bits
          if (is_label) beta = logaddexp(beta, skip[k] ? r2 : kNeg);
        }
        gamma[k] = at + beta - logz;
        z[k] = beta + e;
        zt[own[k]] = z[k];
      }
      if (t == lo) ctc::wait_all();             // the next chunk is in
      __syncthreads();
    }
    lead_a = next_a;
    lead_e = next_e;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!live[k]) continue;
    if (len >= 2) pb[static_cast<size_t>(S) + s[k]] = ready[k];
    pb[s[k]] = expf(fmaxf(gamma[k], -80.0f));
  }
}

// (b). post and work from (a); dlp: (B, T, V) fp32 out. Grid (ceil(T /
// kScatterFrames), B); warp w of a CTA takes its frames t = first + w,
// first + w + warps, ... Dynamic shared memory: the row's work record,
// then for each warp a frame's S posteriors and V masses.
__global__ void ctc_beta_bwd_scatter_kernel(const float* __restrict__ post,
                                            const int* __restrict__ work,
                                            float* __restrict__ dlp, int T,
                                            int V, int L, int blank) {
  extern __shared__ int rec[];
  const int S = 2 * L + 1;
  const int W = work_ints(L, V);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int first = blockIdx.x * kScatterFrames;
  const int end = min(first + kScatterFrames, T);
  const int* wb = work + static_cast<size_t>(b) * W;
  float* db = dlp + static_cast<size_t>(b) * T * V;
  const int live_frames = wb[0];

  if (live_frames <= first) {                   // zeros past the live frames
    for (int i = first * V + threadIdx.x; i < end * V; i += blockDim.x) {
      db[i] = 0.0f;
    }
    return;
  }
  const int ll = wb[1];
  const int n_lab = wb[2 + V];                  // labels with a column
  for (int i = threadIdx.x; i < V + 3 + n_lab; i += blockDim.x) {
    rec[i] = wb[i];
  }
  __syncthreads();
  const int* seg = rec + 2;
  const int* order = rec + V + 3;
  float* row = reinterpret_cast<float*>(rec + W) + warp * (S + V);
  float* mass = row + S;

  for (int t = first + warp; t < end; t += warps) {
    float* dt = db + static_cast<size_t>(t) * V;
    if (t >= live_frames) {
      for (int v = lane; v < V; v += 32) dt[v] = 0.0f;
      continue;
    }
    const float* pt = post + (static_cast<size_t>(b) * T + t) * S;
    for (int s = lane; s < 2 * ll + 1; s += 32) row[s] = pt[s];
    __syncwarp();
    float blank_mass = 0.0f;
    for (int j = lane; j <= ll; j += 32) blank_mass += row[2 * j];
    for (int off = 16; off > 0; off >>= 1) {
      blank_mass += __shfl_xor_sync(0xffffffffu, blank_mass, off);
    }
    float total = 0.0f;
    for (int v = lane; v < V; v += 32) {
      float m = v == blank ? blank_mass : 0.0f;
      for (int q = seg[v]; q < seg[v + 1]; ++q) m += row[2 * order[q] + 1];
      mass[v] = m;
      total += m;
    }
    // an xor tree leaves every lane the same sum
    for (int off = 16; off > 0; off >>= 1) {
      total += __shfl_xor_sync(0xffffffffu, total, off);
    }
    for (int v = lane; v < V; v += 32) dt[v] = -mass[v] / total;
    __syncwarp();
  }
}

size_t recursion_smem(int L, int V, int chunk) {
  return (((2 * static_cast<size_t>(2 * L + 1) + L + 3) & ~size_t{3}) +
          2 * static_cast<size_t>(ctc::staged_floats(chunk, 2 * L + 1) +
                                  ctc::staged_floats(chunk, V))) *
         4;
}

// The recursion's most frames a chunk that fit (0: none), with its
// shared memory.
int recursion_chunk(int L, int V, int max_smem, size_t* smem) {
  const int chunk = ctc::fit_chunk(
      [&](int c) { return recursion_smem(L, V, c); }, max_smem);
  *smem = recursion_smem(L, V, chunk ? chunk : 1);
  return chunk;
}

// The scatter's warps a CTA (8, 4, 2 or 1: the most whose shared memory
// fits `max_smem`; 0 where none does) and its shared memory.
int scatter_warps(int L, int V, int max_smem, size_t* smem) {
  for (int w = kScatterWarps; w >= 1; w /= 2) {
    *smem = (static_cast<size_t>(work_ints(L, V)) +
             static_cast<size_t>(w) * (2 * L + 1 + V)) * 4;
    if (*smem <= static_cast<size_t>(max_smem)) return w;
  }
  return 0;
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int K>
int launch_recursion(const float* lp, const int* logit_len,
                     const int* labels, const int* label_len,
                     const float* nll, const float* alpha, float* post,
                     int* work, int B, int T, int V, int L, int blank,
                     const ctc::Layout& l, int chunk, size_t smem,
                     cudaStream_t stream) {
  int err = set_smem(reinterpret_cast<const void*>(ctc_beta_bwd_kernel<K>),
                     smem);
  if (err != 0) return err;
  ctc_beta_bwd_kernel<K><<<B, l.threads(), smem, stream>>>(
      lp, logit_len, labels, label_len, nll, alpha, post, work, T, V, L,
      blank, l.blank_threads, l.label_threads, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches (a) and (b) on `stream`; returns cudaGetLastError() after
// each launch (0 on success). The caller guarantees B >= 1, T >= 1, L >=
// 0, V >= 1, a shape that ctc_beta_bwd_resources says fits, contiguous
// device buffers of the documented shapes (post (B, T, 2L+1) fp32, work
// (B, L + V + 3) int32, both scratch), and `alpha` and `nll` written by
// ctc_alpha_fwd on the same inputs.
extern "C" int ctc_beta_bwd(const float* lp, const int* logit_len,
                            const int* labels, const int* label_len,
                            const float* nll, const float* alpha,
                            float* post, int* work, float* dlp, int B,
                            int T, int V, int L, int blank, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ctc::Layout l = ctc::layout(L);
  int max_smem = 0;
  int err = ctc::max_smem_optin(&max_smem);
  if (err != 0) return err;
  size_t rsmem = 0;
  const int chunk = recursion_chunk(L, V, max_smem, &rsmem);
  if (chunk == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  switch (l.states) {
    case 1: err = launch_recursion<1>(lp, logit_len, labels, label_len, nll,
                                      alpha, post, work, B, T, V, L, blank,
                                      l, chunk, rsmem, s); break;
    case 2: err = launch_recursion<2>(lp, logit_len, labels, label_len, nll,
                                      alpha, post, work, B, T, V, L, blank,
                                      l, chunk, rsmem, s); break;
    case 4: err = launch_recursion<4>(lp, logit_len, labels, label_len, nll,
                                      alpha, post, work, B, T, V, L, blank,
                                      l, chunk, rsmem, s); break;
    default: return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (err != 0) return err;
  size_t smem = 0;
  const int warps = scatter_warps(L, V, max_smem, &smem);
  if (warps == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = set_smem(reinterpret_cast<const void*>(ctc_beta_bwd_scatter_kernel),
                 smem);
  if (err != 0) return err;
  const dim3 grid((T + kScatterFrames - 1) / kScatterFrames, B);
  ctc_beta_bwd_scatter_kernel<<<grid, warps * 32, smem, s>>>(
      post, work, dlp, T, V, L, blank);
  return static_cast<int>(cudaGetLastError());
}

// The two launches' resources at (L, V), nothing launched: out[0..4] =
// the recursion's threads, states a thread, frames a chunk, dynamic shared
// memory in bytes and CTAs an SM; out[5..9] = the scatter's threads,
// frames a CTA, warps a CTA, dynamic shared memory and CTAs an SM. A CTA
// count of 0 means that launch does not fit. Returns a CUDA error, 0 on
// success.
extern "C" int ctc_beta_bwd_resources(int L, int V, int* out) {
  const ctc::Layout l = ctc::layout(L);
  int max_smem = 0;
  int err = ctc::max_smem_optin(&max_smem);
  if (err != 0) return err;
  size_t smem = 0;
  const int chunk = recursion_chunk(L, V, max_smem, &smem);
  switch (l.states) {
    case 2: err = ctc::recursion_fit(ctc_beta_bwd_kernel<2>, l, chunk, smem,
                                     out);
            break;
    case 4: err = ctc::recursion_fit(ctc_beta_bwd_kernel<4>, l, chunk, smem,
                                     out);
            break;
    default: err = ctc::recursion_fit(ctc_beta_bwd_kernel<1>, l, chunk, smem,
                                      out);
  }
  if (err != 0) return err;
  size_t ssmem = 0;
  const int warps = scatter_warps(L, V, max_smem, &ssmem);
  out[5] = warps * 32;
  out[6] = kScatterFrames;
  out[7] = warps;
  out[8] = static_cast<int>(ssmem);
  out[9] = 0;
  if (warps == 0) return 0;
  err = set_smem(reinterpret_cast<const void*>(ctc_beta_bwd_scatter_kernel),
                 ssmem);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[9], ctc_beta_bwd_scatter_kernel, warps * 32, ssmem));
}
