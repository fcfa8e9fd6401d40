// GRU recurrence, forward, over pre-projected inputs: one persistent
// cooperative launch per direction and layer.
//
// Replaces `_fwd_kernel` in openseq2seq_tpu/ops/gru_pallas.py:64 (kernel
// B4, forward), which `parts/rnns/rnn.GRU` reaches under the model key
// `fused_rnn` (the DeepSpeech2 recipes' bidirectional `cudnn_gru`). The
// cuDNN variant of the cell, as there, all in fp32 from a compute-type h
// and W_h:
//   hp = h W_h + b_h                       (fp32 accumulation)
//   r = sigmoid(x_r + hp_r);  z = sigmoid(x_z + hp_z)
//   n = tanh(x_n + r * hp_n)
//   h' = (1 - z) n + z h,   kept only where t < length
// h' is rounded to the compute type (bf16 or fp32) before it is carried
// to the next step, as the TPU kernel carries it. ys[t] is h' where
// t < length and 0 past it (the JAX layer's output mask, applied here).
// With residuals asked for, [r, z, n] go to acts and hp_n to hn, both in
// the compute type, at the original time index t, for the backward pass.
//
// What bounds it on an H100: at the DeepSpeech2-medium shape (B = 32,
// T = 500, H = 1024, bf16) it must read x_proj (98.3 MB) and W_h (6.3 MB)
// and write ys (32.8 MB), 41 us at 3.35 TB/s, and do 100.7 GFLOP, 102 us
// at the bf16 tensor-core peak: operations, in principle. In practice the
// 500 steps are dependent and each ends in a grid-wide barrier, so a
// step's latency sets the pace: the barrier, the read of h_{t-1} from L2,
// the product, the sum across warps, the gate math and the stores (about
// 2.7 us a step at B = 8, H = 128, where the product is next to nothing).
// The design (rnn_scan.cuh) keeps that path short: 8 hidden units (24
// columns of W_h) a CTA over 128 CTAs, W_h on chip for all steps; in bf16
// (scan_fwd_mma_kernel) W_h in registers as mma.sync fragments, the
// per-step (32 x 1024) . (1024 x 24) product on the tensor cores (48
// mma.sync a warp, where the fp32 design does 3,072 FMAs a thread on the
// CUDA cores, about 1.7 ms to dispatch over the 500 steps), each warp
// waiting only for its own slice of h, which clusters of two CTAs read
// from L2 once and multicast (4 MiB of L2 reads a step, not 8); x_proj
// read while h lands; no atomics in the sums. fp32 keeps the CUDA-core
// design. Both directions in one launch (half the grid barriers) is the
// next step.
#include "rnn_scan.cuh"

namespace {

using rnn_scan::from_f;
using rnn_scan::Params;
using rnn_scan::sigmoid;

struct GruCell {
  // the GRU carries h alone
  static __device__ __forceinline__ float state(const Params&, int, int) {
    return 0.f;
  }
  template <typename T>
  static __device__ __forceinline__ void step(
      const Params& p, int b, int t, int col, const float (&pre)[3],
      const float (&x)[3], float h_prev, float, bool live, bool last,
      T* dst) {
    const int H = p.H;
    const float hr = pre[0] + p.bh[col];
    const float hz = pre[1] + p.bh[H + col];
    const float hn = pre[2] + p.bh[2 * H + col];
    const float r = sigmoid(x[0] + hr);
    const float z = sigmoid(x[1] + hz);
    const float n = tanhf(x[2] + r * hn);
    const float h_new = (1.f - z) * n + z * h_prev;
    const T h = from_f<T>(live ? h_new : h_prev);
    const size_t bt = static_cast<size_t>(b) * p.T + t;
    dst[static_cast<size_t>(b) * H + col] = h;
    static_cast<T*>(p.ys)[bt * H + col] = live ? h : from_f<T>(0.f);
    if (last) static_cast<T*>(p.h_last)[static_cast<size_t>(b) * H + col] = h;
    if (p.acts != nullptr) {
      T* a = static_cast<T*>(p.acts) + bt * 3 * H + col;
      a[0] = from_f<T>(r);
      a[H] = from_f<T>(z);
      a[2 * H] = from_f<T>(n);
      static_cast<T*>(p.aux)[bt * H + col] = from_f<T>(hn);
    }
  }
};

}  // namespace

// Launches on `stream`; returns 0 on success, a CUDA error code, or
// rnn_scan::kNotCoResident (-2) when the H / units CTAs cannot all be
// resident at once, kTooMuchSmem (-4) when a CTA's shared memory passes
// what an SM gives one (nothing is launched then), or kBadUnits (-3). The
// caller guarantees B, T >= 1, H % 128 == 0 (or H = 64 in fp32), 1 <=
// units <= 10 dividing H, and contiguous device buffers: x_proj (B, T,
// 3H) and W_h (H, 3H) in the compute type (bf16 when is_bf16, else fp32),
// b_h (3H,) fp32, lengths (B,) int32, hbuf (2, B, H) with h0 in hbuf[0],
// ys (B, T, H), h_last (B, H), acts (B, T, 3H) and hn (B, T, H) both null
// or both given, and a zeroed uint32 barrier counter.
extern "C" int gru_scan_fwd(const void* x_proj, const void* wh,
                            const void* bh, const void* lengths, void* hbuf,
                            void* ys, void* h_last, void* acts, void* hn,
                            void* barrier, int B, int T, int H, int units,
                            int reverse, int is_bf16, void* stream) {
  Params p{};
  p.xp = x_proj;
  p.wh = wh;
  p.bh = static_cast<const float*>(bh);
  p.lens = static_cast<const int*>(lengths);
  p.hbuf = hbuf;
  p.cstate = nullptr;
  p.ys = ys;
  p.h_last = h_last;
  p.acts = acts;
  p.aux = hn;
  p.barrier = static_cast<unsigned int*>(barrier);
  p.B = B;
  p.T = T;
  p.H = H;
  p.reverse = reverse;
  p.forget_bias = 0.f;
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return rnn_scan::dispatch_units<__nv_bfloat16, 3, GruCell>(p, units, s);
  return rnn_scan::dispatch_units<float, 3, GruCell>(p, units, s);
}

// The dynamic shared memory (out[0], bytes), the CTAs an SM holds
// (out[1]) and the CTAs that can be resident at once in its clusters
// (out[2]) of the kernel gru_scan_fwd launches at width H with `units` a
// CTA, out[1] and out[2] 0 where a CTA's shared memory passes what an
// SM gives one; nothing is launched. Returns 0 or a CUDA error code.
extern "C" int gru_scan_fwd_resources(int H, int units, int is_bf16,
                                      int* out) {
  Params p{};
  p.H = H;
  p.query = out;
  if (is_bf16)
    return rnn_scan::dispatch_units<__nv_bfloat16, 3, GruCell>(
        p, units, nullptr);
  return rnn_scan::dispatch_units<float, 3, GruCell>(
        p, units, nullptr);
}
