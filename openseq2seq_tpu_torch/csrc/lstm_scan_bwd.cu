// LSTM recurrence, backward: one persistent cooperative launch per
// direction and layer.
//
// Replaces `_bwd_kernel` in openseq2seq_tpu/ops/lstm_pallas.py:173 (kernel
// B3, backward), which the VJP of `lstm_scan` (`_lstm_vjp_bwd`, :318) runs
// for `parts/rnns/rnn.LSTM` under the model key `fused_rnn` (the
// bidirectional `cudnn_lstm` of lstm_small, the LSTM language models).
// From the residuals the forward kernel saves ([i, f, tanh g, o] in the
// compute type, the unmasked fp32 c' of each step), per step, all in fp32
// (lstm_pallas.py:185-216):
//   dh = carry_h + dys[t] (dropped past the length, where ys is 0)
//   dh_new, dc_new = dh, carry_c where t < length, else 0
//   dc_new += dh_new o (1 - tanh^2 c')
//   dgates = [dc_new g i (1 - i), dc_new c_prev f (1 - f),
//             dc_new i (1 - g^2), dh_new tanh(c') o (1 - o)]
//            (written to dx, this is dx_proj, rounded to the compute type
//             and used rounded in the product)
//   carry_h = (dh where t >= length) + dgates W_h^T      (fp32 sums)
//   carry_c = (carry_c where t >= length) + dc_new f
// and dh0 (compute type) and dc0 (fp32) = the last carries. c_prev is
// cs[t_prev] or c0 (rnn_scan_bwd.cuh). The TPU kernel takes cs[t - 1] of
// the flipped sequence for a reverse cell, the unmasked c' of a padded
// step on a short row, which is not the carried c0 where the input
// projection has a bias (ROADMAP.md C15); this kernel takes c0 there.
// dW_h = h_prev^T dgates is not computed here: a GEMM outside does it, as
// XLA does for the TPU kernel.
//
// What bounds it on an H100: at the lstm_small shape (B = 32, T = 500,
// H = 512, bf16) it must read acts (65.5 MB), cs (32.8 MB fp32), dys
// (16.4 MB) and W_h (2.1 MB) and write dgates (65.5 MB): 54 us at 3.35
// TB/s; and do 33.6 GFLOP, 34 us at the bf16 tensor-core peak. In
// practice it is latency-bound as the forward is (500 dependent steps,
// each ending in a grid-wide barrier). The design is the GRU's
// (rnn_scan_bwd.cuh; bf16 on the tensor cores, the 4 units padded to an
// n8 tile, 32 fragment registers a thread, clusters of two), 4 units
// (rows of W_h, 4H = 2048 values each) per CTA over 128 CTAs at H = 512,
// with no exchange buffer: the dgates a step writes to its output are
// what every CTA reads back from L2 for the product.
#include "rnn_scan_bwd.cuh"

namespace {

using rnn_scan::BwdParams;
using rnn_scan::from_f;
using rnn_scan::to_f;

struct LstmBwdCell {
  static constexpr int kRes = 7;   // i, f, tanh g, o, c', c_prev, dys

  template <typename T>
  static __device__ __forceinline__ void load(const BwdParams& p, int b,
                                              int t, int col, int len,
                                              float (&res)[kRes]) {
    const int H = p.H;
    const size_t bt = static_cast<size_t>(b) * p.T + t;
    const T* a = static_cast<const T*>(p.acts) + bt * 4 * H + col;
    res[0] = to_f(a[0]);
    res[1] = to_f(a[H]);
    res[2] = to_f(a[2 * H]);
    res[3] = to_f(a[3 * H]);
    const float* cs = static_cast<const float*>(p.aux);
    res[4] = cs[bt * H + col];
    int tp;
    res[5] = rnn_scan::has_prev(p, t, len, &tp)
        ? cs[(static_cast<size_t>(b) * p.T + tp) * H + col]
        : static_cast<const float*>(p.init)[static_cast<size_t>(b) * H + col];
    res[6] = to_f(static_cast<const T*>(p.dys)[bt * H + col]);
  }

  template <typename T>
  static __device__ __forceinline__ void step(const BwdParams& p, int b,
                                              int t, int col, bool live,
                                              float carry,
                                              const float (&res)[kRes],
                                              T* /* dgates are dx */) {
    const int H = p.H;
    const float si = res[0], sf = res[1], tg = res[2], so = res[3];
    const size_t i = static_cast<size_t>(b) * H + col;
    const size_t bt = static_cast<size_t>(b) * p.T + t;
    const float dh = carry + (live ? res[6] : 0.f);
    const float dc = p.ccarry[i];
    if (p.carries != nullptr) {
      p.carries[bt * H + col] = carry;
      p.ccarries[bt * H + col] = dc;
    }
    const float dh_new = live ? dh : 0.f;
    const float tc = tanhf(res[4]);
    const float dc_new = (live ? dc : 0.f) + dh_new * so * (1.f - tc * tc);
    T* dg = static_cast<T*>(p.dx) + bt * 4 * H + col;
    dg[0] = from_f<T>(dc_new * tg * si * (1.f - si));
    dg[H] = from_f<T>(dc_new * res[5] * sf * (1.f - sf));
    dg[2 * H] = from_f<T>(dc_new * si * (1.f - tg * tg));
    dg[3 * H] = from_f<T>(dh_new * tc * so * (1.f - so));
    p.hcarry[i] = live ? 0.f : dh;
    p.ccarry[i] = (live ? 0.f : dc) + dc_new * sf;
  }
};

}  // namespace

// Launches on `stream`; returns 0 on success, a CUDA error code, or
// rnn_scan::kNotCoResident (-2) when the H / units CTAs cannot all be
// resident at once, kTooMuchSmem (-4) when a CTA's shared memory passes
// what an SM gives one (nothing is launched then), or kBadUnits (-3). The
// caller guarantees B, T >= 1, H % 128 == 0 (or H = 64 in fp32), 1 <=
// units <= 10 dividing H, and contiguous device buffers in the compute
// type (bf16 when is_bf16, else fp32) unless said otherwise: W_h (H, 4H),
// the forward's acts (B, T, 4H) and cs (B, T, H) fp32, c0 (B, H) fp32,
// lengths (B,) int32, dys (B, T, H), hcarry (B, H) fp32 holding dh_last,
// ccarry (B, H) fp32 holding dc_last (dc0 on return), dgates (B, T, 4H)
// and dh0 (B, H) out, carries and ccarries (B, T, H) fp32 out (the dh and
// dc carried into each step) or both null, and a zeroed uint32 barrier
// counter. bf16 runs on the tensor cores (scan_bwd_mma_kernel), fp32 on
// the CUDA cores (scan_bwd_kernel).
extern "C" int lstm_scan_bwd(const void* wh, const void* acts, const void* cs,
                             const void* c0, const void* lengths,
                             const void* dys, void* hcarry, void* ccarry,
                             void* dgates, void* dh0, void* carries,
                             void* ccarries, void* barrier, int B, int T,
                             int H, int units, int reverse, int is_bf16,
                             void* stream) {
  BwdParams p{};
  p.wh = wh;
  p.acts = acts;
  p.aux = cs;
  p.prev = cs;
  p.init = c0;
  p.lens = static_cast<const int*>(lengths);
  p.dys = dys;
  p.hcarry = static_cast<float*>(hcarry);
  p.ccarry = static_cast<float*>(ccarry);
  p.dx = dgates;
  p.xbuf = nullptr;
  p.dh0 = dh0;
  p.carries = static_cast<float*>(carries);
  p.ccarries = static_cast<float*>(ccarries);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.B = B;
  p.T = T;
  p.H = H;
  p.reverse = reverse;
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return rnn_scan::dispatch_bwd_units<__nv_bfloat16, 4, LstmBwdCell>(
        p, units, s);
  return rnn_scan::dispatch_bwd_units<float, 4, LstmBwdCell>(p, units, s);
}

// The dynamic shared memory (out[0], bytes), the CTAs an SM holds
// (out[1]) and the CTAs that can be resident at once in its clusters
// (out[2]) of the kernel lstm_scan_bwd launches at width H with `units` a
// CTA, out[1] and out[2] 0 where a CTA's shared memory passes what an
// SM gives one; nothing is launched. Returns 0 or a CUDA error code.
extern "C" int lstm_scan_bwd_resources(int H, int units, int is_bf16,
                                       int* out) {
  BwdParams p{};
  p.H = H;
  p.query = out;
  if (is_bf16)
    return rnn_scan::dispatch_bwd_units<__nv_bfloat16, 4, LstmBwdCell>(
        p, units, nullptr);
  return rnn_scan::dispatch_bwd_units<float, 4, LstmBwdCell>(
        p, units, nullptr);
}
