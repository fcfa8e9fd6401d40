// LSTM recurrence, forward, over pre-projected inputs: one persistent
// cooperative launch per direction and layer.
//
// Replaces `_fwd_kernel` in openseq2seq_tpu/ops/lstm_pallas.py:73 (kernel
// B3, forward), which `parts/rnns/rnn.LSTM` reaches under the model key
// `fused_rnn` (the bidirectional `cudnn_lstm` of lstm_small, the LSTM
// language models). The cell, as there, in fp32 from a compute-type h and
// W_h and an fp32 c:
//   g = x_proj[t] + h W_h                  (fp32 accumulation, no bias)
//   i = sigmoid(g_i); f = sigmoid(g_f + forget_bias); o = sigmoid(g_o)
//   c' = f c + i tanh(g_g);  h' = o tanh(c')
//   h, c <- h', c' only where t < length
// h' is rounded to the compute type before it is carried, c stays fp32
// (in a (B, H) buffer that ends as c_last). ys[t] is h' where t < length
// and 0 past it. With residuals asked for, [i, f, tanh(g_g), o] go to acts
// in the compute type and c' (unmasked, fp32) to cs, at the original time
// index t, for the backward pass.
//
// What bounds it on an H100: at the lstm_small shape (B = 32, T = 500,
// H = 512, bf16) it must read x_proj (65.5 MB) and W_h (2.1 MB) and write
// ys (16.4 MB), 25 us at 3.35 TB/s, and do 33.6 GFLOP, 34 us at the bf16
// tensor-core peak: operations, in principle. In practice 500 dependent
// steps, each ending in a grid-wide barrier, make a step's latency set the
// pace (about 3.3 us a step at B = 8, H = 128). The design is the GRU's
// (rnn_scan.cuh): 4 hidden units (16 columns) a CTA over 128 CTAs at H =
// 512; in bf16 W_h in registers as mma.sync fragments (16 a thread; 100
// at H = 1280, where an fp32 copy of W_h would not fit a CTA's shared
// memory), the product on the tensor cores, h_{t-1} read from L2 once a
// cluster of two CTAs and multicast, c kept in fp32; fp32 keeps W_h's
// columns in shared memory and the products on the CUDA cores (it is
// refused at H = 1280 before any launch); fixed-order sums.
#include "rnn_scan.cuh"

namespace {

using rnn_scan::from_f;
using rnn_scan::Params;
using rnn_scan::sigmoid;

struct LstmCell {
  // c, which this thread wrote in the step before (or c0)
  static __device__ __forceinline__ float state(const Params& p, int b,
                                                int col) {
    return p.cstate[static_cast<size_t>(b) * p.H + col];
  }
  template <typename T>
  static __device__ __forceinline__ void step(
      const Params& p, int b, int t, int col, const float (&pre)[4],
      const float (&x)[4], float h_prev, float c, bool live, bool last,
      T* dst) {
    const int H = p.H;
    const float si = sigmoid(x[0] + pre[0]);
    const float sf = sigmoid(x[1] + pre[1] + p.forget_bias);
    const float tg = tanhf(x[2] + pre[2]);
    const float so = sigmoid(x[3] + pre[3]);
    const float c_new = sf * c + si * tg;
    const float h_new = so * tanhf(c_new);
    p.cstate[static_cast<size_t>(b) * H + col] = live ? c_new : c;
    const T h = from_f<T>(live ? h_new : h_prev);
    const size_t bt = static_cast<size_t>(b) * p.T + t;
    dst[static_cast<size_t>(b) * H + col] = h;
    static_cast<T*>(p.ys)[bt * H + col] = live ? h : from_f<T>(0.f);
    if (last) static_cast<T*>(p.h_last)[static_cast<size_t>(b) * H + col] = h;
    if (p.acts != nullptr) {
      T* a = static_cast<T*>(p.acts) + bt * 4 * H + col;
      a[0] = from_f<T>(si);
      a[H] = from_f<T>(sf);
      a[2 * H] = from_f<T>(tg);
      a[3 * H] = from_f<T>(so);
      static_cast<float*>(p.aux)[bt * H + col] = c_new;
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
// 4H) and W_h (H, 4H) in the compute type (bf16 when is_bf16, else fp32),
// lengths (B,) int32, hbuf (2, B, H) with h0 in hbuf[0], cstate (B, H)
// fp32 holding c0 (c_last on return), ys (B, T, H), h_last (B, H), acts
// (B, T, 4H) and cs (B, T, H) fp32 both null or both given, and a zeroed
// uint32 barrier counter.
extern "C" int lstm_scan_fwd(const void* x_proj, const void* wh,
                             const void* lengths, void* hbuf, void* cstate,
                             void* ys, void* h_last, void* acts, void* cs,
                             void* barrier, int B, int T, int H, int units,
                             int reverse, int is_bf16, float forget_bias,
                             void* stream) {
  Params p{};
  p.xp = x_proj;
  p.wh = wh;
  p.bh = nullptr;
  p.lens = static_cast<const int*>(lengths);
  p.hbuf = hbuf;
  p.cstate = static_cast<float*>(cstate);
  p.ys = ys;
  p.h_last = h_last;
  p.acts = acts;
  p.aux = cs;
  p.barrier = static_cast<unsigned int*>(barrier);
  p.B = B;
  p.T = T;
  p.H = H;
  p.reverse = reverse;
  p.forget_bias = forget_bias;
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return rnn_scan::dispatch_units<__nv_bfloat16, 4, LstmCell>(p, units, s);
  return rnn_scan::dispatch_units<float, 4, LstmCell>(p, units, s);
}

// The dynamic shared memory (out[0], bytes), the CTAs an SM holds
// (out[1]) and the CTAs that can be resident at once in its clusters
// (out[2]) of the kernel lstm_scan_fwd launches at width H with `units` a
// CTA, out[1] and out[2] 0 where a CTA's shared memory passes what an
// SM gives one; nothing is launched. Returns 0 or a CUDA error code.
extern "C" int lstm_scan_fwd_resources(int H, int units, int is_bf16,
                                       int* out) {
  Params p{};
  p.H = H;
  p.query = out;
  if (is_bf16)
    return rnn_scan::dispatch_units<__nv_bfloat16, 4, LstmCell>(
        p, units, nullptr);
  return rnn_scan::dispatch_units<float, 4, LstmCell>(
        p, units, nullptr);
}
