// GRU recurrence, backward: one persistent cooperative launch per
// direction and layer.
//
// Replaces `_bwd_kernel` in openseq2seq_tpu/ops/gru_pallas.py:150 (kernel
// B4, backward), which the VJP of `gru_scan` (`_gru_vjp_bwd`, :270) runs
// for `parts/rnns/rnn.GRU` under the model key `fused_rnn` (the
// DeepSpeech2 recipes' bidirectional `cudnn_gru`). From the residuals the
// forward kernel saves ([r, z, n] and hn in the compute type), per step,
// all in fp32 (gru_pallas.py:14-26, 160-184):
//   dh = carry + dys[t] (dropped past the length, where ys is 0)
//   dh_new = dh where t < length, else 0
//   dz = dh_new (h_prev - n);  dn = dh_new (1 - z)(1 - n^2)
//   dr = dn hn r (1 - r)
//   dx[t] = [dr, dz z (1 - z), dn]             (rounded to the compute type)
//   dhp   = [dr, dz z (1 - z), dn r]           (rounded before the product)
//   carry = (dh where t >= length) + dh_new z + dhp W_h^T   (fp32 sums)
// and dh0 = the last carry, in the compute type. h_prev is ys[t_prev] or
// h0 (rnn_scan_bwd.cuh: the port's ys is 0 past each length, so a reverse
// row's first valid step takes h0, not ys). dW_h = h_prev^T dhp and db_h =
// sum dhp are not computed here: they are two large products over all T
// and B, left to a GEMM outside as the TPU kernel leaves them to XLA.
//
// What bounds it on an H100: at the DeepSpeech2-medium shape (B = 32,
// T = 500, H = 1024, bf16) it must read the residuals (acts 98.3 MB, hn,
// ys and dys 32.8 MB each), W_h (6.3 MB) and write dx (98.3 MB): 91 us at
// 3.35 TB/s; and do 100.7 GFLOP, 102 us at the bf16 tensor-core peak. As
// the forward, it is latency-bound in practice: 500 dependent steps, each
// ending in a grid-wide barrier. The design (rnn_scan_bwd.cuh): each CTA
// keeps its 8 units' rows of W_h (3H = 3072 values each) on chip for all
// steps (bf16: mma.sync B fragments in registers, 48 a thread) and owns
// those units' carries, so only dhp crosses CTAs, through a 384 KiB
// ping-pong buffer in L2 that every CTA needs whole each step: three
// times the forward's bytes per step (192 KiB at B = 32). That stream
// from L2 sets the pace once the products run on the tensor cores, so in
// bf16 clusters of two CTAs read each row once and multicast it.
#include "rnn_scan_bwd.cuh"

namespace {

using rnn_scan::BwdParams;
using rnn_scan::from_f;
using rnn_scan::to_f;

struct GruBwdCell {
  static constexpr int kRes = 6;   // r, z, n, hn, h_prev, dys

  template <typename T>
  static __device__ __forceinline__ void load(const BwdParams& p, int b,
                                              int t, int col, int len,
                                              float (&res)[kRes]) {
    const int H = p.H;
    const size_t bt = static_cast<size_t>(b) * p.T + t;
    const T* a = static_cast<const T*>(p.acts) + bt * 3 * H + col;
    res[0] = to_f(a[0]);
    res[1] = to_f(a[H]);
    res[2] = to_f(a[2 * H]);
    res[3] = to_f(static_cast<const T*>(p.aux)[bt * H + col]);
    int tp;
    res[4] = rnn_scan::has_prev(p, t, len, &tp)
        ? to_f(static_cast<const T*>(p.prev)[(static_cast<size_t>(b) * p.T +
                                              tp) * H + col])
        : to_f(static_cast<const T*>(p.init)[static_cast<size_t>(b) * H +
                                             col]);
    res[5] = to_f(static_cast<const T*>(p.dys)[bt * H + col]);
  }

  template <typename T>
  static __device__ __forceinline__ void step(const BwdParams& p, int b,
                                              int t, int col, bool live,
                                              float carry,
                                              const float (&res)[kRes],
                                              T* dhp) {
    const int H = p.H;
    const float r = res[0], z = res[1], n = res[2], hn = res[3];
    const size_t bt = static_cast<size_t>(b) * p.T + t;
    if (p.carries != nullptr) p.carries[bt * H + col] = carry;
    const float dh = carry + (live ? res[5] : 0.f);
    const float dh_new = live ? dh : 0.f;
    const float dz = dh_new * (res[4] - n);
    const float dn = dh_new * (1.f - z) * (1.f - n * n);
    const float dr = dn * hn * r * (1.f - r);
    const float dzp = dz * z * (1.f - z);
    T* dx = static_cast<T*>(p.dx) + bt * 3 * H + col;
    dx[0] = from_f<T>(dr);
    dx[H] = from_f<T>(dzp);
    dx[2 * H] = from_f<T>(dn);
    T* g = dhp + static_cast<size_t>(b) * 3 * H + col;
    g[0] = from_f<T>(dr);
    g[H] = from_f<T>(dzp);
    g[2 * H] = from_f<T>(dn * r);
    p.hcarry[static_cast<size_t>(b) * H + col] =
        (live ? 0.f : dh) + dh_new * z;
  }
};

}  // namespace

// Launches on `stream`; returns 0 on success, a CUDA error code, or
// rnn_scan::kNotCoResident (-2) when the H / units CTAs cannot all be
// resident at once, kTooMuchSmem (-4) when a CTA's shared memory passes
// what an SM gives one (nothing is launched then), or kBadUnits (-3). The
// caller guarantees B, T >= 1, H % 128 == 0 (or H = 64 in fp32), 1 <=
// units <= 10 dividing H, and contiguous device buffers in the compute
// type (bf16 when is_bf16, else fp32) unless said otherwise: W_h (H, 3H),
// the forward's acts (B, T, 3H) and hn (B, T, H), ys (B, T, H), h0 (B, H),
// lengths (B,) int32, dys (B, T, H), hcarry (B, H) fp32 holding dh_last,
// dx (B, T, 3H) and dh0 (B, H) out, a (2, B, 3H) exchange buffer, carries
// (B, T, H) fp32 out (the dh carried into each step) or null, and a zeroed
// uint32 barrier counter. bf16 runs on the tensor cores
// (scan_bwd_mma_kernel), fp32 on the CUDA cores (scan_bwd_kernel).
extern "C" int gru_scan_bwd(const void* wh, const void* acts, const void* hn,
                            const void* ys, const void* h0,
                            const void* lengths, const void* dys,
                            void* hcarry, void* dx, void* xbuf, void* dh0,
                            void* carries, void* barrier, int B, int T,
                            int H, int units, int reverse, int is_bf16,
                            void* stream) {
  BwdParams p{};
  p.wh = wh;
  p.acts = acts;
  p.aux = hn;
  p.prev = ys;
  p.init = h0;
  p.lens = static_cast<const int*>(lengths);
  p.dys = dys;
  p.hcarry = static_cast<float*>(hcarry);
  p.ccarry = nullptr;
  p.dx = dx;
  p.xbuf = xbuf;
  p.dh0 = dh0;
  p.carries = static_cast<float*>(carries);
  p.ccarries = nullptr;
  p.barrier = static_cast<unsigned int*>(barrier);
  p.B = B;
  p.T = T;
  p.H = H;
  p.reverse = reverse;
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return rnn_scan::dispatch_bwd_units<__nv_bfloat16, 3, GruBwdCell>(
        p, units, s);
  return rnn_scan::dispatch_bwd_units<float, 3, GruBwdCell>(p, units, s);
}

// The dynamic shared memory (out[0], bytes), the CTAs an SM holds
// (out[1]) and the CTAs that can be resident at once in its clusters
// (out[2]) of the kernel gru_scan_bwd launches at width H with `units` a
// CTA, out[1] and out[2] 0 where a CTA's shared memory passes what an
// SM gives one; nothing is launched. Returns 0 or a CUDA error code.
extern "C" int gru_scan_bwd_resources(int H, int units, int is_bf16,
                                      int* out) {
  BwdParams p{};
  p.H = H;
  p.query = out;
  if (is_bf16)
    return rnn_scan::dispatch_bwd_units<__nv_bfloat16, 3, GruBwdCell>(
        p, units, nullptr);
  return rnn_scan::dispatch_bwd_units<float, 3, GruBwdCell>(
        p, units, nullptr);
}
