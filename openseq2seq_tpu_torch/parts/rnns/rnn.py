"""Recurrent layers (port of ``openseq2seq_tpu/parts/rnns/rnn.py``).

:class:`LSTM` and :class:`GRU` take (B, T, D) and (B,) lengths and return
(B, T, H), zero past each length, and their last state. As in the JAX
package, the input projection for all steps is one dense layer (module
``input_proj``, weight (G·H, D)) ahead of the recurrence, the recurrent
weight ``recurrent_kernel`` is kept as flax keeps it, (H, G·H), and the
GRU adds ``recurrent_bias`` (3H,) to h W_h before the reset gate scales
its candidate part (the cuDNN variant). A reverse cell walks time
backward; the carry freezes where the mask is 0, so a padded row's state
is its state at its last valid frame.

Two paths, chosen per call exactly where the JAX package chooses:

  * ``fused`` (the model key ``fused_rnn``, passed down explicitly) and a
    shape that ``ops/gru_scan.supported`` / ``ops/lstm_scan.supported``
    takes: the whole recurrence in one call, the hand-written CUDA kernels
    on the card (kernels B4 and B3, forward and, in training, backward)
    or their plain versions on the CPU, with the TPU kernels' numbers;
    the forward keeps the backward's residuals only when autograd will
    need them, so eval and infer hold no more than ys;
  * otherwise the scan: a Python loop of torch operations with the
    ``lax.scan``'s numbers. Under a bf16 compute type these round where
    the scan rounds: the LSTM adds x_proj + h W_h in bf16, the GRU rounds
    h W_h to bf16 before its fp32 bias; the fused path does both in fp32.

:class:`BiRNN` concatenates a forward and a reverse cell (``fw``, ``bw``)
and :func:`make_rnn` maps the configs' ``rnn_type`` strings as the JAX
package does. The language model's other cells keep the flax modules'
names, weights and numbers:

  * :class:`GLSTM`: the input and the state split into ``num_groups``
    slices, each an :class:`LSTM` (``group{g}``), so that under ``fused``
    each group's recurrence reaches kernel B3 wherever its width H / G is
    supported;
  * :class:`SLSTM`: gates from the input alone (one input projection
    ahead of the loop), the recurrence elementwise;
  * :class:`FLSTM`: [x, h] through a bias-free bottleneck of
    ``fact_size`` (``first_gemm_x``, ``first_gemm_h``), then the gates
    (``second_gemm``, ``second_gemm_bias``), optionally the output
    projected to ``num_proj`` (``projection``);
  * :class:`LayerNormLSTM`: a bias-free input projection, each gate's
    pre-activation layer-normed (``ln_scale``, ``ln_bias``, (4, H)), and
    in training with ``recurrent_weight_keep_prob`` below 1 one
    DropConnect mask on W_h a call, drawn from the generator passed in.

The last three run the scan: no kernel computes them, in the JAX package
or here. :class:`TemporalConvolutionalLayer` is the causal conv of
``encoders/tdnn_encoder.CausalConv1d`` under the flax layer's name.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ...decoders.fc_decoders import Dense
from ...ops import gru_scan, lstm_scan
from ..initializers import resolve_initializer

_LSTM_TYPES = ("lstm", "cudnn_lstm", "layernorm_lstm")
_GRU_TYPES = ("gru", "cudnn_gru")


def _time_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """(B, T) bool: t < length."""
    return torch.arange(T, device=lengths.device)[None, :] < \
        lengths[:, None]


def _steps(T: int, reverse: bool):
    return range(T - 1, -1, -1) if reverse else range(T)


class _Cell(nn.Module):
    """The input projection and recurrent weight of a G-gate cell."""

    def __init__(self, in_features: int, hidden_size: int, gates: int,
                 reverse: bool, dtype: torch.dtype, fused: bool,
                 generator: torch.Generator):
        super().__init__()
        self.hidden_size, self.reverse = hidden_size, reverse
        self.dtype, self.fused = dtype, fused
        self.input_proj = Dense(in_features, gates * hidden_size, dtype,
                                resolve_initializer(None), generator)
        self.recurrent_kernel = nn.Parameter(
            torch.empty(hidden_size, gates * hidden_size))
        with torch.no_grad():
            nn.init.orthogonal_(self.recurrent_kernel, generator=generator)


class LSTM(_Cell):
    """Unidirectional LSTM over (B, T, D) -> (B, T, H), (h_last, c_last)."""

    def __init__(self, in_features: int, hidden_size: int,
                 forget_bias: float = 1.0, reverse: bool = False,
                 dtype: torch.dtype = torch.float32, fused: bool = False,
                 generator: torch.Generator = None):
        super().__init__(in_features, hidden_size, 4, reverse, dtype, fused,
                         generator)
        self.forget_bias = forget_bias

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                initial_state=None):
        B, T, _ = x.shape
        H = self.hidden_size
        x_proj = self.input_proj(x)                          # (B, T, 4H)
        if initial_state is None:
            h0 = x_proj.new_zeros((B, H))
            c0 = torch.zeros((B, H), device=x.device)
        else:
            h0, c0 = initial_state
        if self.fused and lstm_scan.supported(B, T, H,
                                                 x_proj.dtype):
            return lstm_scan.lstm_scan(
                x_proj, self.recurrent_kernel, h0, c0.float(), lengths,
                float(self.forget_bias), self.reverse)
        w = self.recurrent_kernel.to(self.dtype)
        mask = _time_mask(lengths, T)
        h, c = h0, c0
        ys = [None] * T
        for t in _steps(T, self.reverse):
            gates = (x_proj[:, t] + h @ w).float()
            i, f, g, o = torch.split(gates, H, dim=-1)
            c_new = torch.sigmoid(f + self.forget_bias) * c + \
                torch.sigmoid(i) * torch.tanh(g)
            h_new = (torch.sigmoid(o) * torch.tanh(c_new)).to(self.dtype)
            live = mask[:, t, None]
            h = torch.where(live, h_new, h)
            c = torch.where(live, c_new, c)
            ys[t] = h
        out = torch.stack(ys, dim=1) * mask[:, :, None].to(self.dtype)
        return out, (h, c)


class GRU(_Cell):
    """Unidirectional GRU (cuDNN gate math) over (B, T, D) -> (B, T, H),
    h_last."""

    def __init__(self, in_features: int, hidden_size: int,
                 reverse: bool = False, dtype: torch.dtype = torch.float32,
                 fused: bool = False, generator: torch.Generator = None):
        super().__init__(in_features, hidden_size, 3, reverse, dtype, fused,
                         generator)
        self.recurrent_bias = nn.Parameter(torch.zeros(3 * hidden_size))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                initial_state=None):
        B, T, _ = x.shape
        H = self.hidden_size
        x_proj = self.input_proj(x)                          # (B, T, 3H)
        h0 = x_proj.new_zeros((B, H)) if initial_state is None \
            else initial_state
        if self.fused and gru_scan.supported(B, T, H,
                                                 x_proj.dtype):
            return gru_scan.gru_scan(x_proj, self.recurrent_kernel,
                                     self.recurrent_bias, h0, lengths,
                                     self.reverse)
        w = self.recurrent_kernel.to(self.dtype)
        b = self.recurrent_bias.float()
        mask = _time_mask(lengths, T)
        h = h0
        ys = [None] * T
        for t in _steps(T, self.reverse):
            hp = (h @ w).float() + b
            xr, xz, xn = torch.split(x_proj[:, t].float(), H, dim=-1)
            hr, hz, hn = torch.split(hp, H, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h_new = ((1 - z) * n + z * h.float()).to(self.dtype)
            h = torch.where(mask[:, t, None], h_new, h)
            ys[t] = h
        out = torch.stack(ys, dim=1) * mask[:, :, None].to(self.dtype)
        return out, h


def _cell(cell_type: str, in_features: int, hidden_size: int, reverse: bool,
          dtype: torch.dtype, fused: bool, generator: torch.Generator):
    if cell_type in _LSTM_TYPES:
        return LSTM(in_features, hidden_size, reverse=reverse, dtype=dtype,
                    fused=fused, generator=generator)
    if cell_type in _GRU_TYPES:
        return GRU(in_features, hidden_size, reverse=reverse, dtype=dtype,
                   fused=fused, generator=generator)
    raise ValueError("not supported rnn type: {}".format(cell_type))


class BiRNN(nn.Module):
    """Bidirectional wrapper: concat(forward, backward) features."""

    def __init__(self, in_features: int, hidden_size: int, cell_type: str,
                 dtype: torch.dtype = torch.float32, fused: bool = False,
                 generator: torch.Generator = None):
        super().__init__()
        # the JAX package's BiRNN: every type but the LSTM ones is a GRU
        kind = "lstm" if cell_type in _LSTM_TYPES else "gru"
        self.fw = _cell(kind, in_features, hidden_size, False, dtype, fused,
                        generator)
        self.bw = _cell(kind, in_features, hidden_size, True, dtype, fused,
                        generator)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        fwd, _ = self.fw(x, lengths)
        bwd, _ = self.bw(x, lengths)
        return torch.cat([fwd, bwd], dim=-1)


def make_rnn(cell_type: str, in_features: int, hidden_size: int,
             unidirectional: bool, dtype: torch.dtype, fused: bool = False,
             generator: torch.Generator = None) -> nn.Module:
    """The reference's ``rnn_type`` strings (``ds2_encoder.py:20-35``);
    the ``cudnn_*`` types map to the same cells."""
    if unidirectional:
        return _cell(cell_type, in_features, hidden_size, False, dtype,
                     fused, generator)
    return BiRNN(in_features, hidden_size, cell_type, dtype, fused,
                 generator)


def _masked_scan(step, x: torch.Tensor, mask: torch.Tensor, state,
                 dtype: torch.dtype):
    """Run ``step(x_t, (h, c)) -> (h_new, c_new)`` over time, the carry
    frozen where ``mask`` is 0: (B, T, H) outputs zero past each length,
    and the last state."""
    h, c = state
    ys = []
    for t in range(x.shape[1]):
        h_new, c_new = step(x[:, t], (h, c))
        live = mask[:, t, None]
        h = torch.where(live, h_new, h)
        c = torch.where(live, c_new, c)
        ys.append(h)
    out = torch.stack(ys, dim=1) * mask[:, :, None].to(dtype)
    return out, (h, c)


def _zero_state(B: int, H_out: int, H: int, like: torch.Tensor,
                dtype: torch.dtype):
    return (torch.zeros((B, H_out), dtype=dtype, device=like.device),
            torch.zeros((B, H), device=like.device))


class GLSTM(nn.Module):
    """Group LSTM (``parts/rnns/rnn.py:230-256``): the input and the state
    split into ``num_groups`` slices, each an independent :class:`LSTM`
    of width ``hidden_size / num_groups``; the outputs concatenated, the
    states a list."""

    def __init__(self, in_features: int, hidden_size: int,
                 num_groups: int = 4, reverse: bool = False,
                 dtype: torch.dtype = torch.float32, fused: bool = False,
                 generator: torch.Generator = None):
        super().__init__()
        if hidden_size % num_groups or in_features % num_groups:
            raise ValueError("hidden_size and input dim must divide "
                             "num_groups")
        self.num_groups = num_groups
        for g in range(1, num_groups + 1):
            self.add_module("group{}".format(g), LSTM(
                in_features // num_groups, hidden_size // num_groups,
                reverse=reverse, dtype=dtype, fused=fused,
                generator=generator))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                initial_state=None):
        outs, states = [], []
        for g, xs in enumerate(torch.chunk(x, self.num_groups, dim=-1)):
            out, st = self._modules["group{}".format(g + 1)](xs, lengths)
            outs.append(out)
            states.append(st)
        return torch.cat(outs, dim=-1), states


class SLSTM(nn.Module):
    """Simplified LSTM (``parts/rnns/rnn.py:259-299``): the gates
    (i, j, f, o) from the input alone, one projection ahead of the loop;
    the recurrence is the cell update."""

    def __init__(self, in_features: int, hidden_size: int,
                 forget_bias: float = 1.0,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator = None):
        super().__init__()
        self.hidden_size, self.forget_bias, self.dtype = hidden_size, \
            forget_bias, dtype
        self.input_proj = Dense(in_features, 4 * hidden_size, dtype,
                                resolve_initializer(None), generator)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                initial_state=None):
        B, T, _ = x.shape
        H = self.hidden_size
        gates = self.input_proj(x)                           # (B, T, 4H)
        state = initial_state or _zero_state(B, H, H, x, self.dtype)

        def step(g, carry):
            c = carry[1]
            i, j, f, o = torch.split(g.float(), H, dim=-1)
            c_new = c * torch.sigmoid(f + self.forget_bias) + \
                torch.sigmoid(i) * torch.tanh(j)
            return (torch.tanh(c_new) * torch.sigmoid(o)).to(self.dtype), \
                c_new
        return _masked_scan(step, gates, _time_mask(lengths, T), state,
                            self.dtype)


class FLSTM(nn.Module):
    """Factorized LSTM (``parts/rnns/rnn.py:302-365``): [x, h] through a
    bias-free bottleneck of ``fact_size`` (x's half ahead of the loop),
    then the gates; with ``num_proj`` the output (and h) projected to that
    width by an fp32 product."""

    def __init__(self, in_features: int, hidden_size: int, fact_size: int,
                 num_proj: int = 0, forget_bias: float = 1.0,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator = None):
        super().__init__()
        H = hidden_size
        self.hidden_size, self.num_proj = H, num_proj
        self.forget_bias, self.dtype = forget_bias, dtype
        self.first_gemm_x = Dense(in_features, fact_size, dtype,
                                  resolve_initializer(None), generator,
                                  use_bias=False)
        xavier = resolve_initializer("xavier_uniform")
        self.first_gemm_h = nn.Parameter(torch.empty(num_proj or H,
                                                     fact_size))
        self.second_gemm = nn.Parameter(torch.empty(fact_size, 4 * H))
        self.second_gemm_bias = nn.Parameter(torch.zeros(4 * H))
        with torch.no_grad():
            nn.init.orthogonal_(self.first_gemm_h, generator=generator)
            xavier(self.second_gemm, generator)
        if num_proj:
            self.projection = nn.Parameter(torch.empty(H, num_proj))
            with torch.no_grad():
                xavier(self.projection, generator)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                initial_state=None):
        B, T, _ = x.shape
        H = self.hidden_size
        x_fact = self.first_gemm_x(x)                        # (B, T, F)
        state = initial_state or _zero_state(
            B, self.num_proj or H, H, x, self.dtype)
        w1h = self.first_gemm_h.to(self.dtype)
        w2 = self.second_gemm.to(self.dtype)

        def step(xf, carry):
            h, c = carry
            gates = ((xf + h @ w1h) @ w2).float() + self.second_gemm_bias
            i, j, f, o = torch.split(gates, H, dim=-1)
            c_new = torch.sigmoid(f + self.forget_bias) * c + \
                torch.sigmoid(i) * torch.tanh(j)
            m = torch.sigmoid(o) * torch.tanh(c_new)
            if self.num_proj:
                m = m @ self.projection
            return m.to(self.dtype), c_new
        return _masked_scan(step, x_fact, _time_mask(lengths, T), state,
                            self.dtype)


class LayerNormLSTM(nn.Module):
    """Layer-norm LSTM with DropConnect on W_h (``parts/rnns/rnn.py:
    368-432``): a bias-free input projection; each gate's pre-activation
    layer-normed (eps ``norm_epsilon``) with its own scale and bias; in
    training with ``recurrent_weight_keep_prob`` below 1, one mask on W_h
    a call, an exact Bernoulli draw per weight from ``generator``, the
    kept weights scaled by 1 / keep."""

    def __init__(self, in_features: int, hidden_size: int,
                 forget_bias: float = 1.0,
                 recurrent_weight_keep_prob: float = 1.0,
                 norm_epsilon: float = 1e-6,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator = None):
        super().__init__()
        H = hidden_size
        self.hidden_size, self.forget_bias, self.dtype = H, forget_bias, \
            dtype
        self.keep, self.eps = recurrent_weight_keep_prob, norm_epsilon
        self.input_proj = Dense(in_features, 4 * H, dtype,
                                resolve_initializer(None), generator,
                                use_bias=False)
        self.recurrent_kernel = nn.Parameter(torch.empty(H, 4 * H))
        with torch.no_grad():
            nn.init.orthogonal_(self.recurrent_kernel, generator=generator)
        self.ln_scale = nn.Parameter(torch.ones(4, H))
        self.ln_bias = nn.Parameter(torch.zeros(4, H))

    def recurrent_weight(self, train: bool,
                         generator: torch.Generator = None) -> torch.Tensor:
        """W_h, with the call's DropConnect mask in training."""
        w = self.recurrent_kernel
        if train and self.keep < 1.0:
            if generator is None:
                raise ValueError("DropConnect in training needs a "
                                 "torch.Generator")
            mask = torch.rand(w.shape, generator=generator,
                              device=w.device) < self.keep
            w = torch.where(mask, w / self.keep, 0.0)
        return w

    def _ln(self, v, idx):
        mu = v.mean(-1, keepdim=True)
        var = torch.square(v - mu).mean(-1, keepdim=True)
        v = (v - mu) * torch.rsqrt(var + self.eps)
        return v * self.ln_scale[idx] + self.ln_bias[idx]

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                initial_state=None, train: bool = False,
                generator: torch.Generator = None):
        B, T, _ = x.shape
        H = self.hidden_size
        x_proj = self.input_proj(x)
        w = self.recurrent_weight(train, generator).to(self.dtype)
        state = initial_state or _zero_state(B, H, H, x, self.dtype)

        def step(xp, carry):
            h, c = carry
            gates = (xp + h @ w).float()
            i, j, f, o = (self._ln(g, k) for k, g in
                          enumerate(torch.split(gates, H, dim=-1)))
            c_new = torch.sigmoid(f + self.forget_bias) * c + \
                torch.sigmoid(i) * torch.tanh(j)
            return (torch.sigmoid(o) * torch.tanh(c_new)).to(self.dtype), \
                c_new
        return _masked_scan(step, x_proj, _time_mask(lengths, T), state,
                            self.dtype)


class TemporalConvolutionalLayer(nn.Module):
    """The causal (left-padded) 1-D convolution of the reference's
    ``parts/cnns/tcn.py``: ``(k - 1) * d`` zeros on the left, then the
    VALID conv (module ``conv``, a :class:`CausalConv1d`); (B, T, C) in,
    (B, ceil(T / strides), filters) out."""

    def __init__(self, in_features: int, filters: int, kernel_size: int,
                 strides: int = 1, dilation: int = 1, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator = None):
        super().__init__()
        from ...encoders.tdnn_encoder import CausalConv1d
        self.conv = CausalConv1d(in_features, filters, kernel_size, strides,
                                 dilation, dtype, resolve_initializer(None),
                                 generator, use_bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)
