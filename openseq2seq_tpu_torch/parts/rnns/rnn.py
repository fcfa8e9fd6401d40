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
package does. The language model's other cells (``GLSTM``, ``SLSTM``,
``FLSTM``, ``LayerNormLSTM``; its plain LSTM and GRU layers are these) and
the speech-synthesis recipes' ``TemporalConvolutionalLayer`` are not
ported yet and raise.
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


class _NotPorted(nn.Module):
    slice_name = ""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("{} is not ported yet: it comes with the "
                                  "{} slice (ROADMAP.md)".format(
                                      type(self).__name__, self.slice_name))


class GLSTM(_NotPorted):
    slice_name = "LM cells"


class SLSTM(_NotPorted):
    slice_name = "LM cells"


class FLSTM(_NotPorted):
    slice_name = "LM cells"


class LayerNormLSTM(_NotPorted):
    slice_name = "LM cells"


class TemporalConvolutionalLayer(_NotPorted):
    slice_name = "speech synthesis"
