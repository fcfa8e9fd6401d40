"""WaveNet encoder (port of ``openseq2seq_tpu/encoders/wavenet_encoder.py``):
mu-law coding, blocks of gated causal dilated convolutions with residual
and skip connections, conditioned on mel features upsampled to the audio
rate, and the logits over the quantization channels (the decoder is a
pass-through).

What the JAX module computes, and so the port:

  * :func:`mu_law_encode` of the audio (clipped to [-1, 1]; the ``+ 0.5``,
    then a truncating int cast) gives the labels; the input is the one-hot
    of the previous sample, ``Q // 2`` first, in the compute type;
  * the causal ``entry`` conv (:class:`CausalConv1d`, k ``kernel_size``)
    to ``filters`` F;
  * the conditioning (B, T_mel, F_mel), in the compute type, repeated
    ``T // T_mel`` times a frame, cut to T and padded with its last frame;
  * ``blocks`` x ``layers_per_block`` gated layers ``b{b}_l{l}``: the
    causal conv ``_dilated`` at dilation ``2**(l - 1)`` to 2F, plus the
    1x1 conv ``_cond`` of the conditioning, split into filter and gate in
    that order, ``tanh(filter) * sigmoid(gate)``, then the 1x1 convs
    ``_res`` (added to the layer's input) and ``_skip`` (summed over the
    layers);
  * relu, the 1x1 ``post1``, relu and the 1x1 ``post2`` to Q in fp32.

:func:`wavenet_generate` is the fast generation of the JAX package: each
layer keeps a ring of its last ``d (K - 1) + 1`` inputs and one step
reads its K taps ``d`` apart, so a sample costs one product a layer, not
a run over the receptive field. The conditioning's projection, with the
dilated conv's bias, is made for every sample up front; all of it is fp32
whatever the model's compute type, as in the JAX function. At temperature
0 the next sample is the argmax; otherwise it is drawn from the softmax
of the logits over the temperature, from the ``torch.Generator`` given
(``jax.random.categorical`` draws another sample from the same
distribution). A sample takes about ten launches a layer; on the card the
whole step is one CUDA graph, replayed a sample at a time, so that the
host issues a few launches a sample, not hundreds; on the CPU it runs
eagerly.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .encoder import Encoder
from .tdnn_encoder import CausalConv1d, SameConv1d
from ..parts.initializers import resolve_initializer


def mu_law_encode(signal: torch.Tensor, channels: int) -> torch.Tensor:
    """[-1, 1] float -> int32 ids in [0, channels)."""
    mu = float(channels - 1)
    safe = torch.clamp(signal.float(), -1.0, 1.0)
    magnitude = torch.log1p(mu * safe.abs()) / float(np.log1p(np.float32(mu)))
    encoded = torch.sign(safe) * magnitude
    return ((encoded + 1.0) / 2.0 * mu + 0.5).to(torch.int32)


def mu_law_decode(ids: torch.Tensor, channels: int) -> torch.Tensor:
    mu = float(channels - 1)
    y = 2.0 * (ids.float() / mu) - 1.0
    return torch.sign(y) * torch.expm1(
        y.abs() * float(np.log1p(np.float32(mu)))) / mu


def upsample(cond: torch.Tensor, length: int) -> torch.Tensor:
    """(B, T_mel, F) -> (B, length, F): each frame repeated ``length //
    T_mel`` times (at least once), cut to ``length`` and padded with the
    last frame."""
    if cond.shape[1] == length:
        return cond
    ratio = max(length // cond.shape[1], 1)
    cond = torch.repeat_interleave(cond, ratio, dim=1)[:, :length]
    pad = length - cond.shape[1]
    if pad > 0:
        cond = torch.cat([cond, cond[:, -1:].expand(-1, pad, -1)], dim=1)
    return cond


class WavenetNet(nn.Module):
    """(B, T) audio in [-1, 1], (B,) lengths and (B, T_mel, F_mel)
    conditioning (or None) -> the logits (B, T, Q) and the labels."""

    def __init__(self, blocks: int, layers_per_block: int, filters: int,
                 kernel_size: int, quantization_channels: int,
                 cond_features: Optional[int], dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.blocks, self.layers_per_block = blocks, layers_per_block
        self.filters, self.kernel_size = filters, kernel_size
        self.Q = Q = quantization_channels
        self.dtype = dtype
        self.conditioned = cond_features is not None
        init = resolve_initializer(None)
        conv = lambda i, o, k=1, d=1, cls=SameConv1d, dt=dtype: cls(  # noqa
            i, o, k, 1, d, dt, init, generator)
        self.entry = conv(Q, filters, kernel_size, cls=CausalConv1d)
        for name, d in self.layer_specs():
            self.add_module(name + "_dilated", conv(
                filters, 2 * filters, kernel_size, d, CausalConv1d))
            if self.conditioned:
                self.add_module(name + "_cond", conv(cond_features,
                                                     2 * filters))
            self.add_module(name + "_res", conv(filters, filters))
            self.add_module(name + "_skip", conv(filters, filters))
        self.post1 = conv(filters, filters)
        self.post2 = conv(filters, Q, dt=torch.float32)

    def layer_specs(self):
        """(name, dilation) of each gated layer, in order."""
        return [("b{}_l{}".format(b + 1, l + 1), 2 ** l)
                for b in range(self.blocks)
                for l in range(self.layers_per_block)]

    def forward(self, audio: torch.Tensor, audio_len: torch.Tensor,
                conditioning: Optional[torch.Tensor], train: bool
                ) -> Dict[str, Any]:
        Q = self.Q
        labels = mu_law_encode(audio, Q)
        prev = torch.cat([torch.full_like(labels[:, :1], Q // 2),
                          labels[:, :-1]], dim=1)
        x = self.entry(F.one_hot(prev.long(), Q).to(self.dtype))
        cond = None
        if self.conditioned and conditioning is not None:
            cond = upsample(conditioning.to(self.dtype), x.shape[1])
        skips = None
        m = self._modules
        for name, _ in self.layer_specs():
            gate_in = m[name + "_dilated"](x)
            if cond is not None:
                gate_in = gate_in + m[name + "_cond"](cond)
            filt, gate = torch.chunk(gate_in, 2, dim=-1)
            z = torch.tanh(filt) * torch.sigmoid(gate)
            x = x + m[name + "_res"](z)
            skip = m[name + "_skip"](z)
            skips = skip if skips is None else skips + skip
        out = torch.relu(self.post1(torch.relu(skips)))
        logits = self.post2(out)
        return {"logits": logits, "labels": labels, "audio_len": audio_len,
                "outputs": [labels, mu_law_decode(logits.argmax(-1), Q)]}


def _taps(weight: torch.Tensor) -> torch.Tensor:
    """A conv weight (out, in, k) as the (k in, out) matrix of its taps."""
    return weight.float().permute(2, 1, 0).reshape(-1, weight.shape[0])


class _GenerateStep:
    """One sample through every layer, over device tensors alone: the
    sample's index ``t`` is a device scalar, so the same step runs
    eagerly on the CPU and, on the card, is captured once as a CUDA graph
    and replayed a sample at a time. It reads ``prev`` (the last sample's
    ids) and writes ``logits`` and ``all_logits[:, t]``."""

    def __init__(self, net: WavenetNet, n_samples: int, batch: int,
                 cond_bias: torch.Tensor):
        K, Q, F_ = net.kernel_size, net.Q, net.filters
        dev = cond_bias.device
        m = net._modules
        specs = net.layer_specs()
        self.B, self.K, self.Q, self.F = batch, K, Q, F_
        self.w_entry = _taps(net.entry.weight)
        self.b_entry = net.entry.bias.float()
        self.w_dil = [_taps(m[n + "_dilated"].weight) for n, _ in specs]
        # the residual and skip convs of a layer as one product
        self.w_rs = [torch.cat([_taps(m[n + "_res"].weight),
                                _taps(m[n + "_skip"].weight)], dim=1)
                     for n, _ in specs]
        self.b_rs = [torch.cat([m[n + "_res"].bias,
                                m[n + "_skip"].bias]).float()
                     for n, _ in specs]
        self.w_p1, self.b_p1 = _taps(net.post1.weight), net.post1.bias.float()
        self.w_p2, self.b_p2 = _taps(net.post2.weight), net.post2.bias.float()
        self.cond_bias = cond_bias                       # (n, L, B, 2F)
        # each layer's ring of its last d (K - 1) + 1 inputs, slot t mod
        # size for sample t, and the table of each slot's K tap slots
        self.rings, self.tables = [], []
        for _, d in specs:
            size = d * (K - 1) + 1
            self.rings.append(torch.zeros((batch, size, F_), device=dev))
            t = np.arange(size)[:, None]
            self.tables.append(torch.from_numpy(
                (t - d * np.arange(K - 1, -1, -1)[None, :]) % size).to(dev))
        # the entry conv's last K one-hots
        self.entry = torch.zeros((batch, K, Q), device=dev)
        self.t = torch.zeros(1, dtype=torch.long, device=dev)
        self.prev = torch.full((batch,), Q // 2, dtype=torch.long,
                               device=dev)
        self.logits = torch.zeros((batch, Q), device=dev)
        self.all_logits = torch.zeros((batch, n_samples, Q), device=dev)

    def reset(self):
        for ring in self.rings:
            ring.zero_()
        self.entry.zero_()
        self.t.zero_()
        self.prev.fill_(self.Q // 2)

    def __call__(self):
        B, K, Q, F_ = self.B, self.K, self.Q, self.F
        x = torch.zeros((B, Q), device=self.entry.device).scatter_(
            1, self.prev[:, None], 1.0)
        self.entry.copy_(torch.cat([self.entry[:, 1:], x[:, None]], dim=1))
        h = torch.addmm(self.b_entry, self.entry.view(B, K * Q),
                        self.w_entry)
        cond_t = self.cond_bias.index_select(0, self.t)[0]   # (L, B, 2F)
        skips = None
        for i, ring in enumerate(self.rings):
            slot = torch.remainder(self.t, ring.shape[1])
            ring.index_copy_(1, slot, h[:, None])
            taps = ring.index_select(
                1, self.tables[i].index_select(0, slot)[0])
            g = torch.addmm(cond_t[i], taps.view(B, K * F_), self.w_dil[i])
            z = torch.tanh(g[:, :F_]) * torch.sigmoid(g[:, F_:])
            rs = torch.addmm(self.b_rs[i], z, self.w_rs[i])
            h = h + rs[:, :F_]
            skips = rs[:, F_:] if skips is None else skips + rs[:, F_:]
        out = torch.relu(torch.addmm(self.b_p1, torch.relu(skips),
                                     self.w_p1))
        self.logits.copy_(torch.addmm(self.b_p2, out, self.w_p2))
        self.all_logits.index_copy_(1, self.t, self.logits[:, None])
        self.t.add_(1)


def _captured(step: _GenerateStep):
    """``step`` as a CUDA graph (after a warm-up run on a side stream,
    whose effects ``reset`` undoes), or ``step`` itself off the card."""
    if step.t.device.type != "cuda":
        return step
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        step()
    torch.cuda.current_stream().wait_stream(stream)
    step.reset()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return graph.replay


@torch.no_grad()
def wavenet_generate(net: WavenetNet, n_samples: int,
                     conditioning: Optional[torch.Tensor] = None,
                     batch_size: int = 1, temperature: float = 0.0,
                     generator: Optional[torch.Generator] = None):
    """Autoregressive synthesis of ``n_samples`` samples from ``net``'s
    weights, on their device; ``conditioning`` (B, T_mel, F_mel) is
    upsampled to ``n_samples`` as the net does. Returns (ids (B, n)
    int32, the mu-law decoded audio (B, n), the logits (B, n, Q) fp32)."""
    dev = net.entry.weight.device
    B = conditioning.shape[0] if conditioning is not None else batch_size
    m = net._modules
    specs = net.layer_specs()
    # per sample and layer: the conditioning's projection plus the dilated
    # conv's bias, (n, L, B, 2F)
    if conditioning is not None and net.conditioned:
        cond = upsample(conditioning.float().to(dev), n_samples)
        cond_bias = torch.stack([
            cond @ _taps(m[n + "_cond"].weight) + m[n + "_cond"].bias.float()
            + m[n + "_dilated"].bias.float() for n, _ in specs])
        cond_bias = cond_bias.permute(2, 0, 1, 3).contiguous()
    else:
        cond_bias = torch.stack([m[n + "_dilated"].bias.float()
                                 for n, _ in specs])[None, :, None].expand(
            n_samples, -1, B, -1).contiguous()
    step = _GenerateStep(net, n_samples, B, cond_bias)
    run = _captured(step)
    ids = torch.empty((B, n_samples), dtype=torch.long, device=dev)
    for t in range(n_samples):
        run()
        if temperature > 0.0:
            probs = torch.softmax(step.logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = step.logits.argmax(-1)
        step.prev.copy_(nxt)
        ids[:, t] = nxt
    ids = ids.to(torch.int32)
    return ids, mu_law_decode(ids, net.Q), step.all_logits


class WavenetEncoderModule(nn.Module):

    def __init__(self, net: WavenetNet):
        super().__init__()
        self.net = net
        self.out_features = net.Q

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None) -> Dict[str, Any]:
        src = input_dict["source_tensors"]
        cond = src[2] if len(src) > 2 else None
        return self.net(src[0], src[1], cond, train)


class WavenetEncoder(Encoder):
    """Config wrapper, the JAX package's schema. ``layer_type``,
    ``strides``, ``padding``, ``data_format``, ``bn_momentum`` and
    ``bn_epsilon`` are accepted with no effect, as in the JAX package."""

    @staticmethod
    def get_required_params():
        return dict(Encoder.get_required_params(), **{
            "layer_type": str,
            "kernel_size": int,
            "strides": int,
            "padding": str,
            "blocks": int,
            "layers_per_block": int,
            "filters": int,
            "quantization_channels": int,
        })

    @staticmethod
    def get_optional_params():
        return dict(Encoder.get_optional_params(), **{
            "data_format": str,
            "bn_momentum": float,
            "bn_epsilon": float,
        })

    def make_module(self, in_features: Optional[int],
                    generator: torch.Generator) -> WavenetEncoderModule:
        """``in_features`` is the conditioning's width (None: none)."""
        p = self._params
        return WavenetEncoderModule(WavenetNet(
            p["blocks"], p["layers_per_block"], p["filters"],
            p["kernel_size"], p["quantization_channels"], in_features,
            self.compute_dtype, generator))
