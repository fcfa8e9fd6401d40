"""Centaur decoder (port of ``openseq2seq_tpu/decoders/centaur_decoder.py``):
a convolutional, attention-based autoregressive TTS decoder with no
recurrence.

What the JAX module computes, and so the port, over previous frames (B,
T, F):

  * the prenet: ``prenet{i}`` dense layers, each with relu and then
    dropout at 0.5, on in every mode (the Tacotron and Centaur
    convention); the masks come from :meth:`CentaurDecoderModule.keep_mask`
    and the ``torch.Generator`` passed to ``forward`` (the model seeds one
    in eval and infer); a forward pass draws them once, so each re-run of
    the stack in infer takes the same masks, as the JAX module passes each
    re-run the same key;
  * ``pre_proj`` to ``hidden_size``, plus the sinusoidal positions;
  * per block: the causal conv ``conv{i}`` (:class:`CausalConv1d`,
    whatever the spec's padding, its stride ignored), batch norm ``bn{i}``
    (momentum 0.95, epsilon 1e-8 by default), relu and dropout at
    ``cnn_dropout_prob``, added to the block's input only where the shapes
    agree; then cross-attention over the encoder outputs: ``att_q{i}`` of
    the block's output, ``att_kv{i}`` of the memory, logits ``(q
    dh^-0.5) . k`` summed in fp32, -1e9 past each source length and, in
    infer for the ``force_layers`` (all when unset), outside the window
    ``[p - back_step_size, p - back_step_size + window_size)`` where p is
    the previous step's alignment argmax of that layer and head; the
    softmax's weights are recorded (the alignments) before the attention
    dropout; the context through ``att_o{i}`` is added back through the
    post-process dropout;
  * ``frame`` (F r) and ``stop`` (r) dense layers in fp32, reshaped to (B,
    T r, F) and (B, T r): the ``reduction_factor`` r un-reduced.

Under teacher forcing the input of group g is the last frame of the
ground-truth group g - 1 (zeros first), over the targets cut to a
multiple of r. In infer ``infer_max_steps // r`` groups are decoded by
re-running the whole stack over the growing frame buffer, each run
writing group i's last frame as group i + 1's input and step i's
alignment argmax as step i + 1's window base; a final run gives the
outputs, and the lengths come from the stop logits by the cumulative-sum
rule, plus one, clipped to the frames. The re-run is O(T^2), as in the
JAX package, which keeps no incremental cache; the memory's key and value
projections, the same in every run, are made once.

The alignments output is the last block's, averaged over the heads.
Accepted with no effect, as in the JAX module (C27): ``mag_conv_layers``,
``attention_layers``, ``self_attention_conv_params``,
``prenet_activation_fn``, ``prenet_dropout`` (the rate is 0.5),
``prenet_use_inference_dropout`` (the prenet's dropout stays on in infer)
and ``attention_cnn_dropout_prob``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from .decoder import Decoder
from ..parts.dropout import dropout
from ..parts.initializers import resolve_initializer
from ..parts.transformer.common import (Dense, position_encoding,
                                        weak_scalar)

_NEG = -1e9


class CentaurDecoderModule(nn.Module):

    def __init__(self, p: Dict[str, Any], enc_width: int, mode: str,
                 dtype: torch.dtype, generator: torch.Generator,
                 dropout_bits: int = 32):
        super().__init__()
        # here, not at the top: the encoders' package imports the
        # recurrent layers, which import this package's dense layer
        from ..encoders.tdnn_encoder import BatchNorm, CausalConv1d
        self.F = p["num_audio_features"]
        self.r = p.get("reduction_factor", 1)
        self.hidden = H = p["hidden_size"]
        self.heads = p.get("attention_heads", 1)
        self.prenet_layers = p["prenet_layers"]
        self.num_blocks = len(p["conv_layers"])
        self.attention_dropout = p["attention_dropout"]
        self.postprocess_dropout = p["layer_postprocess_dropout"]
        self.cnn_dropout = p.get("cnn_dropout_prob", 0.5)
        self.infer_max_steps = p.get("infer_max_steps", 200)
        self.window_size = p.get("window_size")
        self.back_step_size = p.get("back_step_size", 0)
        force = p.get("force_layers")
        self.force_layers = None if force is None else tuple(force)
        self.mode, self.dtype, self.dropout_bits = mode, dtype, dropout_bits

        width = self.F
        self.prenet_width = p["prenet_hidden_size"]
        for i in range(1, self.prenet_layers + 1):
            self.add_module("prenet{}".format(i), Dense(
                width, self.prenet_width, dtype, generator))
            width = self.prenet_width
        self.pre_proj = Dense(width, H, dtype, generator)
        width = H
        momentum = p.get("bn_momentum", 0.95)
        eps = p.get("bn_epsilon", 1e-8)
        for i, spec in enumerate(p["conv_layers"], start=1):
            ch = spec["num_channels"]
            self.add_module("conv{}".format(i), CausalConv1d(
                width, ch, spec["kernel_size"][0], 1, 1, dtype,
                resolve_initializer(None), generator))
            # flax momentum is the decay of the running average
            self.add_module("bn{}".format(i),
                            BatchNorm(ch, 1.0 - momentum, eps, dtype))
            width = ch
            self.add_module("att_q{}".format(i), Dense(width, H, dtype,
                                                       generator))
            self.add_module("att_kv{}".format(i), Dense(
                enc_width, 2 * H, dtype, generator))
            self.add_module("att_o{}".format(i), Dense(H, H, dtype,
                                                       generator))
        self.frame = Dense(width, self.F * self.r, torch.float32, generator)
        self.stop = Dense(width, self.r, torch.float32, generator)
        self._positions = None

    def keep_mask(self, shape, generator: torch.Generator, device
                  ) -> torch.Tensor:
        """A prenet dropout mask: keep with probability 0.5."""
        return torch.rand(shape, generator=generator, device=device) < 0.5

    def drop(self, x: torch.Tensor, rate: float, train: bool,
             generator: torch.Generator) -> torch.Tensor:
        if not train:
            return x
        return dropout(x, 1.0 - rate, generator, self.dropout_bits)

    def forced(self, layer: int) -> bool:
        return self.force_layers is None or layer in self.force_layers

    def stack(self, frames_in: torch.Tensor, keys_values: List,
              enc_mask: torch.Tensor, prenet_keep: List[torch.Tensor],
              train: bool, generator: torch.Generator,
              positions: Optional[torch.Tensor] = None):
        """frames_in (B, T, F) previous frames -> (frames (B, T r, F),
        stop logits (B, T r), alignments (L, B, heads, T, S) fp32);
        ``keys_values`` holds each block's (k, v) of the memory, (B, S,
        heads, dh) each; ``positions`` (L, B, heads, T) the window bases
        of the forced layers (None: no forcing)."""
        B, T, _ = frames_in.shape
        h = frames_in.to(self.dtype)
        for i, keep in enumerate(prenet_keep, start=1):
            h = torch.relu(getattr(self, "prenet{}".format(i))(h))
            h = torch.where(keep, h / 0.5, torch.zeros((), dtype=h.dtype,
                                                       device=h.device))
        h = self.pre_proj(h)
        if self._positions is None or self._positions.shape[0] != T or \
                self._positions.device != h.device:
            # made once for a length: an infer re-runs the stack G times
            self._positions = position_encoding(T, self.hidden, self.dtype,
                                                h.device)
        h = h + self._positions[None]
        nh = self.heads
        dh = self.hidden // nh
        aligns = []
        for li in range(self.num_blocks):
            i = li + 1
            y = getattr(self, "conv{}".format(i))(h)
            y = torch.relu(getattr(self, "bn{}".format(i))(y, train))
            y = self.drop(y, self.cnn_dropout, train, generator)
            h = h + y if y.shape == h.shape else y
            q = getattr(self, "att_q{}".format(i))(h).reshape(B, T, nh, dh)
            k, v = keys_values[li]
            q = q * weak_scalar(dh ** -0.5, q.dtype)
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            logits = logits.masked_fill(~enc_mask[:, None, None, :], _NEG)
            if positions is not None and self.window_size is not None \
                    and self.forced(li):
                base = torch.clamp(positions[li] - self.back_step_size,
                                   min=0)[..., None]         # (B,nh,T,1)
                k_idx = torch.arange(logits.shape[-1], device=h.device)
                window = (k_idx >= base) & (k_idx < base + self.window_size)
                logits = logits.masked_fill(~window, _NEG)
            w = torch.softmax(logits, dim=-1)
            aligns.append(w)
            w = self.drop(w, self.attention_dropout, train, generator)
            ctx = torch.einsum("bhqk,bkhd->bqhd", w.to(self.dtype), v)
            ctx = getattr(self, "att_o{}".format(i))(ctx.reshape(B, T, -1))
            h = h + self.drop(ctx, self.postprocess_dropout, train,
                              generator)
        frame = self.frame(h.float()).reshape(B, T * self.r, self.F)
        stop = self.stop(h.float()).reshape(B, T * self.r)
        return frame, stop, torch.stack(aligns).float()

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None) -> Dict[str, Any]:
        enc = input_dict["encoder_output"]
        memory, mem_len = enc["outputs"], enc["src_length"]
        B, S, _ = memory.shape
        dev = memory.device
        F_, r, nh = self.F, self.r, self.heads
        enc_mask = torch.arange(S, device=dev)[None, :] < mem_len[:, None]
        keys_values = []
        for i in range(1, self.num_blocks + 1):
            kv = getattr(self, "att_kv{}".format(i))(memory)
            k, v = torch.chunk(kv, 2, dim=-1)
            keys_values.append((k.reshape(B, S, nh, -1),
                                v.reshape(B, S, nh, -1)))
        if self.prenet_layers and generator is None:
            raise ValueError("the prenet's dropout, on in every mode, needs "
                             "a torch.Generator")

        targets = input_dict.get("target_tensors")
        if self.mode != "infer" and targets is not None:
            spec, _, spec_len = targets[:3]
            T = spec.shape[1] // r * r
            grouped = spec.float()[:, :T].reshape(B, T // r, r * F_)
            dec_in = torch.cat([grouped.new_zeros((B, 1, r * F_)),
                                grouped[:, :-1]], dim=1)
            # the last frame of the previous group
            dec_in = dec_in[..., -F_:]
            frame, stop, aligns = self.stack(
                dec_in, keys_values, enc_mask,
                self.prenet_masks(B, T // r, generator, dev), train,
                generator)
            out_len = spec_len
        elif self.mode == "infer":
            frame, stop, aligns = self.infer(keys_values, enc_mask,
                                             generator)
            stopped = torch.sigmoid(stop) > 0.5
            seen = torch.cumsum(stopped.int(), dim=1)
            out_len = torch.clamp((seen == 0).int().sum(1) + 1, 1,
                                  frame.shape[1])
        else:
            return {}
        return {"decoder_spec": frame, "post_net_spec": frame,
                "stop_token_logits": stop,
                "alignments": aligns[-1].mean(dim=1),
                "lengths": out_len, "outputs": [frame, out_len]}

    def prenet_masks(self, B: int, T: int, generator: torch.Generator,
                     device) -> List[torch.Tensor]:
        return [self.keep_mask((B, T, self.prenet_width), generator, device)
                for _ in range(self.prenet_layers)]

    def infer(self, keys_values, enc_mask, generator):
        """``infer_max_steps // r`` groups by re-running the stack."""
        B = enc_mask.shape[0]
        dev = enc_mask.device
        G = self.infer_max_steps // self.r
        keep = self.prenet_masks(B, G, generator, dev)
        frames = torch.zeros((B, G, self.F), device=dev)
        windowing = self.window_size is not None
        positions = torch.zeros((self.num_blocks, B, self.heads, G),
                                dtype=torch.long, device=dev) \
            if windowing else None
        for i in range(G - 1):
            frame, _, aligns = self.stack(frames, keys_values, enc_mask, keep,
                                          False, generator, positions)
            frames[:, i + 1] = frame[:, (i + 1) * self.r - 1]
            if windowing:
                # step i's alignment argmax is step i + 1's window base
                positions[..., i + 1] = aligns[:, :, :, i].argmax(-1)
        return self.stack(frames, keys_values, enc_mask, keep, False,
                          generator, positions)


class CentaurDecoder(Decoder):
    """Config wrapper, the JAX package's schema."""

    @staticmethod
    def get_required_params():
        return dict(Decoder.get_required_params(), **{
            "prenet_layers": int,
            "prenet_hidden_size": int,
            "hidden_size": int,
            "conv_layers": list,
            "mag_conv_layers": None,
            "attention_dropout": float,
            "layer_postprocess_dropout": float,
        })

    @staticmethod
    def get_optional_params():
        return dict(Decoder.get_optional_params(), **{
            "prenet_activation_fn": None,
            "prenet_dropout": float,
            "prenet_use_inference_dropout": bool,
            "cnn_dropout_prob": float,
            "bn_momentum": float,
            "bn_epsilon": float,
            "reduction_factor": int,
            "attention_layers": int,
            "self_attention_conv_params": dict,
            "attention_heads": int,
            "attention_cnn_dropout_prob": float,
            "window_size": int,
            "back_step_size": int,
            "force_layers": list,
            "num_audio_features": int,
            "infer_max_steps": int,
        })

    def make_module(self, in_features: int, generator: torch.Generator
                    ) -> CentaurDecoderModule:
        """``in_features`` is the encoder's output width."""
        dtype = torch.float32 if self._model is None \
            else self._model.mp_policy.compute_dtype
        model = self._model.params if self._model is not None else {}
        return CentaurDecoderModule(self._params, in_features, self._mode,
                                    dtype, generator,
                                    model.get("dropout_bits", 32))
